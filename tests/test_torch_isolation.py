"""The port stands alone and keeps the repo's lint clean.

* No module under ``src/repro_torch/``, and not ``chip_smoke.py``,
  imports ``jax``, ``jaxlib`` or the JAX package ``repro`` (checked on
  the AST, so an import inside a function counts too).
* ``tools/analysis/reprolint.py`` walks all of ``src/`` and indexes
  functions and classes by bare name, first definition winning, so
  which package it reads first decides which ``ContinuousBatcher``,
  ``Model`` or ``BlockAllocator`` its rules look at.  It must report
  nothing whichever package comes first.
"""
import ast
import importlib.util
import os
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")

_spec = importlib.util.spec_from_file_location(
    "reprolint_torch_isolation", REPO / "tools" / "analysis" / "reprolint.py")
reprolint = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = reprolint       # dataclasses needs the module
_spec.loader.exec_module(reprolint)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [(ln, mod) for ln, mod in _imported_roots(path) if mod in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("order", ["sorted", "reverse-sorted"])
def test_reprolint_clean_in_either_walk_order(order, monkeypatch):
    real_walk = os.walk

    def walk(top, *args, **kwargs):
        entries = list(real_walk(top, *args, **kwargs))
        entries.sort(key=lambda e: e[0], reverse=order != "sorted")
        return iter(entries)

    monkeypatch.setattr(reprolint.os, "walk", walk)
    findings = reprolint.lint_root(str(REPO))
    assert findings == [], "\n".join(f.render(str(REPO)) for f in findings)
