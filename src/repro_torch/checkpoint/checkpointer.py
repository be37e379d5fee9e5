"""Async checkpointing of tensor trees (the trainer's fault-tolerance
substrate) — the port's counterpart of ``repro.checkpoint.checkpointer``,
on the same on-disk format, so either package restores what the other
wrote.

Format: one directory per step, ``step_XXXXXXXXXX/``, with
  manifest.json     step, extra, the compression codec, a description of
                    the tree (``treedef``: neither package reads it back)
                    and per leaf its file, shape, numpy dtype name and
                    index
  leaf_NNNNN.bin.zst compressed raw bytes of one leaf, C order
  _COMPLETE         written last; a directory without it is ignored
A step is written under ``<dir>.tmp`` and renamed into place; the oldest
steps beyond ``keep`` are deleted.

Leaves are keyed by their path as ``jax.tree_util`` names it: dict keys
by name (sorted, as JAX flattens them), tuple and list entries by index,
NamedTuple fields as ``.field``, joined with ``/``; a ``(lora,
AdamWState)`` pair gives ``0/q/a``, ``1/.step``, ``1/.m/q/a``.  Restore
looks leaves up by key, so the order of the files does not matter.

bfloat16 leaves are written as their raw 16-bit patterns under the dtype
name ``bfloat16`` (what numpy calls it once ``ml_dtypes`` is loaded),
and read back the same way, so no ``ml_dtypes`` is needed here.

zstandard is optional: without it the writer uses stdlib zlib and
records the codec; a zstd checkpoint restored without zstandard raises.

``save`` copies every leaf to host memory before it returns (the
training loop may update its tensors in place afterwards) and writes on
a background thread; ``wait()`` joins it and raises what it raised.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import resolve_device

try:
    import zstandard
except ImportError:               # optional dep: fall back to stdlib zlib
    zstandard = None

_FLAG = "_COMPLETE"
_MESH = ("shardings= restores onto a device mesh, which the port does not "
         "have yet; see ROADMAP.md, item 6 (the XLA/TPU-mesh tooling)")


def _compressor(codec: str):
    if codec == "zstd":
        return zstandard.ZstdCompressor(level=3).compress
    return lambda data: zlib.compress(data, 3)


def _decompressor(codec: str):
    if codec == "zstd":
        if zstandard is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd compression but "
                "zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress
    if codec == "zlib":
        return zlib.decompress
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _tree_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) for every leaf of nested dicts, tuples, lists and
    NamedTuples, in ``jax.tree_util``'s order and with its key strings."""
    return [("/".join(path), leaf) for path, leaf in _flatten(tree)]


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken from ``leaves`` (an
    iterator, in ``_tree_paths`` order)."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _describe(tree: Any) -> str:
    """The tree's structure, leaves as ``*`` (the manifest's ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf that owns its bytes, and its dtype name."""
    host = t.detach().to("cpu", copy=True)  # lint: host-sync-ok checkpoint snapshot, once per save
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape: Tuple[int, ...]
                ) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> str:
        """Snapshot to host memory synchronously, write asynchronously."""
        self.wait()
        leaves = [(k, *_to_host(v)) for k, v in _tree_paths(tree)]
        treedef = _describe(tree)
        path = os.path.join(self.directory, f"step_{step:010d}")

        def write():
            try:
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                codec = "zstd" if zstandard is not None else "zlib"
                manifest = {"step": step, "extra": extra or {},
                            "codec": codec, "treedef": treedef,
                            "leaves": {}}
                compress = _compressor(codec)
                for i, (key, arr, dtype) in enumerate(leaves):
                    fn = f"leaf_{i:05d}.bin.zst"
                    manifest["leaves"][key] = {
                        "file": fn, "shape": list(arr.shape),
                        "dtype": dtype, "index": i}
                    with open(os.path.join(tmp, fn), "wb") as f:
                        f.write(compress(
                            np.ascontiguousarray(arr).tobytes()))
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                with open(os.path.join(tmp, _FLAG), "w") as f:
                    f.write("ok")
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.rename(tmp, path)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            full = os.path.join(self.directory, d)
            if d.startswith("step_") and \
                    os.path.exists(os.path.join(full, _FLAG)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template``, a tree of tensors
        whose shapes must match the checkpoint's; each leaf takes its
        template leaf's dtype and lands on ``device``, or, when that is
        None, on its template leaf's device.  A template leaf on the
        ``meta`` device (shapes and dtypes only, as ``jax.eval_shape``
        gives them) lands on ``device``, by default the card.  Returns
        (tree, the manifest's ``extra``)."""
        if shardings is not None:
            raise NotImplementedError(_MESH)
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        # pre-codec checkpoints carry no codec field and were zstd-only
        decompress = _decompressor(manifest.get("codec", "zstd"))
        by_key = manifest["leaves"]
        out = []
        for key, leaf in _tree_paths(template):
            meta = by_key.get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            want_shape = tuple(leaf.shape)
            if tuple(meta["shape"]) != want_shape:
                raise ValueError(
                    f"{key}: checkpoint shape {meta['shape']} != "
                    f"template {want_shape}")
            with open(os.path.join(path, meta["file"]), "rb") as f:
                raw = decompress(f.read())
            dev = device if device is not None else (
                "cuda" if leaf.device.type == "meta" else leaf.device)
            dev = resolve_device(dev)
            out.append(_from_bytes(raw, meta["dtype"], want_shape)
                       .to(device=dev, dtype=leaf.dtype))
        return _unflatten(template, iter(out)), manifest["extra"]

