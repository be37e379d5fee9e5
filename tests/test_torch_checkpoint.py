"""The port's checkpointer (``repro_torch.checkpoint``):

* twins of ``tests/test_checkpoint.py``'s first five tests on tensor
  trees, ``restore(shardings=)`` keeping a rank's block of each leaf
  (the elastic restore across meshes of spawned ranks is in
  ``tests/test_torch_mesh.py``);
* cross-package, bitwise, both ways: a checkpoint of the reduced qwen's
  ``(lora, AdamWState)`` after two JAX train steps (nonzero moments and
  step), carried into the port through ``repro_torch.convert``, written
  by either package and restored by the other; the port's leaf keys
  equal ``jax.tree_util``'s on the same trees; a bfloat16 leaf both
  ways; under zstd and zlib (``zstandard`` patched away in both
  packages), and a zstd checkpoint read without ``zstandard`` raises;
* the snapshot owns its bytes: a tree updated in place after ``save``
  and before the write is written with its values as of ``save``.
"""
import json
import os
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import checkpointer as jax_ckpt_mod
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.data.synthetic import SyntheticDataset
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.convert import lora_from_numpy, opt_state_from_numpy
from repro_torch.models.sharding import MeshSharding
from repro_torch.optim.adamw import AdamWState


def _tree():
    return {"w": torch.arange(24.0).reshape(4, 6),
            "opt": {"m": torch.ones((3,), dtype=torch.float32),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return [leaf for _, leaf in ckpt_mod._tree_paths(tree)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


# ------------------------------------------- twins of test_checkpoint ----
def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(5, tree, extra={"loss": 1.25})
    restored, extra = ck.restore(tree)
    assert extra["loss"] == 1.25
    assert _equal(tree, restored)
    assert list(restored) == ["w", "opt"]           # the template's order


def test_async_writer_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, _tree())
    ck.wait()
    assert ck.all_steps() == [3, 4]


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    tree = _tree()
    ck.save(1, tree)
    ck.save(2, {"w": tree["w"] * 2, "opt": tree["opt"]})
    ck.wait()
    r1, _ = ck.restore(tree, step=1)
    r2, _ = ck.restore(tree, step=2)
    assert float(r2["w"][0, 1]) == 2 * float(r1["w"][0, 1])


def test_incomplete_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    ck.wait()
    # simulate a crash mid-write: directory without the _COMPLETE flag
    os.makedirs(tmp_path / "step_0000000099")
    assert ck.all_steps() == [1]
    assert ck.latest_step() == 1


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    ck.wait()
    bad = {"w": torch.zeros((2, 2)),
           "opt": {"m": torch.ones((3,)),
                   "step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        ck.restore(bad)


# ------------------------------------------------ restore's arguments ----
def test_restore_casts_and_places_as_asked(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(1, tree, blocking=True)
    meta = {"w": torch.empty((4, 6), dtype=torch.float64, device="meta"),
            "opt": {"m": torch.empty((3,), device="meta"),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    got, _ = ck.restore(meta, device="cpu")
    assert got["w"].dtype == torch.float64 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], tree["w"].double())
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore({"x": torch.zeros(1)})
    # shardings= keeps this rank's block of each whole leaf: here rank 1
    # of a 2-way "data" axis (a stand-in mesh: shape and coordinates)
    mesh = SimpleNamespace(shape={"data": 2}, coords={"data": 1})
    shd = {"w": MeshSharding(mesh, ("data", None)),
           "opt": {"m": MeshSharding(mesh, (None,)),
                   "step": MeshSharding(mesh, ())}}
    part, _ = ck.restore(meta, device="cpu", shardings=shd)
    assert torch.equal(part["w"], tree["w"].double()[2:])
    assert torch.equal(part["opt"]["m"], tree["opt"]["m"])
    with pytest.raises(ValueError, match="shardings"):
        ck.restore(tree, shardings={"w": shd["w"]})


def test_default_device_raises_without_a_card(tmp_path):
    """A shape-only (meta) template lands on the card unless asked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore({"w": torch.empty(2, device="meta")})


def test_snapshot_owns_its_bytes(tmp_path, monkeypatch):
    """The writer thread is held until the tree has been updated in
    place: what it writes is the tree as of ``save``."""
    go = threading.Event()
    real = ckpt_mod._compressor

    def held(codec):
        compress = real(codec)

        def run(data):
            go.wait(10)
            return compress(data)
        return run

    monkeypatch.setattr(ckpt_mod, "_compressor", held)
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.zeros(64, 64), "step": torch.tensor(3)}
    ck.save(1, tree)
    tree["w"].add_(1.0)
    tree["step"].add_(1)
    go.set()
    ck.wait()
    got, _ = ck.restore({"w": torch.ones(64, 64), "step": torch.tensor(0)})
    assert torch.equal(got["w"], torch.zeros(64, 64))
    assert int(got["step"]) == 3


# ------------------------------------------------ across the packages ----
@pytest.fixture(scope="module")
def trained():
    """The reduced qwen's JAX (lora, AdamWState) after two train steps,
    and the same trees carried into the port."""
    cfg = jax_config("qwen1.5-0.5b").scaled()
    eng = jax_make_engine(cfg, lr=3e-3)
    params = eng.model.init(jax.random.key(0))
    lora = eng.model.init_lora(jax.random.key(1))
    opt = eng.optimizer.init(lora)
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=16, seed=0)
    step = jax.jit(eng.train_step)
    for _ in range(2):
        b = {k: jnp.asarray(v) for k, v in data.batch(2).items()}
        lora, opt, _ = step(params, lora, opt, b)
    np_lora = jax.tree.map(np.asarray, lora)
    np_opt = jax.tree.map(np.asarray, opt)
    port = (lora_from_numpy(np_lora, device="cpu"),
            opt_state_from_numpy(np_opt, device="cpu"))
    return (lora, opt), port


@pytest.fixture(params=["zstd", "zlib"])
def codec(request, monkeypatch):
    if request.param == "zlib":
        monkeypatch.setattr(ckpt_mod, "zstandard", None)
        monkeypatch.setattr(jax_ckpt_mod, "zstandard", None)
    elif ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not installed")
    return request.param


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _bits(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _assert_bitwise(port_tree, jax_tree):
    pl, jl = _leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl) == 25
    for p, j in zip(pl, jl):
        assert np.array_equal(p.numpy(), np.asarray(j))
        assert str(p.dtype).split(".")[-1] == str(np.asarray(j).dtype)


def test_leaf_keys_are_jax_keys(trained):
    (jlora, jopt), (tlora, topt) = trained
    want = [k for k, _ in jax_ckpt_mod._tree_paths((jlora, jopt))]
    got = [k for k, _ in ckpt_mod._tree_paths((tlora, topt))]
    assert got == want
    assert {"0/q/a", "1/.step", "1/.m/q/a"} <= set(got)


def test_jax_checkpoint_restored_by_the_port(tmp_path, trained, codec):
    (jlora, jopt), port = trained
    ck = JaxCheckpointer(str(tmp_path))
    ck.save(7, (jlora, jopt), extra={"arch": "qwen1.5-0.5b"})
    ck.wait()
    assert _manifest(ck.directory + "/step_0000000007")["codec"] == codec
    got, extra = Checkpointer(str(tmp_path)).restore(port)
    assert extra == {"arch": "qwen1.5-0.5b"}
    assert isinstance(got[1], AdamWState) and int(got[1].step) == 2
    _assert_bitwise(got, (jlora, jopt))


def test_port_checkpoint_restored_by_jax(tmp_path, trained, codec):
    (jlora, jopt), port = trained
    ck = Checkpointer(str(tmp_path))
    path = ck.save(7, port, extra={"arch": "qwen1.5-0.5b"})
    ck.wait()
    man = _manifest(path)
    assert man["codec"] == codec and man["step"] == 7
    assert {m["dtype"] for m in man["leaves"].values()} == {"float32",
                                                             "int32"}
    got, extra = JaxCheckpointer(str(tmp_path)).restore(
        jax.eval_shape(lambda: (jlora, jopt)))
    assert extra == {"arch": "qwen1.5-0.5b"}
    _assert_bitwise(port, got)
    assert isinstance(got[1], type(jopt))


def test_bfloat16_leaf_both_ways(tmp_path, codec):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    # port -> JAX
    Checkpointer(str(tmp_path / "p")).save(1, {"w": x}, blocking=True)
    man = _manifest(str(tmp_path / "p" / "step_0000000001"))
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    got, _ = JaxCheckpointer(str(tmp_path / "p")).restore(
        jax.eval_shape(lambda: {"w": jx}))
    assert got["w"].dtype == jnp.bfloat16
    assert np.array_equal(_bits(got["w"]), x.view(torch.int16).numpy()
                          .view(np.uint16))
    # JAX -> port
    ck = JaxCheckpointer(str(tmp_path / "j"))
    ck.save(1, {"w": jx})
    ck.wait()
    back, _ = Checkpointer(str(tmp_path / "j")).restore(
        {"w": torch.zeros((5, 7), dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    if ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not installed")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        Checkpointer(str(tmp_path)).restore(_tree())
