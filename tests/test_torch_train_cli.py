"""The port's training CLI (``repro_torch.launch.train``) and data
pipeline, on the CPU:

* twins of ``tests/test_drivers.py``'s three training tests (held-out CE
  falls, a NaN rolls back, a restart resumes from the checkpoint);
* ``train_from_weights`` over the JAX ``Model.init`` / ``init_lora``
  weights (through ``repro_torch.convert``) against the JAX
  ``run_training`` in the same process on the same synthetic batches
  (the data seeds from Python's per-process ``hash``): 15 steps with a
  checkpoint every 5, again with a NaN injected at step 12, and a
  restart.  Step counts, checkpointed steps and the rollback lines are
  exact; every per-step loss within ``LOSS_RTOL`` relative (the rtol of
  ``tests/test_torch_train.py``'s train steps) and the final adapters
  within ``LORA_ATOL``; the port also resumes from the JAX run's
  checkpoints;
* ``main()`` in-process prints the reference's lines;
* mamba2 trains on the CPU (the plain ``ssd_scan`` and its plain
  backward; hymba's twin is in ``tests/test_torch_hybrid.py``); the VLM
  and the archs still to port raise, naming their ROADMAP item; the
  default device raises without a card;
* ``DataPipeline`` yields ``sample_fn``'s batches in order.
"""
import re
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.launch import train as jax_train
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch import train
from repro_torch.launch.train import (
    init_weights, run_training, train_from_weights,
)
from repro_torch.tree import tree_leaves

ARCH = "qwen1.5-0.5b"
# the losses agree far inside the train-step rtol; the adapters' gap
# depends on the (hash-seeded) data: AdamW's normalised update (lr 3e-3
# a step) turns float32 noise in a near-zero gradient component into a
# step-sized difference in that component, so their bound sits above the
# largest gap seen across data sets, a small fraction of one step
LOSS_RTOL = 1e-5
LORA_ATOL = 2e-4


# ------------------------------------------- twins of test_drivers -------
def test_training_reduces_loss(tmp_path):
    out = run_training(ARCH, smoke=True, steps=30, batch=8, seq=32,
                       ckpt_dir=str(tmp_path), ckpt_every=10, lr=5e-3,
                       verbose=False, device="cpu")
    assert out["steps"] == 30
    # per-batch train losses are noisy at 30 steps; compare eval CE on a
    # FIXED held-out batch with the initial vs the trained adapter (the
    # weights are seed-reconstructible from run_training)
    cfg = get_config(ARCH).scaled()
    engine = make_engine(cfg, device="cpu")
    params, lora0 = init_weights(engine, 0)
    held = {k: torch.as_tensor(v) for k, v in SyntheticDataset(
        "alpaca", vocab_size=cfg.vocab_size, seq_len=32,
        seed=0).batch(16).items()}
    with torch.no_grad():
        l0 = float(engine.model.forward_loss(params, lora0, held)[0])
        l1 = float(engine.model.forward_loss(params, out["lora"], held)[0])
    assert l1 < l0, f"LoRA training should reduce held-out CE ({l0}->{l1})"


def test_training_restores_after_nan(tmp_path):
    out = run_training(ARCH, smoke=True, steps=25, batch=4, seq=32,
                       ckpt_dir=str(tmp_path), ckpt_every=5,
                       inject_nan_at=12, verbose=False, device="cpu")
    # the injected failure rolled back to step 10 and retrained
    assert out["steps"] == 25
    assert all(l == l for l in out["losses"])  # no NaN kept
    assert len(out["losses"]) == 27            # steps 10 and 11 twice


def test_rollback_resumes_at_the_checkpoint_still_being_written(
        tmp_path, monkeypatch):
    """A NaN one step after a save whose write is still on the writer
    thread rolls back to that save: step 10, with steps 0-10 and 10-14
    kept (16 losses), as when the write is done.  The write of step 10 is
    held until the train step of step 11 has returned, then takes half a
    second more: reading the latest complete step before it lands, as
    the reference's loop does, resumes the count at 5 with step 10's
    state restored (21 losses)."""
    from repro_torch.core.engine import Engine
    real_compressor, real_step = ckpt_mod._compressor, Engine.train_step
    released, writes, steps = threading.Event(), [], []

    def step(self, *a, **kw):
        out = real_step(self, *a, **kw)
        steps.append(1)
        if len(steps) == 12:            # the train step of step 11
            released.set()
        return out

    def compressor(codec):
        compress, first = real_compressor(codec), []
        held = len(writes) == 1         # the second write: step 10
        writes.append(1)

        def call(data):
            if held and not first:
                released.wait()
                time.sleep(0.5)
            first.append(1)
            return compress(data)
        return call

    monkeypatch.setattr(Engine, "train_step", step)
    monkeypatch.setattr(ckpt_mod, "_compressor", compressor)
    out = run_training(ARCH, smoke=True, steps=15, batch=4, seq=32,
                       ckpt_dir=str(tmp_path), ckpt_every=5,
                       inject_nan_at=11, verbose=False, device="cpu")
    assert out["steps"] == 15
    assert len(out["losses"]) == 16


def test_training_restart_from_checkpoint(tmp_path):
    run_training(ARCH, smoke=True, steps=10, batch=4, seq=32,
                 ckpt_dir=str(tmp_path), ckpt_every=5, verbose=False,
                 device="cpu")
    out = run_training(ARCH, smoke=True, steps=15, batch=4, seq=32,
                       ckpt_dir=str(tmp_path), restore=True,
                       verbose=False, device="cpu")
    assert out["steps"] == 15
    assert len(out["losses"]) == 5  # only steps 10..15 re-run


# ------------------------------------------- against the JAX trainer -----
@pytest.fixture(scope="module")
def jax_weights():
    """The weights JAX ``run_training`` draws for seed 0, as numpy."""
    cfg = jax_config(ARCH).scaled()
    model = jax_make_engine(cfg).model
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    lora = jax.tree.map(np.asarray, model.init_lora(jax.random.key(1)))
    return params, lora


def _port_run(jax_weights, **kw):
    cfg = get_config(ARCH).scaled()
    engine = make_engine(cfg, lr=3e-3, device="cpu")
    params, lora = jax_weights
    return train_from_weights(
        engine, params_from_numpy(cfg, params, device="cpu"),
        lora_from_numpy(lora, device="cpu"), arch=ARCH, batch=4, seq=32,
        ckpt_every=5, log_every=5, **kw)


def _jax_run(**kw):
    return jax_train.run_training(ARCH, smoke=True, batch=4, seq=32,
                                  ckpt_every=5, log_every=5, **kw)


def _rollbacks(text):
    return [ln for ln in text.splitlines()
            if "restor" in ln or "non-finite" in ln]


def _compare(port, ref):
    assert port["steps"] == ref["steps"]
    assert len(port["losses"]) == len(ref["losses"])
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    got = [t.numpy() for t in tree_leaves(port["lora"])]
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref["lora"]))
    # both trees are dicts: tree_leaves walks insertion order, JAX sorted
    got = [g for _, g in sorted(zip(_keys(port["lora"]), got))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LORA_ATOL)


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key, v in tree.items()
                for k in _keys(v, f"{prefix}/{key}")]
    return [prefix]


@pytest.mark.parametrize("inject_nan_at,steps", [(-1, 15), (12, 25)],
                         ids=["plain", "nan_at_12"])
def test_train_from_weights_matches_jax(tmp_path, capsys, jax_weights,
                                        inject_nan_at, steps):
    ref = _jax_run(steps=steps, ckpt_dir=str(tmp_path / "jax"),
                   inject_nan_at=inject_nan_at)
    ref_log = capsys.readouterr().out
    port = _port_run(jax_weights, steps=steps,
                     ckpt_dir=str(tmp_path / "port"),
                     inject_nan_at=inject_nan_at)
    port_log = capsys.readouterr().out
    _compare(port, ref)
    assert _rollbacks(port_log) == _rollbacks(ref_log)
    if inject_nan_at >= 0:
        assert _rollbacks(port_log) == [
            "step 12: non-finite loss; restoring step 10"]
        assert len(port["losses"]) == steps + 2
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_restart_matches_jax_and_resumes_from_its_checkpoint(
        tmp_path, capsys, jax_weights):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_run(steps=10, ckpt_dir=jdir)
    _port_run(jax_weights, steps=10, ckpt_dir=pdir)
    capsys.readouterr()
    ref = _jax_run(steps=15, ckpt_dir=jdir, restore=True)
    assert "restored step 10" in capsys.readouterr().out
    port = _port_run(jax_weights, steps=15, ckpt_dir=pdir, restore=True)
    assert "restored step 10" in capsys.readouterr().out
    assert len(port["losses"]) == 5
    _compare(port, ref)
    # the port resumes from the JAX run's own step-10 checkpoint too
    cross = str(tmp_path / "cross")
    _jax_run(steps=10, ckpt_dir=cross)
    port2 = _port_run(jax_weights, steps=15, ckpt_dir=cross, restore=True)
    _compare(port2, ref)


def _done_lines(text):
    return [re.sub(r"loss [0-9.]+", "loss L", ln)
            for ln in text.splitlines() if ln.startswith(("done", "rest"))]


def test_main_prints_the_reference_lines(tmp_path, capsys, monkeypatch):
    common = ["train", "--arch", ARCH, "--batch", "4", "--seq", "16",
              "--steps", "3"]
    outs = {}
    for name, mod, extra in [("jax", jax_train, []),
                             ("port", train, ["--device", "cpu"])]:
        ck = ["--ckpt", str(tmp_path / name)]
        monkeypatch.setattr(sys, "argv", common + ck + extra)
        mod.main()
        monkeypatch.setattr(sys, "argv", common[:-1] + ["4", "--restore"]
                            + ck + extra)
        mod.main()
        outs[name] = capsys.readouterr().out
    assert _done_lines(outs["port"]) == _done_lines(outs["jax"]) == [
        "done: 3 steps, final loss L", "restored step 3",
        "done: 4 steps, final loss L"]
    # the weights differ (the port draws from torch generators), so the
    # losses do; the differential tests above hold them on one weight set
    assert all(np.isfinite(float(m)) for m in re.findall(
        r"final loss ([0-9.]+)", outs["port"]))


# ------------------------------------------------------ other archs ------
def test_mamba2_trains_on_the_cpu(tmp_path):
    out = run_training("mamba2-780m", smoke=True, steps=3, batch=2, seq=16,
                       ckpt_dir=str(tmp_path), verbose=False, device="cpu")
    assert out["steps"] == 3
    assert all(np.isfinite(out["losses"]))


def test_vlm_refused_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 4"):
        run_training("llama-3.2-vision-90b", steps=1, device="cpu",
                     verbose=False)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "moonshot-v1-16b-a3b",
                                  "grok-1-314b"])
def test_pending_archs_refused_naming_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="Other families"):
        run_training(arch, steps=1, device="cpu", verbose=False)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(ARCH, steps=1, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(lambda b: {"x": np.zeros(b)}, 2)


# ------------------------------------------------------- the pipeline ----
def _counter(delay=0.0):
    """A sample_fn whose n-th call returns batch n (and may take a while,
    so that a refill is still running when the next batch is asked for);
    it records calls made while another is in progress."""
    state = {"n": 0, "busy": False, "overlaps": 0}
    lock = threading.Lock()

    def sample(b):
        with lock:
            if state["busy"]:
                state["overlaps"] += 1
            state["busy"] = True
            n = state["n"]
            state["n"] += 1
        time.sleep(delay)
        with lock:
            state["busy"] = False
        return {"tokens": np.full((b, 3), n, np.int32),
                "mask": np.full((b, 3), n / 2, np.float32)}
    return sample, state


@pytest.mark.parametrize("delay", [0.0, 0.02])
def test_pipeline_yields_batches_in_order(delay):
    sample, state = _counter(delay)
    pipe = DataPipeline(sample, 4, device="cpu")
    got = [next(pipe) for _ in range(6)]
    want_fn, _ = _counter()
    for g, n in zip(got, range(6)):
        want = want_fn(4)
        assert g.keys() == want.keys()
        for k in want:
            assert g[k].device.type == "cpu"
            assert torch.equal(g[k], torch.as_tensor(want[k]))
        assert int(g["tokens"][0, 0]) == n
    assert state["overlaps"] == 0


def test_pipeline_order_under_thread_switching():
    """The refill thread and the consumer interleave at every bytecode:
    the batches still come out in ``sample_fn``'s order, one at a time."""
    sample, state = _counter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = DataPipeline(sample, 2, device="cpu")
        got = [int(next(pipe)["tokens"][0, 0]) for _ in range(200)]
    finally:
        sys.setswitchinterval(old)
    pipe._thread.join(timeout=10)
    assert not pipe._thread.is_alive()
    assert got == list(range(200))
    assert state["overlaps"] == 0


def test_pipeline_over_the_synthetic_data():
    data = SyntheticDataset("alpaca", vocab_size=64, seq_len=8, seed=2)
    twin = SyntheticDataset("alpaca", vocab_size=64, seq_len=8, seed=2)
    pipe = DataPipeline(data.batch, 3, device="cpu")
    for _ in range(3):
        got, want = next(pipe), twin.batch(3)
        assert all(torch.equal(got[k], torch.as_tensor(want[k]))
                   for k in want)
