"""The port's training CLI (``repro_torch.launch.train``) and data
pipeline, on the CPU:

* twins of ``tests/test_drivers.py``'s three training tests (held-out CE
  falls, a NaN rolls back, a restart resumes from the checkpoint);
* ``train_from_weights`` over the JAX ``Model.init`` / ``init_lora``
  weights (through ``repro_torch.convert``) against the JAX
  ``run_training`` in the same process: 15 steps with a checkpoint every
  5, again with a NaN injected at step 12, and a restart.  Step counts,
  checkpointed steps and the rollback lines are exact, and every
  per-step loss is within ``LOSS_RTOL`` relative (the rtol of
  ``tests/test_torch_train.py``'s train steps); the port also resumes
  from the JAX run's checkpoints.  The adapters are held one step at a
  time: along the JAX run's own trajectory (its states, its batches,
  drawn once here and handed to both), each package takes one
  ``Engine.train_step`` from JAX's state: the new AdamW moments agree
  within float32 noise, and each package's new adapters are within
  ``STEP_ATOL`` of the AdamW update applied in float64 to JAX's previous
  adapters with that package's own new moments; the walk goes on from
  JAX's state, so no gap carries from one step to the next, whatever
  batches Python's per-process ``hash`` seeds;
* ``main()`` in-process prints the reference's lines;
* mamba2 trains on the CPU (the plain ``ssd_scan`` and its plain
  backward; hymba's twin is in ``tests/test_torch_hybrid.py``; the
  encoder's and the VLM's CLI runs are in ``tests/test_torch_encoder.py``
  and ``tests/test_torch_vlm.py``); the default device raises without a
  card;
* ``DataPipeline`` yields ``sample_fn``'s batches in order.
"""
import re
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.launch import train as jax_train
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs.registry import get_config
from repro_torch.convert import (
    lora_from_numpy, opt_state_from_numpy, params_from_numpy,
)
from repro_torch.core.engine import make_engine
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch import train
from repro_torch.launch.train import (
    init_weights, run_training, train_from_weights,
)

ARCH = "qwen1.5-0.5b"
# the losses agree far inside the train-step rtol
LOSS_RTOL = 1e-5
# one AdamW step from a shared state.  The moments hold the gradient:
# m' - 0.9 m = 0.1 g, v' - 0.999 v = 0.001 g^2, both from the same m, v,
# so their gaps are float32 noise in g (at most 3.7e-9 in m across hash
# seeds; v within the rtol of tests/test_torch_train.py).  The adapters
# then move by lr m^ / (sqrt(v^) + eps), which turns that noise into a
# real fraction of lr where g itself is at noise level (seed 13, step 0:
# g of 1e-9 in one bias, beside eps 1e-8).  So they are not held against
# JAX's adapters but against the update itself: each package's new
# adapters against prev - lr m^ / (sqrt(v^) + eps) in float64, from
# JAX's previous adapters and the package's own new moments (held above),
# at STEP_ATOL, float32 rounding of an update of at most a few lr.
STEP_ATOL = 1e-6
M_RTOL, M_ATOL = 1e-5, 1e-8
V_RTOL, V_ATOL = 1e-4, 1e-12
LR, B1, B2, EPS = 3e-3, 0.9, 0.999, 1e-8


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


@pytest.fixture(scope="module")
def steppers(jax_weights):
    """One train step of each package: JAX's public ``Engine.train_step``
    (jitted, as ``run_training`` runs it) and the port's, over the same
    weights; and a fresh JAX start state (adapters, AdamW state)."""
    params, lora = jax_weights
    jeng = jax_make_engine(jax_config(ARCH).scaled(), lr=3e-3)
    cfg = get_config(ARCH).scaled()
    return {"jstep": jax.jit(jeng.train_step),
            "jparams": jax.tree.map(jnp.asarray, params),
            "start": (jax.tree.map(jnp.asarray, lora),
                      jeng.optimizer.init(jax.tree.map(jnp.asarray, lora))),
            "engine": make_engine(cfg, lr=3e-3, device="cpu"),
            "params": params_from_numpy(cfg, params, device="cpu")}


def _batches(n):
    """The first ``n`` batches a run draws (``SyntheticDataset`` of seed
    0), drawn once in this process for both packages."""
    cfg = get_config(ARCH).scaled()
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size, seq_len=32,
                            seed=0)
    return [data.batch(4) for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """(path, leaf) of a tree of nested dicts, sorted by path."""
    if isinstance(tree, dict):
        return sorted(p for key, v in tree.items()
                      for p in _paths(v, f"{prefix}/{key}"))
    return [(prefix, tree)]


def _close(port_tree, jax_tree, what, k, **tol):
    got = [(p, t.numpy()) for p, t in _paths(port_tree)]
    want = _paths(_np_tree(jax_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=f"step {k}: {what} {p}",
                                   **tol)


def _adamw_holds(new, prev, m, v, step, what, k):
    """``new`` (adapters, numpy leaves by path) is within STEP_ATOL of
    one AdamW step (no weight decay) from ``prev`` with new moments
    ``m``, ``v`` at ``step``, computed in float64."""
    bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
    for (p, got), (_, w), (_, mm), (_, vv) in zip(new, prev, m, v):
        mm, vv = mm.astype(np.float64), vv.astype(np.float64)
        want = w.astype(np.float64) - LR * (mm / bc1) / (
            np.sqrt(vv / bc2) + EPS)
        gap = np.abs(got.astype(np.float64) - want)
        assert gap.max() <= STEP_ATOL, (
            f"step {k}: {what} adapter {p} off its AdamW update by "
            f"{gap.max()}")


def _walk(st, state, batches, first_step):
    """JAX's trajectory from ``state`` over ``batches``; at each step the
    port takes one train step from JAX's state (converted through
    ``convert.py``) on the same batch: its loss and new moments are held
    against JAX's, and both packages' new adapters against the AdamW
    update from JAX's previous adapters with their own new moments.
    Returns JAX's states before each step and after the last, and JAX's
    losses."""
    states, losses = [state], []
    for k, b in enumerate(batches, start=first_step):
        lora, opt = state
        jl, jo, jm = st["jstep"](st["jparams"], lora, opt,
                                 {n: jnp.asarray(v) for n, v in b.items()})
        tl, to, tm = st["engine"].train_step(
            st["params"], lora_from_numpy(_np_tree(lora), device="cpu"),
            opt_state_from_numpy(_np_tree(opt), device="cpu"),
            {n: torch.as_tensor(v) for n, v in b.items()})
        np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {k}")
        assert int(to.step) == int(jo.step)
        _close(to.m, jo.m, "m", k, rtol=M_RTOL, atol=M_ATOL)
        _close(to.v, jo.v, "v", k, rtol=V_RTOL, atol=V_ATOL)
        prev = _paths(_np_tree(lora))
        _adamw_holds([(p, t.numpy()) for p, t in _paths(tl)], prev,
                     [(p, t.numpy()) for p, t in _paths(to.m)],
                     [(p, t.numpy()) for p, t in _paths(to.v)],
                     int(to.step), "port", k)
        _adamw_holds(_paths(_np_tree(jl)), prev, _paths(_np_tree(jo.m)),
                     _paths(_np_tree(jo.v)), int(jo.step), "JAX", k)
        state = (jl, jo)
        states.append(state)
        losses.append(float(jm["ce_loss"]))
    return states, losses


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


@pytest.mark.parametrize("inject_nan_at,steps", [(-1, 15), (12, 25)],
                         ids=["plain", "nan_at_12"])
def test_train_from_weights_matches_jax(tmp_path, capsys, jax_weights,
                                        steppers, inject_nan_at, steps):
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
    # the run's trajectory one step at a time: without a fault, batch k
    # at step k; with one, steps 0-11, the faulted step's batch 12 spent,
    # then steps 10-24 from the step-10 state on batches 13-27
    batches = _batches(steps + 3 if inject_nan_at >= 0 else steps)
    if inject_nan_at < 0:
        _, losses = _walk(steppers, steppers["start"], batches, 0)
    else:
        states, losses = _walk(steppers, steppers["start"],
                               batches[:inject_nan_at], 0)
        _, more = _walk(steppers, states[10], batches[inject_nan_at + 1:],
                        10)
        losses += more
    # ... which is the JAX run's own
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)


def test_restart_matches_jax_and_resumes_from_its_checkpoint(
        tmp_path, capsys, jax_weights, steppers):
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
    # one step at a time: the step-10 state (the checkpoint both resume
    # from), then steps 10-14 on a restarted run's first five batches
    states, _ = _walk(steppers, steppers["start"], _batches(10), 0)
    _, losses = _walk(steppers, states[-1], _batches(5), 10)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)


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
