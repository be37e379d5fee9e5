"""The port's evaluation harness (``repro_torch.data.traces``,
``runtime.baselines``, ``runtime.experiment``, over the port's simulator
and ``SimReplica``):

* twins of ``tests/test_experiment.py``, ``tests/test_simulator.py`` and
  ``tests/test_traces.py`` on the port's modules;
* differential tests against the JAX package's modules: the traces give
  equal ``Request`` fields at two seeds and two scales, and
  ``run_experiment`` gives every simulated output of the reference's
  exactly, for each of the five policies, and for CoLLM with a replica
  failure and with a straggler.  The outputs left out are wall-clock
  (``control_wall_s``, ``overhead_frac``) or objects (``_metrics``,
  ``_replicas``).
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.data import traces as jax_traces
from repro.runtime.experiment import (
    ExperimentConfig as JaxExperimentConfig, run_experiment as jax_run,
)
from repro_torch.core.interfaces import Request
from repro_torch.data.traces import (
    TraceConfig, code_trace, conv_trace, generate, merged_trace, stats,
)
from repro_torch.runtime.experiment import (
    POLICIES, ExperimentConfig, run_experiment,
)
from repro_torch.runtime.replica import (
    InterferenceSurface, LossCurve, SimReplica,
)
from repro_torch.runtime.simulator import Simulator

WALL_CLOCK = ("control_wall_s", "overhead_frac", "_metrics", "_replicas")


# --------------------------------------------- twins of test_experiment --
@pytest.fixture(scope="module")
def short_runs():
    out = {}
    for policy in ["collm", "dlora", "shepherd", "peft", "rr"]:
        cfg = ExperimentConfig(policy=policy, n_replicas=6,
                               duration=420.0, scale=1.0, seed=3)
        out[policy] = run_experiment(cfg)
    return out


def test_all_policies_complete_requests(short_runs):
    for policy, out in short_runs.items():
        assert out["requests"] > 0
        assert out["completed"] > 0, policy
        assert out["slo_rate"] > 0.3, (policy, out["slo_rate"])


def test_collm_finetunes_at_low_load(short_runs):
    out = short_runs["collm"]
    assert out["fl_rounds"] > 0, "idle troughs must trigger FL rounds"
    assert out["mean_loss"] < 2.4, "fine-tuning must reduce loss"


def test_collm_quality_beats_static_baselines(short_runs):
    q_collm = short_runs["collm"]["mean_quality"]
    for p in ["dlora", "shepherd", "peft", "rr"]:
        assert q_collm > short_runs[p]["mean_quality"], p


def test_collm_utilization_higher(short_runs):
    u_collm = short_runs["collm"]["mean_util"]
    assert u_collm > short_runs["peft"]["mean_util"]


def test_overhead_small(short_runs):
    assert short_runs["collm"]["overhead_frac"] < 0.05


def test_determinism():
    cfg = ExperimentConfig(policy="collm", n_replicas=4, duration=200.0,
                           seed=7)
    a = run_experiment(cfg)
    b = run_experiment(cfg)
    assert a["slo_met"] == b["slo_met"]
    assert a["goodput_tok_s"] == pytest.approx(b["goodput_tok_s"])


def test_replica_failure_tolerated():
    cfg = ExperimentConfig(policy="collm", n_replicas=6, duration=300.0,
                           seed=1, failures=[(2, 100.0, 200.0)])
    out = run_experiment(cfg)
    assert out["slo_rate"] > 0.3
    assert out["completed"] > 0


def test_straggler_mitigated():
    base = ExperimentConfig(policy="collm", n_replicas=6, duration=300.0,
                            seed=2)
    slow = ExperimentConfig(policy="collm", n_replicas=6, duration=300.0,
                            seed=2, stragglers={0: 3.0})
    out_base = run_experiment(base)
    out_slow = run_experiment(slow)
    # a 3x straggler on 1/6 replicas must not collapse goodput
    assert out_slow["goodput_tok_s"] > 0.6 * out_base["goodput_tok_s"]


# ---------------------------------------------- twins of test_simulator --
def test_event_ordering_deterministic():
    sim = Simulator()
    log = []
    sim.schedule(2.0, lambda t: log.append(("b", t)))
    sim.schedule(1.0, lambda t: log.append(("a", t)))
    sim.schedule(1.0, lambda t: log.append(("a2", t)))  # FIFO at same time
    sim.run(10.0)
    assert [x[0] for x in log] == ["a", "a2", "b"]
    assert sim.now == 10.0


def test_schedule_every_respects_until():
    sim = Simulator()
    hits = []
    sim.schedule_every(1.0, hits.append, until=3.5)
    sim.run(10.0)
    assert hits == [0.0, 1.0, 2.0, 3.0]


def _mk_replica(sim, results):
    return SimReplica("r0", "m", sim,
                      lambda res, sid: results.append(res),
                      InterferenceSurface(noise_frac=0.0), seed=1)


def test_replica_serializes_batches():
    """Eq. 13d: one batch at a time; later batch waits."""
    sim = Simulator()
    results = []
    r = _mk_replica(sim, results)
    reqs1 = [Request(i, "m", 0.0, 1.0) for i in range(4)]
    reqs2 = [Request(i + 4, "m", 0.0, 1.0) for i in range(4)]
    r.submit_batch(reqs1, 0.0)
    r.submit_batch(reqs2, 0.0)
    sim.run(5.0)
    assert len(results) == 2
    lat = 0.02 * 4 + 0.05
    assert results[0].finished_at == pytest.approx(lat, rel=1e-6)
    assert results[1].finished_at == pytest.approx(2 * lat, rel=1e-6)
    assert results[1].queue_latency == pytest.approx(lat, rel=1e-6)


def test_interference_slows_inference():
    sim = Simulator()
    results = []
    r = _mk_replica(sim, results)
    r.train_round(train_batch=16, infer_batch=4, steps=100, now=0.0)
    r.submit_batch([Request(0, "m", 0.0, 1.0)], 0.0)
    sim.run(5.0)
    base = 0.02 * 1 + 0.05
    assert results[0].infer_latency == pytest.approx(
        base + 0.008 * 16, rel=1e-6)
    assert results[0].train_batch == 16


def test_utilization_window():
    sim = Simulator()
    results = []
    r = _mk_replica(sim, results)
    for k in range(20):
        sim.schedule(k * 0.5, lambda t, rr=r: rr.submit_batch(
            [Request(int(t * 10), "m", t, t + 1.0)], t))
    sim.run(10.0)
    u = r.utilization(10.0)
    # each 1-request batch takes 0.07s every 0.5s => ~14% busy
    assert 0.05 < u < 0.30


def test_failure_drops_requests():
    sim = Simulator()
    results = []
    r = _mk_replica(sim, results)
    r.fail(0.0)
    r.submit_batch([Request(0, "m", 0.0, 1.0)], 0.0)
    sim.run(1.0)
    assert results == []
    r.recover(1.0)
    r.submit_batch([Request(1, "m", 1.0, 2.0)], 1.0)
    sim.run(3.0)
    assert len(results) == 1


def test_loss_curve_monotone():
    c = LossCurve()
    l0 = c.loss()
    c.advance(5000)
    assert c.loss() < l0
    assert c.loss() >= c.floor


def test_loss_curve_fractional_progress_monotone():
    """``seen`` accumulates fractional ``samples * eff`` (statistical
    efficiency < 1), so it is a float — and loss must stay monotone
    non-increasing in samples under batch-size scaling."""
    c = LossCurve()
    assert isinstance(c.seen, float)
    prev = c.loss()
    for _ in range(50):
        before, after = c.advance(2, batch_size=64)
        assert before == pytest.approx(prev)
        assert after <= before
        prev = after
    # large batches well past the noise scale => eff << 1: progress is
    # fractional, not floor-to-int
    assert 0.0 < c.seen < 50 * 2
    assert c.seen != int(c.seen)


# ------------------------------------------------- twins of test_traces --
def test_deterministic_under_seed():
    a = generate(TraceConfig(duration=600, seed=5))
    b = generate(TraceConfig(duration=600, seed=5))
    assert len(a) == len(b)
    assert all(x.arrival == y.arrival for x, y in zip(a, b))


def test_diurnal_trough_and_peak():
    cfg = TraceConfig(duration=1800, peak_rate=40, seed=1)
    reqs = generate(cfg)
    s = stats(reqs, bucket=30.0)
    assert s["peak_rate"] > 10 * max(s["trough_over_peak"] *
                                     s["peak_rate"], 0.01)
    assert s["requests"] > 1000


def test_bursty_subsecond_cv():
    s = stats(conv_trace(1800, seed=2), bucket=10.0)
    assert s["per_second_cv"] > 1.0  # paper: large CV at fine granularity


def test_merged_trace_sorted_and_unique_ids():
    reqs = merged_trace(600, scale=1.0, seed=0)
    arr = [r.arrival for r in reqs]
    assert arr == sorted(arr)
    ids = [r.request_id for r in reqs]
    assert len(ids) == len(set(ids))


def test_deadlines_respect_slo():
    reqs = generate(TraceConfig(duration=300, slo=0.5, seed=3))
    assert all(abs((r.deadline - r.arrival) - 0.5) < 1e-9 for r in reqs)


# ------------------------------------------- against the JAX package ----
def _fields(reqs):
    return [dataclasses.asdict(r) for r in reqs]


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("scale", [1.0, 2.5])
@pytest.mark.parametrize("kind", ["code_trace", "conv_trace",
                                  "merged_trace"])
def test_traces_match_the_reference(kind, scale, seed):
    port = {"code_trace": code_trace, "conv_trace": conv_trace,
            "merged_trace": merged_trace}[kind](600.0, seed=seed,
                                                scale=scale)
    ref = getattr(jax_traces, kind)(600.0, seed=seed, scale=scale)
    assert len(port) > 0
    assert _fields(port) == _fields(ref)
    assert stats(port) == jax_traces.stats(ref)


def _same(a, b):
    """Exact equality, NaN equal to NaN (an empty stream's percentile)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


CASES = [(p, {}) for p in POLICIES] + [
    ("collm", {"failures": [(1, 30.0, 80.0)]}),
    ("collm", {"stragglers": {0: 3.0}}),
]


@pytest.mark.parametrize("policy,faults", CASES,
                         ids=[p + ("-" + "-".join(f) if f else "")
                              for p, f in CASES])
def test_run_experiment_matches_the_reference(policy, faults):
    kw = dict(policy=policy, n_replicas=4, duration=120.0, seed=5, **faults)
    port = run_experiment(ExperimentConfig(**kw))
    ref = jax_run(JaxExperimentConfig(**kw))
    assert port.keys() == ref.keys()
    keys = sorted(k for k in port if k not in WALL_CLOCK)
    assert port["completed"] > 0
    bad = [k for k in keys if not _same(port[k], ref[k])]
    assert not bad, {k: (port[k], ref[k]) for k in bad}
    if policy == "collm":
        assert {"fl_rounds", "final_states", "mean_loss"} <= set(keys)
    assert np.isfinite(port["overhead_frac"])
