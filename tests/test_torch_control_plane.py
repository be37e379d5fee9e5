"""The port's copy of the framework-free control plane
(``repro_torch.core``: interfaces, latency_model, goodput, states,
dispatcher, coordinator, federated, launcher, cluster; the simulator and
``SimReplica`` of ``repro_torch.runtime``) on the CPU.

* Twins of ``tests/test_dispatcher.py``, ``test_states.py``,
  ``test_goodput.py``, ``test_latency_model.py``, ``test_multi_stream.py``
  and ``test_federated.py``, of ``test_multi_lora.py``'s control-plane
  tests and of ``test_preemption.py``'s pressure test, run against the
  port's modules.
* Differential tests: the same seeded inputs (hypothesis, through
  ``_hyp``) go through the JAX package's module and the port's copy and
  must give equal results (exactly: the copies run the same numpy code):
  latency fits, ``optimize``'s split, state transitions, the
  dispatcher's routing decisions and ``b_max`` budgets, the
  coordinator's plans, and a ``SimReplica``-driven cluster run of a few
  simulated seconds with fine-tuning on.  FedAvg over float32 trees is
  held against JAX's bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.cluster as j_cluster
import repro.core.coordinator as j_coord
import repro.core.dispatcher as j_disp
import repro.core.federated as j_fed
import repro.core.goodput as j_good
import repro.core.interfaces as j_if
import repro.core.latency_model as j_lat
import repro.core.states as j_states
import repro.runtime.metrics as j_metrics
import repro.runtime.replica as j_replica
import repro.runtime.simulator as j_sim
import repro_torch.core.cluster as t_cluster
import repro_torch.core.coordinator as t_coord
import repro_torch.core.dispatcher as t_disp
import repro_torch.core.federated as t_fed
import repro_torch.core.goodput as t_good
import repro_torch.core.interfaces as t_if
import repro_torch.core.latency_model as t_lat
import repro_torch.core.states as t_states
import repro_torch.runtime.metrics as t_metrics
import repro_torch.runtime.replica as t_replica
import repro_torch.runtime.simulator as t_sim
from repro_torch.core.cluster import ClusterConfig, ClusterController
from repro_torch.core.dispatcher import (
    DispatcherConfig, Subflow, SubflowDispatcher,
)
from repro_torch.core.federated import (
    EarlyStopper, FederatedSession, FLRoundResult, fedavg, quality_update,
)
from repro_torch.core.goodput import (
    EfficiencyParams, efficiency, goodput, optimize, throughput,
)
from repro_torch.core.interfaces import (
    BatchResult, ReplicaPressure, Request,
)
from repro_torch.core.latency_model import (
    BivariateLatencyModel, LinearLatencyModel,
)
from repro_torch.core.states import (
    ClusterStateManager, EWMAWindow, ReplicaState, StatePolicy,
)
from repro_torch.runtime.metrics import aggregate_serve_stats
from repro_torch.runtime.replica import SimReplica
from repro_torch.runtime.simulator import Simulator

JAX = dict(cluster=j_cluster, coord=j_coord, disp=j_disp, good=j_good,
           iface=j_if, lat=j_lat, states=j_states, replica=j_replica,
           sim=j_sim)
PORT = dict(cluster=t_cluster, coord=t_coord, disp=t_disp, good=t_good,
            iface=t_if, lat=t_lat, states=t_states, replica=t_replica,
            sim=t_sim)


# =====================================================================
# twins of tests/test_dispatcher.py
# =====================================================================
class FakeReplica:
    def __init__(self, rid):
        self.replica_id = rid
        self.model_id = "m"
        self.batches = []
        self.outstanding = 0
        self.quality = 1.0

    def submit_batch(self, reqs, now):
        self.batches.append((now, list(reqs)))

    def outstanding_batches(self, now):
        return self.outstanding

    def queue_length(self, now):
        return self.outstanding

    def quality_score(self, now):
        return self.quality


class FakeLiveReplica(FakeReplica):
    """Fake exporting the live-runtime placement surface."""

    def __init__(self, rid, free_blocks=8, pool_blocks=8,
                 affinity_tokens=0):
        super().__init__(rid)
        self.free_blocks = free_blocks
        self.pool_blocks = pool_blocks
        self.affinity_tokens = affinity_tokens
        self.pending_reqs = []
        self.reclaim_calls = []

    def pressure(self, now):
        return ReplicaPressure(
            queue_len=self.outstanding,
            pending=len(self.pending_reqs),
            active_slots=0, total_slots=4,
            free_blocks=self.free_blocks,
            pool_blocks=self.pool_blocks)

    def prefix_affinity(self, prompt, adapter_id=None):
        return self.affinity_tokens if prompt is not None else 0

    def reclaim_queued(self, max_n, now):
        self.reclaim_calls.append(max_n)
        out = self.pending_reqs[-max_n:]
        self.pending_reqs = self.pending_reqs[:-max_n]
        return out


def make_dispatcher(n=2, **cfg_kw):
    cfg = DispatcherConfig(**cfg_kw)
    replicas = {f"r{i}": FakeReplica(f"r{i}") for i in range(n)}
    promoted = []

    def promote(now):
        promoted.append(now)
        return None

    d = SubflowDispatcher("m", cfg, replicas,
                          state_of=lambda rid: ReplicaState.SERVING,
                          promote_idle=promote)
    return d, replicas, promoted


def _req(i, t=0.0, slo=0.5):
    return Request(request_id=i, stream_id="m", arrival=t, deadline=t + slo)


def test_fire_respects_batch_bound():
    d, replicas, _ = make_dispatcher(n=1)
    for i in range(100):
        d.submit(_req(i))
    sf = d._ensure_subflow("r0", 0.0)
    sf.batch_size = 4
    sf.b_max = 4
    d._fire_due_subflows(0.0)
    assert len(replicas["r0"].batches) == 1
    assert len(replicas["r0"].batches[0][1]) == 4


def test_backpressure_blocks_busy_replica():
    d, replicas, _ = make_dispatcher(n=1)
    replicas["r0"].outstanding = 5
    for i in range(10):
        d.submit(_req(i))
    d._fire_due_subflows(0.0)
    assert replicas["r0"].batches == []
    assert d.queue_depth() == 10


def test_feasibility_shedding():
    """Eq. 13c: requests that cannot meet their deadline are dropped."""
    d, replicas, _ = make_dispatcher(n=1)
    d._ensure_subflow("r0", 0.0)
    lm = d.latency_models["r0"]
    for b, lat in [(1, 0.12), (4, 0.18), (8, 0.26)]:
        lm.observe(b, lat)
    lm.fit()
    d.submit(_req(0, t=-0.45))     # deadline 0.05 < predicted latency
    d.submit(_req(1, t=0.0))
    sf = d.subflows["r0"]
    sf.batch_size = 4
    d._fire_due_subflows(0.0)
    assert d.dropped == 1
    assert len(replicas["r0"].batches[0][1]) == 1


def test_expired_requests_dropped():
    d, _, _ = make_dispatcher(n=1)
    d.submit(_req(0, t=0.0, slo=0.1))
    d._expire_requests(now=1.0)
    assert d.dropped == 1 and d.queue_depth() == 0


def test_micro_cycle_priority_allocation():
    """Eq. 18-19: higher quality + higher unsaturation gets more batch."""
    d, replicas, _ = make_dispatcher(n=2)
    a = d._ensure_subflow("r0", 0.0)
    b = d._ensure_subflow("r1", 0.0)
    a.b_max = b.b_max = 32
    a.batch_size = b.batch_size = 16
    replicas["r0"].quality = 4.0
    replicas["r1"].quality = 1.0
    a.history.append((16, 16))
    b.history.append((16, 16))
    d.micro_cycle(0.0)
    assert a.batch_size > b.batch_size


def test_micro_cycle_smoothing_bounds():
    d, replicas, _ = make_dispatcher(n=1)
    sf = d._ensure_subflow("r0", 0.0)
    sf.b_max = 64
    sf.batch_size = 4
    replicas["r0"].quality = 100.0
    d.micro_cycle(0.0)
    assert sf.batch_size <= int(1.5 * 4) + 1   # no abrupt jump


def test_overload_pressure_promotes():
    d, replicas, promoted = make_dispatcher(n=1)
    sf = d._ensure_subflow("r0", 0.0)
    sf.b_max = 4
    for i in range(50):
        d.submit(_req(i))
    d._overload_pressure(0.0)
    assert promoted, "deep backlog must trigger promotion"


def test_macro_cycle_sets_bmax_from_model():
    d, replicas, _ = make_dispatcher(n=1)
    d._ensure_subflow("r0", 0.0)
    lm = d.latency_models["r0"]
    for b in range(1, 12):
        lm.observe(b, 0.02 * b + 0.05)
    # completed batches feed T_queue
    d.on_batch_result(BatchResult(
        replica_id="r0", batch_size=4, infer_latency=0.13,
        total_latency=0.2, queue_latency=0.07, finished_at=1.0,
        quality=1.0, tokens=100))
    d.macro_cycle(1.0)
    sf = d.subflows["r0"]
    expected = int(((0.5 - 0.07) - 0.05) // 0.02)
    assert abs(sf.b_max - expected) <= 1


def test_macro_overload_reset_clears_stale_queue_samples():
    """Regression: the overload promotion resets T̄_queue to 0.1τ for the
    current cycle, but the pre-promotion latency samples used to stay in
    the deque — the NEXT macro cycle read the same stale overload and
    re-promoted immediately.  The reset must clear the window so
    T̄_queue is re-measured under the new capacity."""
    cfg = DispatcherConfig(slo=0.5)
    replicas = {"r0": FakeReplica("r0"), "r1": FakeReplica("r1")}
    d = SubflowDispatcher("m", cfg, replicas,
                          state_of=lambda rid: ReplicaState.SERVING,
                          promote_idle=lambda now: "r1")
    for _ in range(8):                      # way past the SLO
        d.on_batch_result(BatchResult(
            replica_id="r0", batch_size=4, infer_latency=0.2,
            total_latency=0.9, queue_latency=0.7, finished_at=1.0,
            quality=1.0, tokens=100))
    d.macro_cycle(0.0)
    assert d.overload_promotions == 1
    assert len(d.queue_lat) == 0            # stale window dropped
    assert d.avg_queue_latency() == pytest.approx(0.1 * cfg.slo)
    # next macro cycle: override expired, no fresh samples -> no
    # phantom re-promotion off the old window
    d.macro_cycle(cfg.t_fit)
    assert d.overload_promotions == 1


def test_in_flight_limit_is_at_most():
    """'At most in_flight_limit outstanding' (§2.3 double buffering):
    with the default limit of 1, one outstanding batch must already
    block the next fire — the old ``>`` stacked a third batch behind
    two."""
    d, replicas, _ = make_dispatcher(n=1)
    replicas["r0"].outstanding = 1
    for i in range(8):
        d.submit(_req(i))
    d._fire_due_subflows(0.0)
    assert replicas["r0"].batches == [], \
        "limit 1 with 1 outstanding must not fire"
    replicas["r0"].outstanding = 0
    sf = d.subflows["r0"]
    sf.next_fire = 0.0
    d._fire_due_subflows(0.1)
    assert len(replicas["r0"].batches) == 1


def _live_dispatcher(replicas):
    return SubflowDispatcher(
        "m", DispatcherConfig(), replicas,
        state_of=lambda rid: ReplicaState.SERVING,
        promote_idle=lambda now: None)


def test_placement_prefers_pool_headroom():
    """Due subflows drain the queue in headroom order: the replica with
    free pool blocks gets the head request; an exhausted pool ranks
    last (admission there would just backpressure)."""
    full = FakeLiveReplica("full", free_blocks=0, pool_blocks=8)
    free = FakeLiveReplica("free", free_blocks=8, pool_blocks=8)
    d = _live_dispatcher({"full": full, "free": free})
    for rid in ("full", "free"):
        sf = d._ensure_subflow(rid, 0.0)
        sf.batch_size = sf.b_max = 4
    d.submit(_req(0))
    d._fire_due_subflows(0.0)
    assert [len(b) for _, b in free.batches] == [1]
    assert full.batches == []


def test_placement_prefix_affinity_routing():
    """A request whose prompt matches a replica's prefix cache routes
    there even when FCFS order would have sent it elsewhere."""
    warm = FakeLiveReplica("warm", affinity_tokens=16)
    cold = FakeLiveReplica("cold", free_blocks=16, pool_blocks=16)
    d = _live_dispatcher({"cold": cold, "warm": warm})
    for rid in ("cold", "warm"):
        sf = d._ensure_subflow(rid, 0.0)
        sf.batch_size = sf.b_max = 1
    plain = _req(0)
    hot = _req(1)
    hot.prompt = [1, 2, 3]      # matches warm's cache (fake: any prompt)
    d.submit(plain)
    d.submit(hot)
    d._fire_due_subflows(0.0)
    # cold (more headroom) fires first but takes the PLAIN head request;
    # the prompt-matching one jumps to the warm replica
    assert [r.request_id for _, b in warm.batches for r in b] == [1]
    assert [r.request_id for _, b in cold.batches for r in b] == [0]
    assert d.affinity_routed == 1


def test_micro_cycle_rebalances_queued_requests():
    """A starved replica (empty admission queue, free slots) pulls
    excess queued work back to the stream queue for re-placement."""
    busy = FakeLiveReplica("busy")
    idle = FakeLiveReplica("idle")
    d = _live_dispatcher({"busy": busy, "idle": idle})
    for rid in ("busy", "idle"):
        sf = d._ensure_subflow(rid, 0.0)
        sf.batch_size = 2
        sf.history.append((2, 2))
    busy.pending_reqs = [_req(i) for i in range(6)]
    d.micro_cycle(0.0)
    assert d.rebalanced > 0
    assert d.queue_depth() == d.rebalanced
    assert len(busy.pending_reqs) == 6 - d.rebalanced


def test_requeue_preserves_order_at_front():
    d, _, _ = make_dispatcher(n=1)
    d.submit(_req(10))
    back = [_req(0), _req(1)]
    for r in back:
        r.dispatched = True
    d.requeue(back)
    assert [r.request_id for r in d.queue] == [0, 1, 10]
    assert all(not r.dispatched for r in back)


def test_unsaturation_ignores_empty_queue_fires():
    """Eq. 17: a fire against an EMPTY stream queue says nothing about
    replica capacity — recording (target, 0) would inflate u_i and
    skew micro-cycle priorities toward idle streams."""
    d, replicas, _ = make_dispatcher(n=1)
    sf = d._ensure_subflow("r0", 0.0)
    sf.batch_size = 4
    d._fire_due_subflows(0.0)          # no demand at all
    assert len(sf.history) == 0
    assert sf.unsaturation() == 0.0
    d.submit(_req(0, t=0.2))
    sf.next_fire = 0.0
    d._fire_due_subflows(0.2)          # real demand, partial fill
    assert list(sf.history) == [(4, 1)]
    assert sf.unsaturation() == pytest.approx(0.75)


# =====================================================================
# twins of tests/test_states.py
# =====================================================================
def test_ewma_recent_weighted():
    w = EWMAWindow(window=4, decay=1.0)
    for v in [0.0, 0.0, 0.0, 1.0]:
        w.observe(v)
    assert w.value > 0.5  # newest sample dominates with strong decay


def test_idle_transition_at_low_load():
    mgr = ClusterStateManager(StatePolicy(window=3))
    for i in range(4):
        mgr.register(f"r{i}")
    for _ in range(3):
        for i in range(4):
            mgr.observe(f"r{i}", 0.01 * (i + 1) * 0.1, 0.0)
    idled = mgr.evaluate_idle_transitions(now=10.0)
    assert idled, "low-utilization cluster should idle some replicas"
    assert len(mgr.replicas_in(ReplicaState.SERVING)) >= 1


def test_no_idle_at_high_load():
    mgr = ClusterStateManager(StatePolicy(window=3))
    for i in range(4):
        mgr.register(f"r{i}")
    for _ in range(3):
        for i in range(4):
            mgr.observe(f"r{i}", 0.9, 5.0)
    assert mgr.evaluate_idle_transitions(now=10.0) == []


def test_queue_backlog_blocks_idle():
    """Paper insight (a): low utilization alone is insufficient."""
    mgr = ClusterStateManager(StatePolicy(window=3))
    for i in range(4):
        mgr.register(f"r{i}")
    for _ in range(3):
        mgr.observe("r0", 0.01, 50.0)       # idle-looking but backlogged
        for i in range(1, 4):
            mgr.observe(f"r{i}", 0.5, 0.0)
    assert "r0" not in mgr.evaluate_idle_transitions(now=1.0)


def test_rollback_after_unselected_rounds():
    mgr = ClusterStateManager(StatePolicy(rollback_rounds=3))
    mgr.register("a", ReplicaState.IDLE)
    mgr.register("b", ReplicaState.IDLE)
    for k in range(3):
        reverted = mgr.tick_unselected(["b"], now=float(k))
    assert "a" in reverted
    assert mgr.state_of("a") is ReplicaState.SERVING
    assert mgr.state_of("b") is ReplicaState.IDLE


def test_promote_idle():
    mgr = ClusterStateManager()
    mgr.register("a", ReplicaState.IDLE)
    assert mgr.promote_idle(0.0) == "a"
    assert mgr.state_of("a") is ReplicaState.SERVING
    assert mgr.promote_idle(0.0) is None


@given(st.lists(st.tuples(st.floats(0, 1), st.floats(0, 20)),
                min_size=8, max_size=8),
       st.integers(2, 8))
@settings(max_examples=50, deadline=None)
def test_at_least_one_replica_serves(telemetry, n):
    """Whatever the telemetry, Eq. 1-4 must never idle the whole pool."""
    mgr = ClusterStateManager(StatePolicy(window=2))
    for i in range(n):
        mgr.register(f"r{i}")
    for _ in range(3):
        for i in range(n):
            u, q = telemetry[i % len(telemetry)]
            mgr.observe(f"r{i}", u, q)
        mgr.evaluate_idle_transitions(now=1.0)
    assert len(mgr.replicas_in(ReplicaState.SERVING)) >= 1


# =====================================================================
# twins of tests/test_goodput.py
# =====================================================================
def _models():
    tt = BivariateLatencyModel(alpha=0.03, beta=0.01, gamma=0.1)
    ti = BivariateLatencyModel(alpha=0.02, beta=0.008, gamma=0.05)
    for m in (tt, ti):
        m._samples.extend([(1, 1, 1.0)] * 3)  # mark as fitted
    return tt, ti


def test_efficiency_monotone_decreasing_in_batch():
    p = EfficiencyParams(noise_scale=10.0, loss_reduction=0.05)
    vals = [efficiency(b, p) for b in (1, 4, 16, 64)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert vals[0] <= (p.scale_a * 10 * 0.05 + p.init_batch) / \
        (p.scale_a * 10 * 0.05 + 1) + 1e-9


def test_higher_noise_scale_tolerates_larger_batches():
    lo = EfficiencyParams(noise_scale=1.0)
    hi = EfficiencyParams(noise_scale=100.0)
    assert efficiency(64, hi) > efficiency(64, lo)


def test_optimize_respects_slo():
    tt, ti = _models()
    p = EfficiencyParams(noise_scale=10.0, loss_reduction=0.05)
    B, b, g = optimize(tt, ti, p, latency_budget=0.45)
    assert b >= 1 and B >= 1 and g > 0
    assert ti.predict(b, B) <= 0.45 + 1e-9


def test_optimize_tightening_budget_shrinks_inference_batch():
    tt, ti = _models()
    p = EfficiencyParams(noise_scale=10.0, loss_reduction=0.05)
    _, b_loose, _ = optimize(tt, ti, p, latency_budget=0.45)
    _, b_tight, _ = optimize(tt, ti, p, latency_budget=0.15)
    assert b_tight < b_loose


@given(st.floats(0.1, 0.6), st.floats(0.5, 100.0), st.floats(0.001, 1.0))
@settings(max_examples=40, deadline=None)
def test_optimize_always_feasible(budget, noise, lred):
    tt, ti = _models()
    p = EfficiencyParams(noise_scale=noise, loss_reduction=lred)
    B, b, g = optimize(tt, ti, p, latency_budget=budget)
    assert B >= 1 and b >= 1
    assert g >= 0 or (B, b) == (1, 1)


# =====================================================================
# twins of tests/test_latency_model.py
# =====================================================================
def test_linear_recovers_coefficients():
    m = LinearLatencyModel()
    rng = np.random.default_rng(0)
    for _ in range(100):
        b = rng.integers(1, 64)
        m.observe(b, 0.02 * b + 0.05 + rng.normal(0, 1e-4))
    a, beta = m.fit()
    assert abs(a - 0.02) < 1e-3 and abs(beta - 0.05) < 5e-3
    assert m.r2 > 0.99


def test_max_batch_eq16():
    m = LinearLatencyModel(alpha=0.02, beta=0.05)
    m._samples.extend([(1, 0.07), (2, 0.09)])
    m.fit()
    # b_max = floor((0.45 - beta)/alpha)
    assert m.max_batch(0.45) == int((0.45 - m.beta) // m.alpha)


def test_bivariate_beats_univariate_under_interference():
    """Fig. 4b reproduction in miniature: univariate R² degrades when a
    co-running training batch varies; bivariate stays high."""
    rng = np.random.default_rng(1)
    uni = LinearLatencyModel()
    bi = BivariateLatencyModel()
    for _ in range(200):
        b = int(rng.integers(2, 8))
        B = int(rng.integers(0, 20))
        lat = 0.02 * b + 0.008 * B + 0.05 + rng.normal(0, 5e-4)
        uni.observe(b, lat)
        bi.observe(b, B, lat)
    uni.fit()
    bi.fit()
    assert bi.r2 > 0.97
    assert uni.r2 < bi.r2 - 0.1, (uni.r2, bi.r2)


def test_bivariate_max_x1_respects_budget():
    m = BivariateLatencyModel(alpha=0.02, beta=0.01, gamma=0.05)
    m._samples.extend([(1, 0, 0.07), (2, 0, 0.09), (3, 1, 0.12)])
    for B in range(0, 30, 5):
        b = m.max_x1(0.5, B)
        assert m.predict(b, B) <= 0.5 + 1e-9
        assert m.predict(b + 1, B) > 0.5 - 1e-9  # maximality (fp slack)


@given(st.lists(st.tuples(st.integers(1, 128),
                          st.floats(0.01, 10.0)), min_size=2, max_size=64))
@settings(max_examples=50, deadline=None)
def test_linear_fit_never_crashes(samples):
    m = LinearLatencyModel()
    for b, lat in samples:
        m.observe(b, lat)
    a, beta = m.fit()
    assert np.isfinite(a) and np.isfinite(beta)
    # R² may be epsilon-negative from the ridge term; must stay ≤ 1
    assert np.isfinite(m.r2) and m.r2 <= 1.0 + 1e-9


# =====================================================================
# twins of tests/test_multi_stream.py
# =====================================================================
def test_streams_route_to_matching_model_pools():
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    completions = {"m1": 0, "m2": 0}

    def on_result(res, sid):
        completions[sid.split("/")[0]] += res.batch_size
        cluster.on_batch_result(res, sid)

    for i in range(2):
        cluster.add_replica(SimReplica(f"a{i}", "m1", sim, on_result,
                                       seed=i))
        cluster.add_replica(SimReplica(f"b{i}", "m2", sim, on_result,
                                       seed=10 + i))

    rid = 0
    for t in range(50):
        now = t * 0.1
        for stream in ("m1", "m2"):
            cluster.submit_request(Request(rid, stream, now, now + 0.5))
            rid += 1
    sim.schedule_every(0.05, cluster.tick, until=8.0)
    sim.run(8.0)

    assert completions["m1"] > 0 and completions["m2"] > 0
    # stream isolation: each dispatcher only owns its model's replicas
    assert set(cluster.dispatchers["m1"].replicas) == {"a0", "a1"}
    assert set(cluster.dispatchers["m2"].replicas) == {"b0", "b1"}


def test_registry_add_after_dispatcher_exists_receives_traffic():
    """Regression: ``dispatcher_for`` used to hand each dispatcher a
    one-time dict snapshot of the registry, so a replica added AFTER the
    dispatcher existed never received traffic.  The replica view is live
    now: add-then-submit must route to the newcomer."""
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    cluster.add_replica(SimReplica("a0", "m1", sim,
                                   cluster.on_batch_result, seed=0))
    d = cluster.dispatcher_for("m1")          # dispatcher exists first
    assert set(d.replicas) == {"a0"}
    late = SimReplica("a1", "m1", sim, cluster.on_batch_result, seed=1)
    cluster.add_replica(late)
    assert set(d.replicas) == {"a0", "a1"}    # live view, no snapshot
    for i in range(40):
        cluster.submit_request(Request(i, "m1", 0.0, 10.0))
    sim.schedule_every(0.05, cluster.tick, until=5.0)
    sim.run(5.0)
    assert late.served_requests > 0, \
        "late-added replica never received traffic (stale registry)"
    assert "a1" in d.subflows


def test_registry_remove_then_tick_stops_routing():
    """Removed replicas must leave every dispatcher structure — the old
    code only popped subflows/latency_models, so ``d.replicas`` kept a
    dead handle and kept routing to it."""
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    reps = [SimReplica(f"a{i}", "m1", sim, cluster.on_batch_result,
                       seed=i) for i in range(2)]
    for r in reps:
        cluster.add_replica(r)
    d = cluster.dispatcher_for("m1")
    cluster.tick(0.0)                          # subflows exist for both
    cluster.remove_replica("a0", 0.1)
    assert set(d.replicas) == {"a1"}
    assert "a0" not in d.subflows and "a0" not in d.latency_models
    served_before = reps[0].served_requests
    for i in range(20):
        cluster.submit_request(Request(i, "m1", 0.2, 10.0))
    sim.schedule_every(0.05, cluster.tick, until=4.0)
    sim.run(4.0)
    assert reps[0].served_requests == served_before
    assert reps[1].served_requests > 0


def test_idle_pools_are_per_model():
    """FL cohorts must not mix models (§4.2: 'same model')."""
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    for i in range(3):
        cluster.add_replica(SimReplica(f"a{i}", "m1", sim,
                                       lambda r, s: None, seed=i))
    for i in range(2):
        cluster.add_replica(SimReplica(f"b{i}", "m2", sim,
                                       lambda r, s: None, seed=i))
    for rid in list(cluster.replicas):
        cluster.states.transition(rid, ReplicaState.IDLE, 0.0)
    cluster.launcher.maybe_launch(1.0)
    models = {a.session.model_id: sorted(a.session.members)
              for a in cluster.launcher.sessions.values()}
    assert models == {"m1": ["a0", "a1", "a2"]}  # m2 below min_cohort=3


# =====================================================================
# twins of tests/test_federated.py
# =====================================================================
def _tree(val):
    return {"q": {"a": torch.full((2, 3), val), "b": torch.full((3,), val)}}


def test_fedavg_is_mean():
    out = fedavg([_tree(1.0), _tree(3.0)])
    assert float(out["q"]["a"][0, 0]) == 2.0


def test_fedavg_weighted():
    out = fedavg([_tree(0.0), _tree(4.0)], weights=[3.0, 1.0])
    assert float(out["q"]["b"][0]) == 1.0


@given(st.lists(st.floats(-10, 10), min_size=2, max_size=6))
@settings(max_examples=50, deadline=None)
def test_fedavg_bounded_by_extremes(vals):
    out = fedavg([_tree(v) for v in vals])
    x = float(out["q"]["a"][0, 0])
    assert min(vals) - 1e-6 <= x <= max(vals) + 1e-6


def test_quality_update_grows_with_improvement():
    q1 = quality_update(1.0, loss_prev=2.0, loss_now=1.5)
    assert q1 > 1.0
    q2 = quality_update(q1, loss_prev=1.5, loss_now=1.5)
    assert q2 == pytest.approx(q1)


def test_quality_update_literal_eq6():
    # the paper's literal rule contracts Q; we keep it available
    assert quality_update(1.0, 2.0, 1.5, literal_eq6=True) == \
        pytest.approx(0.25)


def test_early_stopper_patience():
    s = EarlyStopper(patience=2, min_delta=1e-3)
    assert not s.update(1.0)
    assert not s.update(0.9)       # improving
    assert not s.update(0.9)       # plateau 1
    assert s.update(0.9)           # plateau 2 -> stop


def test_session_round_flow():
    sess = FederatedSession("m", ["a", "b", "c"], server="a",
                            global_adapter=_tree(0.0))
    res = [FLRoundResult(r, _tree(v), local_loss=l, samples=10)
           for r, v, l in [("a", 1.0, 2.0), ("b", 2.0, 2.2),
                           ("c", 3.0, 1.8)]]
    g = sess.aggregate(res)
    assert float(g["q"]["a"][0, 0]) == pytest.approx(2.0)
    assert sess.round == 1
    # no early stop on first round (losses establish baselines)
    assert sess.early_stops(res) == []
    # plateau everyone for two rounds -> all stop, session dies
    for _ in range(2):
        stopped = sess.early_stops(res)
    assert not sess.alive


# =========================================================================
# twins of tests/test_multi_lora.py's control-plane tests and of
# tests/test_preemption.py's pressure test
# =========================================================================
def test_aggregate_serve_stats_adapter_rollup():
    class S:
        def __init__(self, reqs, vers):
            self.admitted = self.finished = sum(reqs.values())
            self.prefill_tokens = self.cached_prefix_tokens = 0
            self.generated_tokens = self.decode_steps = 0
            self.train_steps = 0
            self.wall_time = 1.0
            self.adapter_version = max(vers.values(), default=0)
            self.train_loss = float("nan")
            self.adapter_requests = reqs
            self.adapter_versions = vers

        def throughput(self):
            return 0.0

    out = aggregate_serve_stats({
        "r0": S({"tenant0": 3, "tenant1": 1}, {"tenant0": 2, "tenant1": 0}),
        "r1": S({"tenant0": 2}, {"tenant0": 5}),
    })
    a = out["cluster"]["adapters"]
    assert a["tenant0"] == {"requests": 5, "version_min": 2,
                            "version_max": 5}
    assert a["tenant1"] == {"requests": 1, "version_min": 0,
                            "version_max": 0}
    assert out["replicas"]["r1"]["adapter_requests"] == {"tenant0": 2}


def test_dispatcher_adapter_affinity_routing():
    """A queued request whose adapter is device-resident on the firing
    replica jumps the FCFS scan window (prefix hits still outrank it)."""
    d, reps, _ = make_dispatcher(1)
    for i in range(4):
        d.submit(Request(request_id=i, stream_id="s", arrival=0.0,
                         deadline=100.0, tokens=4,
                         adapter_id="tenantB" if i == 3 else "tenantA"))
    p = ReplicaPressure(queue_len=0, pending=0, active_slots=0,
                        total_slots=4,
                        resident_adapters=("tenantB",))
    batch = d._select_batch("r0", 2, 0.0, 0.0, pressure=p)
    assert [r.request_id for r in batch] == [3, 0]
    assert d.adapter_routed == 1 and d.affinity_routed == 0


def test_pressure_discounts_preempted_replicas():
    calm = ReplicaPressure(queue_len=0, active_slots=2, total_slots=4,
                           free_blocks=8, pool_blocks=16,
                           oversubscribe=0.9)
    thrash = dataclasses.replace(calm, preempted=2)
    assert thrash.headroom() < calm.headroom()
    assert thrash.headroom() == pytest.approx(calm.headroom() / 3)


# =========================================================================
# differential: the JAX package's module and the port's copy on the same
# seeded inputs
# =========================================================================
def _eq(a, b):
    """Exact equality, NaN equal to NaN (the copies run the same numpy
    code in the same order)."""
    np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                  np.asarray(b, dtype=object))


@given(st.lists(st.tuples(st.integers(1, 64), st.integers(0, 32),
                          st.floats(0.01, 2.0)), min_size=2, max_size=48),
       st.floats(0.05, 1.5), st.integers(0, 32))
@settings(max_examples=40, deadline=None)
def test_latency_fits_match_reference(samples, budget, x2):
    out = []
    for pkg in (JAX, PORT):
        lin = pkg["lat"].LinearLatencyModel()
        biv = pkg["lat"].BivariateLatencyModel()
        for b, big_b, lat in samples:
            lin.observe(b, lat)
            biv.observe(b, big_b, lat)
        out.append((lin.fit(), lin.r2, lin.predict(7), lin.max_batch(budget),
                    biv.fit(), biv.r2, biv.predict(5, x2),
                    biv.max_x1(budget, x2)))
    _eq(out[0], out[1])


@given(st.floats(0.1, 0.6), st.floats(0.5, 100.0), st.floats(0.001, 1.0),
       st.lists(st.tuples(st.integers(1, 32), st.integers(0, 32),
                          st.floats(0.02, 0.8)), min_size=3, max_size=24))
@settings(max_examples=15, deadline=None)
def test_optimize_split_matches_reference(budget, noise, lred, samples):
    out = []
    for pkg in (JAX, PORT):
        tt = pkg["lat"].BivariateLatencyModel()
        ti = pkg["lat"].BivariateLatencyModel()
        for b, big_b, lat in samples:
            tt.observe(big_b + 1, b, lat * 1.5)
            ti.observe(b, big_b, lat)
        tt.fit()
        ti.fit()
        p = pkg["good"].EfficiencyParams(noise_scale=noise,
                                         loss_reduction=lred)
        out.append((pkg["good"].optimize(tt, ti, p, latency_budget=budget),
                    pkg["good"].efficiency(8, p),
                    pkg["good"].throughput(8, 4, tt),
                    pkg["good"].goodput(8, 4, tt, p)))
    _eq(out[0], out[1])


@given(st.lists(st.tuples(st.floats(0, 1), st.floats(0, 20)),
                min_size=8, max_size=8),
       st.integers(2, 8), st.lists(st.integers(0, 3), min_size=6,
                                   max_size=6))
@settings(max_examples=40, deadline=None)
def test_state_transitions_match_reference(telemetry, n, ops):
    logs = []
    for pkg in (JAX, PORT):
        S = pkg["states"]
        mgr = S.ClusterStateManager(S.StatePolicy(window=2,
                                                  rollback_rounds=2))
        for i in range(n):
            mgr.register(f"r{i}")
        log = []
        for k, op in enumerate(ops):
            for i in range(n):
                u, q = telemetry[(i + k) % len(telemetry)]
                mgr.observe(f"r{i}", u, q)
            now = float(k)
            if op == 0:
                log.append(mgr.evaluate_idle_transitions(now))
            elif op == 1:
                idle = mgr.replicas_in(S.ReplicaState.IDLE)
                log.append(mgr.tick_unselected(idle[:1], now))
            elif op == 2:
                log.append(mgr.promote_idle(now))
            else:
                log.append(mgr.transition(
                    f"r{k % n}", S.ReplicaState.COMBINED, now))
            log.append([mgr.state_of(f"r{i}").value for i in range(n)])
        logs.append(log)
    assert logs[0] == logs[1]


def _fake_live(iface, rid, free, pool, affinity, resident, queued):
    class Fake:
        replica_id = rid
        model_id = "m"

        def __init__(self):
            self.batches = []
            self.pending_reqs = []

        def submit_batch(self, reqs, now):
            self.batches.append([r.request_id for r in reqs])

        def outstanding_batches(self, now):
            return len(self.batches) % 2

        def queue_length(self, now):
            return queued

        def quality_score(self, now):
            return 1.0 + free / 8.0

        def pressure(self, now):
            return iface.ReplicaPressure(
                queue_len=queued, pending=len(self.pending_reqs),
                active_slots=queued % 4, total_slots=4, free_blocks=free,
                pool_blocks=pool, resident_adapters=resident,
                admit_capacity=2 + free % 3)

        def prefix_affinity(self, prompt, adapter_id=None):
            if prompt is None:
                return 0
            return affinity if int(prompt[0]) % 3 == int(rid[1]) else 0

        def reclaim_queued(self, max_n, now):
            out = self.pending_reqs[-max_n:]
            self.pending_reqs = self.pending_reqs[:-max_n]
            return out

    return Fake()


@given(st.lists(st.tuples(st.floats(0.0, 1.0), st.floats(0.05, 2.0),
                          st.integers(0, 8), st.integers(0, 3)),
                min_size=4, max_size=24),
       st.lists(st.tuples(st.integers(0, 16), st.integers(0, 32)),
                min_size=3, max_size=3),
       st.lists(st.tuples(st.integers(1, 8), st.floats(0.02, 0.6),
                          st.floats(0.0, 0.3)), min_size=0, max_size=12))
@settings(max_examples=30, deadline=None)
def test_dispatcher_routing_matches_reference(reqs, pools, results):
    """Fires, micro and macro cycles of one stream dispatcher over three
    fake live replicas: the batches each replica is handed, the counters,
    and every subflow's ``b_max`` and batch size."""
    logs = []
    for pkg in (JAX, PORT):
        iface = pkg["iface"]
        reps = {}
        for i, (free, queued) in enumerate(pools):
            reps[f"r{i}"] = _fake_live(
                iface, f"r{i}", free=free, pool=16, affinity=4 * i + 4,
                resident=("t1",) if i == 1 else (), queued=queued % 5)
        d = pkg["disp"].SubflowDispatcher(
            "m", pkg["disp"].DispatcherConfig(), reps,
            state_of=lambda rid, S=pkg["states"]: S.ReplicaState.SERVING,
            promote_idle=lambda now: None)
        for k, (t, slo, p0, a) in enumerate(reqs):
            d.submit(iface.Request(
                request_id=k, stream_id="m", arrival=t, deadline=t + slo,
                prompt=np.asarray([p0, 1, 2], np.int32) if p0 % 2 else None,
                adapter_id=f"t{a}" if a else None))
        for k, (b, lat, q) in enumerate(results):
            d.on_batch_result(iface.BatchResult(
                replica_id=f"r{k % 3}", batch_size=b, infer_latency=lat,
                total_latency=lat + q, queue_latency=q,
                finished_at=0.1 * k, quality=1.0, tokens=4 * b))
        log = []
        for step in range(8):
            now = 0.07 * step
            d.on_tick(now)
            if step == 3:
                d.micro_cycle(now)
            if step == 5:
                d.macro_cycle(now)
            log.append({rid: list(r.batches) for rid, r in reps.items()})
            log.append({rid: (sf.b_max, sf.batch_size)
                        for rid, sf in sorted(d.subflows.items())})
        log.append((d.dropped, d.affinity_routed, d.adapter_routed,
                    d.rebalanced, d.overload_promotions, d.queue_depth()))
        logs.append(log)
    assert logs[0] == logs[1]


@given(st.lists(st.tuples(st.integers(1, 16), st.integers(0, 16),
                          st.floats(0.02, 0.5)), min_size=3, max_size=16),
       st.floats(0.1, 0.8))
@settings(max_examples=30, deadline=None)
def test_coordinator_plans_match_reference(samples, budget):
    plans = []
    for pkg in (JAX, PORT):
        iface = pkg["iface"]
        c = pkg["coord"].InferenceTrainingCoordinator(
            "s", ["r0", "r1"], slo=0.5)
        for k, (b, big_b, lat) in enumerate(samples):
            rid = f"r{k % 2}"
            c.observe_infer(iface.BatchResult(
                replica_id=rid, batch_size=b, infer_latency=lat,
                total_latency=lat, queue_latency=0.0, finished_at=0.0,
                quality=1.0, tokens=b, train_batch=big_b))
            c.observe_train(iface.TrainRoundStats(
                replica_id=rid, steps=4, train_batch=big_b + 1,
                infer_batch=b, avg_step_time=lat * 2,
                loss_before=3.0 - 0.1 * k, loss_after=2.9 - 0.1 * k,
                noise_scale=4.0 + k, samples=4 * (big_b + 1)))
        out = c.replan(budget)
        plans.append(({r: dataclasses.asdict(p) for r, p in out.items()},
                      c.steps_per_round))
    assert plans[0] == plans[1]


def _sim_cluster(pkg, seed, n_reps, finetune):
    sim = pkg["sim"].Simulator()
    ccfg = pkg["cluster"].ClusterConfig(enable_finetuning=finetune)
    ccfg.launcher.min_cohort = 2
    ccfg.launcher.decision_interval = 0.5
    ccfg.launcher.coordinator.bootstrap_steps = 3
    ccfg.launcher.coordinator.steps_per_round = 3
    cluster = pkg["cluster"].ClusterController(ccfg)
    for i in range(n_reps):
        cluster.add_replica(pkg["replica"].SimReplica(
            f"r{i}", "m", sim, cluster.on_batch_result, seed=seed + i))
    return sim, cluster


@given(st.integers(0, 1000), st.integers(2, 4), st.booleans(),
       st.floats(2.0, 30.0))
@settings(max_examples=8, deadline=None)
def test_sim_cluster_run_matches_reference(seed, n_reps, finetune, rate):
    """A ``SimReplica``-driven cluster, a few simulated seconds of Poisson
    arrivals (idle replicas join FL rounds when fine-tuning is on): every
    request's completion time and quality, the dispatcher's counters, the
    replica states and the launcher's round history agree."""
    logs = []
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=64))
    arrivals = arrivals[arrivals < 4.0]
    for pkg in (JAX, PORT):
        sim, cluster = _sim_cluster(pkg, seed, n_reps, finetune)
        if finetune:
            for rid in list(cluster.replicas)[1:]:
                cluster.states.transition(
                    rid, pkg["states"].ReplicaState.IDLE, 0.0)
        reqs = []
        for k, t in enumerate(arrivals):
            r = pkg["iface"].Request(k, "m", float(t), float(t) + 0.5,
                                     tokens=16)
            reqs.append(r)
            sim.schedule(float(t), lambda now, r=r:
                         cluster.submit_request(r))
        sim.schedule_every(0.05, cluster.tick, until=5.0)
        sim.run(5.0)
        d = cluster.dispatchers["m"]
        launcher = cluster.launcher
        logs.append((
            [(r.completed_at, r.quality, r.dispatched) for r in reqs],
            (d.dispatched, d.dropped, d.rebalanced, d.overload_promotions),
            sorted((rid, cluster.states.state_of(rid).value)
                   for rid in cluster.replicas),
            launcher.completed_rounds,
            [dict(h) for h in launcher.round_history],
            dict(launcher.adapter_versions)))
    assert logs[0] == logs[1]
    assert any(c is not None for c, _, _ in logs[1][0])


@given(st.lists(st.floats(-10, 10), min_size=2, max_size=5),
       st.lists(st.floats(0.5, 64.0), min_size=5, max_size=5),
       st.integers(0, 2 ** 16))
@settings(max_examples=30, deadline=None)
def test_fedavg_bitwise_matches_reference(offsets, weights, seed):
    """Float32 adapters (as ``init_lora`` makes them) times the float64
    weights: JAX casts each weight to float32 before the product, and so
    does PyTorch's scalar multiply; the averages agree bit for bit."""
    rng = np.random.default_rng(seed)
    trees = [{"q": {"a": (rng.standard_normal((4, 8)) + o)
                    .astype(np.float32),
                    "b": rng.standard_normal((8, 4)).astype(np.float32)}}
             for o in offsets]
    w = weights[:len(trees)]
    for ws in (w, None):
        j = j_fed.fedavg([jax.tree.map(jnp.asarray, t) for t in trees], ws)
        p = t_fed.fedavg([{"q": {k: torch.from_numpy(v)
                                 for k, v in t["q"].items()}}
                          for t in trees], ws)
        for k in ("a", "b"):
            assert p["q"][k].dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(j["q"][k]),
                                          p["q"][k].numpy())


@given(st.lists(st.tuples(st.integers(0, 9), st.integers(0, 9),
                          st.integers(0, 50), st.floats(0.0, 5.0),
                          st.floats(0.0, 1.0)), min_size=1, max_size=4))
@settings(max_examples=30, deadline=None)
def test_aggregate_serve_stats_matches_reference(rows):
    from repro.runtime.serving_loop import ServeStats as JaxStats
    from repro_torch.runtime.serving_loop import ServeStats
    stats = {}
    for i, (fin, ver, gen, wall, ttft) in enumerate(rows):
        stats[f"r{i}"] = ServeStats(
            admitted=fin, finished=fin, generated_tokens=gen,
            decode_steps=gen // 2, wall_time=wall, adapter_version=ver,
            nan_publishes_blocked=ver % 2, preemptions=fin % 3,
            ttft=[ttft] * fin, tpot=[ttft / 4] * fin,
            adapter_requests={"t0": fin}, adapter_versions={"t0": ver})
    jstats = {rid: JaxStats(**{f.name: getattr(s, f.name)
                               for f in dataclasses.fields(s)})
              for rid, s in stats.items()}
    assert set(f.name for f in dataclasses.fields(ServeStats)) \
        == set(f.name for f in dataclasses.fields(JaxStats))
    assert t_metrics.aggregate_serve_stats(stats) \
        == j_metrics.aggregate_serve_stats(jstats)
