"""The port's fault tolerance (``repro_torch.runtime.fault``:
``FaultInjector``, ``FailureDetector``, ``StragglerWatch``,
``HealthMonitor``, ``RetryPolicy``; ``runtime/elastic.py``'s
``ElasticServingPool``) on the CPU.  Twins of ``tests/test_fault.py``:
heartbeat detection, elastic pool membership and stragglers over
``SimReplica`` pools, and the chaos-hardened live fabric (injected crash,
stall and NaN faults, health-driven failover, retry budgets, publish
gates) on the JAX ``build_fabric``'s weights carried across by
``convert.py`` (``_torch_fabric.py``), whose greedy tokens, failover
included, equal ``conftest.reference_greedy`` on the JAX model.  Beside
them, the twin of ``tests/test_sanitize.py::
test_terminal_request_retried_detected`` through the port's
``RetryPolicy``, and the fabric's own ``run`` loop with a crash and a
NaN round injected, and a differential test of the fault module against
the JAX package's on the same seeded inputs."""
import time

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from _torch_fabric import reference, torch_fabric
from conftest import sample_prompts
from repro_torch.core.cluster import ClusterConfig, ClusterController
from repro_torch.core.interfaces import BatchResult, Request
from repro_torch.runtime.elastic import ElasticServingPool
from repro_torch.runtime.fabric import FabricConfig
from repro_torch.runtime.fault import (
    FailureDetector, FaultEvent, FaultInjector, HealthConfig,
    HealthMonitor, InjectedFault, RetryPolicy, StragglerWatch,
)
from repro_torch.runtime.replica import InterferenceSurface, SimReplica
from repro_torch.runtime.simulator import Simulator
from repro_torch.tree import tree_leaves, tree_map

PROMPT_PAD, MAX_GEN, SLOTS = 10, 6, 2


def _cluster(n=4):
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    results = []
    for i in range(n):
        r = SimReplica(f"r{i}", "m", sim,
                       lambda res, sid: results.append(res), seed=i)
        cluster.add_replica(r)
    return sim, cluster, results


# =========================================================================
# Heartbeat detection (load-bearing heartbeats, no liveness back-channel)
# =========================================================================
def test_failure_detector_removes_dead_replica():
    """Detection keys off actual heartbeat() calls: the replica that
    stops beating accrues misses and is removed; peers that keep
    beating stay."""
    sim, cluster, _ = _cluster()
    det = FailureDetector(cluster, timeout=1.0, max_misses=2)
    healthy = [rid for rid in cluster.replicas if rid != "r1"]
    for now in (0.0, 0.5):
        for rid in healthy:
            det.heartbeat(rid, now)
        det.heartbeat("r1", now)
    # r1 goes silent after 0.5; the others keep beating
    for rid in healthy:
        det.heartbeat(rid, 2.0)
    assert det.poll(2.0) == []             # 1.5 s gap -> first miss only
    assert "r1" in cluster.replicas
    for rid in healthy:
        det.heartbeat(rid, 3.5)
    assert det.poll(3.5) == ["r1"]         # second miss -> dead
    assert "r1" not in cluster.replicas
    assert det.removed == ["r1"]
    assert sorted(cluster.replicas) == sorted(healthy)


def test_failure_detector_first_sight_grace():
    """A replica first seen at poll time gets a grace window — joining
    the pool must not count as a missed beat."""
    sim, cluster, _ = _cluster(2)
    det = FailureDetector(cluster, timeout=1.0, max_misses=1)
    assert det.poll(5.0) == []             # registration, not a miss
    assert det.poll(5.5) == []             # still inside the window
    assert sorted(det.poll(7.0)) == ["r0", "r1"]    # now truly silent


def test_elastic_join_leave():
    sim, cluster, results = _cluster(2)
    pool = ElasticServingPool(cluster)
    cluster.dispatcher_for("m")
    newr = SimReplica("r9", "m", sim, lambda res, sid: None, seed=9)
    pool.join(newr, now=1.0)
    assert "r9" in cluster.replicas
    assert "r9" in cluster.dispatchers["m"].replicas
    pool.leave("r9", now=2.0)
    assert "r9" not in cluster.replicas
    assert "r9" not in cluster.dispatchers["m"].replicas


def test_elastic_pool_live_view_routes_to_joiner():
    """Pin the behavior ElasticServingPool depends on: dispatcher
    replica sets are LIVE views over the cluster registry, so a joiner
    becomes routable on the next tick without re-wiring."""
    sim, cluster, _ = _cluster(1)
    pool = ElasticServingPool(cluster)
    d = cluster.dispatcher_for("m")
    assert list(d._active_replicas(0.0)) == ["r0"]
    newr = SimReplica("r9", "m", sim, lambda res, sid: None, seed=9)
    pool.join(newr, now=1.0)
    assert sorted(d._active_replicas(1.0)) == ["r0", "r9"]
    assert pool.joined == 1


# =========================================================================
# Straggler detection
# =========================================================================
def test_straggler_watch_flags_outlier():
    w = StragglerWatch(threshold=2.0, window=16)
    for _ in range(10):
        for rid, lat in [("a", 1.0), ("b", 1.1), ("c", 0.9), ("d", 5.0)]:
            w.observe(rid, lat)
    assert w.stragglers() == ["d"]


def test_straggler_watch_identical_medians_flag_nothing():
    """threshold x identical-median must be vacuous: an all-equal (or
    all-zero) cluster has no stragglers."""
    for lat in (1.0, 0.0):
        w = StragglerWatch(threshold=2.0)
        for _ in range(10):
            for rid in ("a", "b", "c"):
                w.observe(rid, lat)
        assert w.stragglers() == []


def test_straggler_watch_two_replicas_and_window():
    """Peer-relative medians work at pool size 2, and the sample
    window is a bounded deque (old samples age out)."""
    w = StragglerWatch(threshold=2.0, window=8, min_samples=4)
    for _ in range(8):
        w.observe("a", 0.01)
        w.observe("b", 0.08)
    assert w.stragglers() == ["b"]
    assert len(w.samples["a"]) == 8          # window bound held
    # b recovers: fresh fast samples displace the stall window
    for _ in range(8):
        w.observe("b", 0.01)
    assert w.stragglers() == []
    w.reset("a")
    assert "a" not in w.samples


def test_straggler_watch_warmup_drops_compile_spikes():
    """The first ``warmup`` observations per replica are dropped: the
    replica that pays the one-time jit compile must not be quarantined
    as a straggler for it."""
    w = StragglerWatch(threshold=2.0, min_samples=2, warmup=3)
    for _ in range(3):
        w.observe("a", 9.0)          # compile spikes — dropped
    for _ in range(5):
        w.observe("a", 0.01)
        w.observe("b", 0.01)
    assert w.stragglers() == []
    assert max(w.samples["a"]) == pytest.approx(0.01)


# =========================================================================
# Retry policy (budget, backoff, poison verdict, untouched SLO clock)
# =========================================================================
def _req(i=0):
    return Request(request_id=i, stream_id="m", arrival=0.0,
                   deadline=10.0, tokens=4)


def test_retry_policy_backoff_and_budget_exhaustion():
    p = RetryPolicy(max_retries=2, max_failures=5,
                    backoff_base=0.1, backoff_factor=2.0)
    r = _req()
    assert p.on_requeue(r, 1.0, replica_died=False)
    assert r.retries == 1 and r.not_before == pytest.approx(1.1)
    assert r.deadline == 10.0               # SLO clock never extended
    assert p.on_requeue(r, 2.0, replica_died=False)
    assert r.not_before == pytest.approx(2.2)    # exponential backoff
    assert not p.on_requeue(r, 3.0, replica_died=False)
    assert r.terminal and r.status == "failed"
    assert r.failed_reason == "retries_exhausted"
    assert p.retried == 2 and p.rejected == [r]


def test_retry_policy_poison_request():
    """A request whose accepting replica dies max_failures times is
    terminally rejected, not requeued forever."""
    p = RetryPolicy(max_retries=100, max_failures=2)
    r = _req()
    assert p.on_requeue(r, 0.0, replica_died=True)
    assert not p.on_requeue(r, 1.0, replica_died=True)
    assert r.status == "failed" and r.failed_reason == "poison"
    # quarantine drains (replica survived) never count as failures
    p2 = RetryPolicy(max_retries=100, max_failures=2)
    r2 = _req()
    for t in range(5):
        assert p2.on_requeue(r2, float(t), replica_died=False)
    assert r2.failures == 0 and r2.status == "pending"


def test_dispatcher_honors_backoff_gate():
    """A requeued request with a not_before gate is skipped (kept in
    place) until the clock passes the gate."""
    sim, cluster, _ = _cluster(1)
    d = cluster.dispatcher_for("m")
    gated, ready = _req(0), _req(1)
    gated.not_before = 5.0
    d.submit(gated)
    d.submit(ready)
    batch = d._select_batch("r0", 2, now=1.0, pred=0.0)
    assert batch == [ready]
    assert list(d.queue) == [gated]          # kept its place, not shed
    batch = d._select_batch("r0", 2, now=6.0, pred=0.0)
    assert batch == [gated]


# =========================================================================
# Health monitor (pump-driven)
# =========================================================================
def test_health_monitor_missed_beats_and_pump_failure():
    hm = HealthMonitor(HealthConfig(beat_timeout=0.5, max_misses=2,
                                    poll_interval=0.1))
    hm.beat("r0", 0.0)
    hm.beat("r1", 0.0)
    assert hm.poll(0.2) == ([], [])
    hm.beat("r0", 1.0)                       # r1 silent since 0.0
    dead, _ = hm.poll(1.0)
    assert dead == []                        # first miss
    hm.beat("r0", 2.0)
    dead, _ = hm.poll(2.0)
    assert dead == ["r1"]                    # second miss -> dead
    # pump exceptions surface immediately, bypassing the poll cadence
    hm.failure("r0", 2.01, reason="InjectedFault")
    dead, _ = hm.poll(2.02)
    assert dead == ["r0"]


# =========================================================================
# Chaos-hardened live fabric
# =========================================================================
def _drive_fabric(fab, reqs, max_iters=4000):
    """Drive the fabric's OWN tick (containment + health verdicts)
    until every request is terminal."""
    for r in reqs:
        fab.submit(r)
    t0 = time.perf_counter()
    for _ in range(max_iters):
        now = time.perf_counter() - t0
        busy = fab.tick(now)
        if not busy and all(r.terminal for r in reqs):
            return now
        if not busy:
            time.sleep(0.002)
    raise AssertionError(
        f"fabric did not drain: "
        f"{sum(not r.terminal for r in reqs)} non-terminal")


def _fabric_requests(cfg, lens, gens, n_adapters=0):
    prompts = sample_prompts(cfg, len(lens), lens)
    reqs = [Request(request_id=i, stream_id=cfg.name, arrival=0.0,
                    deadline=1e9, tokens=gens[i], prompt=prompts[i],
                    adapter_id=f"tenant{i % n_adapters}"
                    if n_adapters else None)
            for i in range(len(lens))]
    return reqs, prompts


def test_injected_crash_failover_with_tenant_reregistration():
    """An injected mid-wave crash is contained by the fabric tick,
    detected by the health monitor, and failed over: 100% completion,
    greedy tokens bit-identical to the per-tenant reference, and a
    tenant registered ONLY on the dead replica is re-registered on the
    survivor."""
    # crash early enough that the trace is still live even on a fully
    # warm jit cache (the whole smoke trace drains in ~0.1-0.2s warm)
    inj = FaultInjector([FaultEvent(at=0.05, replica_id="r1",
                                    kind="crash")])
    fab, cfg = torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN, paged=True, block_size=4,
                            n_adapters=2, injector=inj)
    # a tenant resident ONLY on the doomed replica: failover must carry
    # it to the survivor or its requests become unservable
    r1 = fab.replicas["r1"]
    solo_tree = r1.adapters.host_tree("tenant1")
    r1.adapters.register("tenant9", solo_tree, version=7)
    assert not fab.replicas["r0"].adapters.is_registered("tenant9")

    lens = [6, 8, 5, 7, 6, 9, 4, 8]
    gens = [5, 4, 5, 3, 4, 5, 6, 3]
    reqs, prompts = _fabric_requests(cfg, lens, gens, n_adapters=2)
    _drive_fabric(fab, reqs)

    assert "r1" not in fab.replicas and "r0" in fab.replicas
    assert fab.failovers == 1
    assert any(kind == "crash" for _, rid, kind in inj.injected)
    assert all(r.completed_at is not None for r in reqs)
    assert all(len(r.output_tokens) == gens[i]
               for i, r in enumerate(reqs))
    # greedy streams bit-identical to the per-tenant oracle despite the
    # crash + requeue (survivors regenerate from the prompt)
    rep = fab.replicas["r0"]
    for i, r in enumerate(reqs):
        ref = reference(prompts[i], gens[i], n_adapters=2,
                        tenant=int(r.adapter_id[len("tenant"):]))
        assert r.output_tokens == ref, f"req {i} diverged after crash"
    # multi-tenant failover: the solo tenant moved, version intact
    assert rep.adapters.is_registered("tenant9")
    assert rep.adapters.version("tenant9") == 7


def _warm_tick_s(lens, gens):
    """Median serving tick of an unfaulted 2-replica fabric on the same
    trace, as the straggler watch samples it (past its warm-up)."""
    fab, cfg = torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN, paged=True, block_size=4)
    reqs, _ = _fabric_requests(cfg, lens, gens)
    _drive_fabric(fab, reqs)
    return float(np.median([s for v in fab.health.watch.samples.values()
                            for s in v]))


def test_straggler_quarantine_requeues_and_recovers():
    """An injected stall flags the replica as a straggler: its pending
    work drains back to the stream queue (front, order preserved), its
    subflows are suspended for the cooldown, and the pool still
    completes every request."""
    lens = [6, 8, 5, 7, 6, 9, 4, 8, 5, 7, 6, 8, 5, 7]
    gens = [5, 4, 5, 3, 4, 5, 6, 3, 4, 4, 5, 6, 4, 5]
    # the reference stalls a fixed 0.05 s a pump, several times its
    # jitted ticks, and drops 4 compile-time samples a replica; the
    # port's eager CPU ticks take 0.1-0.3 s on a loaded machine, where
    # 0.05 s no longer doubles one: the stall is 3 x the measured warm
    # tick instead.  The port compiles nothing, so 2 samples are dropped:
    # the stalled replica is routed about 8 busy ticks of this trace in
    # all, and 4 + 4 would leave the verdict on its last one
    stall_s = max(0.05, 3.0 * _warm_tick_s(lens, gens))
    inj = FaultInjector([FaultEvent(at=0.0, replica_id="r1",
                                    kind="stall", duration=60.0,
                                    stall_s=stall_s)])
    cfg_f = FabricConfig(straggler_threshold=2.0, straggler_window=8,
                         straggler_min_samples=4,
                         straggler_warmup=2,
                         quarantine_cooldown=30.0,     # stays benched
                         health_poll_interval=0.05)
    fab, cfg = torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN, paged=True, block_size=4,
                            cfg=cfg_f, injector=inj)
    reqs, prompts = _fabric_requests(cfg, lens, gens)
    _drive_fabric(fab, reqs)

    assert fab.quarantines >= 1
    assert any(a == "quarantine" and rid == "r1"
               for _, rid, a in fab.fault_log)
    d = fab.cluster.dispatchers[cfg.name]
    assert d.suspended.get("r1", 0.0) > 0.0
    # the straggler is still a pool MEMBER (quarantine, not kill)
    assert "r1" in fab.replicas
    assert all(r.completed_at is not None for r in reqs)
    # requeued requests kept their original SLO clock
    assert all(r.deadline == 1e9 for r in reqs)
    for i, r in enumerate(reqs):
        assert r.output_tokens == reference(prompts[i], gens[i]), \
            f"req {i} diverged"


def test_retry_budget_exhaustion_terminal_status():
    """With a zero retry budget, requests drained from a crashed
    replica are terminally rejected — the run loop settles instead of
    spinning, and survivors' requests still complete.  The crash fires
    on r1's FIRST pump, while its share of the initial dispatch wave is
    still queued on it — later crash times race the (warm-jit) trace
    drain and can strand nothing."""
    inj = FaultInjector([FaultEvent(at=0.0, replica_id="r1",
                                    kind="crash")])
    fab, cfg = torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN, paged=True, block_size=4,
                            cfg=FabricConfig(max_retries=0),
                            injector=inj)
    lens = [6, 8, 5, 7, 6, 9, 4, 8]
    gens = [5, 4, 5, 3, 4, 5, 6, 3]
    reqs, _ = _fabric_requests(cfg, lens, gens)
    _drive_fabric(fab, reqs)

    assert all(r.terminal for r in reqs)
    failed = [r for r in reqs if r.status == "failed"]
    done = [r for r in reqs if r.completed_at is not None]
    # the crash stranded SOME requests; with no retry budget they went
    # terminal instead of completing elsewhere
    assert failed and done
    assert len(failed) + len(done) == len(reqs)
    assert all(r.failed_reason == "retries_exhausted" for r in failed)
    assert len(fab.retry_policy.rejected) == len(failed)


def test_nan_shadow_publish_rejected_bit_identical():
    """A NaN-poisoned shadow is rejected at the round boundary: the
    round aborts, the served adapter stays bit-for-bit at its last
    published version, and the rejection is counted."""
    fab, cfg = torch_fabric(1, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN)
    rep = fab.replicas["r0"]
    before = tree_map(torch.clone, rep.lora)
    v0 = rep.adapter_version

    rep.begin_round(train_batch=2, infer_batch=0, steps=2, now=0.0)
    while rep._session is not None and not rep._session.done:
        rep.pump_once(0.0)
    rep._poison_shadow()
    assert rep.batcher.train_lora is not None
    stats = rep.finish_round(1.0)            # gate fires here
    assert rep.batcher.train_lora is None    # round aborted
    assert rep.publish_adapter() == v0       # no version bump
    assert rep.batcher.stats.nan_publishes_blocked == 1
    for a, b in zip(tree_leaves(before), tree_leaves(rep.lora)):
        assert torch.equal(a, b)             # served tree untouched
    # a non-finite loss never reaches the coordinator's fit inputs
    assert stats.loss_after == stats.loss_after \
        or np.isnan(stats.loss_after)

    # set_adapter guards the FedAvg seam the same way
    poisoned = tree_map(lambda x: torch.full_like(x, float("nan")),
                        rep.lora)
    rep.set_adapter(poisoned, version=99)
    assert rep.adapter_version == v0
    assert rep.batcher.stats.nan_publishes_blocked == 2


def test_remove_replica_mid_session():
    """Losing a COMBINED replica must not wedge the FL session."""
    from repro_torch.core.states import ReplicaState
    sim, cluster, _ = _cluster(4)
    for rid in cluster.replicas:
        cluster.states.transition(rid, ReplicaState.IDLE, 0.0)
    cluster.launcher.maybe_launch(0.0)
    assert cluster.launcher.sessions
    some = next(iter(cluster.launcher.sessions.values()))
    victim = some.session.members[0]
    cluster.remove_replica(victim, 1.0)
    assert victim not in cluster.replicas
    for a in cluster.launcher.sessions.values():
        assert victim not in a.session.members


# =========================================================================
# twin of tests/test_sanitize.py::test_terminal_request_retried_detected
# =========================================================================
def test_terminal_request_retried_detected(monkeypatch):
    """A served Request handed back to RetryPolicy.on_requeue is a
    control-plane lifecycle bug (the SLO clock must never restart): under
    REPRO_SANITIZE=1 the port's RetryPolicy arms the request FSM."""
    from repro_torch.runtime import sanitize
    from repro_torch.runtime.sanitize import SanitizeError
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize.enabled()
    pol = RetryPolicy()
    req = Request(request_id=0, stream_id="s", arrival=0.0, deadline=9.0)
    req.completed_at = 1.0                    # terminal: already served
    with pytest.raises(SanitizeError, match="terminal-retried"):
        pol.on_requeue(req, now=2.0, replica_died=True)


# =========================================================================
# the fabric's own run loop under a chaos schedule
# =========================================================================
def test_fabric_run_with_crash_and_nan_round():
    """``ServingFabric.run`` with fine-tuning on over three replicas, r2
    crashing on its first pump and r0's first train tick poisoned: the
    crash fails over exactly once (the round goes on without r2), the
    NaN shadow is refused at the publish gate so the served adapters stay
    finite, the round still aggregates, and every request completes."""
    inj = FaultInjector([
        FaultEvent(at=0.0, replica_id="r0", kind="nan_grads"),
        FaultEvent(at=0.0, replica_id="r2", kind="crash")])
    fab, cfg = torch_fabric(
        3, n_slots=SLOTS, prompt_len=PROMPT_PAD, gen_tokens=MAX_GEN,
        paged=True, block_size=4, injector=inj,
        cfg=FabricConfig(enable_finetuning=True, bootstrap_steps=3,
                         steps_per_round=3, decision_interval=0.05))
    lens = [6, 8, 5, 7, 6, 9]
    gens = [5, 4, 5, 3, 4, 5]
    reqs, prompts = _fabric_requests(cfg, lens, gens)
    out = fab.run(reqs, min_rounds=1, timeout=120.0)
    ft = out["fault_tolerance"]
    assert [k for _, _, k in inj.injected].count("nan_grads") == 1
    assert ft["failovers"] == 1 and ft["quarantines"] == 0
    assert sorted(fab.replicas) == ["r0", "r1"]
    assert out["fl_rounds"] >= 1
    assert ft["nan_publishes_blocked"] >= 1
    assert fab.replicas["r0"].batcher.stats.nan_publishes_blocked >= 1
    for rep in fab.replicas.values():
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(rep.lora))
    assert out["incomplete_requests"] == 0 and out["failed_requests"] == 0
    assert all(len(r.output_tokens) == gens[i]
               for i, r in enumerate(reqs))


# =========================================================================
# differential: the JAX package's fault module and the port's copy
# =========================================================================
@given(st.integers(0, 2 ** 16), st.integers(2, 5), st.integers(0, 2),
       st.integers(0, 2), st.integers(0, 2), st.integers(0, 2),
       st.lists(st.tuples(st.integers(0, 4), st.floats(0.0, 0.2)),
                min_size=8, max_size=60))
@settings(max_examples=30, deadline=None)
def test_fault_module_matches_reference(seed, n, crashes, stalls, ooms,
                                        nans, beats):
    """The seeded chaos schedule, and a health monitor fed the same beats,
    latencies, pump failures and polls, give the same events and the same
    verdicts in both packages; so does a retry policy's budget."""
    import repro.runtime.fault as j_fault
    import repro_torch.runtime.fault as t_fault
    from repro.core.interfaces import Request as JaxRequest
    ids = [f"r{i}" for i in range(n)]
    logs = []
    for mod, req_cls in ((j_fault, JaxRequest), (t_fault, Request)):
        plan = mod.FaultInjector.random_plan(
            ids, seed=seed, horizon=3.0, n_crashes=crashes,
            n_stalls=stalls, n_ooms=ooms, n_nan_rounds=nans)
        hm = mod.HealthMonitor(mod.HealthConfig(
            beat_timeout=0.3, max_misses=2, poll_interval=0.05,
            straggler_min_samples=3, straggler_warmup=1))
        pol = mod.RetryPolicy(max_retries=2, max_failures=2)
        reqs = [req_cls(request_id=i, stream_id="m", arrival=0.0,
                        deadline=5.0) for i in range(3)]
        log = [[(e.at, e.replica_id, e.kind, e.duration) for e in plan]]
        for k, (i, lat) in enumerate(beats):
            now = 0.1 * k
            rid = ids[i % n]
            if lat > 0.19:
                hm.failure(rid, now, reason="InjectedFault")
            else:
                hm.beat(rid, now, busy_s=lat * (1 + 9 * (i == 1)))
            log.append(hm.poll(now))
            r = reqs[k % 3]
            if not r.terminal:
                log.append((pol.on_requeue(r, now, replica_died=i % 2 == 0),
                            r.retries, r.failures, r.not_before, r.status,
                            r.failed_reason))
        log.append((sorted(hm.failures), pol.retried, len(pol.rejected)))
        logs.append(log)
    assert logs[0] == logs[1]
