"""The port's live co-execution on the CPU: incremental COMBINED train
sessions with shadow-adapter publishing over the multi-replica fabric
(``repro_torch.runtime.replica.LiveReplica``/``TrainSession``, the
launcher's rounds, FedAvg at the round boundary).  Twins of
``tests/test_combined_fabric.py`` on the JAX ``build_fabric``'s weights
carried across by ``convert.py`` (``_torch_fabric.py``): shadow isolation
(greedy serving equal to ``conftest.reference_greedy`` on the JAX model
for the whole round, publish swapping atomically at the boundary), the
non-blocking launcher rounds polled over live replicas, the §8.2
load-surge suspension, measured noise-scale and busy-fraction telemetry,
and the ServeStats quality-progression fields.  Beside them: a published
adapter mirrored into a tenant's registry slot is a copy, never an alias
of the tree the optimizer trains next."""
import time

import numpy as np
import pytest
import torch

from _torch_fabric import reference, torch_fabric, torch_weights
from conftest import sample_prompts
from repro_torch.core.interfaces import Request
from repro_torch.core.states import ReplicaState
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.runtime.fabric import FabricConfig
from repro_torch.runtime.metrics import aggregate_serve_stats
from repro_torch.runtime.replica import LiveReplica, SimReplica
from repro_torch.runtime.serving_loop import ServeStats
from repro_torch.tree import tree_leaves, tree_map

PROMPT_PAD, MAX_GEN, SLOTS = 8, 4, 2


@pytest.fixture(scope="module")
def setup():
    engine, params, lora, _ = torch_weights()
    return engine.model.cfg, engine, engine.model, params, lora


def _replica(cfg, engine, params, lora, results, seed=0):
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=16, seed=seed)
    return LiveReplica(
        "r0", "m", engine, params, lora,
        engine.optimizer.init(lora),
        on_result=lambda res, sid: results.append(res),
        data_fn=lambda b: data.batch(b),
        serve_slots=SLOTS, serve_prompt_len=PROMPT_PAD,
        max_gen_tokens=MAX_GEN)


def _moved(a, b):
    return any(not torch.allclose(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ======================================================= shadow isolation ==
def test_shadow_isolation_bit_identical_within_round(setup):
    """A whole incremental round of optimizer steps must not move a
    single served token: decode reads the published snapshot while the
    shadow trains, and only publish_adapter swaps them."""
    cfg, engine, model, params, lora = setup
    results = []
    rep = _replica(cfg, engine, params, lora, results)
    prompts = sample_prompts(cfg, 3, [6, 7, 5])
    refs = [reference(p, MAX_GEN) for p in prompts]
    reqs = [Request(request_id=i, stream_id="s", arrival=0.0,
                    deadline=1e9, tokens=MAX_GEN, prompt=prompts[i])
            for i in range(3)]
    rep.submit_batch(reqs, now=0.0)
    rep.begin_round(4, 3, 6, now=0.0)
    for _ in range(200):
        rep.pump_once(now=0.0)
        if rep.round_progress(0.0) >= 1.0:
            break
    assert rep.round_progress(0.0) == 1.0
    stats = rep.finish_round(0.0)
    assert stats.steps == 6
    assert rep.batcher.stats.train_steps == 6
    # shadow diverged from the published tree while serving ran
    assert rep.batcher.train_lora is not None
    assert _moved(rep.lora, rep.batcher.train_lora), \
        "the session must have trained the shadow"
    # drain the remaining serving work BEFORE publishing
    for _ in range(200):
        if not rep.pump_once(now=1.0):
            break
    assert [r.output_tokens for r in reqs] == refs, \
        "shadow training perturbed in-flight greedy serving"
    v = rep.publish_adapter()
    assert v == 1 and rep.batcher.stats.adapter_version == 1
    assert rep.batcher.train_lora is None
    assert _moved(lora, rep.lora), "publish must swap the trained shadow in"
    # publishing again without a shadow is a no-op
    assert rep.publish_adapter() == 1


def test_measured_noise_scale_and_busy_frac(setup):
    """finish_round reports the McCandlish estimate off the fused
    step's microbatch gradients (not a hardcoded 8.0), and utilization
    comes from real per-tick busy-time accounting."""
    cfg, engine, model, params, lora = setup
    rep = _replica(cfg, engine, params, lora, [])
    stats = rep.train_round(train_batch=4, infer_batch=0, steps=3,
                            now=0.0)
    assert rep._noise_ema.initialized
    assert stats.noise_scale == pytest.approx(rep._noise_ema.value)
    assert 0.0 <= stats.noise_scale <= 1e4
    u = rep.utilization(0.0)
    assert 0.0 < u <= 1.0
    assert u != 0.9 or len(rep._busy_log) > 0   # measured, not stamped
    # an odd train batch cannot split into microbatches: the EMA from
    # the measured round carries over instead of resetting to a prior
    stats2 = rep.train_round(train_batch=3, infer_batch=0, steps=2,
                             now=0.0)
    assert stats2.noise_scale == pytest.approx(rep._noise_ema.value)


def test_abort_round_discards_shadow_keeps_published(setup):
    """§8.2 replica-level contract: aborting mid-round drops the shadow
    and the served adapter stays at the last published version."""
    cfg, engine, model, params, lora = setup
    rep = _replica(cfg, engine, params, lora, [])
    rep.begin_round(4, 0, 8, now=0.0)
    for _ in range(3):
        rep.pump_once(now=0.0)
    assert 0.0 < rep.round_progress(0.0) < 1.0
    assert rep.batcher.train_lora is not None
    rep.abort_round(0.0)
    assert rep._session is None
    assert rep.batcher.train_lora is None
    assert rep.adapter_version == 0
    assert rep.round_progress(0.0) == 1.0
    _assert_equal(lora, rep.lora)


def test_zero_step_round_is_born_complete(setup):
    """A degenerate 0-step plan must not wedge the fabric: progress
    reports 1.0 immediately and the coordinator guard drops the
    0-step stats instead of poisoning the latency fit."""
    from repro_torch.core.coordinator import InferenceTrainingCoordinator
    cfg, engine, model, params, lora = setup
    rep = _replica(cfg, engine, params, lora, [])
    rep.begin_round(4, 0, 0, now=0.0)
    assert rep.round_progress(0.0) == 1.0
    stats = rep.finish_round(0.0)
    assert stats.steps == 0
    coord = InferenceTrainingCoordinator("s", ["r0"], slo=0.5)
    coord.observe_train(stats)
    assert not coord.t_train["r0"].fitted


def test_set_adapter_mid_session_aborts(setup):
    """A new global landing mid-session aborts the round: without the
    abort, the remaining ticks would train the SERVED tree and break
    within-round snapshot isolation."""
    cfg, engine, model, params, lora = setup
    rep = _replica(cfg, engine, params, lora, [])
    rep.begin_round(4, 0, 8, now=0.0)
    rep.pump_once(now=0.0)
    assert rep._session is not None
    fresh = model.init_lora(torch.Generator().manual_seed(7))
    rep.set_adapter(fresh, 5)
    assert rep._session is None
    assert rep.batcher.train_lora is None
    assert rep.adapter_version == 5
    # further ticks serve only — no training of the snapshot
    rep.pump_once(now=0.0)
    _assert_equal(fresh, rep.lora)


# ===================================================== fabric co-execution =
def test_combined_fabric_trains_while_serving():
    """The headline path: N=2 live replicas serve a trace while the
    launcher drives incremental rounds through the fabric tick; rounds
    aggregate without blocking, the merged adapter reaches every
    member, and quality telemetry lands in the cluster summary."""
    fab, cfg = torch_fabric(
        2, n_slots=SLOTS, prompt_len=PROMPT_PAD, gen_tokens=MAX_GEN,
        cfg=FabricConfig(enable_finetuning=True, bootstrap_steps=2,
                         steps_per_round=2, decision_interval=0.05))
    prompts = sample_prompts(cfg, 6, [6, 7, 5, 8, 6, 7])
    reqs = [Request(request_id=i, stream_id=cfg.name, arrival=0.0,
                    deadline=1e9, tokens=3, prompt=prompts[i])
            for i in range(6)]
    out = fab.run(reqs, min_rounds=2, timeout=120.0)
    assert out["fl_rounds"] >= 2
    assert all(r.completed_at is not None for r in reqs)
    assert out["incomplete_requests"] == 0
    # every member took real fused/plain steps and serves the merged
    # global: versions coherent across the pool
    c = out["cluster"]
    assert c["train_steps"] >= 2 * 2 * 2   # 2 members x 2 rounds x 2
    assert c["adapter_version_max"] >= 2
    assert c["adapter_version_min"] == c["adapter_version_max"]
    assert c["train_loss"] is not None
    # round history records the quality progression
    assert len(out["rounds"]) == out["fl_rounds"]
    assert all(r["version"] >= 1 for r in out["rounds"])
    for rid, row in out["replicas"].items():
        assert row["adapter_version"] == c["adapter_version_max"]
        assert row["train_loss"] is not None


def test_suspend_mid_round_frees_members_and_keeps_published():
    """§8.2 load-surge path over LIVE replicas: suspend_for_model while
    a round is in flight returns COMBINED members to SERVING, discards
    their shadow state, and the served adapter stays at the last
    PUBLISHED version — then the trace still completes."""
    fab, cfg = torch_fabric(
        2, n_slots=SLOTS, prompt_len=PROMPT_PAD, gen_tokens=MAX_GEN,
        cfg=FabricConfig(enable_finetuning=True, bootstrap_steps=50,
                         steps_per_round=50, decision_interval=0.05))
    launcher = fab.cluster.launcher
    t0 = time.perf_counter()
    # tick until a session opens and every member is mid-round
    for _ in range(500):
        now = time.perf_counter() - t0
        fab.tick(now)
        if launcher.sessions and all(
                0.0 < rep.round_progress(now) < 1.0
                for rep in fab.replicas.values()):
            break
        time.sleep(0.002)
    assert launcher.sessions, "no live session opened"
    active = next(iter(launcher.sessions.values()))
    members = list(active.session.members)
    assert members and all(
        fab.cluster.states.state_of(rid) is ReplicaState.COMBINED
        for rid in members)
    versions = {rid: fab.replicas[rid].adapter_version
                for rid in members}
    published = {rid: fab.replicas[rid].get_adapter()
                 for rid in members}
    now = time.perf_counter() - t0
    n = launcher.suspend_for_model(cfg.name, now)
    assert n == 1 and not launcher.sessions
    for rid in members:
        rep = fab.replicas[rid]
        assert fab.cluster.states.state_of(rid) is ReplicaState.SERVING
        assert rep._session is None, "session must be discarded"
        assert rep.batcher.train_lora is None, "shadow must be dropped"
        assert rep.adapter_version == versions[rid]
        _assert_equal(published[rid], rep.get_adapter())
    # freed members serve the trace to completion
    prompts = sample_prompts(cfg, 4, [6, 7, 5, 8])
    reqs = [Request(request_id=i, stream_id=cfg.name, arrival=0.0,
                    deadline=1e9, tokens=3, prompt=prompts[i])
            for i in range(4)]
    for r in reqs:
        fab.submit(r)
    for _ in range(3000):
        now = time.perf_counter() - t0
        busy = fab.tick(now)
        if not busy and all(r.completed_at is not None for r in reqs):
            break
        if not busy:
            time.sleep(0.002)
    assert all(r.completed_at is not None for r in reqs)


def test_published_tenant_slot_is_a_copy_of_the_shadow():
    """With a registry, publishing writes the trained tree through to the
    co-training tenant's device slot: the slot holds its values (so that
    tenant's requests read the new version) in storage of its own, and
    the next round's optimizer steps leave it untouched."""
    fab, cfg = torch_fabric(1, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                            gen_tokens=MAX_GEN, n_adapters=2)
    rep = fab.replicas["r0"]
    reg = rep.adapters
    slot = reg.acquire("tenant0")
    reg.release("tenant0")
    rep.train_round(train_batch=2, infer_batch=0, steps=2, now=0.0)
    assert rep.adapter_version == 1 and reg.version("tenant0") == 1

    def slot_tree():
        return tree_map(lambda stk: stk[:, slot], reg.device_lora())

    published = rep.lora
    tree_map(lambda s, p: (torch.equal(s, p) and s.data_ptr()
                           != p.data_ptr()) or pytest.fail("slot"),
             slot_tree(), published)
    held = tree_map(torch.clone, slot_tree())
    rep.begin_round(2, 0, 2, now=0.0)
    while not rep._session.done:
        rep.pump_once(0.0)
    assert _moved(published, rep.batcher.train_lora)
    tree_map(lambda s, h: torch.equal(s, h) or pytest.fail("aliased"),
             slot_tree(), held)


# ============================================== control-plane unit pieces ==
def test_sim_replica_session_surface():
    """SimReplica implements the same non-blocking surface: progress
    tracks the billed sim timeline and finish hands out the stats the
    old blocking call returned."""
    from repro_torch.runtime.simulator import Simulator
    rep = SimReplica("s0", "m", Simulator(), lambda r, s: None, seed=0)
    rep.begin_round(train_batch=8, infer_batch=4, steps=10, now=0.0)
    with pytest.raises(RuntimeError):
        rep.begin_round(8, 4, 10, now=0.0)
    assert 0.0 <= rep.round_progress(0.0) < 1.0
    dur = rep._round[2] - rep._round[1]
    assert 0.0 < rep.round_progress(0.4 * dur) < 1.0
    assert rep.round_progress(2 * dur) == 1.0
    stats = rep.finish_round(2 * dur)
    assert stats.steps == 10 and stats.train_batch == 8
    assert rep.round_progress(0.0) == 1.0   # no active round
    assert rep.publish_adapter() == rep.adapter_version
    # abort: pending round dropped WITHOUT its effects — no loss-curve
    # advance, no train-time billing, interference stops at ``now``
    seen = rep.loss_curve.seen
    billed = rep.total_train_time
    rep.begin_round(8, 4, 10, now=100.0)
    rep.abort_round(101.0)
    assert rep._round is None and rep.train_batch == 0
    assert rep.training_until <= 101.0
    assert rep.loss_curve.seen == seen
    assert rep.total_train_time == billed


def test_launcher_rounds_are_polled_not_blocking():
    """The sim-clock launcher flow: maybe_launch begins sessions, ticks
    BEFORE the billed round duration must not aggregate, and the round
    completes only once every member's session reports done."""
    from repro_torch.core.cluster import ClusterConfig, ClusterController
    from repro_torch.runtime.simulator import Simulator
    sim = Simulator()
    cluster = ClusterController(ClusterConfig())
    for i in range(3):
        cluster.add_replica(SimReplica(f"r{i}", "m", sim,
                                       lambda r, s: None, seed=i))
    for rid in list(cluster.replicas):
        cluster.states.transition(rid, ReplicaState.IDLE, 0.0)
    launcher = cluster.launcher
    launcher.maybe_launch(0.0)
    assert launcher.sessions
    active = next(iter(launcher.sessions.values()))
    assert len(active.in_flight) == 3
    launcher.on_tick(0.01)          # mid-round: nothing aggregates
    assert launcher.completed_rounds == 0
    assert active.in_flight, "round must still be in flight"
    done_at = max(r._round[2] for r in cluster.replicas.values())
    launcher.on_tick(done_at + 1e-6)
    assert launcher.completed_rounds == 1
    assert launcher.round_history \
        and launcher.round_history[0]["version"] == 1


def test_aggregate_serve_stats_quality_fields():
    a = ServeStats(admitted=4, finished=4, prefill_tokens=20,
                   generated_tokens=30, decode_steps=10, train_steps=6,
                   wall_time=2.0, adapter_version=3, train_loss=5.5)
    b = ServeStats(admitted=2, finished=2, prefill_tokens=10,
                   generated_tokens=12, decode_steps=6, wall_time=1.0)
    out = aggregate_serve_stats({"r0": a, "r1": b})
    assert out["replicas"]["r0"]["adapter_version"] == 3
    assert out["replicas"]["r0"]["train_loss"] == pytest.approx(5.5)
    assert out["replicas"]["r1"]["adapter_version"] == 0
    assert out["replicas"]["r1"]["train_loss"] is None   # never trained
    c = out["cluster"]
    assert c["adapter_version_min"] == 0
    assert c["adapter_version_max"] == 3
    assert c["train_loss"] == pytest.approx(5.5)
