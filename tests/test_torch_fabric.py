"""The port's multi-replica live serving fabric
(``repro_torch.runtime.fabric``, ``runtime/replica.py::LiveReplica``,
``runtime/metrics.py``) on the CPU, where every decode tick runs the
paged kernel's plain version and every projection ``lora_matmul``'s.

Twins of ``tests/test_fabric.py``, of ``test_multi_lora.py``'s failover
test and of ``test_preemption.py``'s counter fold, on the JAX
``build_fabric``'s weights carried across by ``convert.py``
(``_torch_fabric.py``): the fabric's greedy tokens, failover included,
equal ``tests/conftest.py::reference_greedy`` on the JAX model.  The
port's own ``build_fabric`` is driven end to end through the serve
entry points, which ask for the card by default and raise without one.
"""
import time

import numpy as np
import pytest
import torch

from _torch_fabric import ARCH, reference, torch_fabric
from conftest import sample_prompts
from repro_torch.core.interfaces import Request
from repro_torch.launch.serve import (
    run_combined_fabric_serving, run_multi_replica_serving,
)
from repro_torch.runtime.fabric import FabricConfig, build_fabric
from repro_torch.runtime.metrics import aggregate_serve_stats
from repro_torch.runtime.serving_loop import ServeStats

PROMPT_PAD, MAX_GEN, SLOTS = 10, 6, 2


@pytest.fixture()
def fabric2():
    return torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                        gen_tokens=MAX_GEN, paged=True, block_size=4)


def _reqs(cfg, lens, gens, stream, **kw):
    prompts = sample_prompts(cfg, len(lens), lens)
    return [Request(request_id=i, stream_id=stream, arrival=0.0,
                    deadline=1e9, tokens=gens[i],
                    prompt=prompts[i], **kw)
            for i in range(len(lens))], prompts


def _drive(fab, reqs, *, fail_at_step=None, fail_rid=None,
           max_iters=3000):
    """Deterministic control loop (no wall-clock pacing in asserts):
    tick the controller + pump every replica until all requests
    complete, optionally killing one replica after N iterations."""
    for r in reqs:
        fab.submit(r)
    t0 = time.perf_counter()
    dead = None
    for it in range(max_iters):
        now = time.perf_counter() - t0
        if fail_at_step is not None and it == fail_at_step:
            dead = fab.fail_replica(fail_rid, now)
        fab.cluster.tick(now)
        busy = False
        for rep in list(fab.replicas.values()):
            busy = rep.pump_once(now) or busy
        if not busy and all(r.completed_at is not None for r in reqs):
            return dead
        if not busy:
            time.sleep(0.002)   # wait out subflow pacing, don't spin
    raise AssertionError(
        f"fabric did not drain: "
        f"{sum(r.completed_at is None for r in reqs)} incomplete")


def test_two_replicas_serve_identically_to_reference(fabric2):
    fab, cfg = fabric2
    lens = [6, 9, 4, 8, 7, 5]
    gens = [4, 2, 5, 3, 4, 2]
    reqs, prompts = _reqs(cfg, lens, gens, cfg.name)
    _drive(fab, reqs)
    served = {rid: s["finished"] for rid, s in
              aggregate_serve_stats(
                  {r: h.batcher.stats
                   for r, h in fab.replicas.items()})["replicas"].items()}
    assert sum(served.values()) == len(reqs)
    # the pool actually spread the work (placement, not one hot replica)
    assert all(v > 0 for v in served.values()), served
    for i, r in enumerate(reqs):
        assert r.output_tokens == reference(prompts[i], gens[i]), \
            f"req {i} diverged on the fabric"


def test_failover_requeues_to_survivor(fabric2):
    fab, cfg = fabric2
    lens = [6, 8, 5, 7, 6, 9, 4, 8]
    gens = [5, 4, 5, 3, 4, 5, 6, 3]
    reqs, prompts = _reqs(cfg, lens, gens, cfg.name)
    # kill r1 after a few ticks: some requests are mid-decode there
    dead = _drive(fab, reqs, fail_at_step=4, fail_rid="r1")
    assert dead is not None and "r1" not in fab.replicas
    # 100% completion on the survivor, with full token budgets
    assert all(r.completed_at is not None for r in reqs)
    assert all(len(r.output_tokens) == gens[i]
               for i, r in enumerate(reqs))
    # greedy tokens identical to the reference despite the requeue
    for i, r in enumerate(reqs):
        assert r.output_tokens == reference(prompts[i], gens[i]), \
            f"req {i} diverged after failover"
    # the dead replica's pool is fully freed: no leaked blocks or
    # reservations, every slot evicted
    alloc = dead.batcher.allocator
    assert alloc.n_used == 0 and alloc.reserved == 0
    assert dead.batcher.active_slots() == []
    assert dead.queue_length(1e9) == 0
    # cluster accounting is coherent: every request finished exactly
    # once — on r1 before the kill, or on the survivor after requeue
    stats = aggregate_serve_stats({rid: h.batcher.stats for rid, h in
                                   list(fab.replicas.items())
                                   + [("r1", dead)]})
    assert stats["cluster"]["finished"] == len(reqs)


def test_fabric_sampled_decoding_deterministic(fabric2):
    """Sampling params thread through Request -> GenRequest -> decode
    tick; a fixed per-request seed reproduces the same tokens."""
    fab, cfg = fabric2
    lens = [6, 7, 5, 8]
    gens = [4, 4, 4, 4]
    reqs, prompts = _reqs(cfg, lens, gens, cfg.name,
                          temperature=1.2, top_k=8, seed=123)
    for i, r in enumerate(reqs):
        r.seed = 100 + i
    _drive(fab, reqs)
    fab2, _ = torch_fabric(2, n_slots=SLOTS, prompt_len=PROMPT_PAD,
                           gen_tokens=MAX_GEN, paged=True, block_size=4)
    reqs2 = [Request(request_id=i, stream_id=cfg.name, arrival=0.0,
                     deadline=1e9, tokens=gens[i], prompt=prompts[i],
                     temperature=1.2, top_k=8, seed=100 + i)
             for i in range(len(lens))]
    _drive(fab2, reqs2)
    for a, b in zip(reqs, reqs2):
        assert a.output_tokens == b.output_tokens
        assert len(a.output_tokens) == a.tokens


def test_two_timescale_loop_over_live_replicas():
    """The macro timescale runs over LIVE replicas: the launcher opens
    an FL session across idle live replicas, each runs REAL fused train
    rounds through its batcher, the coordinator aggregates + replans
    per-replica train/infer splits, and the dispatcher's macro cycle
    consumes the plan for COMBINED pacing — while serving requests
    still complete."""
    from repro_torch.core.states import ReplicaState

    fab, cfg = torch_fabric(
        3, n_slots=SLOTS, prompt_len=PROMPT_PAD, gen_tokens=MAX_GEN,
        cfg=FabricConfig(enable_finetuning=True))
    coord_cfg = fab.cluster.cfg.launcher.coordinator
    coord_cfg.bootstrap_steps = 2
    coord_cfg.steps_per_round = 2
    fab.cluster.cfg.launcher.decision_interval = 0.05
    for rid in list(fab.replicas):
        fab.cluster.states.transition(rid, ReplicaState.IDLE, 0.0)
    lens = [6, 7, 5, 8]
    gens = [3, 3, 3, 3]
    reqs, _ = _reqs(cfg, lens, gens, cfg.name)
    for r in reqs:
        fab.submit(r)
    t0 = time.perf_counter()
    launcher = fab.cluster.launcher
    for _ in range(1500):
        now = time.perf_counter() - t0
        fab.cluster.tick(now)
        for rep in list(fab.replicas.values()):
            rep.pump_once(now)
        if launcher.completed_rounds >= 1 \
                and all(r.completed_at is not None for r in reqs):
            break
        time.sleep(0.002)
    assert launcher.completed_rounds >= 1, "no live FL round completed"
    # real fused/plain train steps ran on the live batchers
    assert sum(rep.batcher.stats.train_steps
               for rep in fab.replicas.values()) >= 6   # 2 steps x 3
    assert fab.cluster.launcher.adapter_versions.get(cfg.name, 0) >= 1
    # the coordinator exports a per-replica plan the dispatcher's macro
    # cycle consumes for COMBINED replicas
    combined = [rid for rid in fab.replicas
                if fab.cluster.states.state_of(rid)
                is ReplicaState.COMBINED]
    for rid in combined:
        plan = fab.cluster._combined_plan(rid)
        assert plan is not None
        b_star, bivar = plan
        assert b_star >= 1
    # serving survived the co-running fine-tuning
    assert all(r.completed_at is not None for r in reqs)
    assert all(len(r.output_tokens) == gens[i]
               for i, r in enumerate(reqs))


def test_aggregate_serve_stats_totals():
    a = ServeStats(admitted=5, finished=5, prefill_tokens=40,
                   cached_prefix_tokens=8, generated_tokens=50,
                   decode_steps=12, train_steps=2, wall_time=2.0)
    b = ServeStats(admitted=3, finished=3, prefill_tokens=30,
                   cached_prefix_tokens=0, generated_tokens=30,
                   decode_steps=10, train_steps=0, wall_time=1.0)
    out = aggregate_serve_stats({"r0": a, "r1": b})
    c = out["cluster"]
    assert c["n_replicas"] == 2
    assert c["generated_tokens"] == 80
    assert c["prefill_tokens"] == 70
    assert c["cached_prefix_tokens"] == 8
    assert c["decode_steps"] == 22 and c["train_steps"] == 2
    assert c["wall_time_busy"] == pytest.approx(3.0)
    assert c["wall_time_max"] == pytest.approx(2.0)
    assert c["throughput_sum_tok_s"] == pytest.approx(
        50 / 2.0 + 30 / 1.0)
    # shared-device rate divides by SUMMED busy time (time-sliced device)
    assert c["throughput_wall_tok_s"] == pytest.approx(80 / 3.0)
    assert out["replicas"]["r0"]["throughput_tok_s"] \
        == pytest.approx(25.0)


# ------------------------------------------ test_multi_lora.py's failover --
def test_fabric_failover_reregisters_tenants():
    """Killing a replica must leave every tenant it served registered
    somewhere — survivors lacking the tenant inherit its tree at the dead
    replica's version."""
    fabric, cfg = torch_fabric(2, n_slots=2, prompt_len=8, gen_tokens=4,
                               n_adapters=2)
    (r0, rep0), (r1, rep1) = sorted(fabric.replicas.items())
    rep1.adapters.unregister("tenant1")
    rep0.adapters.update("tenant1", rep0.adapters.host_tree("tenant1"),
                         version=3)
    fabric.fail_replica(r0, 0.0)
    assert rep1.adapters.is_registered("tenant1")
    assert rep1.adapters.version("tenant1") == 3
    assert rep1.adapters.is_registered("tenant0")


# -------------------------------------- test_preemption.py's counter fold --
def test_aggregate_folds_preemption_counters():
    from test_torch_preemption import _serve
    from test_torch_prefix_cache import pair

    s = pair()
    prompts = sample_prompts(s["cfg"], 6, [7, 16, 13, 10, 6, 15])
    _, b = _serve(s, prompts, n_blocks=10, oversubscribe=1.0)
    agg = aggregate_serve_stats({"r0": b.stats})
    for f in ("preemptions", "swap_out_blocks", "swap_in_blocks",
              "reprefill_tokens"):
        assert agg["cluster"][f] == getattr(b.stats, f)
    assert agg["cluster"]["preemptions"] > 0


# ------------------------------------------- the port's own build_fabric --
def test_build_fabric_end_to_end_through_the_entry_points():
    """``run_multi_replica_serving`` and ``run_combined_fabric_serving`` on
    the port's own ``build_fabric`` (reduced config, CPU): every request
    completes on both replicas' pools, which end all-free; both replicas
    share one params tree; the tenant rollup sums to ``finished``; the
    combined run averages and publishes two rounds on both replicas."""
    out = run_multi_replica_serving(
        ARCH, n_replicas=2, n_requests=8, prompt_len=12, gen_tokens=4,
        batch_size=2, paged=True, block_size=4, n_adapters=3,
        device="cpu", verbose=False)
    c = out["cluster"]
    assert out["completed"] == 8 and out["incomplete_requests"] == 0
    assert c["finished"] == 8 and c["generated_tokens"] == 32
    assert sum(a["requests"] for a in c["adapters"].values()) == 8
    assert out["fault_tolerance"]["failovers"] == 0
    fab, _ = build_fabric(ARCH, 2, n_slots=2, prompt_len=12, gen_tokens=4,
                          paged=True, block_size=4, device="cpu")
    r0, r1 = fab.replicas["r0"], fab.replicas["r1"]
    assert r0.params is r1.params
    assert r0.batcher.params is r1.batcher.params
    assert all(a is not b for a, b in zip(
        r0.lora["q"].values(), r1.lora["q"].values()))
    reqs = [Request(request_id=i, stream_id=fab.cluster.replicas["r0"]
                    .model_id, arrival=0.0, deadline=1e9, tokens=4,
                    prompt=np.arange(3 + i, 12, dtype=np.int32))
            for i in range(6)]
    fab.run(reqs, timeout=120.0)
    assert all(r.completed_at is not None for r in reqs)
    for rep in fab.replicas.values():
        alloc = rep.batcher.allocator
        assert alloc.n_used == 0 and alloc.reserved == 0
    out = run_combined_fabric_serving(
        ARCH, n_replicas=2, n_requests=6, prompt_len=12, gen_tokens=4,
        batch_size=2, rounds=2, steps_per_round=2, train_pool=2,
        device="cpu", verbose=False)
    assert out["completed"] == 6 and out["fl_rounds"] >= 2
    assert out["cluster"]["adapter_version_min"] >= 2


def test_fabric_entry_points_ask_for_the_card():
    """Without a CUDA device the fabric's entry points raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fabric(ARCH, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_multi_replica_serving(ARCH, verbose=False)


# ------------------------------------------------ the port's own warm-up --
@pytest.mark.parametrize("mode", ["combined", "adapters"])
def test_warm_up_leaves_the_replicas_untouched(mode):
    """``warm_up`` (which ``fabric_from_weights`` runs on the card before
    the fabric's clock starts) runs a throwaway batcher of the replicas'
    shapes: every replica's adapter, optimizer state, registry, counters,
    pool and train-data stream stay as built.  Multi-tenant, the fabric
    then serves the reference's greedy tokens (with fine-tuning on, the
    rounds publish new adapters at wall-clock boundaries, so tokens are
    no fixed reference there)."""
    from repro_torch.runtime.fabric import warm_up
    from repro_torch.tree import tree_leaves

    n_adapters = 2 if mode == "adapters" else 0

    def build():
        return torch_fabric(
            2, n_slots=SLOTS, prompt_len=PROMPT_PAD, gen_tokens=MAX_GEN,
            paged=True, block_size=4, n_adapters=n_adapters,
            cfg=FabricConfig(enable_finetuning=mode == "combined"))

    fab, cfg = build()

    def state():
        return [[t.clone() for t in tree_leaves(
                    {"l": rep.lora, "o": rep.opt_state._asdict(),
                     "r": {a: rep.adapters.host_tree(a)
                           for a in rep.adapters.registered()}
                     if rep.adapters is not None else {}})]
                for rep in fab.replicas.values()]

    before = state()
    assert warm_up(fab) > 0.0
    for was, now in zip(before, state()):
        assert len(was) == len(now)
        assert all(torch.equal(a, b) for a, b in zip(was, now))
    for rep in fab.replicas.values():
        b = rep.batcher
        assert b.stats == ServeStats() and b.prefill_waves == 0
        assert b.allocator.n_used == 0 and b.allocator.reserved == 0
        assert b.train_lora is None and rep.adapter_version == 0
    cold, _ = build()
    for rid, rep in fab.replicas.items():
        got, want = rep.data_fn(4), cold.replicas[rid].data_fn(4)
        assert all(torch.equal(got[k], want[k]) for k in want)
    if mode == "combined":
        return
    lens, gens = [6, 8, 5, 7], [5, 4, 5, 3]
    reqs, prompts = _reqs(cfg, lens, gens, cfg.name)
    for i, r in enumerate(reqs):
        r.adapter_id = f"tenant{i % n_adapters}"
    _drive(fab, reqs)
    for i, r in enumerate(reqs):
        assert r.output_tokens == reference(
            prompts[i], gens[i], n_adapters=n_adapters,
            tenant=i % n_adapters), f"req {i} diverged after the warm-up"


def test_contained_pump_error_is_recorded_and_the_cli_exits_nonzero(
        monkeypatch, capsys):
    """A pump that raises (here as a failed kernel launch would on the
    card) fails its replica over; the fabric keeps the exception's text
    and traceback beside the health monitor's type name, and the serve
    CLI exits non-zero with them on stderr when requests go unserved.
    A clean fabric run exits 0."""
    from repro_torch.launch import serve
    from repro_torch.runtime.replica import LiveReplica

    argv = ["serve", "--replicas", "2", "--smoke", "--device", "cpu",
            "--requests", "4", "--prompt-len", "8", "--gen", "2",
            "--batch", "2"]
    monkeypatch.setattr("sys.argv", argv)
    serve.main()                        # every request served: no exit

    def launch_failed(self, now):
        raise RuntimeError("lora_matmul: launch failed with CUDA error "
                           "700 (x (8, 128), w (128, 128), r 8)")

    monkeypatch.setattr(LiveReplica, "pump_once", launch_failed)
    out = run_multi_replica_serving(
        ARCH, n_replicas=2, n_requests=4, prompt_len=8, gen_tokens=2,
        batch_size=2, device="cpu", verbose=False)
    ft = out["fault_tolerance"]
    assert ft["failovers"] == 2 and out["incomplete_requests"] == 4
    assert [e[1] for e in ft["pump_errors"]] == ["r0", "r1"]
    assert all("RuntimeError: lora_matmul: launch failed" in e[2]
               and "Traceback" in e[2] for e in ft["pump_errors"])
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        serve.main()
    assert "4 requests incomplete" in str(exc.value.code)
    assert "lora_matmul: launch failed with CUDA error 700" \
        in capsys.readouterr().err
