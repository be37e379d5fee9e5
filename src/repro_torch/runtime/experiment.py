"""End-to-end experiment harness: one call = one (policy × trace ×
cluster) simulation, returning the paper's metrics — the port's copy of
``repro.runtime.experiment`` (numpy only).  Every output but the
wall-clock ``control_wall_s`` / ``overhead_frac`` is the simulator's
arithmetic on the replicas' interference surfaces, not a device time.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterConfig, ClusterController
from repro_torch.core.interfaces import BatchResult, Request
from repro_torch.core.states import ReplicaState
from repro_torch.data import traces as traces_lib
from repro_torch.runtime.baselines import (
    BaseDispatcher, DLoRADispatcher, PEFTDispatcher, RoundRobinDispatcher,
    ShepherdDispatcher,
)
from repro_torch.runtime.metrics import MetricsCollector
from repro_torch.runtime.replica import (
    InterferenceSurface, LossCurve, SimReplica,
)
from repro_torch.runtime.simulator import Simulator

POLICIES = ("collm", "dlora", "shepherd", "peft", "rr")


@dataclasses.dataclass
class ExperimentConfig:
    policy: str = "collm"
    n_replicas: int = 16
    duration: float = 1200.0
    scale: float = 1.0
    slo: float = 0.5
    seed: int = 0
    model_id: str = "llama3-8b"
    control_tick: float = 0.05
    monitor_every: float = 5.0
    heterogeneous: bool = True
    enable_finetuning: bool = True       # CoLLM only
    drain: float = 5.0
    # fault injection: list of (replica_index, fail_t, recover_t)
    failures: Sequence = ()
    # straggler injection: {replica_index: slow_factor}
    stragglers: Dict[int, float] = dataclasses.field(default_factory=dict)


def build_replicas(cfg: ExperimentConfig, sim: Simulator,
                   on_result) -> Dict[str, SimReplica]:
    rng = np.random.default_rng(cfg.seed)
    replicas: Dict[str, SimReplica] = {}
    for i in range(cfg.n_replicas):
        het = rng.lognormal(0.0, 0.08) if cfg.heterogeneous else 1.0
        surface = InterferenceSurface(
            infer_alpha=0.020 * het, infer_beta=0.008 * het,
            infer_gamma=0.050 * het, train_alpha=0.030 * het,
            train_beta=0.010 * het, train_gamma=0.100 * het)
        curve = LossCurve(
            init_loss=float(rng.uniform(2.1, 2.7))
            if cfg.heterogeneous else 2.4,
            floor=float(rng.uniform(0.7, 1.0))
            if cfg.heterogeneous else 0.8,
            rate=1.0 / float(rng.uniform(4000, 9000))
            if cfg.heterogeneous else 1.0 / 6000.0)
        rid = f"r{i:02d}"
        replicas[rid] = SimReplica(
            rid, cfg.model_id, sim, on_result, surface, curve,
            seed=cfg.seed * 1000 + i,
            slow_factor=cfg.stragglers.get(i, 1.0))
    return replicas


def run_experiment(cfg: ExperimentConfig,
                   trace: Optional[List[Request]] = None) -> Dict:
    sim = Simulator()
    metrics = MetricsCollector(horizon=cfg.duration)
    if trace is None:
        trace = traces_lib.merged_trace(cfg.duration, scale=cfg.scale,
                                        stream_id=cfg.model_id,
                                        seed=cfg.seed)

    control_wall = [0.0]
    dispatch_delay = [0.0]

    if cfg.policy == "collm":
        cluster = ClusterController(ClusterConfig(
            slo=cfg.slo, enable_finetuning=cfg.enable_finetuning))

        def on_result(result: BatchResult, stream_id: str) -> None:
            metrics.on_result(result, stream_id)
            cluster.on_batch_result(result, stream_id)

        replicas = build_replicas(cfg, sim, on_result)
        for r in replicas.values():
            cluster.add_replica(r)

        def tick(now: float) -> None:
            t0 = _time.perf_counter()
            cluster.tick(now)
            control_wall[0] += _time.perf_counter() - t0

        sim.schedule_every(cfg.control_tick, tick, "control",
                           until=cfg.duration + cfg.drain)
        submit = cluster.submit_request
        state_of = cluster.states.state_of
    else:
        def on_result(result: BatchResult, stream_id: str) -> None:
            metrics.on_result(result, stream_id)
            if hasattr(dispatcher, "observe"):
                dispatcher.observe(result)

        replicas = build_replicas(cfg, sim, on_result)
        klass = {"dlora": DLoRADispatcher, "shepherd": ShepherdDispatcher,
                 "peft": PEFTDispatcher, "rr": RoundRobinDispatcher}[
                     cfg.policy]
        dispatcher = klass(replicas, slo=cfg.slo)

        def tick(now: float) -> None:
            t0 = _time.perf_counter()
            dispatcher.on_tick(now)
            control_wall[0] += _time.perf_counter() - t0

        sim.schedule_every(cfg.control_tick, tick, "control",
                           until=cfg.duration + cfg.drain)
        submit = dispatcher.submit
        state_of = lambda rid: ReplicaState.SERVING

    # --- faults ---------------------------------------------------------
    rids = list(replicas)
    for (idx, fail_t, recover_t) in cfg.failures:
        rid = rids[idx % len(rids)]
        sim.schedule(fail_t, lambda now, r=rid: replicas[r].fail(now),
                     "fail")
        if recover_t is not None:
            sim.schedule(recover_t,
                         lambda now, r=rid: replicas[r].recover(now),
                         "recover")

    # --- monitoring -------------------------------------------------------
    def sample(now: float) -> None:
        for rid, r in replicas.items():
            metrics.sample_utilization(rid, now, r.utilization(now))

    sim.schedule_every(cfg.monitor_every, sample, "monitor",
                       until=cfg.duration)

    traces_lib.replay(trace, sim, submit)
    sim.run(cfg.duration + cfg.drain)

    out = metrics.goodput(trace)
    out.update(metrics.utilization_summary())
    out["policy"] = cfg.policy
    out["scale"] = cfg.scale
    out["control_wall_s"] = control_wall[0]
    # overhead (Fig. 14): control-plane compute vs data-plane execution.
    # Control is real wall-clock of the Python control path; data-plane is
    # simulated busy seconds — conservative (control is biased up).
    infer_s = sum(r.total_infer_time for r in replicas.values())
    train_s = sum(r.total_train_time for r in replicas.values())
    out["infer_time_s"] = infer_s
    out["train_time_s"] = train_s
    out["overhead_frac"] = control_wall[0] / max(
        control_wall[0] + infer_s + train_s, 1e-9)
    out["train_frac"] = train_s / max(infer_s + train_s, 1e-9)
    out["events"] = sim.processed
    if cfg.policy == "collm":
        states = [state_of(rid).value for rid in replicas]
        out["final_states"] = {s: states.count(s) for s in set(states)}
        out["fl_rounds"] = cluster.launcher.completed_rounds
        out["mean_loss"] = float(np.mean(
            [r.loss_curve.loss() for r in replicas.values()]))
    out["_metrics"] = metrics
    out["_replicas"] = replicas
    return out
