"""Inference-Training Coordinator (paper §5).

One Coordinator per FL PEFT session.  Per round:

  1. collect runtime stats from every COMBINED replica
     (T_train, B, p, l and T_infer, b under interference),
  2. fit the two bivariate latency models (Eq. 9–10),
  3. solve (B*, b*) = argmax GOODPUT(B, b*(B)) s.t. the SLO (Eq. 11–12),
  4. push the configuration to the replicas and export (latency model,
     b*) to the Dispatcher for subflow pacing.

Round 0 uses the conservative bootstrap (small B0, large b0, 50 steps)
so queues drain and the models get sample support (§5.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.goodput import EfficiencyParams, goodput, optimize
from repro_torch.core.interfaces import BatchResult, TrainRoundStats
from repro_torch.core.latency_model import BivariateLatencyModel


@dataclasses.dataclass
class ReplicaPlan:
    """Per-replica configuration for the next round."""
    train_batch: int
    infer_batch: int
    expected_goodput: float = 0.0


@dataclasses.dataclass
class CoordinatorConfig:
    bootstrap_train_batch: int = 4     # B0
    bootstrap_infer_batch: int = 12    # b0 ("relatively large")
    bootstrap_steps: int = 50
    steps_per_round: int = 50
    max_train_batch: int = 64
    max_infer_batch: int = 256
    # a in Eq. 8 — the paper calls it "a scaling constant": it must put
    # a·p_t·l_t on the scale of batch sizes (p_t ~ O(10) gradient-noise
    # scale × l_t ~ O(1e-3) per-iteration loss drop ⇒ a ~ O(500)),
    # otherwise EFFICIENCY ≈ B0/B and the optimizer degenerates to B*=1
    efficiency_scale: float = 500.0


class InferenceTrainingCoordinator:
    """Owns per-replica interference-aware models + batch planning."""

    def __init__(self, session_id: str, replica_ids: Sequence[str],
                 slo: float, cfg: Optional[CoordinatorConfig] = None) -> None:
        self.session_id = session_id
        self.cfg = cfg or CoordinatorConfig()
        self.slo = slo
        self.replicas = list(replica_ids)
        self.round = 0
        self.t_train: Dict[str, BivariateLatencyModel] = {
            r: BivariateLatencyModel() for r in replica_ids}
        self.t_infer: Dict[str, BivariateLatencyModel] = {
            r: BivariateLatencyModel() for r in replica_ids}
        self.eff: Dict[str, EfficiencyParams] = {
            r: EfficiencyParams(scale_a=self.cfg.efficiency_scale,
                                init_batch=self.cfg.bootstrap_train_batch)
            for r in replica_ids}
        self.plans: Dict[str, ReplicaPlan] = {
            r: ReplicaPlan(self.cfg.bootstrap_train_batch,
                           self.cfg.bootstrap_infer_batch)
            for r in replica_ids}

    # ------------------------------------------------------------ telemetry -
    def observe_train(self, stats: TrainRoundStats) -> None:
        """Fold one member's completed round into its latency model +
        efficiency params.  Incremental sessions can complete degenerate
        (0 steps after a mid-round shed, NaN losses when no tick ran) —
        those must not poison the Eq. 9 fit or Eq. 8's l_t."""
        m = self.t_train.get(stats.replica_id)
        if m is None or stats.steps <= 0:
            return
        m.observe(stats.train_batch, stats.infer_batch, stats.avg_step_time)
        e = self.eff[stats.replica_id]
        if math.isfinite(stats.noise_scale):
            e.noise_scale = stats.noise_scale
        if math.isfinite(stats.loss_before) \
                and math.isfinite(stats.loss_after):
            e.loss_reduction = stats.loss_reduction

    def observe_infer(self, result: BatchResult) -> None:
        m = self.t_infer.get(result.replica_id)
        if m is None or result.batch_size <= 0:
            return
        m.observe(result.batch_size, result.train_batch,
                  result.infer_latency)

    # --------------------------------------------------------------- solve --
    def replan(self, latency_budget: Optional[float] = None
               ) -> Dict[str, ReplicaPlan]:
        """Fit models and solve Eq. 11–12 per replica.  ``latency_budget``
        is τ' = τ − T̄_queue (the dispatcher supplies the queue term);
        defaults to the raw SLO."""
        budget = latency_budget if latency_budget is not None else self.slo
        self.round += 1
        for rid in self.replicas:
            tt, ti = self.t_train[rid], self.t_infer[rid]
            if not (tt.fitted and ti.fitted):
                continue  # keep bootstrap plan until models have support
            tt.fit()
            ti.fit()
            big_b, b_star, g = optimize(
                tt, ti, self.eff[rid], budget,
                train_batches=range(1, self.cfg.max_train_batch + 1),
                infer_cap=self.cfg.max_infer_batch)
            self.plans[rid] = ReplicaPlan(big_b, b_star, g)
        return dict(self.plans)

    # ------------------------------------------------------------- exports --
    def plan_for(self, replica_id: str) -> ReplicaPlan:
        return self.plans[replica_id]

    def infer_model_for(self, replica_id: str) -> BivariateLatencyModel:
        return self.t_infer[replica_id]

    def drop_replica(self, replica_id: str) -> None:
        """Early-stopped / failed member leaves the session."""
        if replica_id in self.replicas:
            self.replicas.remove(replica_id)
        self.plans.pop(replica_id, None)

    @property
    def steps_per_round(self) -> int:
        return self.cfg.bootstrap_steps if self.round == 0 \
            else self.cfg.steps_per_round
