"""Replica state management (paper §3 Fig. 7, §4.1).

Three system states — SERVING, IDLE, COMBINED — with the transition
conditions of Eq. 1–4:

  SERVING → IDLE      EWMA utilization AND EWMA queue length both under
                      the cluster α-quantile thresholds (Eq. 1), with
                      U_switch capped by the constant bound U^L = 0.25.
  IDLE → SERVING      unselected by the Launcher for T' consecutive
                      decisions, or promoted by the Dispatcher under
                      load (overload mitigation §6.2).
  IDLE → COMBINED     selected into an FL PEFT cohort (§4.2).
  COMBINED → SERVING  early-stopped (§4.3) or fine-tuning suspended
                      under saturation.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


class ReplicaState(str, enum.Enum):
    SERVING = "serving"
    IDLE = "idle"
    COMBINED = "combined"


@dataclasses.dataclass
class EWMAWindow:
    """Exponentially-weighted moving average over a sliding window of T
    steps with time-decay weights ω_{t'} (Eq. 2)."""
    window: int = 12            # T
    decay: float = 0.35         # λ

    def __post_init__(self) -> None:
        self._values: List[float] = []

    def observe(self, value: float) -> None:
        self._values.append(float(value))
        if len(self._values) > self.window:
            self._values = self._values[-self.window:]

    @property
    def value(self) -> float:
        if not self._values:
            return 0.0
        n = len(self._values)
        # ω_{t'} ∝ exp(-λ (t - t')), normalized over the window
        w = np.exp(-self.decay * np.arange(n - 1, -1, -1, dtype=np.float64))
        w /= w.sum()
        return float(np.dot(w, np.asarray(self._values)))

    def reset(self) -> None:
        self._values.clear()


@dataclasses.dataclass
class StatePolicy:
    """Transition thresholds (Eq. 1–4)."""
    quantile: float = 0.25          # α-quantile across the cluster
    util_lower_bound: float = 0.25  # U^L
    window: int = 12                # T (EWMA window)
    decay: float = 0.35             # λ
    rollback_rounds: int = 3        # T' (IDLE → SERVING if unselected)

    # below this, the whole cluster counts as idle and the quantile gate
    # (Eq. 3) is floored — otherwise identical near-zero EWMAs tie and
    # Eq. 1's strict inequality can never fire (degenerate-trough case).
    idle_floor: float = 0.02

    def thresholds(self, utils: Sequence[float], queues: Sequence[float]
                   ) -> tuple:
        """U_switch (Eq. 3) and q_switch (Eq. 4) from cluster EWMAs."""
        if not utils:
            return self.util_lower_bound, 0.0
        u_q = float(np.quantile(np.asarray(utils), self.quantile))
        q_q = float(np.quantile(np.asarray(queues), self.quantile))
        u_switch = min(max(u_q, self.idle_floor), self.util_lower_bound)
        return u_switch, q_q


@dataclasses.dataclass
class ReplicaStateTracker:
    """Per-replica state + EWMA telemetry, owned by the cluster manager."""
    replica_id: str
    policy: StatePolicy
    state: ReplicaState = ReplicaState.SERVING

    def __post_init__(self) -> None:
        self.util_ewma = EWMAWindow(self.policy.window, self.policy.decay)
        self.queue_ewma = EWMAWindow(self.policy.window, self.policy.decay)
        self.unselected_rounds = 0
        self.state_since: float = 0.0

    def observe(self, utilization: float, queue_len: float) -> None:
        self.util_ewma.observe(utilization)
        self.queue_ewma.observe(queue_len)

    def should_idle(self, u_switch: float, q_switch: float) -> bool:
        """Eq. 1: Ũ < U_switch and q̃ ≤ q_switch (≤ so the empty-queue
        cluster state — everyone at q̃ = 0 — can still idle)."""
        if self.state is not ReplicaState.SERVING:
            return False
        return (self.util_ewma.value < u_switch
                and self.queue_ewma.value <= q_switch)


class ClusterStateManager:
    """Evaluates Eq. 1–4 across the cluster each monitoring tick and owns
    every replica's state variable."""

    def __init__(self, policy: Optional[StatePolicy] = None) -> None:
        self.policy = policy or StatePolicy()
        self.trackers: Dict[str, ReplicaStateTracker] = {}

    # -- registry ------------------------------------------------------------
    def register(self, replica_id: str,
                 state: ReplicaState = ReplicaState.SERVING
                 ) -> ReplicaStateTracker:
        t = ReplicaStateTracker(replica_id, self.policy, state)
        self.trackers[replica_id] = t
        return t

    def remove(self, replica_id: str) -> None:
        self.trackers.pop(replica_id, None)

    def state_of(self, replica_id: str) -> ReplicaState:
        return self.trackers[replica_id].state

    def replicas_in(self, state: ReplicaState) -> List[str]:
        return [r for r, t in self.trackers.items() if t.state is state]

    # -- telemetry + transitions ----------------------------------------------
    def observe(self, replica_id: str, utilization: float,
                queue_len: float) -> None:
        self.trackers[replica_id].observe(utilization, queue_len)

    def evaluate_idle_transitions(self, now: float) -> List[str]:
        """SERVING → IDLE per Eq. 1–4.  Returns newly-idled replica ids.
        At least one replica is always kept SERVING per model pool — the
        dispatcher needs a target (paper keeps serving capacity alive via
        the q-quantile construction; we make the floor explicit)."""
        serving = self.replicas_in(ReplicaState.SERVING)
        if len(serving) <= 1:
            return []
        utils = [self.trackers[r].util_ewma.value for r in self.trackers]
        queues = [self.trackers[r].queue_ewma.value for r in self.trackers]
        u_sw, q_sw = self.policy.thresholds(utils, queues)
        newly_idle = []
        for rid in serving:
            if len(serving) - len(newly_idle) <= 1:
                break
            if self.trackers[rid].should_idle(u_sw, q_sw):
                self.transition(rid, ReplicaState.IDLE, now)
                newly_idle.append(rid)
        return newly_idle

    def transition(self, replica_id: str, state: ReplicaState,
                   now: float) -> None:
        t = self.trackers[replica_id]
        t.state = state
        t.state_since = now
        t.unselected_rounds = 0
        if state is ReplicaState.SERVING:
            # fresh telemetry after a role change
            t.util_ewma.reset()
            t.queue_ewma.reset()

    def tick_unselected(self, selected_ids: Sequence[str], now: float
                        ) -> List[str]:
        """Launcher decision round: IDLE replicas not selected for T'
        consecutive rounds revert to SERVING.  Returns reverted ids."""
        reverted = []
        for rid in self.replicas_in(ReplicaState.IDLE):
            t = self.trackers[rid]
            if rid in selected_ids:
                t.unselected_rounds = 0
                continue
            t.unselected_rounds += 1
            if t.unselected_rounds >= self.policy.rollback_rounds:
                self.transition(rid, ReplicaState.SERVING, now)
                reverted.append(rid)
        return reverted

    def promote_idle(self, now: float) -> Optional[str]:
        """Dispatcher overload mitigation: IDLE → SERVING immediately."""
        idle = self.replicas_in(ReplicaState.IDLE)
        if not idle:
            return None
        rid = idle[0]
        self.transition(rid, ReplicaState.SERVING, now)
        return rid
