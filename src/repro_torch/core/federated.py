"""Collaborative federated LoRA fine-tuning (paper §4.2–4.3).

FedAvg over the adapter matrices (Eq. 5):

  B̄^(t+1) = 1/|K| Σ_k B_k      Ā^(t+1) = 1/|K| Σ_k A_k

plus the model-quality score update (Eq. 6) and per-replica early
stopping (§4.3).  Aggregation is a mean over nested dicts of tensors
(``repro_torch.tree.tree_map``), so the same code path serves the
simulator's placeholder adapters and the live replicas' float32 LoRA
trees.

Note on Eq. 6: taken literally, Q^(t) = Q^(t-1) · ΔF/F^(t-1) contracts
Q toward zero for any relative improvement < 100%.  We implement the
literal rule behind ``literal_eq6=True`` and default to the stabilized
multiplicative form Q·(1 + ΔF/F) which preserves the paper's intent
(quality grows with training progress); §8.1 separately defines served
response quality as 1/CE-loss, which the serving layer uses directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.tree import tree_map


def fedavg(adapter_trees: Sequence[Any], weights: Optional[Sequence[float]]
           = None) -> Any:
    """Eq. 5 — (optionally weighted) mean of LoRA pytrees."""
    assert adapter_trees, "fedavg needs at least one participant"
    if weights is None:
        w = np.full(len(adapter_trees), 1.0 / len(adapter_trees))
    else:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()

    def avg(*leaves):
        out = leaves[0] * w[0]
        for wi, leaf in zip(w[1:], leaves[1:]):
            out = out + wi * leaf
        return out

    return tree_map(avg, *adapter_trees)


def quality_update(q_prev: float, loss_prev: float, loss_now: float, *,
                   literal_eq6: bool = False) -> float:
    """Eq. 6 — model quality score update from FL-round average losses."""
    if loss_prev <= 0:
        return q_prev
    rel = (loss_prev - loss_now) / loss_prev
    if literal_eq6:
        return q_prev * rel
    return max(q_prev * (1.0 + rel), 1e-6)


@dataclasses.dataclass
class EarlyStopper:
    """§4.3 — drop a replica from the cohort when its local loss stops
    improving (patience rounds with < min_delta relative improvement)."""
    patience: int = 2
    min_delta: float = 1e-3

    def __post_init__(self) -> None:
        self.best: float = float("inf")
        self.bad_rounds: int = 0

    def update(self, local_loss: float) -> bool:
        """Returns True if the replica should stop fine-tuning."""
        if local_loss < self.best * (1.0 - self.min_delta):
            self.best = local_loss
            self.bad_rounds = 0
            return False
        self.bad_rounds += 1
        return self.bad_rounds >= self.patience


@dataclasses.dataclass
class FLRoundResult:
    replica_id: str
    adapter: Any
    local_loss: float
    samples: int
    train_time: float = 0.0


class FederatedSession:
    """One FL PEFT process over a cohort of IDLE→COMBINED replicas.

    The Launcher creates a session when ≥ min_cohort IDLE replicas serve
    the same model (§4.2); the member with the highest quality score
    acts as server (global init + aggregation).
    """

    def __init__(self, model_id: str, members: Sequence[str],
                 server: str, global_adapter: Any, *,
                 min_cohort: int = 3) -> None:
        self.model_id = model_id
        self.members: List[str] = list(members)
        self.server = server
        self.global_adapter = global_adapter
        self.min_cohort = min_cohort
        self.round: int = 0
        self.prev_avg_loss: Optional[float] = None
        self.stoppers: Dict[str, EarlyStopper] = {
            m: EarlyStopper() for m in members}
        self.quality: Dict[str, float] = {m: 1.0 for m in members}
        self.history: List[Dict] = []

    def aggregate(self, results: Sequence[FLRoundResult],
                  sample_weighted: bool = True) -> Any:
        """Run Eq. 5 over the round's results and update quality scores
        (Eq. 6).  Returns the new global adapter."""
        weights = [float(r.samples) for r in results] if sample_weighted \
            else None
        self.global_adapter = fedavg([r.adapter for r in results], weights)
        avg_loss = float(np.mean([r.local_loss for r in results]))
        if self.prev_avg_loss is not None:
            for r in results:
                self.quality[r.replica_id] = quality_update(
                    self.quality[r.replica_id], self.prev_avg_loss, avg_loss)
        self.history.append({
            "round": self.round, "avg_loss": avg_loss,
            "members": [r.replica_id for r in results]})
        self.prev_avg_loss = avg_loss
        self.round += 1
        return self.global_adapter

    def early_stops(self, results: Sequence[FLRoundResult]) -> List[str]:
        """§4.3 — members whose local loss plateaued this round."""
        stopped = []
        for r in results:
            if self.stoppers[r.replica_id].update(r.local_loss):
                stopped.append(r.replica_id)
        for rid in stopped:
            if rid in self.members:
                self.members.remove(rid)
        return stopped

    @property
    def alive(self) -> bool:
        # FedAvg is cohort-size agnostic; a session dissolves below 2
        # members (nothing left to aggregate across).
        return len(self.members) >= 2
