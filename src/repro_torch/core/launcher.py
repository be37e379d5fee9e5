"""Fine-tune Task Launcher (paper §4).

Watches IDLE replicas; when ≥ ``min_cohort`` IDLE replicas serve the same
model it opens a FederatedSession (server = highest quality score),
transitions members to COMBINED and creates an Inference-Training
Coordinator for the session.

Rounds are NON-BLOCKING: ``_start_round`` begins an incremental train
session on every member (``ReplicaHandle.begin_round`` — live replicas
advance one fused combined_step per fabric tick, the simulator bills its
analytic timeline) and ``_maybe_finish_round`` POLLS session progress on
every launcher tick instead of calling ``train_round`` synchronously.
Members complete asynchronously: each finished member's stats feed the
Coordinator and its trained shadow is published locally
(``publish_adapter`` — its own round boundary); aggregation fires when
the SLOWEST member finishes and pushes the merged adapter to every
member (stragglers are early-stopped by §4.3 or shed by the cohort-size
check).

Load surges suspend sessions (§8.2: "CoLLM temporarily halts fine-tuning
to prioritize inference") via ``suspend_for_model``; suspended members
discard their shadow state (``abort_round``) and keep serving the last
PUBLISHED adapter.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.coordinator import (
    CoordinatorConfig, InferenceTrainingCoordinator,
)
from repro_torch.core.federated import FederatedSession, FLRoundResult
from repro_torch.core.interfaces import ReplicaHandle
from repro_torch.core.states import ClusterStateManager, ReplicaState


@dataclasses.dataclass
class LauncherConfig:
    min_cohort: int = 3
    slo: float = 0.5
    coordinator: CoordinatorConfig = dataclasses.field(
        default_factory=CoordinatorConfig)
    max_rounds: int = 1000
    decision_interval: float = 5.0   # launcher decision cadence (T' counts
                                     # these decisions, not control ticks)


@dataclasses.dataclass
class ActiveSession:
    session: FederatedSession
    coordinator: InferenceTrainingCoordinator
    round_started_at: float
    pending: List[FLRoundResult] = dataclasses.field(default_factory=list)
    # members whose incremental session has not completed this round
    in_flight: List[str] = dataclasses.field(default_factory=list)


class FineTuneTaskLauncher:
    _ids = itertools.count()

    def __init__(self, cfg: LauncherConfig,
                 replicas: Dict[str, ReplicaHandle],
                 states: ClusterStateManager,
                 global_adapters: Dict[str, Any],
                 on_adapter_update: Callable[[str, Any, int], None]
                 = lambda model_id, adapter, version: None) -> None:
        self.cfg = cfg
        self.replicas = replicas
        self.states = states
        self.global_adapters = global_adapters   # model_id -> adapter tree
        self.on_adapter_update = on_adapter_update
        # τ' provider for Eq. 12 — wired to dispatcher queue telemetry by
        # the cluster controller; defaults to the raw SLO.
        self.budget_fn: Callable[[], float] = lambda: self.cfg.slo
        self.sessions: Dict[str, ActiveSession] = {}
        self.adapter_versions: Dict[str, int] = {}
        self.completed_rounds = 0
        # aggregation log: model_id / round / version / avg member loss
        # per completed round — quality-progression telemetry for the
        # fabric summary and benchmarks
        self.round_history: List[Dict[str, Any]] = []
        self._next_decision = 0.0

    # ------------------------------------------------------------ helpers --
    def _idle_by_model(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for rid in self.states.replicas_in(ReplicaState.IDLE):
            model = self.replicas[rid].model_id
            out.setdefault(model, []).append(rid)
        return out

    def session_for(self, replica_id: str) -> Optional[ActiveSession]:
        for a in self.sessions.values():
            if replica_id in a.session.members:
                return a
        return None

    # -------------------------------------------------------------- launch --
    def maybe_launch(self, now: float) -> List[str]:
        """§4.2 — open sessions for models with ≥ min_cohort IDLE
        replicas.  Returns ids of all replicas selected this decision."""
        selected: List[str] = []
        in_session = {m for a in self.sessions.values()
                      for m in a.session.members}
        for model_id, idle in self._idle_by_model().items():
            idle = [r for r in idle if r not in in_session]
            if len(idle) < self.cfg.min_cohort:
                continue
            # server = member with the highest quality score
            server = max(idle,
                         key=lambda r: self.replicas[r].quality_score(now))
            adapter = self.global_adapters.get(model_id)
            if adapter is None:
                adapter = self.replicas[server].get_adapter()
                self.global_adapters[model_id] = adapter
            session = FederatedSession(model_id, idle, server, adapter,
                                       min_cohort=self.cfg.min_cohort)
            coord = InferenceTrainingCoordinator(
                f"fl-{next(self._ids)}", idle, self.cfg.slo,
                self.cfg.coordinator)
            active = ActiveSession(session, coord, round_started_at=now)
            self.sessions[coord.session_id] = active
            for rid in idle:
                self.states.transition(rid, ReplicaState.COMBINED, now)
            self._start_round(active, now)
            selected.extend(idle)
        # T' rollback for IDLE replicas that keep being passed over
        self.states.tick_unselected(selected, now)
        return selected

    # --------------------------------------------------------------- rounds -
    def _start_round(self, active: ActiveSession, now: float) -> None:
        """Begin an incremental session on every member — no member
        blocks the caller; the fabric/simulator advances them and
        ``_maybe_finish_round`` polls."""
        sess, coord = active.session, active.coordinator
        version = self.adapter_versions.get(sess.model_id, 0)
        active.pending = []
        active.in_flight = list(sess.members)
        active.round_started_at = now
        for rid in active.in_flight:
            handle = self.replicas[rid]
            handle.set_adapter(sess.global_adapter, version)
            plan = coord.plan_for(rid)
            handle.begin_round(plan.train_batch, plan.infer_batch,
                               coord.steps_per_round, now)

    def _maybe_finish_round(self, active: ActiveSession,
                            now: float) -> None:
        """Poll member sessions: collect stats and publish each member's
        trained shadow AS IT COMPLETES (rounds stay asynchronous across
        replicas); aggregate once the slowest member is done."""
        sess, coord = active.session, active.coordinator
        for rid in list(active.in_flight):
            if rid not in sess.members or rid not in self.replicas:
                # shed mid-round (failure / overload release): its
                # result never lands; the cohort aggregates without it
                active.in_flight.remove(rid)
                continue
            handle = self.replicas[rid]
            if handle.round_progress(now) < 1.0:
                continue
            stats = handle.finish_round(now)
            coord.observe_train(stats)
            # member round boundary: serve the local update until the
            # merged global arrives (continuous adaptation, §3)
            handle.publish_adapter()
            active.in_flight.remove(rid)
            active.pending.append(FLRoundResult(
                replica_id=rid, adapter=handle.get_adapter(),
                local_loss=stats.loss_after, samples=stats.samples,
                train_time=stats.steps * stats.avg_step_time))
        if active.in_flight:
            return
        if not active.pending:
            # every member left mid-round — nothing to aggregate
            self._dissolve(active, now)
            return
        self._finish_round(active, now)

    def _finish_round(self, active: ActiveSession, now: float) -> None:
        sess, coord = active.session, active.coordinator
        new_global = sess.aggregate(active.pending)
        version = self.adapter_versions.get(sess.model_id, 0) + 1
        self.adapter_versions[sess.model_id] = version
        self.global_adapters[sess.model_id] = new_global
        self.on_adapter_update(sess.model_id, new_global, version)
        # model sharing: COMBINED members serve with the fresh adapter
        # immediately (the paper's continuous-adaptation mechanism)
        for rid in list(sess.members):
            if rid in self.replicas:
                self.replicas[rid].set_adapter(new_global, version)
        # reuse the session's own row so the round label matches
        # FederatedSession.history (aggregate() has already advanced
        # sess.round past the round it just closed)
        self.round_history.append({
            "model_id": sess.model_id,
            "round": sess.history[-1]["round"],
            "version": version,
            "avg_loss": sess.history[-1]["avg_loss"],
            "members": len(active.pending), "finished_at": now})
        stopped = sess.early_stops(active.pending)
        for rid in stopped:
            coord.drop_replica(rid)
            self.states.transition(rid, ReplicaState.SERVING, now)
        self.completed_rounds += 1
        if not sess.alive or sess.round >= self.cfg.max_rounds:
            self._dissolve(active, now)
            return
        coord.replan(self.budget_fn())
        self._start_round(active, now)

    def _dissolve(self, active: ActiveSession, now: float) -> None:
        """End a session (early-stop cascade, cohort collapse, or §8.2
        suspension).  Members still mid-round discard their shadow state
        — serving stays on the last published adapter."""
        for rid in list(active.session.members):
            handle = self.replicas.get(rid)
            if handle is not None and rid in active.in_flight \
                    and hasattr(handle, "abort_round"):
                handle.abort_round(now)
            self.states.transition(rid, ReplicaState.SERVING, now)
        active.in_flight = []
        self.sessions.pop(active.coordinator.session_id, None)

    def suspend_for_model(self, model_id: str, now: float) -> int:
        """Load surge: halt fine-tuning for a model, release replicas."""
        n = 0
        for sid in list(self.sessions):
            a = self.sessions[sid]
            if a.session.model_id == model_id:
                self._dissolve(a, now)
                n += 1
        return n

    # ------------------------------------------------------------ the loop -
    def on_tick(self, now: float) -> None:
        for sid in list(self.sessions):
            active = self.sessions.get(sid)
            if active is not None:
                self._maybe_finish_round(active, now)
        if now >= self._next_decision:
            self.maybe_launch(now)
            self._next_decision = now + self.cfg.decision_interval
