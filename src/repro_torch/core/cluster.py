"""Cluster controller: wires states + launcher + coordinators +
dispatchers into one control plane (paper Fig. 6).

The controller is clock-agnostic: ``tick(now)`` is driven either by the
discrete-event simulator (paper-scale experiments) or by a wall-clock
loop around live replicas (examples/).
"""
from __future__ import annotations

import collections.abc
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.dispatcher import DispatcherConfig, SubflowDispatcher
from repro_torch.core.interfaces import BatchResult, ReplicaHandle, Request
from repro_torch.core.latency_model import BivariateLatencyModel
from repro_torch.core.launcher import FineTuneTaskLauncher, LauncherConfig
from repro_torch.core.states import ClusterStateManager, ReplicaState, StatePolicy


class StreamReplicaView(collections.abc.Mapping):
    """Live, read-only view of the cluster registry filtered to one
    stream's model.  Dispatchers hold THIS instead of a dict snapshot,
    so ``add_replica`` / ``remove_replica`` join/leave every existing
    stream dispatcher immediately — the old one-time ``dict(...)``
    snapshot meant late-added replicas never received traffic and
    removed ones lingered in ``d.replicas``."""

    def __init__(self, registry: Dict[str, ReplicaHandle], model_id: str) -> None:
        self._registry = registry
        self._model_id = model_id

    def __getitem__(self, rid: str) -> ReplicaHandle:
        h = self._registry[rid]
        if h.model_id != self._model_id:
            raise KeyError(rid)
        return h

    def __iter__(self) -> Iterator[str]:
        return (rid for rid, h in self._registry.items()
                if h.model_id == self._model_id)

    def __len__(self) -> int:
        return sum(1 for _ in self)


@dataclasses.dataclass
class ClusterConfig:
    slo: float = 0.5
    monitor_interval: float = 1.0
    state_policy: StatePolicy = dataclasses.field(default_factory=StatePolicy)
    dispatcher: DispatcherConfig = dataclasses.field(
        default_factory=DispatcherConfig)
    launcher: LauncherConfig = dataclasses.field(
        default_factory=LauncherConfig)
    enable_finetuning: bool = True     # False -> plain SLO-aware serving


class ClusterController:
    def __init__(self, cfg: ClusterConfig) -> None:
        self.cfg = cfg
        cfg.dispatcher.slo = cfg.slo
        cfg.launcher.slo = cfg.slo
        self.replicas: Dict[str, ReplicaHandle] = {}
        self.states = ClusterStateManager(cfg.state_policy)
        self.global_adapters: Dict[str, Any] = {}
        self.launcher = FineTuneTaskLauncher(
            cfg.launcher, self.replicas, self.states, self.global_adapters)
        self.launcher.budget_fn = self._latency_budget
        self.dispatchers: Dict[str, SubflowDispatcher] = {}
        self._next_monitor = 0.0
        # optional runtime.fault.RetryPolicy: when set, every request a
        # dying replica hands back is charged one retry (+ one failure)
        # before re-queueing; budget-exhausted / poison requests are
        # terminally rejected instead of requeued
        self.retry_policy = None

    def _latency_budget(self) -> float:
        """τ' = (τ − T̄_queue) × headroom for the Coordinator's Eq. 12.
        The 0.9 headroom absorbs latency-model noise so b* doesn't sit
        exactly on the SLO boundary (half of noisy batches would miss)."""
        tq = max((d.avg_queue_latency() for d in self.dispatchers.values()),
                 default=0.0)
        return max(self.cfg.slo - tq, 0.1 * self.cfg.slo) * 0.9

    # ------------------------------------------------------------ registry -
    def add_replica(self, handle: ReplicaHandle,
                    state: ReplicaState = ReplicaState.SERVING) -> None:
        self.replicas[handle.replica_id] = handle
        self.states.register(handle.replica_id, state)

    def remove_replica(self, replica_id: str, now: float) -> None:
        """Elastic scale-down / failure: drop the replica everywhere and
        requeue its accepted-but-unfinished requests on the surviving
        pool (failover — no request is lost).  In-session members are
        handled by the session's cohort check."""
        handle = self.replicas.get(replica_id)
        active = self.launcher.session_for(replica_id)
        if active is not None:
            if replica_id in active.session.members:
                active.session.members.remove(replica_id)
            active.coordinator.drop_replica(replica_id)
        self.states.remove(replica_id)
        self.replicas.pop(replica_id, None)
        # failover AFTER the registry drop (requeued requests must only
        # ever be re-placed on survivors) but BEFORE the dispatcher
        # cleanup: the drain emits BatchResults for already-finished
        # generations, which would otherwise resurrect latency-model
        # entries for the dead replica
        if handle is not None and hasattr(handle, "drain_pending"):
            drained = handle.drain_pending(now)
            if self.retry_policy is not None:
                # the replica DIED with these accepted: charge the
                # retry budget + failure count; poison / exhausted
                # requests drop out here with a terminal status
                drained = self.retry_policy.filter_requeue(
                    drained, now, replica_died=True)
            by_stream: Dict[str, List[Request]] = {}
            for req in drained:
                by_stream.setdefault(req.stream_id, []).append(req)
            for sid, reqs in by_stream.items():
                self.dispatcher_for(sid).requeue(reqs)
        for d in self.dispatchers.values():
            d.subflows.pop(replica_id, None)
            d.latency_models.pop(replica_id, None)

    # ---------------------------------------------------------- dispatching -
    def dispatcher_for(self, stream_id: str) -> SubflowDispatcher:
        d = self.dispatchers.get(stream_id)
        if d is None:
            d = SubflowDispatcher(
                stream_id, self.cfg.dispatcher,
                replicas=self._stream_replicas(stream_id),
                state_of=self.states.state_of,
                promote_idle=self._promote_idle,
                combined_plan=self._combined_plan)
            self.dispatchers[stream_id] = d
        return d

    def _stream_replicas(self, stream_id: str) -> StreamReplicaView:
        """Serviceable replicas: those with the stream's model deployed —
        as a LIVE view over the registry, shared with the dispatcher.
        stream_id convention: "<model_id>" or "<model_id>/<slo-class>"."""
        return StreamReplicaView(self.replicas, stream_id.split("/")[0])

    def submit_request(self, req: Request) -> None:
        self.dispatcher_for(req.stream_id).submit(req)

    def on_batch_result(self, result: BatchResult, stream_id: str) -> None:
        d = self.dispatchers.get(stream_id)
        if d is not None:
            d.on_batch_result(result)
        active = self.launcher.session_for(result.replica_id)
        if active is not None:
            active.coordinator.observe_infer(result)

    # ------------------------------------------------------------ callbacks -
    def _promote_idle(self, now: float) -> Optional[str]:
        rid = self.states.promote_idle(now)
        if rid is None and self.cfg.enable_finetuning:
            # no IDLE spare: release a COMBINED replica from fine-tuning
            for active in list(self.launcher.sessions.values()):
                if active.session.members:
                    victim = active.session.members[0]
                    active.session.members.remove(victim)
                    active.coordinator.drop_replica(victim)
                    handle = self.replicas.get(victim)
                    if handle is not None \
                            and hasattr(handle, "abort_round"):
                        # mid-round release: the victim sheds its shadow
                        # state and serves the last published adapter
                        handle.abort_round(now)
                    if not active.session.alive:
                        self.launcher._dissolve(active, now)
                    self.states.transition(victim, ReplicaState.SERVING, now)
                    return victim
        return rid

    def _combined_plan(self, rid: str
                       ) -> Optional[Tuple[int, BivariateLatencyModel]]:
        active = self.launcher.session_for(rid)
        if active is None:
            return None
        plan = active.coordinator.plans.get(rid)
        if plan is None:
            return None
        return plan.infer_batch, active.coordinator.infer_model_for(rid)

    # ------------------------------------------------------------ the loop -
    def tick(self, now: float) -> None:
        if now >= self._next_monitor:
            for rid, h in self.replicas.items():
                self.states.observe(rid, h.utilization(now),
                                    h.queue_length(now))
            if self.cfg.enable_finetuning:
                self.states.evaluate_idle_transitions(now)
            self._next_monitor = now + self.cfg.monitor_interval
        if self.cfg.enable_finetuning:
            self.launcher.on_tick(now)
        for d in self.dispatchers.values():
            d.on_tick(now)
