"""Subflow-based Request Dispatcher (paper §6).

Transforms the bursty arrival stream into per-replica *subflows*, each
pacing batched requests at the replica's Ideal Serving Mode (§2.3:
t(b*) = τ', b* = λ·τ').  Two-phase control:

  macro-cycle (T_fit):    refit the exclusive latency model T(b)=αb+β
                          from served batches (Eq. 14), derive the
                          execution budget τ' = τ − T̄_queue (Eq. 15) and
                          the batch bound b_max = ⌊(τ'−β)/α⌋ (Eq. 16);
                          COMBINED replicas take b_max = b* from the
                          Coordinator and pace with the bivariate model
                          (Eq. 10).  Overload mitigation: T̄_queue ≥ τ−β
                          promotes an IDLE replica and resets T̄_queue
                          to 0.1τ.
  micro-cycle (T_adjust): per-subflow quality-aware reallocation using
                          unsaturation u_i (Eq. 17) and priority
                          Q_i·(1+u_i) (Eq. 18–19), with smoothing
                          bounds, plus queued-request rebalancing:
                          admission-queue work reclaimed from
                          overloaded replicas when a peer is starved.

Placement-aware firing: due subflows drain the stream queue in replica
*headroom* order (``ReplicaHandle.pressure`` — free pool blocks, free
slots, queue depth; least-loaded fallback), each fire is clamped to the
replica's slot-wave ``admit_capacity``, and a request whose prompt
matches a replica's registered prefix-cache chains
(``prefix_affinity``) is routed there so its prefill becomes a cache
hit.

Deviation note: the paper's smoothing range [min(0.5b,2), max(1.5b,b_max)]
has a vacuous upper bound whenever b_max > 1.5b; we use
[max(1, 0.5·b_prev), min(ceil(1.5·b_prev)+1, b_max)] which enforces the
stated intent ("prevent abrupt shifts") in both directions.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.interfaces import (
    BatchResult, ReplicaHandle, ReplicaPressure, Request, deadline_slack,
)
from repro_torch.core.latency_model import BivariateLatencyModel, LinearLatencyModel
from repro_torch.core.states import ReplicaState


@dataclasses.dataclass
class Subflow:
    replica_id: str
    stream_id: str
    batch_size: int = 4            # b_i
    interval: float = 0.25         # I_i
    next_fire: float = 0.0
    b_max: int = 64
    history: Deque[Tuple[int, int]] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64))  # (target, got)

    def unsaturation(self) -> float:
        """Eq. 17 — mean underfill fraction over the micro window."""
        if not self.history:
            return 0.0
        vals = [(t - g) / t for t, g in self.history if t > 0]
        return sum(vals) / max(len(vals), 1)


@dataclasses.dataclass
class DispatcherConfig:
    slo: float = 0.5               # τ (0.5 s per request, §8.1)
    t_fit: float = 10.0            # macro-cycle period
    t_adjust: float = 2.0          # micro-cycle period
    queue_window: int = 64         # samples for T̄_queue
    default_interval: float = 0.25
    min_batch: int = 1
    max_batch: int = 64
    bootstrap_b_max: int = 8       # cap until the latency model has fit
    in_flight_limit: int = 1       # batches outstanding per replica
    overload_check: float = 1.0    # seconds between backlog checks


class SubflowDispatcher:
    """One dispatcher per request stream (same model + same SLO)."""

    def __init__(self, stream_id: str, cfg: DispatcherConfig,
                 replicas: Dict[str, ReplicaHandle],
                 state_of: Callable[[str], ReplicaState],
                 promote_idle: Callable[[float], Optional[str]],
                 combined_plan: Callable[
                     [str], Optional[Tuple[int, BivariateLatencyModel]]]
                 = lambda rid: None) -> None:
        self.stream_id = stream_id
        self.cfg = cfg
        self.replicas = replicas
        self.state_of = state_of
        self.promote_idle = promote_idle
        self.combined_plan = combined_plan

        self.queue: Deque[Request] = collections.deque()
        self.subflows: Dict[str, Subflow] = {}
        # quarantined stragglers: rid -> suspension end; suspended
        # replicas keep their subflow/latency state but receive no
        # traffic until the clock passes the mark
        self.suspended: Dict[str, float] = {}
        self.latency_models: Dict[str, LinearLatencyModel] = {}
        self.queue_lat: Deque[float] = collections.deque(
            maxlen=cfg.queue_window)
        self._queue_lat_reset: Optional[float] = None
        self.next_fit = 0.0
        self.next_adjust = 0.0
        self.next_overload_check = 0.0
        # accounting
        self.dispatched = 0
        self.dropped = 0
        self.overload_promotions = 0
        self.affinity_routed = 0       # requests placed by prefix affinity
        self.adapter_routed = 0        # requests placed by adapter residency
        self.rebalanced = 0            # requests reclaimed + requeued

    # ---------------------------------------------------------- ingestion --
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def requeue(self, requests: Sequence[Request]) -> None:
        """Return requests to the FRONT of the stream queue, preserving
        their order — failover re-queue and micro-cycle rebalancing hand
        back the oldest waiting work, which must not lose its place."""
        for r in reversed(list(requests)):
            r.dispatched = False
            r.dispatch_time = None
            self.queue.appendleft(r)

    def queue_depth(self) -> int:
        return len(self.queue)

    # ----------------------------------------------------------- eligibility
    def suspend_replica(self, replica_id: str, until: float) -> None:
        """Quarantine: exclude a replica from routing until ``until``
        (straggler cooldown).  State/subflow survive — quarantine is a
        traffic decision, not membership."""
        self.suspended[replica_id] = max(
            self.suspended.get(replica_id, 0.0), until)

    def _active_replicas(self, now: float) -> List[str]:
        return [rid for rid in self.replicas
                if self.state_of(rid) in (ReplicaState.SERVING,
                                          ReplicaState.COMBINED)
                and self.suspended.get(rid, 0.0) <= now]

    def _ensure_subflow(self, rid: str, now: float) -> Subflow:
        sf = self.subflows.get(rid)
        if sf is None:
            sf = Subflow(replica_id=rid, stream_id=self.stream_id,
                         interval=self.cfg.default_interval,
                         next_fire=now, b_max=self.cfg.bootstrap_b_max)
            self.subflows[rid] = sf
            self.latency_models.setdefault(rid, LinearLatencyModel())
        return sf

    # ------------------------------------------------------------- telemetry
    def on_batch_result(self, result: BatchResult) -> None:
        """Completion feedback: feeds Eq. 14 fits and T̄_queue."""
        m = self.latency_models.setdefault(result.replica_id,
                                           LinearLatencyModel())
        if result.train_batch == 0:
            m.observe(result.batch_size, result.infer_latency)
        self.queue_lat.append(result.queue_latency)

    def avg_queue_latency(self) -> float:
        if self._queue_lat_reset is not None:
            return self._queue_lat_reset
        if not self.queue_lat:
            return 0.0
        return sum(self.queue_lat) / len(self.queue_lat)

    # ------------------------------------------------------------ the loop -
    def on_tick(self, now: float) -> None:
        if now >= self.next_fit:
            self.macro_cycle(now)
            self.next_fit = now + self.cfg.t_fit
        if now >= self.next_adjust:
            self.micro_cycle(now)
            self.next_adjust = now + self.cfg.t_adjust
        if now >= self.next_overload_check:
            self._overload_pressure(now)
            self.next_overload_check = now + self.cfg.overload_check
        self._fire_due_subflows(now)
        self._expire_requests(now)

    def _overload_pressure(self, now: float) -> None:
        """Fast-path overload mitigation (§6.2): when the stream queue
        holds more than ~one SLO period of the active capacity, promote
        an IDLE (or, via the controller fallback, release a COMBINED)
        replica immediately rather than waiting for the macro cycle."""
        active = self._active_replicas(now)
        capacity = sum(self._ensure_subflow(r, now).b_max for r in active)
        if len(self.queue) > max(capacity, 1):
            promoted = self.promote_idle(now)
            if promoted is not None:
                self.overload_promotions += 1
                self._ensure_subflow(promoted, now)

    # -------------------------------------------------------- subflow firing
    def _pressure_of(self, rid: str, now: float
                     ) -> Optional[ReplicaPressure]:
        handle = self.replicas[rid]
        return handle.pressure(now) if hasattr(handle, "pressure") \
            else None

    def _headroom(self, rid: str, now: float,
                  pressure: Optional[ReplicaPressure]) -> float:
        """Placement score for routing order: runtime pressure when the
        replica exports it (free pool blocks / slots / queue depth),
        least-loaded fallback for handles without pressure signals."""
        if pressure is not None:
            return pressure.headroom()
        return 1.0 / (1.0 + self.replicas[rid].queue_length(now))

    def _select_batch(self, rid: str, target: int, now: float,
                      pred: float,
                      pressure: Optional[ReplicaPressure] = None
                      ) -> List[Request]:
        """Pull up to ``target`` feasible requests from the stream queue
        for ``rid``.  Placement-aware: a request whose prompt matches
        the replica's registered prefix-cache chains jumps the scan
        window (its prefill becomes a cache hit *on this replica*), and
        so does a request whose ``adapter_id`` is already DEVICE-
        resident on the replica's AdapterRegistry (admission skips the
        host->device adapter load); everything else stays FCFS.
        Scanned requests that cannot meet their deadline are shed
        (Eq. 13c)."""
        if not self.queue:
            return []
        handle = self.replicas[rid]
        q = list(self.queue)
        order: Sequence[int] = range(len(q))
        prefix_hits: set = set()
        adapter_hits: set = set()
        resident = set(pressure.resident_adapters) \
            if pressure is not None else set()
        probe_prefix = hasattr(handle, "prefix_affinity")
        if probe_prefix or resident:
            lookahead = min(len(q), max(4 * target, 16))
            for i in range(lookahead):
                if probe_prefix and q[i].prompt is not None \
                        and handle.prefix_affinity(
                            q[i].prompt,
                            adapter_id=q[i].adapter_id) > 0:
                    prefix_hits.add(i)
                elif q[i].adapter_id is not None \
                        and q[i].adapter_id in resident:
                    adapter_hits.add(i)
            if prefix_hits or adapter_hits:
                # prefix hits outrank adapter hits: a cached prefix
                # saves prefill compute, residency only a weight load
                hits = sorted(prefix_hits) \
                    + sorted(adapter_hits - prefix_hits)
                hit_set = set(hits)
                order = hits + [i for i in range(len(q))
                                if i not in hit_set]
        batch: List[Request] = []
        taken: set = set()
        for i in order:
            if len(batch) >= target:
                break
            r = q[i]
            if r.not_before > now:
                # retry backoff gate: the request stays queued (keeps
                # its place) but is not dispatchable yet
                continue
            if deadline_slack(r.deadline, now) < pred:
                self._shed(r)
                taken.add(i)
                continue
            r.dispatched = True
            r.dispatch_time = now
            batch.append(r)
            taken.add(i)
            if i in prefix_hits:
                self.affinity_routed += 1
            elif i in adapter_hits:
                self.adapter_routed += 1
        if taken:
            self.queue = collections.deque(
                q[i] for i in range(len(q)) if i not in taken)
        return batch

    def _fire_due_subflows(self, now: float) -> None:
        due: List[str] = []
        for rid in self._active_replicas(now):
            sf = self._ensure_subflow(rid, now)
            if now < sf.next_fire:
                continue
            # Ideal Serving Mode backpressure: at most ``in_flight_limit``
            # batches outstanding (double buffering) — pacing must match
            # the processing envelope, never stack backlog (§2.3).
            handle = self.replicas[rid]
            outstanding = handle.outstanding_batches(now) \
                if hasattr(handle, "outstanding_batches") \
                else handle.queue_length(now)
            if outstanding >= self.cfg.in_flight_limit:
                # "at most in_flight_limit outstanding": firing now
                # would make outstanding+1 — with the default limit of
                # 1 the old ``>`` stacked a third batch behind two
                sf.next_fire = now + min(sf.interval, 0.05)
                continue
            due.append(rid)
        # placement-aware routing: due replicas drain the stream queue
        # in headroom order — pool/slot headroom first, least-loaded as
        # the fallback — so the queue head lands where admission will
        # not backpressure it
        pressures = {rid: self._pressure_of(rid, now) for rid in due}
        if len(due) > 1:
            due.sort(key=lambda r: -self._headroom(r, now, pressures[r]))
        for rid in due:
            sf = self.subflows[rid]
            target = max(self.cfg.min_batch,
                         min(sf.batch_size, sf.b_max))
            p = pressures[rid]
            if p is not None and p.admit_capacity is not None:
                # a live replica's fire is capped at its slot-wave
                # headroom: never hand one replica more than it can
                # start on while peers sit idle
                if p.admit_capacity < 1:
                    sf.next_fire = now + min(sf.interval, 0.05)
                    continue
                target = min(target, p.admit_capacity)
            if p is not None and p.preempted > 0:
                # thrashing oversubscribed pool: requests are parked
                # off-device waiting for capacity — feeding full fires
                # here only deepens the swap churn, so halve the hand
                # per parked request (floor 1 keeps the subflow alive)
                target = max(1, target // (1 + p.preempted))
            # feasibility shedding (Eq. 13c): a request whose deadline
            # cannot be met by this batch contributes nothing — drop it
            # rather than burn capacity serving it late.
            m = self.latency_models[rid]
            pred = m.predict(target) if m.fitted else 0.0
            had_demand = bool(self.queue)
            batch = self._select_batch(rid, target, now, pred,
                                       pressure=p)
            if had_demand:
                # Eq. 17's u_i measures the replica's unsaturation, not
                # the stream's: an empty queue at fire time says nothing
                # about capacity, and recording (target, 0) would inflate
                # u_i and skew micro-cycle priorities toward idle streams
                sf.history.append((target, len(batch)))
            if batch:
                self.replicas[rid].submit_batch(batch, now)
                self.dispatched += len(batch)
            # pace at the replica's processing envelope: I = α·b_actual+β
            b_eff = max(len(batch), 1)
            interval = m.predict(b_eff) if m.fitted \
                else self.cfg.default_interval
            sf.interval = max(min(interval, self.cfg.slo), 1e-3)
            sf.next_fire = now + sf.interval

    def _shed(self, req: Request) -> None:
        """Deadline shed (Eq. 13c): the drop is TERMINAL — stamping the
        status lets the fabric's run loop stop waiting on a request
        that will never complete."""
        req.status = "failed"
        req.failed_reason = "deadline"
        self.dropped += 1

    def _expire_requests(self, now: float) -> None:
        """Requests past their deadline cannot contribute (Eq. 13c) —
        count and drop so they stop occupying capacity."""
        while self.queue and deadline_slack(self.queue[0].deadline, now) < 0:
            self._shed(self.queue.popleft())

    # ------------------------------------------------------------ macro ----
    def macro_cycle(self, now: float) -> None:
        self._queue_lat_reset = None
        tq = self.avg_queue_latency()
        budget = self.cfg.slo - tq                      # Eq. 15
        # stream-level overload mitigation (Eq. 15 margin exhausted):
        # T̄_queue ≥ τ − β ⇒ activate extra capacity, reset T̄_queue := 0.1τ
        betas = [m.beta for m in self.latency_models.values() if m.fitted]
        beta_ref = min(betas) if betas else 0.0
        if tq >= self.cfg.slo - beta_ref and tq > 0:
            promoted = self.promote_idle(now)
            if promoted is not None:
                self.overload_promotions += 1
                self._ensure_subflow(promoted, now)
                self._queue_lat_reset = 0.1 * self.cfg.slo
                # drop the pre-promotion samples too: once the override
                # expires (next macro cycle) a stale window would read
                # as the SAME overload and re-promote immediately —
                # T̄_queue must be re-measured with the new capacity
                self.queue_lat.clear()
                budget = self.cfg.slo - self.avg_queue_latency()
        for rid in self._active_replicas(now):
            sf = self._ensure_subflow(rid, now)
            plan = self.combined_plan(rid) \
                if self.state_of(rid) is ReplicaState.COMBINED else None
            if plan is not None:
                b_star, bivar = plan
                b_cap = int(b_star)
                # until the bivariate model has sample support (bootstrap
                # round), respect the exclusive-model SLO bound so the
                # conservative-start property of §5.2 actually holds
                m0 = self.latency_models[rid]
                if not bivar.fitted and m0.fitted:
                    b_cap = min(b_cap, m0.max_batch(
                        max(budget, 0.05) * 0.9, floor=self.cfg.min_batch,
                        cap=self.cfg.max_batch))
                sf.b_max = max(self.cfg.min_batch,
                               min(b_cap, self.cfg.max_batch))
                # pace with the interference model (Eq. 10)
                train_b = getattr(self.replicas[rid], "train_batch", 0)
                sf.interval = max(
                    min(bivar.predict(sf.batch_size, train_b),
                        self.cfg.slo), 1e-3) if bivar.fitted \
                    else sf.interval
                continue
            m = self.latency_models[rid]
            m.fit()
            if m.fitted:
                sf.b_max = m.max_batch(max(budget, 0.05),
                                       floor=self.cfg.min_batch,
                                       cap=self.cfg.max_batch)
            else:
                sf.b_max = self.cfg.bootstrap_b_max

    # ------------------------------------------------------------ micro ----
    def micro_cycle(self, now: float) -> None:
        active = self._active_replicas(now)
        if not active:
            return
        flows = [self._ensure_subflow(rid, now) for rid in active]
        total_cap = sum(sf.b_max for sf in flows)
        prios = []
        for rid, sf in zip(active, flows):
            q = max(self.replicas[rid].quality_score(now), 1e-6)
            prios.append(q * (1.0 + sf.unsaturation()))      # Eq. 18
        psum = sum(prios) or 1.0
        for sf, p in zip(flows, prios):
            raw = total_cap * p / psum                       # Eq. 19
            prev = sf.batch_size
            lo = max(self.cfg.min_batch, int(0.5 * prev))
            hi = max(lo, min(int(math.ceil(1.5 * prev)) + 1, sf.b_max))
            sf.batch_size = int(min(max(raw, lo), hi))
        self._rebalance_queued(active, flows, now)

    def _rebalance_queued(self, active: List[str], flows: List[Subflow],
                          now: float) -> None:
        """Micro-cycle request rebalancing: when any active replica is
        starved (empty admission queue, free slots) while another holds
        more queued work than its next batch can absorb, the excess is
        reclaimed back to the stream queue — the next fires re-place it
        by headroom, so a routing mistake never strands requests behind
        one slow replica."""
        if len(active) < 2:
            return
        pressures = {rid: self._pressure_of(rid, now) for rid in active}
        starved = any(p is not None and p.pending == 0
                      and p.slot_headroom > 0.0
                      for p in pressures.values())
        if not starved:
            return
        for rid, sf in zip(active, flows):
            p = pressures[rid]
            h = self.replicas[rid]
            if p is None or not hasattr(h, "reclaim_queued"):
                continue
            excess = p.pending - sf.batch_size
            if excess > 0:
                back = h.reclaim_queued(excess, now)
                if back:
                    self.requeue(back)
                    self.rebalanced += len(back)
