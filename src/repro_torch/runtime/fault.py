"""Fault tolerance for the LIVE serving fabric: deterministic fault
injection, pump-driven health monitoring, straggler quarantine, and
request-lifecycle retry policy.

Detection source — real pump progress, not simulator attributes.  Every
successful ``LiveReplica.pump_once`` registers a heartbeat with the
``HealthMonitor`` (serving ticks also feed their wall latency to the
``StragglerWatch``); an exception escaping a pump is contained by
``ServingFabric.tick`` and reported as an immediate failure.  A replica
is declared DEAD when its pump raises, or when it misses
``max_misses`` beat windows of ``beat_timeout`` seconds — the fabric
then runs the full ``fail_replica`` path (drain + requeue + multi-tenant
adapter re-registration), so no undispatched request is ever lost.
Gross stragglers are QUARANTINED instead of killed: their pending work
is drained and requeued through the same ``drain_pending`` path, their
dispatcher subflows are suspended for a cooldown, and their latency
samples reset so a recovered replica rejoins with a clean slate.

Retry / deadline contract (``RetryPolicy``) — every re-admission after
a failover or quarantine drain consumes one unit of the request's retry
budget and pushes its ``not_before`` gate out exponentially; the SLO
clock (arrival/deadline) is NEVER extended — a retried request races
its ORIGINAL deadline.  A request whose accepting replica dies
``max_failures`` times is a poison request: it is rejected with a
terminal ``status="failed"`` instead of being requeued forever.

Publish-gate semantics — training faults must never corrupt serving.
``LiveReplica.finish_round``/``publish_adapter`` reject a non-finite
shadow tree (NaN/Inf gradients poisoned the round): the round is
aborted, the served adapter stays bit-identical at its last published
version, and the rejection is counted in
``ServeStats.nan_publishes_blocked``.  ``AdapterRegistry.update``
enforces the same invariant at the registry seam.

``FaultInjector`` drives all of the above deterministically for tests
and ``benchmarks/chaos.py``: a seeded schedule of crash / stall / oom /
nan_grads events against named replicas, hooked into
``LiveReplica.pump_once`` (crash raises, stall sleeps), ``_ingest``
(oom raises at admission) and the fused train step (nan_grads poisons
the shadow tree).
"""
from __future__ import annotations

import collections
import dataclasses
import time as _time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterController
from repro_torch.core.interfaces import Request


# =========================================================================
# Fault injection (deterministic, seeded)
# =========================================================================
class InjectedFault(RuntimeError):
    """A FaultInjector-scheduled crash surfacing inside a pump."""


class InjectedOOM(MemoryError):
    """A FaultInjector-scheduled allocator OOM at admission."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault against one replica.

    kind:
      crash      pump_once raises ``InjectedFault`` from ``at`` onward
                 (sticky: a crashed replica never pumps again)
      stall      every pump in ``[at, at + duration]`` sleeps
                 ``stall_s`` extra wall seconds (straggler injection)
      oom        admission in ``[at, at + duration]`` raises
                 ``InjectedOOM``
      nan_grads  ONE train tick at/after ``at`` poisons the session's
                 shadow tree with NaN (one-shot per event)
    """
    at: float
    replica_id: str
    kind: str
    duration: float = 0.0
    stall_s: float = 0.05


class FaultInjector:
    """Deterministic fault schedule for live replicas.

    The injector is pure bookkeeping — replicas call its hooks at the
    relevant points of their tick and the injector raises/sleeps/flags
    per the schedule.  ``injected`` logs every fired event
    ``(now, replica_id, kind)`` for telemetry and test asserts."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.at)
        self.crashed: set = set()
        self._consumed: set = set()     # one-shot events already fired
        self.injected: List[Tuple[float, str, str]] = []

    def _active(self, replica_id: str, now: float, kind: str
                ) -> Optional[FaultEvent]:
        for e in self.events:
            if e.replica_id != replica_id or e.kind != kind:
                continue
            if e.at > now:
                break                   # events are time-sorted
            if kind == "crash" or now <= e.at + max(e.duration, 0.0):
                return e
        return None

    # ---------------------------------------------------------- hooks ----
    def before_pump(self, replica_id: str, now: float) -> None:
        """Top of ``LiveReplica.pump_once``: crash raises (sticky),
        stall sleeps the scheduled straggler delay."""
        if replica_id in self.crashed \
                or self._active(replica_id, now, "crash") is not None:
            self.crashed.add(replica_id)
            self.injected.append((now, replica_id, "crash"))
            raise InjectedFault(f"{replica_id}: injected crash")
        stall = self._active(replica_id, now, "stall")
        if stall is not None:
            self.injected.append((now, replica_id, "stall"))
            _time.sleep(stall.stall_s)

    def at_admission(self, replica_id: str, now: float) -> None:
        """``LiveReplica._ingest``: scheduled allocator OOM."""
        if self._active(replica_id, now, "oom") is not None:
            self.injected.append((now, replica_id, "oom"))
            raise InjectedOOM(f"{replica_id}: injected allocator OOM")

    def poison_grads(self, replica_id: str, now: float) -> bool:
        """After a fused train tick: True exactly once per scheduled
        ``nan_grads`` event — the caller NaN-fills its shadow tree."""
        for i, e in enumerate(self.events):
            if e.replica_id == replica_id and e.kind == "nan_grads" \
                    and e.at <= now and i not in self._consumed:
                self._consumed.add(i)
                self.injected.append((now, replica_id, "nan_grads"))
                return True
        return False

    # ------------------------------------------------------- schedules ----
    @staticmethod
    def random_plan(replica_ids: Sequence[str], *, seed: int = 0,
                    horizon: float = 5.0, n_crashes: int = 1,
                    n_stalls: int = 1, n_ooms: int = 0,
                    n_nan_rounds: int = 0, stall_duration: float = 1.0,
                    stall_s: float = 0.05) -> List[FaultEvent]:
        """A seeded chaos schedule over ``replica_ids``: crashes and
        stalls land on DISTINCT replicas (so a 2-replica pool always
        keeps one survivor per event class), at deterministic times
        drawn inside the horizon."""
        rng = np.random.default_rng(seed)
        ids = list(replica_ids)
        victims = rng.permutation(len(ids))
        events: List[FaultEvent] = []
        k = 0
        for _ in range(n_crashes):
            events.append(FaultEvent(
                at=float(rng.uniform(0.2, 0.6) * horizon),
                replica_id=ids[victims[k % len(ids)]], kind="crash"))
            k += 1
        for _ in range(n_stalls):
            events.append(FaultEvent(
                at=float(rng.uniform(0.05, 0.3) * horizon),
                replica_id=ids[victims[k % len(ids)]], kind="stall",
                duration=stall_duration, stall_s=stall_s))
            k += 1
        for _ in range(n_ooms):
            events.append(FaultEvent(
                at=float(rng.uniform(0.1, 0.5) * horizon),
                replica_id=ids[victims[k % len(ids)]], kind="oom",
                duration=0.2))
            k += 1
        for _ in range(n_nan_rounds):
            events.append(FaultEvent(
                at=float(rng.uniform(0.0, 0.2) * horizon),
                replica_id=ids[victims[k % len(ids)]],
                kind="nan_grads"))
            k += 1
        return sorted(events, key=lambda e: e.at)


# =========================================================================
# Heartbeat crash detection
# =========================================================================
@dataclasses.dataclass
class Heartbeat:
    last_seen: float = 0.0
    misses: int = 0


class FailureDetector:
    """Heartbeat-based crash detection over a ClusterController.

    Detection keys off ACTUAL ``heartbeat()`` calls: a replica that
    stops beating accrues one miss per ``poll`` whose gap since the last
    beat exceeds ``timeout``, and is removed from the cluster after
    ``max_misses`` — there is no liveness back-channel (the old
    ``failed``-attribute peek made ``heartbeat()`` dead code and the
    timeout logic unreachable for real silent failures)."""

    def __init__(self, cluster: ClusterController, timeout: float = 3.0,
                 max_misses: int = 3):
        self.cluster = cluster
        self.timeout = timeout
        self.max_misses = max_misses
        self.beats: Dict[str, Heartbeat] = {}
        self.removed: List[str] = []

    def heartbeat(self, replica_id: str, now: float) -> None:
        hb = self.beats.setdefault(replica_id, Heartbeat())
        hb.last_seen = now
        hb.misses = 0

    def poll(self, now: float) -> List[str]:
        """Returns replicas declared dead this poll (and removes them).
        A replica first seen at poll time gets a grace window from
        ``now`` — registration is not a missed beat."""
        dead = []
        for rid in list(self.cluster.replicas):
            hb = self.beats.setdefault(rid, Heartbeat(last_seen=now))
            if now - hb.last_seen > self.timeout:
                hb.misses += 1
                # one miss per elapsed timeout window, not per poll
                # frequency: restart the window from this poll
                hb.last_seen = now
            if hb.misses >= self.max_misses:
                dead.append(rid)
        for rid in dead:
            self.cluster.remove_replica(rid, now)
            self.beats.pop(rid, None)
            self.removed.append(rid)
        return dead


# =========================================================================
# Straggler detection
# =========================================================================
class StragglerWatch:
    """Flags replicas whose recent batch latencies are gross outliers
    against their PEERS' medians.  Detection only — quarantine/requeue
    is the fabric's move (see module docstring)."""

    def __init__(self, threshold: float = 2.5, window: int = 32,
                 min_samples: int = 8, warmup: int = 0):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.warmup = warmup
        self.samples: Dict[str, Deque[float]] = {}
        self._seen: Dict[str, int] = {}

    def observe(self, replica_id: str, normalized_latency: float) -> None:
        # drop each replica's first ``warmup`` observations: whichever
        # replica serves a shape first pays its jit compile (seconds),
        # which would make the HEALTHY pool member look like the gross
        # outlier and quarantine the wrong replica
        seen = self._seen.get(replica_id, 0) + 1
        self._seen[replica_id] = seen
        if seen <= self.warmup:
            return
        buf = self.samples.get(replica_id)
        if buf is None:
            buf = self.samples[replica_id] = collections.deque(
                maxlen=self.window)
        buf.append(normalized_latency)

    def reset(self, replica_id: str) -> None:
        """Forget a replica's history (post-quarantine clean slate —
        stale straggler samples must not instantly re-flag it).  The
        warmup counter survives: a rehabilitated replica already paid
        its compile, so fresh evidence counts immediately."""
        self.samples.pop(replica_id, None)

    def stragglers(self) -> List[str]:
        """Replicas whose median latency exceeds ``threshold`` x the
        median of their PEERS' medians.  Peer-relative (not cluster-
        median) so the comparison works at 2 replicas and a straggler
        cannot drag the baseline toward itself; the ``peers_med > 0``
        guard keeps an all-identical / all-zero cluster from flagging
        anything (threshold x 0 is vacuous)."""
        med = {rid: float(np.median(v))
               for rid, v in self.samples.items()
               if len(v) >= self.min_samples}
        if len(med) < 2:
            return []
        out = []
        for rid, m in med.items():
            peers = [v for r, v in med.items() if r != rid]
            peers_med = float(np.median(peers))
            if peers_med > 0 and m > self.threshold * peers_med:
                out.append(rid)
        return out


# =========================================================================
# Health monitoring (the fabric's pump-driven view)
# =========================================================================
@dataclasses.dataclass
class HealthConfig:
    beat_timeout: float = 1.0       # seconds without a pump = one miss
    max_misses: int = 3             # misses before declared dead
    poll_interval: float = 0.25     # verdict cadence
    straggler_threshold: float = 3.0
    straggler_window: int = 32
    straggler_min_samples: int = 8
    straggler_warmup: int = 4       # per-replica jit-compile grace
    quarantine_cooldown: float = 1.0


class HealthMonitor:
    """Pump-progress health: ``beat`` on every successful
    ``pump_once`` (serving ticks feed latency to the StragglerWatch),
    ``failure`` on a contained pump exception, ``poll`` for verdicts.

    ``poll`` returns ``(dead, stragglers)``: replicas to fail over
    (pump raised, or ``max_misses`` beat windows elapsed silently) and
    replicas to quarantine.  The monitor tracks quarantine windows so a
    replica is neither double-quarantined nor re-flagged from stale
    samples during its cooldown."""

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self.beats: Dict[str, Heartbeat] = {}
        self.watch = StragglerWatch(
            threshold=self.cfg.straggler_threshold,
            window=self.cfg.straggler_window,
            min_samples=self.cfg.straggler_min_samples,
            warmup=self.cfg.straggler_warmup)
        self.quarantined: Dict[str, float] = {}     # rid -> until
        self.failures: List[Tuple[float, str, str]] = []
        self._pending_dead: Dict[str, str] = {}     # rid -> reason
        self._next_poll = 0.0

    # ---------------------------------------------------------- inputs ----
    def beat(self, replica_id: str, now: float,
             busy_s: Optional[float] = None) -> None:
        """One successful pump.  ``busy_s`` is the tick's wall latency
        when the pump did SERVING work — idle ticks are ~free and would
        poison the straggler medians toward zero."""
        hb = self.beats.setdefault(replica_id, Heartbeat(last_seen=now))
        hb.last_seen = now
        hb.misses = 0
        if busy_s is not None:
            self.watch.observe(replica_id, busy_s)

    def failure(self, replica_id: str, now: float, reason: str) -> None:
        """A pump raised: the replica is dead NOW — no beat-timeout
        dance."""
        self._pending_dead[replica_id] = reason
        self.failures.append((now, replica_id, reason))

    def forget(self, replica_id: str) -> None:
        """A replica left the pool (failover/scale-down): drop all its
        health state."""
        self.beats.pop(replica_id, None)
        self.quarantined.pop(replica_id, None)
        self._pending_dead.pop(replica_id, None)
        self.watch.reset(replica_id)

    # --------------------------------------------------------- verdicts ---
    def quarantine(self, replica_id: str, now: float) -> float:
        """Mark a straggler quarantined until ``now + cooldown``; its
        samples reset so it rejoins on fresh evidence.  Returns the
        release time."""
        until = now + self.cfg.quarantine_cooldown
        self.quarantined[replica_id] = until
        self.watch.reset(replica_id)
        return until

    def in_quarantine(self, replica_id: str, now: float) -> bool:
        return self.quarantined.get(replica_id, 0.0) > now

    def poll(self, now: float) -> Tuple[List[str], List[str]]:
        """(dead, stragglers) this poll.  Rate-limited by
        ``poll_interval`` except that pump failures always surface
        immediately (waiting a poll window on a dead replica only
        strands its requests)."""
        dead = list(self._pending_dead)
        self._pending_dead.clear()
        if now < self._next_poll:
            return dead, []
        self._next_poll = now + self.cfg.poll_interval
        for rid, hb in self.beats.items():
            if rid in dead:
                continue
            if now - hb.last_seen > self.cfg.beat_timeout:
                hb.misses += 1
                hb.last_seen = now
                if hb.misses >= self.cfg.max_misses:
                    dead.append(rid)
                    self.failures.append((now, rid, "missed_beats"))
        stragglers = [rid for rid in self.watch.stragglers()
                      if rid not in dead
                      and not self.in_quarantine(rid, now)]
        return dead, stragglers


# =========================================================================
# Request-lifecycle retry policy
# =========================================================================
@dataclasses.dataclass
class RetryPolicy:
    """Per-request retry budget + exponential backoff for re-admission
    after a failover or quarantine drain.

    The SLO clock is untouched: a retried request keeps its ORIGINAL
    arrival/deadline and only gains a ``not_before`` gate the
    dispatcher honors.  ``max_failures`` is the poison-request bound: a
    request whose accepting replica DIES that many times is terminally
    rejected instead of requeued forever (quarantine drains count
    toward retries but not failures — the replica survived)."""
    max_retries: int = 4
    max_failures: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0

    def __post_init__(self):
        self.retried = 0
        self.rejected: List[Request] = []
        # terminal-stays-terminal FSM shadow, armed by REPRO_SANITIZE=1
        from repro_torch.runtime.sanitize import request_sanitizer
        self._san = request_sanitizer()

    def on_requeue(self, req: Request, now: float, *,
                   replica_died: bool) -> bool:
        """Charge one re-admission.  Returns True if the request may be
        requeued; False marks it terminally failed (the caller must NOT
        requeue it)."""
        if self._san is not None:
            self._san.check_requeue(req)
        if replica_died:
            req.failures += 1
        req.retries += 1
        if req.failures >= self.max_failures:
            req.status = "failed"
            req.failed_reason = "poison"
        elif req.retries > self.max_retries:
            req.status = "failed"
            req.failed_reason = "retries_exhausted"
        if req.status == "failed":
            self.rejected.append(req)
            return False
        req.not_before = now + self.backoff_base \
            * self.backoff_factor ** (req.retries - 1)
        self.retried += 1
        return True

    def filter_requeue(self, requests: Sequence[Request], now: float, *,
                       replica_died: bool) -> List[Request]:
        """Apply the budget to a drained batch; returns the survivors
        (order preserved) with backoff gates stamped."""
        return [r for r in requests
                if self.on_requeue(r, now, replica_died=replica_died)]
