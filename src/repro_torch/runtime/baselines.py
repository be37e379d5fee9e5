"""Baseline serving systems (paper §8.1): dLoRA-like, Shepherd-like,
vanilla PEFT, and round-robin — all running against the same SimReplica
fleet so the comparison isolates the scheduling policy.

None of the baselines fine-tune: they serve static models (constant
response quality), exactly as in the paper's evaluation.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.interfaces import BatchResult, Request
from repro_torch.core.latency_model import LinearLatencyModel


class BaseDispatcher:
    name = "base"

    def __init__(self, replicas: Dict[str, object], slo: float = 0.5):
        self.replicas = replicas
        self.slo = slo
        self.queue: Deque[Request] = collections.deque()
        self.dispatched = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free(self, rid: str, now: float) -> bool:
        r = self.replicas[rid]
        return r.busy_until <= now and not r.pending

    def _take(self, n: int) -> List[Request]:
        out = []
        while self.queue and len(out) < n:
            out.append(self.queue.popleft())
        return out

    def on_tick(self, now: float) -> None:
        raise NotImplementedError


class PEFTDispatcher(BaseDispatcher):
    """Vanilla HF-PEFT-style serving: fixed batch size, FIFO, no SLO
    awareness, no pacing."""
    name = "peft"

    def __init__(self, replicas, slo=0.5, batch_size: int = 8):
        super().__init__(replicas, slo)
        self.batch_size = batch_size

    def on_tick(self, now: float) -> None:
        for rid in self.replicas:
            if not self.queue:
                return
            if self._free(rid, now):
                batch = self._take(self.batch_size)
                if batch:
                    self.replicas[rid].submit_batch(batch, now)
                    self.dispatched += len(batch)


class RoundRobinDispatcher(BaseDispatcher):
    """Fig. 5/13 baseline: requests round-robin'd to per-replica queues
    with the same optimal batch size b* CoLLM would use — the comparison
    that isolates the value of subflow pacing."""
    name = "rr"

    def __init__(self, replicas, slo=0.5, batch_size: int = 16):
        super().__init__(replicas, slo)
        self.batch_size = batch_size
        self._rr = itertools.cycle(list(replicas))
        self.local: Dict[str, Deque[Request]] = {
            rid: collections.deque() for rid in replicas}

    def submit(self, req: Request) -> None:
        self.local[next(self._rr)].append(req)

    def on_tick(self, now: float) -> None:
        for rid, q in self.local.items():
            if q and self._free(rid, now):
                batch = []
                while q and len(batch) < self.batch_size:
                    batch.append(q.popleft())
                self.replicas[rid].submit_batch(batch, now)
                self.dispatched += len(batch)


class ShepherdDispatcher(BaseDispatcher):
    """Shepherd-like: SLO-aware, aggressively prefers large batches — a
    free replica waits (up to a slack) for the queue to fill its
    latency-feasible maximum batch before serving."""
    name = "shepherd"

    def __init__(self, replicas, slo=0.5, wait_slack_frac: float = 0.3):
        super().__init__(replicas, slo)
        self.wait_slack = slo * wait_slack_frac
        self.models: Dict[str, LinearLatencyModel] = {
            rid: LinearLatencyModel() for rid in replicas}

    def observe(self, result: BatchResult) -> None:
        m = self.models.get(result.replica_id)
        if m is not None:
            m.observe(result.batch_size, result.infer_latency)
            m.fit()

    def on_tick(self, now: float) -> None:
        # drop requests that can no longer meet their deadline
        while self.queue and self.queue[0].deadline < now:
            self.queue.popleft()
        for rid in self.replicas:
            if not self.queue:
                return
            if not self._free(rid, now):
                continue
            m = self.models[rid]
            oldest = self.queue[0]
            budget = oldest.deadline - now
            bmax = m.max_batch(budget, floor=1, cap=256) if m.fitted else 32
            if len(self.queue) >= bmax or \
                    (now - oldest.arrival) >= self.wait_slack:
                batch = self._take(bmax)
                if batch:
                    self.replicas[rid].submit_batch(batch, now)
                    self.dispatched += len(batch)


class DLoRADispatcher(BaseDispatcher):
    """dLoRA-like: per-replica queues, dynamic batch sizing under the
    SLO, periodic migration of queued requests from overloaded to
    underloaded replicas (the paper's 'adaptive request migration')."""
    name = "dlora"

    def __init__(self, replicas, slo=0.5, migrate_every: float = 1.0):
        super().__init__(replicas, slo)
        self.local: Dict[str, Deque[Request]] = {
            rid: collections.deque() for rid in replicas}
        self.models: Dict[str, LinearLatencyModel] = {
            rid: LinearLatencyModel() for rid in replicas}
        self.migrate_every = migrate_every
        self._next_migrate = 0.0
        self.migrations = 0

    def submit(self, req: Request) -> None:
        # join the shortest queue
        rid = min(self.local, key=lambda r: len(self.local[r]))
        self.local[rid].append(req)

    def observe(self, result: BatchResult) -> None:
        m = self.models.get(result.replica_id)
        if m is not None:
            m.observe(result.batch_size, result.infer_latency)
            m.fit()

    def on_tick(self, now: float) -> None:
        if now >= self._next_migrate:
            self._migrate(now)
            self._next_migrate = now + self.migrate_every
        for rid, q in self.local.items():
            while q and q[0].deadline < now:
                q.popleft()
            if q and self._free(rid, now):
                m = self.models[rid]
                budget = q[0].deadline - now
                bmax = m.max_batch(budget, floor=1, cap=256) \
                    if m.fitted else 16
                batch = []
                while q and len(batch) < bmax:
                    batch.append(q.popleft())
                self.replicas[rid].submit_batch(batch, now)
                self.dispatched += len(batch)

    def _migrate(self, now: float) -> None:
        sizes = {rid: len(q) for rid, q in self.local.items()}
        if not sizes:
            return
        mean = sum(sizes.values()) / len(sizes)
        donors = [r for r, s in sizes.items() if s > 2 * mean + 4]
        takers = [r for r, s in sizes.items() if s < mean]
        for d in donors:
            while takers and len(self.local[d]) > mean:
                t = min(takers, key=lambda r: len(self.local[r]))
                self.local[t].append(self.local[d].pop())
                self.migrations += 1
                if len(self.local[t]) >= mean:
                    takers.remove(t)
