"""Discrete-event cluster simulator — the stand-in for the paper's
32×H20 testbed (DESIGN.md §8.2).

A binary-heap event loop drives: request arrivals (from data/traces),
control-plane ticks (ClusterController.tick), replica batch completions,
FL round completions, and fault injections.  All latencies come from the
replicas' analytic interference surfaces (runtime/replica.SimReplica),
which share the bivariate structure CoLLM fits (Eq. 9–10) plus noise —
the control plane never sees the ground-truth coefficients.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    action: Callable[[float], None] = dataclasses.field(compare=False)
    tag: str = dataclasses.field(compare=False, default="")


class Simulator:
    def __init__(self):
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self.processed: int = 0

    def schedule(self, time: float, action: Callable[[float], None],
                 tag: str = "") -> None:
        heapq.heappush(self._heap,
                       Event(max(time, self.now), next(self._seq),
                             action, tag))

    def schedule_every(self, period: float, action: Callable[[float], None],
                       tag: str = "", until: Optional[float] = None,
                       start: float = 0.0) -> None:
        def fire(now: float) -> None:
            action(now)
            nxt = now + period
            if until is None or nxt <= until:
                self.schedule(nxt, fire, tag)
        self.schedule(start, fire, tag)

    def run(self, until: float) -> None:
        while self._heap and self._heap[0].time <= until:
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            ev.action(ev.time)
            self.processed += 1
        self.now = until

    def peek(self) -> Optional[float]:
        return self._heap[0].time if self._heap else None
