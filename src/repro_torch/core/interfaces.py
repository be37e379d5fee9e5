"""Deadline slack, the urgency rank shared by the control plane — the
part of ``repro.core.interfaces`` the batcher's chunked-prefill
scheduler reads.  The rest of the module (the request and replica
records, ``ReplicaHandle``) comes with the live fabric slice (ROADMAP
item 2), which copies it here beside these two functions.
"""
from __future__ import annotations

from typing import Any, List, Sequence


def deadline_slack(deadline: float, now: float) -> float:
    """Remaining SLO slack ``deadline - now``; negative once the deadline
    has passed."""
    return deadline - now


def slack_order(items: Sequence[Any], now: float,
                key: Any = None) -> List[Any]:
    """``items`` sorted most urgent first by deadline slack.  ``key``
    extracts an item's deadline (default: its ``deadline`` attribute);
    ties keep the input (FCFS) order, as ``sorted`` is stable."""
    get = key if key is not None else (lambda it: it.deadline)
    return sorted(items, key=lambda it: deadline_slack(get(it), now))
