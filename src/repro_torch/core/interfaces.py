"""The control-plane ↔ data-plane seam.

CoLLM's components (Launcher / Coordinator / Dispatcher) operate on this
protocol only; ``runtime.replica`` provides two implementations:
``SimReplica`` (discrete-event, analytic latency surfaces — the paper's
testbed proxy) and ``LiveReplica`` (real PyTorch steps on the model's device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, runtime_checkable


@dataclasses.dataclass
class Request:
    """One inference request of a stream (paper §6.1)."""
    request_id: int
    stream_id: str              # requests sharing (model, SLO) form a stream
    arrival: float              # a_r
    deadline: float             # d_r
    tokens: int = 128           # output length (token-level goodput §8.1)
    dispatched: bool = False
    dispatch_time: Optional[float] = None   # when a subflow picked it up
    completed_at: Optional[float] = None
    quality: float = 0.0        # response quality when served (1/CE)
    # live serving: concrete prompt token ids ([P] int32).  None on the
    # simulator path (analytic latencies never look at content); live
    # replicas draw from their data distribution when absent.  The
    # dispatcher also reads it for prefix-cache affinity routing.
    prompt: Optional[Any] = None
    # multi-tenant serving: the registered adapter this request's tokens
    # flow through (None = base model).  The dispatcher prefers replicas
    # where the adapter is already device-resident (adapter affinity).
    adapter_id: Optional[str] = None
    # sampling configuration, threaded through to the decode tick
    # (temperature <= 0 is exact greedy — the default)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # filled by live replicas on completion: the generated token ids
    # (the multi-replica equivalence gates compare these bit-for-bit)
    output_tokens: Optional[List[int]] = None
    # --- fault-tolerance lifecycle (runtime/fault.py RetryPolicy) ---
    # retries: re-admissions after a failover/quarantine drain handed
    # the request back; failures: how many of those drains were replica
    # DEATHS with this request accepted there (the poison-request
    # signal: a request that kills every replica it lands on must stop
    # being requeued).  ``not_before`` is the exponential-backoff gate —
    # the dispatcher skips the request until the clock passes it.  The
    # SLO clock (arrival/deadline) is NEVER touched by a retry: a
    # re-admitted request keeps its original deadline.
    retries: int = 0
    failures: int = 0
    not_before: float = 0.0
    # "pending" until served or terminally rejected; "failed" is a
    # TERMINAL verdict (retry budget exhausted, poison request, missed
    # deadline) — the fabric loop stops waiting on failed requests
    status: str = "pending"
    failed_reason: Optional[str] = None

    @property
    def slo_met(self) -> bool:
        return self.completed_at is not None \
            and self.completed_at <= self.deadline

    @property
    def terminal(self) -> bool:
        """Served or terminally rejected — either way the control plane
        owes this request nothing further."""
        return self.completed_at is not None or self.status == "failed"


def deadline_slack(deadline: float, now: float) -> float:
    """Remaining SLO slack d_r - now (Eq. 13c's feasibility margin).

    Negative means the deadline has already passed.  Shared by the
    dispatcher's feasibility shedding and the batcher's chunked-prefill
    scheduler so the two rank urgency identically."""
    return deadline - now


def slack_order(items: Sequence[Any], now: float,
                key: Any = None) -> List[Any]:
    """``items`` sorted most-urgent-first by deadline slack.

    ``key`` extracts the deadline from an item (default: its
    ``deadline`` attribute).  Ties keep the input (FCFS) order —
    ``sorted`` is stable."""
    get = key if key is not None else (lambda it: it.deadline)
    return sorted(items, key=lambda it: deadline_slack(get(it), now))


@dataclasses.dataclass
class BatchResult:
    """Completion record for a dispatched batch."""
    replica_id: str
    batch_size: int
    infer_latency: float        # T_infer (processing only)
    total_latency: float        # ℓ = T_infer + T_queue
    queue_latency: float
    finished_at: float
    quality: float              # replica model quality at serve time
    tokens: int
    train_batch: int = 0        # co-running training batch (0 = none)


@dataclasses.dataclass
class TrainRoundStats:
    """Telemetry from one local FL training round (Coordinator inputs)."""
    replica_id: str
    steps: int
    train_batch: int
    infer_batch: int
    avg_step_time: float        # T_train per iteration
    loss_before: float
    loss_after: float
    noise_scale: float          # p_t
    samples: int

    @property
    def loss_reduction(self) -> float:
        """l_t — average per-iteration loss reduction."""
        return max(self.loss_before - self.loss_after, 0.0) \
            / max(self.steps, 1)


@dataclasses.dataclass
class ReplicaPressure:
    """Runtime pressure a replica exports for placement-aware routing.

    ``SimReplica`` fills the slot/queue fields from its event queue;
    ``LiveReplica`` reads them off the continuous batcher + block
    allocator (free pool blocks, reservations, prefix-cache occupancy).
    A contiguous (non-paged) replica reports ``pool_blocks == 0`` and
    full block headroom — admission there is gated by slots only.
    """
    queue_len: int = 0          # accepted but unfinished requests
    pending: int = 0            # admission-queue requests (not ingested)
    active_slots: int = 0
    total_slots: int = 0
    free_blocks: int = 0        # unreserved + unreferenced pool blocks
    reserved_blocks: int = 0    # admission-time worst-case reservations
    pool_blocks: int = 0        # allocator capacity (0 = contiguous)
    cached_blocks: int = 0      # prefix-cache retained/registered blocks
    # max requests one dispatcher fire should hand over right now
    # (None = unbounded; live replicas report their slot-wave headroom
    # so one fire never swallows a whole trace while peers sit idle)
    admit_capacity: Optional[int] = None
    # multi-tenant serving: adapter ids currently DEVICE-resident on
    # this replica's AdapterRegistry — the dispatcher routes a tenant's
    # requests here to skip the host->device adapter load (empty on
    # single-adapter replicas and the simulator)
    resident_adapters: tuple = ()
    # oversubscribed KV pool: the replica's configured oversubscription
    # fraction (0 = preemption-free worst-case reservation) and how
    # many requests it currently holds preempted off-device — a
    # non-zero count means the pool is thrashing and new work should
    # route elsewhere
    oversubscribe: float = 0.0
    preempted: int = 0

    @property
    def slot_headroom(self) -> float:
        if self.total_slots <= 0:
            return 0.0
        return (self.total_slots - self.active_slots) / self.total_slots

    @property
    def block_headroom(self) -> float:
        if self.pool_blocks <= 0:
            return 1.0              # contiguous: blocks never gate
        return self.free_blocks / self.pool_blocks

    def headroom(self) -> float:
        """Scalar placement score: how much more work this replica can
        absorb right now.  Pool headroom dominates (an exhausted pool
        backpressures admission outright), slots break ties, and a deep
        per-replica queue discounts both.  ``queue_len`` already counts
        admission-queue requests, so ``pending`` is not re-added."""
        h = min(self.block_headroom, 1.0) * (0.5 + 0.5 * self.slot_headroom)
        h /= 1.0 + self.queue_len / max(self.total_slots, 1)
        # a thrashing oversubscribed pool (requests parked off-device)
        # discounts hard: every parked request will reclaim capacity
        # the free-block count is still advertising
        return h / (1.0 + self.preempted)


@runtime_checkable
class ReplicaHandle(Protocol):
    """What the CoLLM control plane needs from a replica."""
    replica_id: str
    model_id: str

    # ---- serving -----------------------------------------------------------
    def submit_batch(self, requests: Sequence[Request], now: float) -> None:
        """Enqueue a batch for execution (completion is reported through
        the event loop / completion callbacks)."""
        ...

    def queue_length(self, now: float) -> int: ...

    def outstanding_batches(self, now: float) -> int:
        """Submitted-but-unfinished batches (the dispatcher's in-flight
        backpressure unit — §2.3 double buffering)."""
        ...

    def utilization(self, now: float) -> float:
        """Busy fraction over the last monitoring interval (the
        stand-in for nvidia-smi SM utilization — DESIGN.md §2)."""
        ...

    # ---- placement signals -------------------------------------------------
    def pressure(self, now: float) -> ReplicaPressure:
        """Runtime pressure snapshot for placement-aware routing."""
        ...

    def prefix_affinity(self, prompt: Any,
                        adapter_id: Optional[str] = None) -> int:
        """Prompt tokens this replica could serve from its prefix cache
        (0 when it has no cache or no match) — the dispatcher routes
        matching requests here to convert prefill into cache hits.
        ``adapter_id`` scopes the lookup to that tenant's cached blocks
        (cached KV is adapter-specific)."""
        ...

    # ---- elasticity / failover ---------------------------------------------
    def reclaim_queued(self, max_n: int, now: float) -> List[Request]:
        """Hand back up to ``max_n`` admission-queue requests that have
        not started executing (micro-cycle rebalancing)."""
        ...

    def drain_pending(self, now: float) -> List[Request]:
        """Failover: stop serving, free all runtime resources, and
        return every accepted-but-unfinished request so the control
        plane can requeue it on a survivor."""
        ...

    # ---- fine-tuning -------------------------------------------------------
    def set_adapter(self, adapter: Any, version: int) -> None:
        """Publish ``adapter`` as the SERVED snapshot immediately (round
        boundaries / deployment only) and discard any staged shadow."""
        ...

    def get_adapter(self) -> Any: ...

    def train_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> TrainRoundStats:
        """Run one local FL round in COMBINED mode to completion — the
        blocking convenience over the incremental session surface below
        (begin → driven ticks → finish → publish)."""
        ...

    # ---- incremental train sessions ----------------------------------------
    # The non-blocking round surface: the Launcher begins a round, the
    # fabric/simulator advances it (live replicas train one fused
    # combined_step per pump_once tick, interleaved with serving), and
    # the Launcher POLLS progress instead of blocking on train_round —
    # no round ever monopolizes the device.
    def begin_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> None:
        """Start one local FL round as an incremental session.  Live
        replicas stage a SHADOW copy of the published adapter for the
        optimizer to train; serving keeps reading the published snapshot
        untouched for the whole round."""
        ...

    def round_progress(self, now: float) -> float:
        """Fraction of the active round completed in [0, 1]; 1.0 when no
        session is active."""
        ...

    def finish_round(self, now: float) -> TrainRoundStats:
        """Close the completed session and return its measured stats
        (Coordinator inputs: T_train, losses, noise scale p_t)."""
        ...

    def publish_adapter(self) -> int:
        """Atomically swap the trained shadow into the published slot
        (round boundaries only); returns the served adapter version."""
        ...

    def abort_round(self, now: float) -> None:
        """§8.2 suspension: discard the session + shadow state; the
        served adapter stays at the last published version."""
        ...

    # ---- quality -----------------------------------------------------------
    def quality_score(self, now: float) -> float:
        """Served response quality = 1 / CE-loss (paper §8.1)."""
        ...
