"""Opt-in shadow-state sanitizers for the port's serving runtime
(reprosan) — the port's own copy of ``repro.runtime.sanitize`` (numpy
only), with the same checks and the same ``[reprosan:<check>]``
diagnostics.

``REPRO_SANITIZE=1`` arms thin instrumentation points inside the
hand-maintained correctness regimes of the runtime — the invariants
that are otherwise enforced only by convention and review:

  BlockSanitizer     mirrors ``runtime.paging.BlockAllocator``: an
                     independent shadow refcount/reservation ledger is
                     advanced on every allocator mutation and
                     cross-checked against the allocator, plus
                     decode-wave checks over the batcher's block
                     tables — use-after-free gather, use-after-swap
                     gather of a chain whose contents were swapped to
                     host (preemption), write into a shared
                     (refcount > 1) block without copy-on-write, an
                     active slot writing scratch block 0, and
                     reservation leaks at eviction/drain.
  AdapterSanitizer   mirrors the ``AdapterRegistry`` residency state:
                     decode-wave reads of a refcount-0 / non-resident /
                     mid-publish tenant slot, LRU eviction of a tenant
                     with live refs, release-without-acquire, and
                     version regression at publish.
  RequestLifecycle   a per-batcher FSM over ``GenRequest`` objects
                     (queued -> active -> finished, drain -> requeue):
                     flags double submission, decode of an evicted or
                     never-admitted slot, and replay of a terminal
                     (finished) request.
  RequestFSM         the control-plane twin: a TERMINAL ``Request``
                     (served, or status == "failed") handed back to a
                     retry policy's requeue is a lifecycle bug.  Its
                     caller, the fabric's ``RetryPolicy``, comes with
                     the live fabric (ROADMAP item 2).

Every check raises ``SanitizeError`` with a precise diagnostic (and
records it in ``reports()`` for telemetry).  When the env var is unset
the factory helpers return ``None`` and the instrumented call sites
reduce to one ``is not None`` test — no hot-path cost when off.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def enabled() -> bool:
    """True iff shadow-state sanitizers are armed for this process."""
    return os.environ.get("REPRO_SANITIZE", "") == "1"


class SanitizeError(AssertionError):
    """A hand-maintained runtime invariant was violated (reprosan)."""


_REPORTS: List[str] = []


def reports() -> List[str]:
    """Every diagnostic raised so far in this process (telemetry)."""
    return list(_REPORTS)


def _fail(check: str, msg: str) -> None:
    diag = f"[reprosan:{check}] {msg}"
    _REPORTS.append(diag)
    raise SanitizeError(diag)


# =========================================================================
# Block pool shadow state
# =========================================================================
class BlockSanitizer:
    """Shadow ledger mirroring one ``BlockAllocator`` plus decode-wave
    checks over the owning batcher's slot/block tables.

    The mirror is advanced by the allocator's own mutation hooks
    (``on_take``/``on_free``/...) so a divergence between mirror and
    allocator pinpoints a refcount-accounting bug inside the allocator;
    the wave checks consume the batcher's view (``slot_blocks``,
    ``slot_pos``, ``slot_reserved``) so a divergence there pinpoints
    allocator *misuse* by the runtime (skipped COW, stale table)."""

    def __init__(self, alloc: Any):
        self.alloc = alloc
        self.ref = np.zeros(alloc.n_blocks, np.int64)
        self.reserved = 0
        # blocks whose CONTENTS left the device (preemption swap-out):
        # free-list members whose bytes live host-side until a swap_in
        # re-takes fresh blocks — gathering one before then is a
        # use-after-swap, distinct from plain use-after-free
        self.swapped: set = set()
        self.pinned: set = set()

    # ------------------------------------------------- allocator hooks --
    def on_reserve(self, n: int) -> None:
        self.reserved += n

    def on_release(self, n: int) -> None:
        if n > self.reserved:
            _fail("reservation-underflow",
                  f"release({n}) exceeds shadow reservation "
                  f"{self.reserved}")
        self.reserved -= n

    def on_take(self, ids: List[int]) -> None:
        for b in ids:
            if self.ref[b] != 0:
                _fail("double-hand-out",
                      f"take handed out block {b} with shadow refcount "
                      f"{int(self.ref[b])} (still referenced)")
            self.ref[b] = 1
            # a re-taken block is a fresh allocation: its new owner
            # overwrites the contents, so the swapped/pinned marks from
            # its previous life are cleared (reclaim discards the
            # allocator pin without an unpin hook)
            self.swapped.discard(b)
            self.pinned.discard(b)
        self.reserved -= len(ids)
        if self.reserved < 0:
            _fail("reservation-underflow",
                  f"take({len(ids)}) drove the shadow reservation "
                  f"negative ({self.reserved})")

    def on_acquire(self, ids: List[int]) -> None:
        for b in ids:
            self.ref[b] += 1

    def on_share(self, ids: List[int]) -> None:
        for b in ids:
            if self.ref[b] < 1:
                _fail("share-of-free",
                      f"share aliased block {b} with shadow refcount 0")
            self.ref[b] += 1

    def on_free(self, ids: List[int]) -> None:
        for b in ids:
            if self.ref[b] < 1:
                _fail("double-free",
                      f"free of block {b} with shadow refcount 0")
            self.ref[b] -= 1

    def on_swap_out(self, ids: List[int]) -> None:
        for b in ids:
            if self.ref[b] != 1:
                _fail("swap-out-shared",
                      f"swap-out of block {b} with shadow refcount "
                      f"{int(self.ref[b])} — only a sole-referenced "
                      "private block may leave the device")
            if b in self.pinned:
                _fail("swap-out-pinned",
                      f"swap-out of pinned (prefix-cached) block {b} — "
                      "registered blocks stay pool-resident")
            self.ref[b] = 0
            self.swapped.add(b)

    def on_swap_in(self, ids: List[int]) -> None:
        # fresh blocks scattered from host copies are live again
        # (``on_take`` already cleared any stale swapped marks)
        self.swapped.difference_update(ids)

    def on_pin(self, bid: int) -> None:
        if self.ref[bid] < 1:
            _fail("pin-of-free",
                  f"pin of block {bid} with shadow refcount "
                  f"{int(self.ref[bid])} — only live blocks may be "
                  "registered")
        self.pinned.add(bid)

    def on_unpin(self, bid: int) -> None:
        self.pinned.discard(bid)

    # ---------------------------------------------------- wave checks --
    def _check_mirror(self) -> None:
        """Mirror-vs-allocator cross-check: any drift means the
        allocator's own ledger went wrong (not just its callers)."""
        if self.reserved != self.alloc.reserved:
            _fail("reservation-drift",
                  f"shadow reservation {self.reserved} != allocator "
                  f"reservation {self.alloc.reserved}")
        theirs = np.asarray(self.alloc._ref, np.int64)
        if not np.array_equal(self.ref, theirs):
            bad = np.nonzero(self.ref != theirs)[0][:8]
            _fail("refcount-drift",
                  "shadow refcounts diverged from allocator at blocks "
                  f"{bad.tolist()} (shadow "
                  f"{self.ref[bad].tolist()} vs allocator "
                  f"{theirs[bad].tolist()})")
        if self.pinned != set(self.alloc._pinned):
            _fail("pin-drift",
                  "shadow pin set diverged from allocator: shadow-only "
                  f"{sorted(self.pinned - set(self.alloc._pinned))[:8]} "
                  "allocator-only "
                  f"{sorted(set(self.alloc._pinned) - self.pinned)[:8]}")

    def check_decode_wave(self, batcher: Any, active: List[int]) -> None:
        """Pre-decode: every gathered block must be live, every write
        target must be private (COW done) and non-scratch, and the
        reservation ledger must balance across slots."""
        self._check_mirror()
        alloc = self.alloc
        for i in active:
            blocks = batcher.slot_blocks[i]
            for b in blocks:
                # swapped-out first: the block IS refcount-0, but the
                # precise diagnosis is that its contents left the
                # device — restore must swap_in before decoding
                if b in self.swapped:
                    _fail("use-after-swap",
                          f"slot {i} decode wave gathers block {b} "
                          "whose contents were swapped out to host — "
                          "the chain must swap_in (fresh blocks + "
                          "scatter) before it decodes")
                if alloc.ref(b) < 1:
                    _fail("use-after-free-gather",
                          f"slot {i} decode wave gathers block {b} with "
                          f"refcount {alloc.ref(b)} (freed or retained "
                          "content)")
            wr = int(batcher.slot_pos[i]) % batcher.ring_len
            bidx = wr // batcher.block_size
            if bidx >= len(blocks):
                _fail("table-underflow",
                      f"slot {i} writes position {wr} (block index "
                      f"{bidx}) beyond its {len(blocks)}-block table")
            wb = blocks[bidx]
            if wb < alloc.n_scratch:
                _fail("scratch-write",
                      f"slot {i} (active) would write scratch block "
                      f"{wb} — its KV would be silently shared with "
                      "every dead lane")
            if alloc.ref(wb) > 1:
                _fail("shared-write",
                      f"slot {i} writes block {wb} with refcount "
                      f"{alloc.ref(wb)} (> 1) — copy-on-write was "
                      "skipped; sharers would observe torn KV")
        total = int(np.sum(batcher.slot_reserved))
        if alloc.reserved != total:
            _fail("reservation-leak",
                  f"allocator holds {alloc.reserved} reserved blocks "
                  f"but slots account for {total}")

    def check_evicted(self, batcher: Any, slot: int) -> None:
        """Post-eviction: the slot must hold no blocks, no reservation,
        and its table row must be parked on scratch."""
        if batcher.slot_blocks[slot]:
            _fail("eviction-block-leak",
                  f"slot {slot} evicted but still maps blocks "
                  f"{batcher.slot_blocks[slot]}")
        if int(batcher.slot_reserved[slot]) != 0:
            _fail("reservation-leak",
                  f"slot {slot} evicted with "
                  f"{int(batcher.slot_reserved[slot])} reserved blocks "
                  "never released")
        if int(np.max(batcher.block_tables[slot])) != 0:
            _fail("eviction-table-leak",
                  f"slot {slot} evicted but its table row still points "
                  "at pool blocks")

    def check_quiescent(self, batcher: Any) -> None:
        """Post-drain: nothing may stay referenced or reserved (retained
        prefix-cache blocks are refcount-0 by definition)."""
        self._check_mirror()
        if self.alloc.reserved != 0:
            _fail("reservation-leak",
                  f"drained batcher leaks {self.alloc.reserved} "
                  "reserved blocks")
        if self.alloc.n_used != 0:
            _fail("drain-block-leak",
                  f"drained batcher leaks {self.alloc.n_used} "
                  "referenced pool blocks")


# =========================================================================
# Adapter registry shadow state
# =========================================================================
class AdapterSanitizer:
    """Shadow residency/refcount/version ledger for one
    ``AdapterRegistry`` plus decode-wave read checks."""

    def __init__(self) -> None:
        self.refs: Dict[str, int] = {}
        self.versions: Dict[str, int] = {}
        self.resident: set = set()
        self.publishing: set = set()

    # ------------------------------------------------- registry hooks --
    def on_register(self, aid: str, version: int) -> None:
        self.versions[aid] = version

    def on_unregister(self, aid: str) -> None:
        if self.refs.get(aid, 0) > 0:
            _fail("unregister-live",
                  f"adapter {aid!r} unregistered with "
                  f"{self.refs[aid]} live refs")
        self.refs.pop(aid, None)
        self.versions.pop(aid, None)
        self.resident.discard(aid)

    def on_acquire(self, aid: str) -> None:
        self.refs[aid] = self.refs.get(aid, 0) + 1
        self.resident.add(aid)

    def on_release(self, aid: str) -> None:
        if self.refs.get(aid, 0) <= 0:
            _fail("release-without-acquire",
                  f"adapter {aid!r} released with shadow refcount 0")
        self.refs[aid] -= 1

    def on_evict(self, aid: str) -> None:
        """LRU eviction of a cold tenant: refs must be exactly 0 —
        evicting a pinned tenant would rip the weights out from under
        its in-flight rows."""
        if self.refs.get(aid, 0) != 0:
            _fail("evict-live-refs",
                  f"adapter {aid!r} evicted with {self.refs[aid]} "
                  "live refs (in-flight rows still index its slot)")
        self.resident.discard(aid)

    def begin_publish(self, aid: str, version: Optional[int]) -> None:
        if version is not None and version < self.versions.get(aid, 0):
            _fail("version-regression",
                  f"adapter {aid!r} publish at version {version} after "
                  f"version {self.versions[aid]} was already served")
        self.publishing.add(aid)

    def end_publish(self, aid: str, version: Optional[int]) -> None:
        self.publishing.discard(aid)
        if version is not None:
            self.versions[aid] = version

    # ---------------------------------------------------- wave checks --
    def check_decode_wave(self, batcher: Any, active: List[int]) -> None:
        reg = batcher.adapters
        for i in active:
            aid = batcher.slot_aid[i]
            if aid is None:
                continue
            if reg.refcount(aid) < 1:
                _fail("refcount0-read",
                      f"slot {i} decodes through adapter {aid!r} with "
                      "registry refcount 0 — its slot can be evicted "
                      "mid-wave")
            if reg.slot_index(aid) < 0:
                _fail("non-resident-read",
                      f"slot {i} decodes through adapter {aid!r} which "
                      "is not device-resident")
            if aid in self.publishing:
                _fail("mid-publish-read",
                      f"slot {i} decodes through adapter {aid!r} while "
                      "its slot publish is in flight (torn weights)")


# =========================================================================
# Request lifecycle FSMs
# =========================================================================
_QUEUED, _ACTIVE, _FINISHED, _DRAINED = ("queued", "active", "finished",
                                         "drained")


class RequestLifecycle:
    """Per-batcher FSM over ``GenRequest`` objects.

    Legal transitions::

        (new) ───────────── submit ──> queued
        drained ─────────── submit ──> queued      (failover resubmit)
        queued ──────────── admit ───> active
        queued/active ───── finish ──> finished    (finish-at-admission)
        queued/active ───── drain ───> drained
        finished ────────── *  ──────> ERROR       (terminal replay)

    Keyed by object identity with a strong reference held (sanitizers
    trade memory for certainty), so a recycled ``id()`` can never
    alias two requests."""

    def __init__(self) -> None:
        self._state: Dict[int, Tuple[Any, str]] = {}

    def _get(self, req: Any) -> Optional[str]:
        entry = self._state.get(id(req))
        return entry[1] if entry is not None else None

    def _set(self, req: Any, state: str) -> None:
        self._state[id(req)] = (req, state)

    def on_submit(self, req: Any) -> None:
        prev = self._get(req)
        if prev == _FINISHED:
            _fail("terminal-replay",
                  f"request {req.request_id} resubmitted after it "
                  "finished — a terminal request must never re-enter "
                  "the queue")
        if prev in (_QUEUED, _ACTIVE):
            _fail("double-submit",
                  f"request {req.request_id} submitted while already "
                  f"{prev}")
        self._set(req, _QUEUED)

    def on_admit(self, req: Any) -> None:
        prev = self._get(req)
        if prev != _QUEUED:
            _fail("illegal-admit",
                  f"request {req.request_id} admitted from state "
                  f"{prev!r} (expected queued)")
        self._set(req, _ACTIVE)

    def on_finish(self, req: Any) -> None:
        prev = self._get(req)
        if prev not in (_QUEUED, _ACTIVE, None):
            _fail("illegal-finish",
                  f"request {req.request_id} finished from state "
                  f"{prev!r}")
        self._set(req, _FINISHED)

    def on_drain(self, req: Any) -> None:
        prev = self._get(req)
        if prev == _FINISHED:
            _fail("terminal-drain",
                  f"request {req.request_id} drained for requeue after "
                  "finishing — its results would be regenerated and "
                  "double-counted")
        self._set(req, _DRAINED)

    def check_decode_wave(self, batcher: Any, active: List[int]) -> None:
        """Every slot the decode wave advances must hold an ACTIVE
        request — an evicted/drained slot decoding means the runtime is
        generating tokens into freed state."""
        for i in active:
            req = batcher.slot_req[i]
            state = self._get(req)
            if state != _ACTIVE:
                _fail("evicted-decoding",
                      f"slot {i} decodes request "
                      f"{getattr(req, 'request_id', '?')} in state "
                      f"{state!r} (expected active)")


class RequestFSM:
    """Control-plane twin: terminal ``Request`` objects must stay
    terminal (never retried / requeued)."""

    def check_requeue(self, req: Any) -> None:
        if getattr(req, "terminal", False):
            why = "completed" if req.completed_at is not None \
                else f"status={req.status!r} ({req.failed_reason})"
            _fail("terminal-retried",
                  f"request {req.request_id} charged a retry while "
                  f"already terminal ({why}) — retries must never "
                  "resurrect a settled request")


# =========================================================================
# Factories (the instrumentation points call these once, at init)
# =========================================================================
def block_sanitizer(alloc: Any) -> Optional[BlockSanitizer]:
    return BlockSanitizer(alloc) if enabled() else None


def adapter_sanitizer() -> Optional[AdapterSanitizer]:
    return AdapterSanitizer() if enabled() else None


def lifecycle_sanitizer() -> Optional[RequestLifecycle]:
    return RequestLifecycle() if enabled() else None


def request_sanitizer() -> Optional[RequestFSM]:
    return RequestFSM() if enabled() else None
