"""Host-side accounting for the paged KV cache, with copy-on-write
prefix sharing and preemption swapping — the port of
``repro.runtime.paging``.

The device side is a global block pool ``[L, n_blocks, block_size, Hkv,
Dh]`` (``Model.init_paged_caches``) plus per-slot block tables; this
module owns which pool blocks are free and whether an admission's worst
case fits.  At admission the batcher reserves a request's WORST-CASE
block count; blocks are then taken lazily (prompt blocks at admission,
one more each time decode crosses a block boundary), always against the
reservation, so a slot never stalls mid-decode waiting for a block.
Oversubscribed admission (``ContinuousBatcher(oversubscribe=...)``)
reserves only near-term need instead and handles mid-decode exhaustion
by preempting a victim slot: the victim's private blocks either swap to
host memory (``swap_out``/``swap_in`` below) or are dropped and
re-prefilled on restore.

Sharing (prefix caching): every block carries a refcount.  Full,
immutable prompt blocks are registered in a ``PrefixCache`` keyed by
``(parent block, content hash of the block's tokens)``; a request whose
prompt starts with a cached block chain aliases those pool blocks at
refcount+1 instead of prefilling them again.  Shared blocks are never
written: the runtime copies a block before a decode write would land in
a shared one.  When the last reference to a registered (pinned) block is
freed, the block parks in an LRU retained pool instead of the free list,
so warm prefixes outlive their requests; ``take`` reclaims retained
blocks, oldest first, only when the free list runs dry.

Block 0 is the scratch block: inactive decode slots keep all-zero block
tables, so their dead-lane writes land there instead of in live blocks.
``REPRO_SANITIZE=1`` arms ``san``, a shadow refcount and reservation
ledger (``runtime/sanitize.py``) that every mutation below advances.
"""
from __future__ import annotations

import collections
import hashlib
from typing import (
    Callable, Deque, Dict, List, Optional, Sequence, Tuple,
)

import numpy as np

from repro_torch.runtime.sanitize import block_sanitizer


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache rows."""
    return -(-max(int(n_tokens), 0) // block_size)


class OutOfBlocks(RuntimeError):
    """Raised when a reserve exceeds the unreserved free pool."""


class BlockError(RuntimeError):
    """Refcount invariant violation: a double free, an alias of a free
    block, or a take that hands out a still-referenced block."""


class BlockAllocator:
    """Refcounted free-list allocator over ``n_blocks`` pool blocks.

    ``n_scratch`` leading blocks (default 1: block 0) are never handed
    out.  ``reserve``/``release`` move the admission-time worst-case
    bound; ``take`` turns reservation into concrete block ids at
    refcount 1; ``share`` aliases live blocks (refcount+1); ``acquire``
    takes a reference for a prefix-cache hit, reviving retained blocks;
    ``free`` drops one reference per id, and freeing an unreferenced
    block is a hard error.  A block whose refcount reaches 0 returns to
    the free list unless it is pinned (registered in a prefix cache):
    then it parks in the LRU retained pool until reclaimed.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 n_scratch: int = 1) -> None:
        if n_blocks <= n_scratch:
            raise ValueError(
                f"n_blocks {n_blocks} must exceed scratch count "
                f"{n_scratch}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_scratch = n_scratch
        self.capacity = n_blocks - n_scratch
        self._free: Deque[int] = collections.deque(
            range(n_scratch, n_blocks))
        self._ref = np.zeros(n_blocks, np.int32)
        # pinned = registered in a prefix cache: parked in the retained
        # pool on last free, reported to ``on_reclaim`` when reclaimed
        self._pinned: set = set()
        # pinned blocks at refcount 0, oldest first
        self._retained: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.reserved = 0
        self.peak_used = 0
        # called with a block id when ``take`` reclaims a retained block
        # (the prefix cache drops its entry there)
        self.on_reclaim: Optional[Callable[[int], None]] = None
        # shadow refcount/reservation mirror, armed by REPRO_SANITIZE=1
        # (None otherwise: every hook below is one is-not-None test)
        self.san = block_sanitizer(self)

    # ------------------------------------------------------------ queries --
    @property
    def n_free(self) -> int:
        """Blocks holding no content at all (not retained)."""
        return len(self._free)

    @property
    def n_retained(self) -> int:
        """Cached blocks without a reference, reclaimable under pressure."""
        return len(self._retained)

    @property
    def n_used(self) -> int:
        """Blocks with at least one live reference."""
        return self.capacity - len(self._free) - len(self._retained)

    def ref(self, bid: int) -> int:
        return int(self._ref[bid])

    def available(self) -> int:
        """Blocks neither referenced nor promised to an admitted slot
        (retained blocks count: they are reclaimable on demand)."""
        return len(self._free) + len(self._retained) - self.reserved

    def can_reserve(self, n: int) -> bool:
        return self.available() >= n

    def n_would_revive(self, ids: Sequence[int]) -> int:
        """How many of ``ids`` ``acquire`` would take out of the retained
        pool: admission budgets them against ``available()``."""
        return sum(1 for b in ids if self._ref[b] == 0)

    # ------------------------------------------------------------ mutation -
    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise OutOfBlocks(
                f"reserve({n}): only {self.available()} unreserved "
                f"blocks available")
        self.reserved += n
        if self.san is not None:
            self.san.on_reserve(n)

    def release(self, n: int) -> None:
        if not 0 <= n <= self.reserved:
            raise BlockError(
                f"release({n}) exceeds outstanding reservation "
                f"{self.reserved}")
        self.reserved -= n
        if self.san is not None:
            self.san.on_release(n)

    def take(self, n: int) -> List[int]:
        """Convert ``n`` reserved blocks into concrete pool block ids,
        each at refcount 1: the free list first, then retained blocks,
        oldest first, each reported to ``on_reclaim``."""
        if n > self.reserved:
            raise BlockError(
                f"take({n}) without reservation (reserved={self.reserved})")
        if n > len(self._free) + len(self._retained):
            raise BlockError("reservation accounting broken: reserved "
                             "blocks must be free or retained")
        ids = []
        for _ in range(n):
            if self._free:
                bid = self._free.popleft()
            else:
                bid, _ = self._retained.popitem(last=False)    # LRU
                self._pinned.discard(bid)
                if self.on_reclaim is not None:
                    self.on_reclaim(bid)
            if self._ref[bid] != 0:
                raise BlockError(
                    f"take: block {bid} still has refcount "
                    f"{self._ref[bid]}")
            self._ref[bid] = 1
            ids.append(bid)
        self.reserved -= n
        self.peak_used = max(self.peak_used, self.n_used)
        if self.san is not None:
            self.san.on_take(ids)
        return ids

    def share(self, ids: Sequence[int]) -> None:
        """Alias live blocks: refcount+1 each.  Aliasing a block without
        a reference is a hard error (a prefix-cache hit uses ``acquire``,
        which revives retained blocks)."""
        for b in ids:
            if self._ref[b] < 1:
                raise BlockError(
                    f"share of unreferenced block {b} (refcount "
                    f"{self._ref[b]})")
            self._ref[b] += 1
        if self.san is not None:
            self.san.on_share(list(ids))

    def acquire(self, ids: Sequence[int]) -> None:
        """One reference on each block for a prefix-cache hit: live blocks
        are shared (refcount+1), retained ones revived out of the LRU
        pool."""
        for b in ids:
            if self._ref[b] >= 1:
                self._ref[b] += 1
            elif b in self._retained:
                del self._retained[b]
                self._ref[b] = 1
            else:
                raise BlockError(
                    f"acquire of free block {b}: prefix cache points "
                    "at reclaimed content")
        self.peak_used = max(self.peak_used, self.n_used)
        if self.san is not None:
            self.san.on_acquire(list(ids))

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; refcount 0 returns the block to the
        free list, or to the retained pool when it is pinned."""
        for b in ids:
            if not (self.n_scratch <= b < self.n_blocks):
                raise BlockError(f"free of invalid block id {b}")
            if self._ref[b] < 1:
                raise BlockError(
                    f"double free of block {b} (refcount 0)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._pinned:
                    self._retained[b] = None   # most recently used end
                    self._retained.move_to_end(b)
                else:
                    self._free.append(b)
        if len(self._free) + len(self._retained) > self.capacity:
            raise BlockError("free-list overflow: refcount accounting "
                             "broken")
        if self.san is not None:
            self.san.on_free(list(ids))

    # ------------------------------------------------------------- swapping -
    def swap_out(self, ids: Sequence[int]) -> None:
        """Preemption swap-out: drop the SOLE reference on each private
        block whose contents were just copied to host memory, returning
        the block to the free list.  Only unpinned refcount-1 blocks may
        swap (shared and registered blocks stay pool-resident), so
        swapping another is a hard error.  The sanitizer marks the ids
        swapped out: a decode wave that gathers one before a ``swap_in``
        restores fresh blocks is a use-after-swap."""
        for b in ids:
            if not (self.n_scratch <= b < self.n_blocks):
                raise BlockError(f"swap-out of invalid block id {b}")
            if self._ref[b] != 1:
                raise BlockError(
                    f"swap-out of block {b} with refcount "
                    f"{self._ref[b]} (must be the sole reference)")
            if b in self._pinned:
                raise BlockError(
                    f"swap-out of pinned (prefix-cached) block {b} — "
                    "registered blocks stay pool-resident")
            self._ref[b] = 0
            self._free.append(b)
        if self.san is not None:
            self.san.on_swap_out(list(ids))

    def swap_in(self, n: int) -> List[int]:
        """Restore-side allocation: reserve AND take ``n`` fresh blocks in
        one step, for the host-to-device copy of a swapped-out chain.
        Raises ``OutOfBlocks`` when the pool cannot cover the restore
        (the caller defers it to a later tick)."""
        self.reserve(n)
        ids = self.take(n)
        if self.san is not None:
            self.san.on_swap_in(ids)
        return ids

    # -------------------------------------------------------------- pinning -
    def pin(self, bid: int) -> None:
        """Mark ``bid`` prefix-cached: its content outlives its last
        reference (retained pool) until reclaimed or unpinned."""
        self._pinned.add(bid)
        if self.san is not None:
            self.san.on_pin(bid)

    def unpin(self, bid: int) -> None:
        """Drop the cache pin; a retained block goes straight back to the
        free list."""
        self._pinned.discard(bid)
        if bid in self._retained:
            del self._retained[bid]
            self._free.append(bid)
        if self.san is not None:
            self.san.on_unpin(bid)


# =========================================================================
# Hash-indexed prefix cache over full, immutable prompt blocks
# =========================================================================
_ROOT = -1   # parent id of a prompt's first block


def _ns_bytes(namespace: Optional[str]) -> bytes:
    """Tenant salt: a cached block's KV was computed under one adapter,
    so lookups are namespaced per tenant (None: the base model)."""
    return b"" if namespace is None \
        else namespace.encode("utf-8") + b"\x00"


def _digest(tokens: np.ndarray, namespace: Optional[str] = None) -> bytes:
    """Content hash of one block's tokens (blake2b: stable across
    processes), salted by the tenant namespace."""
    return hashlib.blake2b(
        _ns_bytes(namespace)
        + np.ascontiguousarray(tokens, np.int32).tobytes(),
        digest_size=16).digest()


class PrefixCache:
    """Maps ``(parent block, content hash)`` to the pool block holding
    that block's KV, chained so a lookup walks the longest cached
    block-aligned prefix of a prompt.

    Entries keep the full token bytes and lookups compare them, so a
    hash collision never aliases other content.  Registration pins the
    block in the allocator; the allocator calls ``_on_reclaim`` when it
    reclaims a retained block, and the runtime calls
    ``unregister_block`` before it writes a registered block in place
    (a ring wrap over a refcount-1 block)."""

    def __init__(self, allocator: BlockAllocator) -> None:
        self.alloc = allocator
        self.block_size = allocator.block_size
        allocator.on_reclaim = self._on_reclaim
        # (parent, digest) -> [(token_bytes, bid), ...] (collision list)
        self._table: Dict[Tuple[int, bytes],
                          List[Tuple[bytes, int]]] = {}
        self._key_of: Dict[int, Tuple[int, bytes, bytes]] = {}
        # parent bid -> registered child bids: entries are keyed by the
        # parent's BLOCK ID, so dropping a parent drops its children; a
        # recycled parent id registered for other content would otherwise
        # revive chains whose KV was computed under another prefix
        self._children: Dict[int, List[int]] = {}
        self.hits = 0          # blocks served from the cache
        self.misses = 0        # full blocks that had to be prefilled
        self.reclaimed = 0     # retained blocks reclaimed under pressure

    def __len__(self) -> int:
        return len(self._key_of)

    # -------------------------------------------------------------- lookup -
    def match(self, prompt: np.ndarray,
              namespace: Optional[str] = None) -> List[int]:
        """Longest chain of cached blocks covering a block-aligned prefix
        of ``prompt``, capped so at least ONE prompt token is left to
        prefill (its logits give the first token).  A pure lookup:
        ``count_admitted`` bumps the counters once an admission commits
        to a (possibly trimmed) match.  ``namespace`` scopes the lookup
        to one tenant's blocks."""
        bs = self.block_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_blocks = (len(prompt) - 1) // bs
        out: List[int] = []
        parent = _ROOT
        for i in range(max_blocks):
            bid = self._lookup(parent, prompt[i * bs:(i + 1) * bs],
                               namespace)
            if bid is None:
                break
            out.append(bid)
            parent = bid
        return out

    def count_admitted(self, prompt: np.ndarray, n_matched: int,
                       namespace: Optional[str] = None) -> None:
        """Hit/miss counters for one admitted request: ``n_matched``
        blocks aliased, the rest of its matchable blocks prefilled."""
        max_blocks = (len(np.asarray(prompt).reshape(-1)) - 1) \
            // self.block_size
        self.hits += n_matched
        self.misses += max_blocks - n_matched

    def _lookup(self, parent: int, chunk: np.ndarray,
                namespace: Optional[str] = None) -> Optional[int]:
        entries = self._table.get((parent, _digest(chunk, namespace)))
        if not entries:
            return None
        raw = _ns_bytes(namespace) \
            + np.ascontiguousarray(chunk, np.int32).tobytes()
        for token_bytes, bid in entries:
            if token_bytes == raw:      # a collision never matches
                return bid
        return None

    # -------------------------------------------------------- registration -
    def register(self, prompt: np.ndarray, block_ids: Sequence[int],
                 n_matched: int, namespace: Optional[str] = None) -> None:
        """Register the full prompt blocks a request just wrote.
        ``block_ids`` is the slot's block list (matched prefix, then its
        own); blocks ``n_matched .. len(prompt) // bs - 1`` are full,
        immutable and new.  A block whose key is already mapped (the
        same prompt admitted in the same wave) stays unregistered: the
        existing entry wins."""
        bs = self.block_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_full = len(prompt) // bs
        parent = block_ids[n_matched - 1] if n_matched > 0 else _ROOT
        for i in range(n_matched, n_full):
            chunk = prompt[i * bs:(i + 1) * bs]
            bid = block_ids[i]
            key = (parent, _digest(chunk, namespace))
            raw = _ns_bytes(namespace) \
                + np.ascontiguousarray(chunk, np.int32).tobytes()
            entries = self._table.setdefault(key, [])
            existing = next((b for tb, b in entries if tb == raw), None)
            if existing is None and bid not in self._key_of:
                entries.append((raw, bid))
                self._key_of[bid] = (key[0], key[1], raw)
                if parent != _ROOT:
                    self._children.setdefault(parent, []).append(bid)
                self.alloc.pin(bid)
            # chain through the canonical holder of this content, so a
            # same-wave duplicate registers its deeper blocks under
            # reachable parents
            parent = existing if existing is not None else bid

    # ------------------------------------------------------- invalidation --
    def _drop_entry(self, bid: int) -> None:
        """Remove ``bid``'s entry and its whole subtree (children are
        keyed by this block's id)."""
        info = self._key_of.pop(bid, None)
        if info is None:
            return
        parent, digest, _raw = info
        entries = self._table.get((parent, digest))
        if entries:
            entries[:] = [(tb, b) for tb, b in entries if b != bid]
            if not entries:
                del self._table[(parent, digest)]
        if parent != _ROOT:
            kids = self._children.get(parent)
            if kids and bid in kids:
                kids.remove(bid)
        for child in self._children.pop(bid, []):
            self._drop_entry(child)
            self.alloc.unpin(child)     # no longer reachable

    def unregister_block(self, bid: int) -> None:
        """Drop ``bid``'s entry and its pin (its sole owner is about to
        write it in place)."""
        self._drop_entry(bid)
        self.alloc.unpin(bid)

    def _on_reclaim(self, bid: int) -> None:
        # the allocator has already unpinned and popped the block
        self.reclaimed += 1
        self._drop_entry(bid)

    def is_registered(self, bid: int) -> bool:
        return bid in self._key_of
