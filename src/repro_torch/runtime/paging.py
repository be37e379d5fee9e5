"""Host-side accounting for the paged KV cache — the port of the
preemption-free core of ``repro.runtime.paging``.

The device side is a global block pool ``[L, n_blocks, block_size, Hkv,
Dh]`` (``Model.init_paged_caches``) plus per-slot block tables; this
module owns which pool blocks are free and whether an admission's worst
case fits.  At admission the batcher reserves a request's WORST-CASE
block count; blocks are then taken lazily (prompt blocks at admission,
one more each time decode crosses a block boundary), always against the
reservation, so a slot never stalls mid-decode waiting for a block.

Block 0 is the scratch block: inactive decode slots keep all-zero block
tables, so their dead-lane writes land there instead of in live blocks.
Prefix sharing (``share``/``acquire``/pinning), swapping and the shadow
sanitizer come in later slices; ``san`` is the sanitizer's hook, None
until then.
"""
from __future__ import annotations

import collections
from typing import Any, Deque, List, Sequence

import numpy as np


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache rows."""
    return -(-max(int(n_tokens), 0) // block_size)


class OutOfBlocks(RuntimeError):
    """Raised when a reserve exceeds the unreserved free pool."""


class BlockError(RuntimeError):
    """Refcount invariant violation: a double free, or a take that hands
    out a still-referenced block."""


class BlockAllocator:
    """Refcounted free-list allocator over ``n_blocks`` pool blocks.

    ``n_scratch`` leading blocks (default 1: block 0) are never handed
    out.  ``reserve``/``release`` move the admission-time worst-case
    bound; ``take`` turns reservation into concrete block ids at
    refcount 1; ``free`` drops one reference per id, and freeing an
    unreferenced block is a hard error.
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
        self.reserved = 0
        self.peak_used = 0
        # shadow-state sanitizer hook (the JAX allocator's reprosan
        # mirror); stays None until the sanitizer is ported
        self.san: Any = None

    # ------------------------------------------------------------ queries --
    @property
    def n_used(self) -> int:
        """Blocks with at least one live reference."""
        return self.capacity - len(self._free)

    def ref(self, bid: int) -> int:
        return int(self._ref[bid])

    def available(self) -> int:
        """Blocks neither referenced nor promised to an admitted slot."""
        return len(self._free) - self.reserved

    def can_reserve(self, n: int) -> bool:
        return self.available() >= n

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
        each at refcount 1."""
        if n > self.reserved:
            raise BlockError(
                f"take({n}) without reservation (reserved={self.reserved})")
        ids = []
        for _ in range(n):
            bid = self._free.popleft()
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

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; refcount 0 returns the block to the
        free list."""
        for b in ids:
            if not (self.n_scratch <= b < self.n_blocks):
                raise BlockError(f"free of invalid block id {b}")
            if self._ref[b] < 1:
                raise BlockError(
                    f"double free of block {b} (refcount 0)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
        if self.san is not None:
            self.san.on_free(list(ids))
