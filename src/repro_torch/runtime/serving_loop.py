"""Slot-based continuous-batching decode runtime — the port of the core
of ``repro.runtime.serving_loop``.

A ``ContinuousBatcher`` owns a fixed pool of decode *slots* whose KV
lives in one of two layouts:

  contiguous  ``model.init_caches(n_slots, max_seq)``: every slot owns a
              worst-case ``max_seq`` stripe;
  paged       ``paged=True``: a global block pool
              ``[L, n_blocks, block_size, Hkv, Dh]`` plus per-slot block
              tables; a ``BlockAllocator`` reserves each request's worst
              case at admission (FCFS; the queue waits when the pool
              cannot cover the head request) and hands out blocks lazily.

Each tick admits queued requests into free slots (the whole wave
prefills through ONE ragged ``model.prefill_ragged`` call and lands in
the cache with ONE batched write), then advances every active slot one
token through ``decode_step`` / ``decode_step_paged`` with per-slot
positions, and evicts finished requests so the next ones are admitted
mid-flight.  Both decode layouts run the paged-decode-attention kernel
in every layer.  The host reads back one argmax per wave.

SSM stacks (Mamba2) keep a conv tail and an SSD state per slot in the
contiguous layout only: their recurrence threads state through pads, so
each request of a wave prefills at its exact length (``model.prefill``,
the ssd_scan kernel in every layer on the card), the wave's last-position
logits are stacked on the device for ONE argmax pull, and the wave's
caches, gathered row by row (``write_prefill_slot``), land in their
slots with the same batched write.  Decode then runs the O(1)
recurrence.  The hybrid (hymba) takes the same path with its sliding-
window K/V beside the SSM caches: each prompt's K/V lands verbatim in the
first rows of its slot's ring (``prompt_pad`` is at most the window), and
decode writes wrap at ``ring_len``.  Paged caches, multi-tenant adapters,
chunked prefill, oversubscription and the prefix cache refuse SSM and
hybrid stacks, as in the reference.

Co-serving: passing a training batch to ``step`` runs the engine's
``combined_step[_paged]`` — the decode wave reads the published adapter
``self.lora`` while the optimizer steps the train tree (``train_lora``
when a train session staged a shadow, else ``self.lora`` itself, which
is replaced by the trained tree after the tick).  A tick with no active
slot trains alone.  The host pulls the train metrics once per tick.

Multi-tenant serving: pass an ``AdapterRegistry`` as ``adapters`` and
tag requests with ``GenRequest.adapter_id``.  Every prefill and decode
then reads the registry's stacked device tree with one slot index per
row (the segmented_lora_matmul kernel on the card), so one wave mixes
tenants; admission pins each request's adapter (loading it on a miss,
waiting while every slot is pinned) and eviction unpins it.  Requests
without an ``adapter_id`` serve the bare base model.  Co-training still
steps ``self.lora`` (the co-train tenant's tree) in place, while decode
reads the registry's copies.

Prefix caching (``prefix_cache=True``, paged only): full, immutable
prompt blocks are registered in a hash-indexed ``PrefixCache``
(runtime/paging.py), namespaced per tenant; a request whose prompt
starts with a cached block chain aliases those pool blocks at
refcount+1 and prefills only the uncached suffix
(``model.prefill_ragged_suffix``: the suffix attends over the prefix K/V
gathered from the pool, layer by layer).  A decode write that would land
in a shared block (a sliding-window ring wrap) copies the block first
(``model.copy_blocks``, one call a tick).  Blocks whose last reference
is freed stay cached in an LRU retained pool until the allocator needs
them.

Chunked prefill (``prefill_chunk > 0``): admission only binds a request
to a slot; each tick then prefills one chunk of the most urgent
prefilling slots (deadline-slack order) in ONE wave program, attending
over the K/V the slot's earlier chunks (or its matched prefix) wrote:
``prefill_ragged_suffix`` over the paged pool (chunks rounded up to
whole blocks), ``prefill_ragged_continue`` + ``write_prefill_rows`` over
contiguous caches.  A slot joins the decode wave on the tick its final
chunk lands; until then its decode lane is parked (scratch block 0 when
paged).  With ``tpot_target > 0`` a ``_TickBudget`` plans each tick from
measured costs: decode first, prefill chunks in the slack, then a train
microbatch in what is left (full, half or skipped).

Oversubscription (``oversubscribe=w``, 0 < w <= 1, paged only):
admission reserves only near-term need (the prompt's blocks and one
block of decode lookahead) against a ``w``-fraction watermark of the
pool, and a decode write that finds the pool exhausted PREEMPTS a victim
slot (the one with the most deadline slack).  Its private block chain
either swaps to host memory (one indexed gather per K/V leaf, one
synchronous copy to the CPU; restored by one copy back and one indexed
write into fresh blocks) or is dropped and re-prefilled from the
request's prompt and generated tokens through the chunk programs,
whichever an EMA cost model (``_SwapCost``) prices cheaper; ``swap=False``
always drops.  Shared and prefix-registered blocks are never copied:
they stay in the pool.  Restores run ahead of admission in
deadline-slack order, and greedy output equals a never-preempted run's.

These features, like the reference's, refuse a ``prompt_pad`` past the
dense limit (``prompt_pad``^2 > 1M, where prefill runs blockwise, on the
card through the flash_attention kernels): the suffix programs mirror
the dense softmax.  Chunked prefill refuses SSM stacks, and
oversubscription sliding windows (a ring wrap overwrites rows in place,
so a dropped request could not be re-prefilled into the same state).
VLM stacks are refused, as in the reference: they serve through
``Engine.prefill_step``/``decode_step``.

MoE stacks take every path a dense stack takes, with the reference's
routing (``models/moe.py``): a decode tick routes every slot's token, a
free slot's too (token 0 at position 0, as ``_evict`` leaves it, the
same row paged or contiguous), and its choices take expert capacity, so
a request's tokens can depend on its slot and its neighbours; a prefill
wave routes its pad tokens with its prompts.  A wave (or chunk, or
suffix wave) of more than 512 tokens must be a whole number of 512-token
routing groups: a lone 992-token wave or an 8 x 224 suffix wave raises
``ValueError`` where the reference asserts.

``REPRO_SANITIZE=1`` arms the shadow sanitizers (``runtime/sanitize.py``):
the allocator's refcount mirror, the registry's residency mirror and a
request lifecycle FSM, each checked on every decode wave, eviction and
drain; a violation raises a ``[reprosan:...]`` diagnostic.

``static_batch_serve`` is the lock-step baseline: prefill a batch, then
decode until every request of the batch finishes, finished requests
riding along as dead slots.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import Family
from repro_torch.core.interfaces import slack_order
from repro_torch.models.lora import lora_shapes
from repro_torch.models.sharding import current_mesh
from repro_torch.models.transformer import use_dense_prefill
from repro_torch.runtime.paging import BlockAllocator, PrefixCache, blocks_for
from repro_torch.runtime.sanitize import adapter_sanitizer, lifecycle_sanitizer
from repro_torch.tree import tree_finite, tree_leaves, tree_map


@dataclasses.dataclass
class GenRequest:
    """One generation request: prompt in, sampled tokens out (greedy by
    default — ``temperature <= 0``)."""
    request_id: int
    prompt: np.ndarray                  # [P] int32 token ids
    max_new_tokens: int = 16
    arrival: float = 0.0                # on the caller's ``now`` clock
    # SLO deadline (same clock as ``arrival``): chunked prefill spends a
    # tick's prefill budget in deadline-slack order
    deadline: float = float("inf")
    # multi-tenant serving: the registered adapter this request's tokens
    # flow through (None: the base model, or the single-adapter mode)
    adapter_id: Optional[str] = None
    # sampling: temperature <= 0 is exact greedy; top_k/top_p filter
    # before the softmax; ``seed`` (default request_id) seeds ``rng``
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # filled by the runtime
    tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_at: Optional[float] = None
    # when the first generated token landed (the TTFT stamp): the tick
    # that admitted the request under monolithic prefill, the tick of
    # its final chunk under chunked prefill
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # wall-clock (perf_counter) finish stamp: ``finished_at`` is on the
    # caller's ``now`` clock, which may be simulated time
    finished_wall: Optional[float] = None
    rng: Any = None                     # per-request sampling stream

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def samples(self) -> bool:
        return self.temperature > 0.0


def sample_token(logits: np.ndarray, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Sample one token id from a ``[V]`` logits row: greedy argmax for
    ``temperature <= 0`` (or no rng), else temperature, top-k, then the
    nucleus (smallest mass >= ``top_p``), drawn in float64 on the host."""
    if temperature <= 0.0 or rng is None:
        return int(np.argmax(logits))
    row = np.asarray(logits, np.float64) / temperature
    if 0 < top_k < row.size:
        kth = np.partition(row, -top_k)[-top_k]
        row = np.where(row < kth, -np.inf, row)
    row -= row.max()
    probs = np.exp(row)
    probs /= probs.sum()
    if top_p < 1.0:
        order = np.argsort(-probs, kind="stable")
        csum = np.cumsum(probs[order])
        cut = int(np.searchsorted(csum, top_p)) + 1
        mask = np.zeros_like(probs, bool)
        mask[order[:cut]] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    return int(rng.choice(probs.size, p=probs))


@dataclasses.dataclass
class ServeStats:
    admitted: int = 0
    finished: int = 0
    # prompt tokens a prefill program computed; prefix-cache hits are
    # skipped and counted apart
    prefill_tokens: int = 0
    cached_prefix_tokens: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    train_steps: int = 0
    wall_time: float = 0.0
    # the adapter version this replica serves (bumped by the live
    # replica's set_adapter / publish_adapter)
    adapter_version: int = 0
    # latest train CE loss of a combined or plain train tick (NaN until
    # the batcher has trained)
    train_loss: float = float("nan")
    # publish gate: shadow (or incoming global) trees refused as
    # non-finite instead of being swapped into serving
    nan_publishes_blocked: int = 0
    # multi-tenant: finished requests per adapter, and the version each
    # tenant's adapter served at its last finish
    adapter_requests: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    adapter_versions: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # token budget (tpot_target > 0): ticks planned under it, measured
    # seconds of work against the summed per-tick target, and ticks whose
    # train microbatch was skipped to protect the decode TPOT
    budget_ticks: int = 0
    budget_spent_s: float = 0.0
    budget_target_s: float = 0.0
    train_skipped_ticks: int = 0
    # oversubscribed pool: victim slots preempted on pool exhaustion,
    # blocks moved device->host and host->device by swaps, and prompt
    # and generated tokens recomputed by drop-restores (these count in
    # prefill_tokens too: that is all prefill compute)
    preemptions: int = 0
    swap_out_blocks: int = 0
    swap_in_blocks: int = 0
    reprefill_tokens: int = 0
    # per finished request, on the caller's ``now`` clock: time to first
    # token (arrival -> the admitting tick) and seconds per later output
    # token (first token -> the finishing tick, over the tokens after it)
    ttft: List[float] = dataclasses.field(default_factory=list)
    tpot: List[float] = dataclasses.field(default_factory=list)

    def throughput(self) -> float:
        return self.generated_tokens / max(self.wall_time, 1e-9)


def _ema(old: Optional[float], new: float) -> float:
    """The cost models' moving average: the first sample, then 3:1 old to
    new."""
    return new if old is None else 0.75 * old + 0.25 * new


class _TickBudget:
    """Per-tick token budget for a decode TPOT target.

    Keeps EMA cost estimates of the three kinds of work a tick can carry
    (the decode wave, prefill-chunk tokens, train tokens) from measured
    wall times, and plans each tick: decode first, leftover budget to
    prefill chunks (the caller picks rows in deadline-slack order), and
    whatever slack remains to train tokens.  An unknown prefill cost
    plans optimistically, so it is measured once before it is
    regulated; an unknown train cost never rides a tick with serving
    work."""

    def __init__(self, target_s: float):
        self.target_s = target_s
        self.decode_tick_s: Optional[float] = None
        self.prefill_tok_s: Optional[float] = None
        self.train_tok_s: Optional[float] = None

    def observe_decode(self, dt: float) -> None:
        self.decode_tick_s = _ema(self.decode_tick_s, dt)

    def observe_prefill(self, tokens: int, dt: float) -> None:
        if tokens > 0:
            self.prefill_tok_s = _ema(self.prefill_tok_s,
                                           dt / tokens)

    def observe_train(self, tokens: int, dt: float) -> None:
        if tokens > 0 and dt > 0:
            self.train_tok_s = _ema(self.train_tok_s, dt / tokens)

    def prefill_allowance(self, n_decoding: int) -> float:
        """Prefill tokens this tick may spend after decode's share; with
        nothing decoding, prefill owns the tick (no TPOT to protect)."""
        if n_decoding == 0:
            return float("inf")
        rem = self.target_s - (self.decode_tick_s or 0.0)
        if rem <= 0:
            return 0.0
        if self.prefill_tok_s is None:
            return float("inf")
        return rem / self.prefill_tok_s

    def train_tokens(self, b: int, s: int,
                     prefill_spent_s: float) -> Optional[int]:
        """Token cap for a [B, S] train microbatch in this tick's slack:
        0 runs the full batch, a positive cap halves it, None skips the
        step.  Before the train cost is known it skips: ticks with no
        serving work train unconditionally (the caller), which measures
        it."""
        rem = self.target_s - (self.decode_tick_s or 0.0) \
            - prefill_spent_s
        if self.train_tok_s is None:
            return None
        if rem >= b * s * self.train_tok_s:
            return 0
        half = (b // 2) * s
        if b >= 2 and rem >= half * self.train_tok_s:
            return half
        return None


class _SwapCost:
    """EMA cost model for the per-victim preemption choice, priced like
    ``_TickBudget``: measured seconds per byte of a device-to-host block
    copy against seconds per re-prefilled token.  Swap keeps the state
    exactly, so unknown costs prefer swap: each path is measured before
    it is regulated, and the safe choice is the default."""

    def __init__(self) -> None:
        self.swap_byte_s: Optional[float] = None
        self.prefill_tok_s: Optional[float] = None

    def observe_swap(self, nbytes: int, dt: float) -> None:
        if nbytes > 0 and dt > 0:
            self.swap_byte_s = _ema(self.swap_byte_s, dt / nbytes)

    def observe_prefill(self, tokens: int, dt: float) -> None:
        if tokens > 0 and dt > 0:
            self.prefill_tok_s = _ema(self.prefill_tok_s,
                                           dt / tokens)

    def prefer_swap(self, tail_bytes: int, reprefill_tokens: int) -> bool:
        """Is a swap round trip (out and in) cheaper than recomputing
        the dropped rows?"""
        if self.swap_byte_s is None or self.prefill_tok_s is None:
            return True
        return 2.0 * tail_bytes * self.swap_byte_s \
            <= reprefill_tokens * self.prefill_tok_s


@dataclasses.dataclass
class _Swapped:
    """A preempted request parked off its slot.  ``kept`` blocks (the
    shared or prefix-registered start of its chain) stay in the pool with
    its references held; the private tail either lives in host memory in
    ``host_kv`` (mode "swap") or was dropped and is recomputed from the
    request's token ids (mode "reprefill").  The adapter pin is kept
    across the preemption, so a restore never waits on residency."""
    req: GenRequest
    adapter_id: Optional[str]
    mode: str                     # "swap" | "reprefill"
    kept: List[int]               # pool-resident chain start (refs held)
    # (k, v) CPU tensors [L, n_tail, bs, Hkv, Dh] in the pool's dtype
    # (swap mode only): a round trip is bitwise
    host_kv: Any
    n_tail: int                   # private blocks to restore
    pos: int                      # decode frontier: next write position
    tok: int                      # next token to feed
    cached: int                   # prefix-cache hit tokens at admission


def _host_ids(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload host-side int32 ids (a copy: the slot arrays keep
    changing after the upload)."""
    return torch.tensor(arr, dtype=torch.int32, device=device)


class AdapterError(RuntimeError):
    """Misuse of the AdapterRegistry (unknown id, double free, ...)."""


class OutOfAdapterSlots(AdapterError):
    """Every device slot is pinned by in-flight requests."""


def _write_adapter_slot(stack, tree, slot: int) -> None:
    """Overwrite device slot ``slot`` of a stacked multi-adapter tree
    (leaves ``[L, A, din, r]``) with one tenant's tree, in place."""
    with torch.no_grad():
        tree_map(lambda stk, leaf: stk[:, slot].copy_(leaf), stack, tree)


class AdapterRegistry:
    """Multi-tenant adapter residency of one replica: every registered
    tenant keeps its own LoRA tree (wherever the caller made it); up to
    ``capacity`` of them are resident in one stacked tree on the model's
    device (leaves ``[L, capacity, din, r]``, float32) that prefill and
    decode index per row.

    Residency is refcounted like the paged pool's ``BlockAllocator``:
    ``acquire`` pins a tenant's slot for a request's lifetime (copying
    its tree into a free slot on a miss), ``release`` unpins it, and
    refcount-0 residents wait in an LRU list, still servable at no cost,
    until a miss needs their slot (cold-adapter eviction).  ``update``
    rewrites a resident tenant's slot in place, so in-flight rows read
    the new weights on their next tick (the atomic publish).  Slots start
    zero-filled and are overwritten on load, so the stacks stay finite.
    """

    def __init__(self, model, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        cfg = model.cfg
        self._stack = tree_map(
            lambda shp: torch.zeros((shp[0], capacity) + shp[1:],
                                    dtype=torch.float32,
                                    device=model.device),
            lora_shapes(cfg, cfg.n_layers))
        self._trees: Dict[str, Any] = {}
        self._version: Dict[str, int] = {}
        self._slot: Dict[str, int] = {}        # resident tenants only
        self._refs: Dict[str, int] = {}        # resident tenants only
        self._free: List[int] = list(range(capacity))
        # refcount-0 residents, oldest first (the LRU retained pool)
        self._lru: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.loads = 0
        self.evictions = 0
        # shadow residency/refcount/version mirror, armed by
        # REPRO_SANITIZE=1 (None otherwise)
        self.san = adapter_sanitizer()

    # ---------------------------------------------------------- tenants --
    def register(self, adapter_id: str, tree: Any,
                 version: int = 0) -> None:
        """Add (or overwrite) a tenant's adapter tree."""
        if adapter_id in self._slot:
            raise AdapterError(
                f"{adapter_id}: already registered and resident; use "
                "update() to change a live tenant's weights")
        self._trees[adapter_id] = tree
        self._version[adapter_id] = version
        if self.san is not None:
            self.san.on_register(adapter_id, version)

    def unregister(self, adapter_id: str) -> None:
        if self.refcount(adapter_id) > 0:
            raise AdapterError(
                f"{adapter_id}: unregister with {self.refcount(adapter_id)} "
                "in-flight refs")
        if self.san is not None:
            self.san.on_unregister(adapter_id)
        if adapter_id in self._slot:
            self._free.append(self._slot.pop(adapter_id))
            self._refs.pop(adapter_id, None)
            self._lru.pop(adapter_id, None)
        self._trees.pop(adapter_id, None)
        self._version.pop(adapter_id, None)

    def is_registered(self, adapter_id: str) -> bool:
        return adapter_id in self._trees

    def registered(self) -> List[str]:
        return sorted(self._trees)

    def host_tree(self, adapter_id: str) -> Any:
        """A tenant's own tree, as registered or last updated (the
        reference keeps it on the host; here it stays where its caller
        made it).  Failover re-registers it on a survivor."""
        return self._trees[adapter_id]

    def version(self, adapter_id: str) -> int:
        return self._version.get(adapter_id, 0)

    # -------------------------------------------------------- residency --
    def refcount(self, adapter_id: str) -> int:
        return self._refs.get(adapter_id, 0)

    def slot_index(self, adapter_id: str) -> int:
        """Device slot of a resident tenant, -1 otherwise."""
        return self._slot.get(adapter_id, -1)

    def resident_ids(self) -> tuple:
        return tuple(sorted(self._slot))

    def can_acquire(self, adapter_id: str) -> bool:
        if not self.is_registered(adapter_id):
            return False
        return adapter_id in self._slot or bool(self._free) \
            or bool(self._lru)

    def acquire(self, adapter_id: str) -> int:
        """Pin ``adapter_id``'s device slot (+1 ref), loading it on a
        miss and evicting the coldest unpinned tenant when no slot is
        free.  Raises ``OutOfAdapterSlots`` when every slot is pinned."""
        if not self.is_registered(adapter_id):
            raise AdapterError(f"{adapter_id}: not registered")
        slot = self._slot.get(adapter_id)
        if slot is not None:
            self.hits += 1
            self._lru.pop(adapter_id, None)
            self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
            if self.san is not None:
                self.san.on_acquire(adapter_id)
            return slot
        if self._free:
            slot = self._free.pop()
        elif self._lru:
            cold, slot = self._lru.popitem(last=False)
            if self.san is not None:
                self.san.on_evict(cold)
            del self._slot[cold]
            self._refs.pop(cold, None)
            self.evictions += 1
        else:
            raise OutOfAdapterSlots(
                f"{adapter_id}: all {self.capacity} adapter slots are "
                "pinned by in-flight requests")
        _write_adapter_slot(self._stack, self._trees[adapter_id], slot)
        self.loads += 1
        self._slot[adapter_id] = slot
        self._refs[adapter_id] = 1
        if self.san is not None:
            self.san.on_acquire(adapter_id)
        return slot

    def release(self, adapter_id: str) -> None:
        refs = self._refs.get(adapter_id, 0)
        if refs <= 0:
            raise AdapterError(f"{adapter_id}: release without acquire")
        if self.san is not None:
            self.san.on_release(adapter_id)
        refs -= 1
        self._refs[adapter_id] = refs
        if refs == 0:
            # stays resident (warm) until a miss needs the slot
            self._lru[adapter_id] = self._slot[adapter_id]

    def update(self, adapter_id: str, tree: Any,
               version: Optional[int] = None) -> None:
        """Swap a tenant's weights: its own tree always, its device slot
        in place when resident.  A non-finite tree is refused, so every
        resident slot stays servable."""
        if not self.is_registered(adapter_id):
            raise AdapterError(f"{adapter_id}: not registered")
        if not tree_finite(tree):
            raise AdapterError(
                f"{adapter_id}: refusing non-finite adapter publish")
        if self.san is not None:
            self.san.begin_publish(adapter_id, version)
        self._trees[adapter_id] = tree
        if version is not None:
            self._version[adapter_id] = version
        slot = self._slot.get(adapter_id)
        if slot is not None:
            _write_adapter_slot(self._stack, tree, slot)
        if self.san is not None:
            self.san.end_publish(adapter_id, version)

    def device_lora(self) -> Any:
        """The stacked device tree the multi-tenant paths read."""
        return self._stack


def refuse_encoder(cfg) -> None:
    """The reference's refusal of an encoder-only stack, which has no
    decode (it serves through ``Engine.encoder_serve_step``)."""
    if not cfg.has_decode:
        raise NotImplementedError(
            f"{cfg.name}: encoder-only, no decode serving")


def refuse_vlm(cfg) -> None:
    """The reference's refusal of VLM stacks, which serve through the
    engine's prefill and decode steps instead."""
    if cfg.family is Family.VLM:
        raise NotImplementedError(
            f"{cfg.name}: VLM cross-KV slot plumbing (units-leading "
            "cache layout + per-request vision inputs) is a ROADMAP "
            "item; use the prefill/decode API directly")


class ContinuousBatcher:
    """Fixed-slot continuous batching over one model replica (see the
    module docstring).  ``params`` and ``lora`` are the port's tensor
    trees on the model's device; every prefill and decode reads ``lora``,
    or with ``adapters`` (an ``AdapterRegistry``) the registry's stacked
    tree.  ``opt_state`` (the engine optimizer's state of the train tree)
    is needed for co-training ticks.
    """

    def __init__(self, engine, params, lora, *, n_slots: int = 8,
                 max_seq: int = 128, prompt_pad: int = 32,
                 opt_state: Any = None,
                 eos_id: Optional[int] = None, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 adapters: Optional[AdapterRegistry] = None,
                 prefill_chunk: int = 0, tpot_target: float = 0.0,
                 oversubscribe: float = 0.0, swap: bool = True):
        cfg = engine.model.cfg
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        refuse_encoder(cfg)
        refuse_vlm(cfg)
        if current_mesh() is not None:
            raise NotImplementedError(
                f"{cfg.name}: the continuous batcher (per-slot writes, the "
                "paged pool, prefix sharing, multi-tenant decode) on a mesh "
                "is queued for a later slice of the mesh (ROADMAP.md); "
                "static_batch_serve serves on one")
        if cfg.sliding_window > 0 and prompt_pad > cfg.sliding_window:
            raise ValueError(
                f"{cfg.name}: prompt_pad {prompt_pad} exceeds the "
                f"attention window {cfg.sliding_window}")
        if adapters is not None and cfg.has_ssm:
            raise NotImplementedError(
                f"{cfg.name}: multi-tenant adapter serving needs the "
                "ragged attention paths (SSM prefill is exact-length "
                "per request)")
        if paged and cfg.has_ssm:
            raise NotImplementedError(
                f"{cfg.name}: paged KV serving needs an "
                "attention-only stack (SSM/conv state is per-slot, "
                "not per-block)")
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache requires paged=True (sharing rides on "
                "pool block aliasing)")
        if prefill_chunk > 0 and cfg.has_ssm:
            raise NotImplementedError(
                f"{cfg.name}: chunked prefill needs an attention-only "
                "stack (SSM state threads through every token in order)")
        if oversubscribe:
            if not paged:
                raise ValueError(
                    "oversubscribe requires paged=True (preemption "
                    "moves pool blocks, not contiguous slot stripes)")
            if not 0 < oversubscribe <= 1:
                raise ValueError(f"oversubscribe must be in (0, 1], got "
                                 f"{oversubscribe}")
            if cfg.sliding_window > 0:
                raise NotImplementedError(
                    f"{cfg.name}: oversubscribed preemption needs full "
                    "attention — a sliding-window ring wrap overwrites "
                    "cache rows in place, so a dropped request cannot "
                    "be re-prefilled into an equivalent state")
        # these replay prefill through programs that mirror the DENSE
        # softmax bit for bit, so they refuse a prompt_pad past the dense
        # limit (blockwise prefill)
        dense = use_dense_prefill(cfg, min(prompt_pad, max_seq))
        for name, val, why in (
                ("prefix_cache", prefix_cache, "suffix prefill mirrors "
                 "its softmax formulation bit-for-bit, while blockwise "
                 "prefill accumulates online and would break cache-on/off "
                 "greedy identity"),
                ("prefill_chunk", prefill_chunk, "the continuation "
                 "programs mirror its softmax formulation bit-for-bit, "
                 "while blockwise prefill accumulates online and would "
                 "break chunked-vs-monolithic greedy identity"),
                ("oversubscribe", oversubscribe, "drop-restore re-prefill "
                 "rides the suffix-continuation programs, which mirror "
                 "the dense prefill path bit-for-bit")):
            if val and not dense:
                raise NotImplementedError(
                    f"{cfg.name}: {name} needs the dense prefill path — "
                    f"{why}")
        self.engine = engine
        self.model = engine.model
        self.device = engine.model.device
        self.cfg = cfg
        self.params = params
        self.lora = lora
        self.opt_state = opt_state
        self.adapters = adapters
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prompt_pad = min(prompt_pad, max_seq)
        self.eos_id = eos_id
        # logical cache length per slot: sliding-window archs ring-wrap
        # at the window, everyone else uses the full budget
        self.ring_len = min(max_seq, cfg.sliding_window) \
            if cfg.sliding_window > 0 else max_seq
        self.paged = paged
        self.prefix_cache: Optional[PrefixCache] = None
        if paged:
            self.block_size = block_size
            self.blocks_per_slot = blocks_for(self.ring_len, block_size)
            if n_blocks is None:
                # full worst case + scratch block 0
                n_blocks = 1 + n_slots * self.blocks_per_slot
            if n_blocks < 1 + self.blocks_per_slot:
                raise ValueError(
                    f"n_blocks {n_blocks} cannot cover one worst-case "
                    f"request ({self.blocks_per_slot} blocks + scratch); "
                    "admission would deadlock")
            self.n_blocks = n_blocks
            self.allocator = BlockAllocator(n_blocks, block_size)
            if prefix_cache:
                self.prefix_cache = PrefixCache(self.allocator)
            self.caches = self.model.init_paged_caches(n_blocks, block_size)
            # all-zero rows park inactive slots on scratch block 0
            self.block_tables = np.zeros((n_slots, self.blocks_per_slot),
                                         np.int32)
            self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
            # worst-case blocks still reserved (not yet taken) per slot
            self.slot_reserved = np.zeros(n_slots, np.int32)
            # device copy of the full table (mid-prefill rows parked on
            # scratch block 0), re-uploaded only when the host table
            # changed; each tick passes a [:, :width] view
            self._dev_tables: Optional[torch.Tensor] = None
        else:
            self.caches = self.model.init_caches(n_slots, max_seq)
        # oversubscribed pool: (1 - w) * capacity blocks stay out of
        # admission's reach, headroom for decode growth and swap-in
        # restores; preempted requests park in _swapped, restored ahead
        # of admission in deadline-slack order
        self.oversubscribe = float(oversubscribe)
        self.swap = bool(swap)
        self._headroom_blocks = 0
        self.swap_cost: Optional[_SwapCost] = None
        if self.oversubscribe > 0:
            self._headroom_blocks = self.allocator.capacity \
                - int(self.oversubscribe * self.allocator.capacity)
            self.swap_cost = _SwapCost()
        self._swapped: List[_Swapped] = []
        # chunked prefill: a paged chunk is rounded up to whole blocks
        # (write_prefill_blocks writes whole blocks; only a prompt's
        # final chunk may be ragged)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk > 0 and paged:
            self.prefill_chunk = self.block_size * blocks_for(
                self.prefill_chunk, self.block_size)
        # the width of a chunk wave: the chunk when set; otherwise (a
        # drop-restore re-prefills in chunk waves too) prompt_pad rounded
        # up to whole blocks, so one chunk covers a typical prompt
        if self.prefill_chunk > 0:
            self._prefill_pad = self.prefill_chunk
        elif paged:
            self._prefill_pad = self.block_size * blocks_for(
                self.prompt_pad, self.block_size)
        else:
            self._prefill_pad = self.prompt_pad
        self.tpot_target = float(tpot_target)
        self.budget = _TickBudget(self.tpot_target) \
            if self.tpot_target > 0 else None
        # per-slot prefill progress: prompt tokens in cache (== the goal
        # once decoding), how many of them were prefix-cache hits, and the
        # goal: the prompt length, or for a drop-restore the restore
        # sequence's (prompt and generated tokens, ``slot_seq``), whose
        # final chunk re-installs the feed token ``slot_restore_tok``
        # instead of sampling one
        self.slot_prefilled = np.zeros(n_slots, np.int32)
        self.slot_cached = np.zeros(n_slots, np.int32)
        self.slot_goal = np.zeros(n_slots, np.int32)
        self.slot_seq: List[Optional[np.ndarray]] = [None] * n_slots
        self.slot_restore_tok = np.full(n_slots, -1, np.int32)
        # what the latest step() trained: the budget may halve or skip
        # a tick's microbatch
        self.last_tick_trained = False
        self.last_tick_train_rows = 0
        self.queue: Deque[GenRequest] = collections.deque()
        self.slot_req: List[Optional[GenRequest]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)   # next write position
        self.slot_tok = np.zeros(n_slots, np.int32)   # next token to feed
        # registry mode: the adapter id each slot's request pinned
        self.slot_aid: List[Optional[str]] = [None] * n_slots
        # request-lifecycle FSM shadow, armed by REPRO_SANITIZE=1 (None
        # otherwise: each hook is one is-not-None test)
        self._lsan = lifecycle_sanitizer()
        self.stats = ServeStats()
        # prefill programs run: monolithic, suffix and chunk waves
        self.prefill_waves = 0
        # co-training: CE loss per train tick, the shadow tree a train
        # session trains instead of self.lora (None: train self.lora in
        # place), microbatches per train step, and host copies of the
        # latest step's scalar metrics
        self.train_losses: List[float] = []
        self.train_lora: Optional[Any] = None
        self.train_grad_accum: int = 1
        self.last_train_metrics: Dict[str, float] = {}

    # ------------------------------------------------------------ ingestion -
    def submit(self, req: GenRequest) -> None:
        req.prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if len(req.prompt) > self.prompt_pad:
            raise ValueError(f"prompt len {len(req.prompt)} > prompt_pad "
                             f"{self.prompt_pad}")
        if req.adapter_id is not None:
            if self.adapters is None:
                raise AdapterError(
                    f"request {req.request_id} names adapter "
                    f"{req.adapter_id!r} but this batcher has no "
                    "AdapterRegistry")
            if not self.adapters.is_registered(req.adapter_id):
                raise AdapterError(
                    f"request {req.request_id}: adapter "
                    f"{req.adapter_id!r} is not registered")
        # a slot holds prompt + generation; clamp so writes stay in-cache
        budget = self.max_seq - len(req.prompt)
        req.max_new_tokens = max(1, min(req.max_new_tokens, budget))
        if self._lsan is not None:
            self._lsan.on_submit(req)
        self.queue.append(req)

    def active_slots(self) -> List[int]:
        return [i for i in range(self.n_slots)
                if self.slot_req[i] is not None]

    def _is_prefilling(self, i: int) -> bool:
        """Slot ``i`` holds a request whose prefill goal (the prompt, or
        for a drop-restore the prompt and generated tokens) is not all in
        cache yet: parked out of the decode wave."""
        return self.slot_req[i] is not None \
            and int(self.slot_prefilled[i]) < int(self.slot_goal[i])

    def _slot_seq(self, i: int) -> np.ndarray:
        """The tokens slot ``i``'s prefill consumes: the request's prompt,
        unless a drop-restore installed a longer restore sequence."""
        seq = self.slot_seq[i]
        return seq if seq is not None else self.slot_req[i].prompt

    def decoding_slots(self) -> List[int]:
        return [i for i in self.active_slots()
                if not self._is_prefilling(i)]

    def prefilling_slots(self) -> List[int]:
        return [i for i in self.active_slots() if self._is_prefilling(i)]

    def idle(self) -> bool:
        return not self.queue and not self.active_slots() \
            and not self._swapped

    @property
    def n_preempted(self) -> int:
        """Requests parked off the device by preemption (swap or drop):
        the replica's thrashing signal."""
        return len(self._swapped)

    # ------------------------------------------------------------ admission -
    def _worst_blocks(self, req: GenRequest) -> int:
        """Worst-case blocks over the request's lifetime: prompt plus
        ``max_new_tokens - 1`` decode writes, capped by the ring."""
        tokens = min(len(req.prompt) + req.max_new_tokens - 1,
                     self.ring_len)
        return blocks_for(tokens, self.block_size)

    def _need_blocks(self, req: GenRequest, matched: List[int]) -> int:
        """Blocks to reserve for ``req`` with ``matched`` blocks aliased:
        full attention never writes an aliased block, so the match comes
        off the worst case; a sliding window may copy every aliased block
        on a ring wrap, so it reserves the whole worst case.  An
        oversubscribed batcher reserves only near-term need: the prompt's
        uncached blocks and one block of decode lookahead (growth past it
        is ``_ensure_headroom``'s: reserve, or preempt)."""
        worst = self._worst_blocks(req)
        full = worst if self.cfg.sliding_window > 0 \
            else worst - len(matched)
        if self.oversubscribe <= 0:
            return full
        return min(full, blocks_for(
            len(req.prompt) - len(matched) * self.block_size,
            self.block_size) + 1)

    # ---------------------------------------------------- adapter routing --
    def _serve_lora(self) -> Any:
        """The tree every prefill and decode reads: the registry's stacked
        device tree in multi-tenant mode, else the published adapter."""
        return self.adapters.device_lora() if self.adapters is not None \
            else self.lora

    def _wave_adapter_idx(self, reqs: List[GenRequest]):
        """Per-row registry slots of a prefill wave (pinned at admission,
        so stable), on the device; None without a registry."""
        if self.adapters is None:
            return None
        return _host_ids(np.array(
            [self.adapters.slot_index(r.adapter_id)
             if r.adapter_id is not None else -1 for r in reqs], np.int32),
            self.device)

    def _record_finish(self, req: GenRequest, now: float) -> None:
        if self._lsan is not None:
            self._lsan.on_finish(req)
        req.finished_at = now
        req.finished_wall = time.perf_counter()
        self.stats.finished += 1
        first = req.first_token_at
        if first is not None:
            self.stats.ttft.append(max(first - req.arrival, 0.0))
            if len(req.tokens) > 1:
                self.stats.tpot.append(
                    max(now - first, 0.0) / (len(req.tokens) - 1))
        if req.adapter_id is not None:
            self.stats.adapter_requests[req.adapter_id] = \
                self.stats.adapter_requests.get(req.adapter_id, 0) + 1
            self.stats.adapter_versions[req.adapter_id] = \
                self.adapters.version(req.adapter_id)

    def _sample_first(self, req: GenRequest, first: int, rows, k: int):
        """The first token of ``req``: ``first`` (the wave's argmax) when
        greedy, else drawn from the k-th logits row of ``rows`` (one host
        pull of the wave's rows, made once by the caller) on a fresh
        per-request stream."""
        if not req.samples:
            return first
        req.rng = np.random.default_rng(
            req.seed if req.seed is not None else req.request_id)
        return sample_token(rows[k], temperature=req.temperature,
                            top_k=req.top_k, top_p=req.top_p, rng=req.rng)

    def _prefill_wave(self, reqs: List[GenRequest],
                      matched: Optional[List[List[int]]] = None):
        """ONE prefill program for the whole wave and ONE batched argmax
        pull for its first tokens.  Returns (first tokens [W] np, prefill
        caches [.., W, ..], last-position logits [W, V]).  Attention
        stacks prefill the right-padded prompts ragged; with prefix-cache
        hits in the wave (``matched``: each row's aliased blocks) the
        suffix program computes only each row's uncached tokens, and the
        caches hold only those.  SSM stacks prefill each request at its
        exact length (state threads through pads) and gather its caches
        into row j of the wave's (fixed-size) caches; their
        last-position logits are stacked on the device, still ONE argmax
        pull."""
        self.prefill_waves += 1
        if self.cfg.has_ssm:
            # a hybrid's K/V rows: the wave's longest prompt (<= the ring)
            pre = self.model.init_caches(
                len(reqs), max(len(r.prompt) for r in reqs))
            lasts = []
            with torch.no_grad():
                for j, r in enumerate(reqs):
                    logits, one = self.model.prefill(
                        self.params, self._serve_lora(),
                        {"tokens": torch.tensor(r.prompt[None],
                                                dtype=torch.long,
                                                device=self.device)})
                    self.model.write_prefill_slot(pre, one, j)
                    lasts.append(logits[0, -1])
                    del one     # gathered: not alive through the next one
            last = torch.stack(lasts)
            firsts = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per prefill wave
            return firsts, pre, last
        lens = np.array([len(r.prompt) for r in reqs], np.int32)
        if matched is not None and any(matched):
            bs = self.block_size
            pre_lens = np.array([len(m) * bs for m in matched], np.int32)
            suf_lens = lens - pre_lens
            # the reference's widths: the suffix padded to whole blocks,
            # the prefix tables to a power of two over the wave's longest
            # match (extra lanes name scratch block 0 and are masked)
            suf_pad = bs * blocks_for(int(suf_lens.max()), bs)
            npre = max(len(m) for m in matched)
            npre = min(1 << (npre - 1).bit_length(),
                       blocks_for(self.prompt_pad, bs))
            padded = np.zeros((len(reqs), suf_pad), np.int32)
            pre_tables = np.zeros((len(reqs), npre), np.int32)
            for j, r in enumerate(reqs):
                padded[j, :suf_lens[j]] = r.prompt[pre_lens[j]:]
                pre_tables[j, :len(matched[j])] = matched[j]
            with torch.no_grad():
                logits, pre = self.model.prefill_ragged_suffix(
                    self.params, self._serve_lora(),
                    {"tokens": torch.tensor(padded, dtype=torch.long,
                                            device=self.device)},
                    suf_lens, pre_lens, self.caches, pre_tables,
                    adapter_idx=self._wave_adapter_idx(reqs))
        else:
            padded = np.zeros((len(reqs), self.prompt_pad), np.int32)
            for j, r in enumerate(reqs):
                padded[j, :lens[j]] = r.prompt
            tokens = torch.tensor(padded, dtype=torch.long,
                                  device=self.device)
            with torch.no_grad():
                logits, pre = self.model.prefill_ragged(
                    self.params, self._serve_lora(), {"tokens": tokens},
                    torch.tensor(lens, device=self.device),
                    adapter_idx=self._wave_adapter_idx(reqs))
        last = logits[:, -1]
        firsts = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per prefill wave
        return firsts, pre, last

    def admit(self, now: float = 0.0) -> List[GenRequest]:
        """Fill free slots from the queue, FCFS; returns requests that
        finished at admission (max_new_tokens == 1 / instant EOS).  Paged
        mode admits only while the allocator can cover the head request's
        worst case — otherwise the queue waits for an eviction.  With the
        prefix cache on, the head's longest cached block-aligned prefix
        (in its tenant's namespace) is aliased at refcount+1, trimmed
        until the pool fits it, only the suffix is prefilled, and the
        request's new full prompt blocks are registered.  With a
        registry, a request whose adapter cannot get a device slot (every
        slot pinned) is skipped for this wave and keeps its place; its
        adapter is pinned at admission.  Chunked mode only binds the
        wave to slots (``_assign_chunked``)."""
        finished: List[GenRequest] = []
        free = [i for i in range(self.n_slots) if self.slot_req[i] is None]
        reqs: List[GenRequest] = []
        # per admitted request: (aliased block chain, blocks reserved)
        plans: List = []
        picked: List[int] = []      # queue indices claimed this wave
        qi = 0
        while len(reqs) < len(free) and qi < len(self.queue):
            head = self.queue[qi]
            if head.adapter_id is not None \
                    and not self.adapters.can_acquire(head.adapter_id):
                qi += 1
                continue
            if self.paged:
                matched = self.prefix_cache.match(
                    head.prompt, namespace=head.adapter_id) \
                    if self.prefix_cache is not None else []
                # reviving retained blocks costs capacity on top of the
                # reservation: trim the match until it fits (a cold
                # admission always fits one worst-case request, so a
                # warm hit never deadlocks an idle pool).  The
                # oversubscription watermark keeps _headroom_blocks out
                # of admission's reach (0 when off)
                while matched and self.allocator.available() \
                        < self._need_blocks(head, matched) \
                        + self.allocator.n_would_revive(matched) \
                        + self._headroom_blocks:
                    matched.pop()
                need = self._need_blocks(head, matched)
                if self.allocator.available() \
                        < need + self.allocator.n_would_revive(matched) \
                        + self._headroom_blocks:
                    break           # strict FCFS backpressure
                self.allocator.acquire(matched)
                self.allocator.reserve(need)
                if self.prefix_cache is not None:
                    self.prefix_cache.count_admitted(
                        head.prompt, len(matched),
                        namespace=head.adapter_id)
                plans.append((matched, need))
            if self._lsan is not None:
                self._lsan.on_admit(head)
            if head.adapter_id is not None:
                self.adapters.acquire(head.adapter_id)
            reqs.append(head)
            picked.append(qi)
            qi += 1
        for j in reversed(picked):
            del self.queue[j]
        if not reqs:
            return finished
        if self.prefill_chunk > 0:
            self._assign_chunked(free, reqs, plans, now)
            return finished
        firsts, wave_pre, last_logits = self._prefill_wave(
            reqs, [m for m, _ in plans] if self.paged else None)
        # one batched write per wave; rows flagged with an out-of-range
        # id are dropped (requests that finished at admission)
        if self.paged:
            # the wave's width: full prompts, or just the suffixes
            nbp = blocks_for(wave_pre["kv"][0].shape[2], self.block_size)
            wave_tables = np.full((len(reqs), nbp), self.n_blocks, np.int32)
        else:
            wave_slots = np.full(len(reqs), self.n_slots, np.int32)
        rows = last_logits.float().cpu().numpy() \
            if any(r.samples for r in reqs) else None  # lint: host-sync-ok one batched logits pull per sampled admission wave
        admitted_rows = 0
        for k, (slot, req) in enumerate(zip(free, reqs)):
            first = self._sample_first(req, int(firsts[k]), rows, k)
            matched, reserved = plans[k] if self.paged else ([], 0)
            n_cached = len(matched) * self.block_size if self.paged else 0
            req.tokens.append(first)
            req.prefill_at = req.first_token_at = now
            self.stats.admitted += 1
            self.stats.prefill_tokens += len(req.prompt) - n_cached
            self.stats.cached_prefix_tokens += n_cached
            self.stats.generated_tokens += 1
            if len(req.tokens) >= req.max_new_tokens \
                    or first == self.eos_id:
                # done at admission: never occupies the slot
                self._record_finish(req, now)
                if req.adapter_id is not None:
                    self.adapters.release(req.adapter_id)
                if self.paged:
                    self.allocator.release(reserved)
                    if matched:
                        self.allocator.free(matched)
                finished.append(req)
                continue
            if self.paged:
                need = blocks_for(len(req.prompt) - n_cached,
                                  self.block_size)
                ids = self.allocator.take(need)
                self.slot_blocks[slot] = list(matched) + ids
                self.slot_reserved[slot] = reserved - need
                self.block_tables[slot, :] = 0
                self.block_tables[slot, :len(matched) + need] = \
                    self.slot_blocks[slot]
                wave_tables[k, :need] = ids
                self._register_prompt(slot, req, len(matched))
                self._dev_tables = None
            else:
                wave_slots[k] = slot
            admitted_rows += 1
            self.slot_req[slot] = req
            self.slot_aid[slot] = req.adapter_id
            self.slot_pos[slot] = len(req.prompt)
            self.slot_tok[slot] = first
            self.slot_prefilled[slot] = self.slot_goal[slot] = \
                len(req.prompt)
            self.slot_cached[slot] = n_cached
        if admitted_rows and self.paged:
            self.caches = self.model.write_prefill_blocks(
                self.caches, wave_pre, wave_tables)
        elif admitted_rows:
            self.caches = self.model.write_prefill_slots(
                self.caches, wave_pre, wave_slots)
        return finished

    def _register_prompt(self, slot: int, req: GenRequest,
                         n_matched: int) -> None:
        """Register the slot's new full prompt blocks in the prefix cache
        — unless the request's decode will wrap the ring back into them:
        they would be overwritten mid-flight, and an owner copying its
        own registered blocks would outrun its reservation."""
        wraps = len(req.prompt) + req.max_new_tokens - 1 > self.ring_len
        if self.prefix_cache is not None and not wraps:
            self.prefix_cache.register(req.prompt, self.slot_blocks[slot],
                                       n_matched, namespace=req.adapter_id)

    # ------------------------------------------------------ chunked prefill -
    def _assign_chunked(self, free: List[int], reqs: List[GenRequest],
                        plans: List, now: float) -> None:
        """Chunked admission: bind each request to a slot in the
        prefilling state (no prefill program runs here), starting from
        its aliased prefix.  The slot stays out of the decode wave until
        ``_advance_prefill`` lands its final chunk."""
        for k, (slot, req) in enumerate(zip(free, reqs)):
            matched, reserved = plans[k] if self.paged else ([], 0)
            n_cached = len(matched) * self.block_size if self.paged else 0
            req.prefill_at = now
            self.stats.admitted += 1
            self.stats.cached_prefix_tokens += n_cached
            self.slot_req[slot] = req
            self.slot_aid[slot] = req.adapter_id
            self.slot_prefilled[slot] = n_cached
            self.slot_goal[slot] = len(req.prompt)
            self.slot_cached[slot] = n_cached
            # parked: the decode wave's write for this row lands at
            # position ``slot_prefilled`` (contiguous: the next chunk
            # overwrites it before it is read) or on scratch block 0
            # (paged: the device table row is zeroed)
            self.slot_pos[slot] = n_cached
            self.slot_tok[slot] = 0
            if self.paged:
                self.slot_blocks[slot] = list(matched)
                self.slot_reserved[slot] = reserved
                self.block_tables[slot, :] = 0
                self.block_tables[slot, :len(matched)] = matched
                self._dev_tables = None

    def _advance_prefill(self, now: float, allowance: float):
        """Spend up to ``allowance`` prefill tokens on the most urgent
        prefilling slots (deadline-slack order), one chunk per slot, as
        ONE wave program and ONE batched cache write.  A slot whose final
        chunk lands takes its first token from the wave's logits and
        joins this tick's decode wave.  Returns (requests finished at
        prefill completion, measured seconds)."""
        done: List[GenRequest] = []
        pref = self.prefilling_slots()
        if not pref or allowance <= 0:
            return done, 0.0
        order = slack_order(pref, now,
                            key=lambda i: self.slot_req[i].deadline)
        rows: List = []             # (slot, chunk_len)
        used = 0
        for i in order:
            c = min(int(self.slot_goal[i]) - int(self.slot_prefilled[i]),
                    self._prefill_pad)
            if rows and used + c > allowance:
                break               # the first chunk always goes
            rows.append((i, c))
            used += c
            if used >= allowance:
                break
        t0 = time.perf_counter()
        wave_reqs = [self.slot_req[i] for i, _ in rows]
        pre_lens = self.slot_prefilled[[i for i, _ in rows]]    # a copy
        logits = self._chunk_wave(rows, pre_lens)
        final = [j for j, (i, c) in enumerate(rows)
                 if int(pre_lens[j]) + c >= int(self.slot_goal[i])]
        nxt = host_rows = None
        if final:
            last = logits[:, -1]
            nxt = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per chunk wave
            if any(wave_reqs[j].samples for j in final):
                host_rows = last.float().cpu().numpy()  # lint: host-sync-ok one batched logits pull per sampling chunk wave
        for j, (i, c) in enumerate(rows):
            req = wave_reqs[j]
            p = int(pre_lens[j]) + c
            self.slot_prefilled[i] = p
            self.stats.prefill_tokens += c
            if p < int(self.slot_goal[i]):
                self.slot_pos[i] = p    # stay parked at the frontier
                continue
            if int(self.slot_restore_tok[i]) >= 0:
                # a drop-restore's final chunk: every generated token was
                # emitted before the preemption, so re-install the decode
                # frontier (next position, stored feed token) instead of
                # sampling
                self.slot_pos[i] = int(self.slot_goal[i])
                self.slot_tok[i] = int(self.slot_restore_tok[i])
                self.slot_restore_tok[i] = -1
                self.slot_seq[i] = None
                continue
            # the final chunk's logits row is the whole prompt's last
            # token's
            first = self._sample_first(req, int(nxt[j]), host_rows, j)
            req.tokens.append(first)
            req.first_token_at = now
            self.stats.generated_tokens += 1
            if self.paged:
                self._register_prompt(
                    i, req, int(self.slot_cached[i]) // self.block_size)
            if len(req.tokens) >= req.max_new_tokens \
                    or first == self.eos_id:
                self._record_finish(req, now)
                self._evict(i)
                done.append(req)
                continue
            self.slot_pos[i] = len(req.prompt)
            self.slot_tok[i] = first
        dt = time.perf_counter() - t0
        if self.budget is not None:
            self.budget.observe_prefill(used, dt)
        if self.swap_cost is not None:
            self.swap_cost.observe_prefill(used, dt)
        return done, dt

    def _chunk_wave(self, rows: List, pre_lens: np.ndarray):
        """Run one chunk wave's program and land its K/V: row j prefills
        ``rows[j] = (slot, chunk length)`` from token ``pre_lens[j]`` of
        its sequence (``_slot_seq``), over the K/V already in cache, and
        its chunk lands in fresh blocks (paged) or its slot's rows
        (contiguous).  Returns the wave's logits at each row's last chunk
        token [W, 1, V]."""
        w = len(rows)
        slots = [i for i, _ in rows]
        chunk_lens = np.array([c for _, c in rows], np.int32)
        tokens = np.zeros((w, self._prefill_pad), np.int32)
        for j, (i, c) in enumerate(rows):
            p = int(pre_lens[j])
            tokens[j, :c] = self._slot_seq(i)[p:p + c]
        tokens = torch.tensor(tokens, dtype=torch.long, device=self.device)
        adapter_idx = self._wave_adapter_idx(
            [self.slot_req[i] for i in slots])
        if self.paged:
            bs = self.block_size
            # prefix tables: each slot's blocks so far, width a power of
            # two (extra lanes name scratch block 0, masked by pre_lens)
            npre = max(max(len(self.slot_blocks[i]) for i in slots), 1)
            npre = min(1 << (npre - 1).bit_length(), self.blocks_per_slot)
            pre_tables = np.zeros((w, npre), np.int32)
            for j, i in enumerate(slots):
                pre_tables[j, :len(self.slot_blocks[i])] = \
                    self.slot_blocks[i]
            with torch.no_grad():
                logits, pre = self.model.prefill_ragged_suffix(
                    self.params, self._serve_lora(), {"tokens": tokens},
                    chunk_lens, pre_lens, self.caches, pre_tables,
                    adapter_idx=adapter_idx)
            # the chunk lands in fresh blocks against each slot's
            # admission-time reservation (chunks are whole blocks, so
            # their blocks add up to the monolithic count)
            wave_tables = np.full((w, blocks_for(self._prefill_pad, bs)),
                                  self.n_blocks, np.int32)
            for j, (i, c) in enumerate(rows):
                need = blocks_for(c, bs)
                if self.slot_reserved[i] < need:
                    raise RuntimeError(
                        f"slot {i}: chunk beyond admission reservation")
                ids = self.allocator.take(need)
                self.slot_reserved[i] -= need
                base = len(self.slot_blocks[i])
                self.slot_blocks[i].extend(ids)
                self.block_tables[i, base:base + need] = ids
                wave_tables[j, :need] = ids
            self._dev_tables = None
            self.caches = self.model.write_prefill_blocks(
                self.caches, pre, wave_tables)
        else:
            with torch.no_grad():
                logits, pre = self.model.prefill_ragged_continue(
                    self.params, self._serve_lora(), {"tokens": tokens},
                    chunk_lens, pre_lens, self.caches, slots,
                    adapter_idx=adapter_idx)
            self.caches = self.model.write_prefill_rows(
                self.caches, pre, slots, pre_lens, chunk_lens)
        self.prefill_waves += 1
        return logits

    # --------------------------------------------------- preemption / swap -
    def _block_bytes(self) -> int:
        """Bytes one pool block holds across the K/V leaves (the swap cost
        model's unit)."""
        return sum(t.numel() * t.element_size()
                   for t in self.caches["kv"]) // self.n_blocks

    def _pick_victim(self, protect: int, now: float) -> Optional[int]:
        """The victim of one preemption: among active slots that would
        return pool capacity (a sole-referenced block to free, or an
        unused reservation), the one with the MOST deadline slack; the
        cheapest to restore (fewest rows) breaks ties.  ``slack_order``
        puts the most urgent first, so the victim is its last."""
        cands = []
        for j in self.active_slots():
            if j == protect:
                continue
            gain = int(self.slot_reserved[j]) + sum(
                1 for b in self.slot_blocks[j] if self.allocator.ref(b) == 1)
            if gain > 0:
                cands.append(j)
        if not cands:
            return None
        # a stable pre-sort by restore cost, so slack ties fall to the
        # cheapest victim once the most-slack end is taken
        cands.sort(key=lambda j: -int(self.slot_pos[j]))
        order = slack_order(cands, now,
                            key=lambda j: self.slot_req[j].deadline)
        return order[-1]

    def _preempt(self, i: int, now: float) -> None:
        """Preempt slot ``i``: park its request off the device and return
        its private pool capacity.  The shared or prefix-registered start
        of its chain stays in the pool with its references held; the
        private tail either swaps to host memory (one indexed gather per
        K/V leaf and one synchronous copy to the CPU) or is dropped for a
        re-prefill from the request's token ids, whichever ``_SwapCost``
        prices cheaper.  The adapter pin is kept across the preemption,
        so a restore never waits on adapter residency."""
        req = self.slot_req[i]
        chain = self.slot_blocks[i]

        def resident(b: int) -> bool:
            return self.allocator.ref(b) > 1 \
                or (self.prefix_cache is not None
                    and self.prefix_cache.is_registered(b))

        kept = 0
        while kept < len(chain) and resident(chain[kept]):
            kept += 1
        tail = chain[kept:]
        # under full attention resident blocks form the START of a chain
        # (decode never writes shared or registered blocks, and only full
        # prompt blocks register); a resident block further in forces the
        # drop path, whose ``free`` handles shared and registered blocks
        mode = "swap"
        if self._is_prefilling(i) or not tail \
                or any(resident(b) for b in tail) or not self.swap:
            mode = "reprefill"
        elif not self.swap_cost.prefer_swap(
                len(tail) * self._block_bytes(),
                int(self.slot_pos[i]) - kept * self.block_size):
            mode = "reprefill"
        if mode == "swap":
            t0 = time.perf_counter()
            got = self.model.gather_blocks(self.caches, tail)["kv"]
            host_kv = tuple(t.cpu() for t in got)  # lint: host-sync-ok one batched device-to-host block copy per swap-out
            self.allocator.swap_out(tail)
            self.swap_cost.observe_swap(len(tail) * self._block_bytes(),
                                        time.perf_counter() - t0)
            entry = _Swapped(
                req=req, adapter_id=self.slot_aid[i], mode="swap",
                kept=chain[:kept], host_kv=host_kv, n_tail=len(tail),
                pos=int(self.slot_pos[i]), tok=int(self.slot_tok[i]),
                cached=int(self.slot_cached[i]))
            self.stats.swap_out_blocks += len(tail)
        else:
            # drop the whole chain: shared blocks lose this alias,
            # registered sole-referenced ones park in the retained pool
            # and revive through the prefix cache at the restore
            if chain:
                self.allocator.free(chain)
            entry = _Swapped(
                req=req, adapter_id=self.slot_aid[i], mode="reprefill",
                kept=[], host_kv=None, n_tail=0,
                pos=int(self.slot_pos[i]), tok=int(self.slot_tok[i]),
                cached=0)
        self._swapped.append(entry)
        self.stats.preemptions += 1
        # clear the slot WITHOUT finishing the request (it stays active in
        # the lifecycle FSM: a restore is not an admission) and WITHOUT
        # releasing its adapter pin
        self.allocator.release(int(self.slot_reserved[i]))
        self.slot_reserved[i] = 0
        self.slot_req[i] = None
        self.slot_aid[i] = None
        self.slot_blocks[i] = []
        self._reset_slot(i)

    def _ensure_headroom(self, active: List[int], now: float) -> List[int]:
        """Oversubscribed decode: every slot whose write crosses into a
        new block this tick must hold a reservation for it BEFORE
        ``_grow_tables`` takes one.  On pool exhaustion, preempt victims
        (most deadline slack first) until the reservation fits; as a last
        resort the needy slot preempts itself.  Returns the active slots
        that were not preempted."""
        active = list(active)
        for i in list(active):
            if self.slot_req[i] is None or i not in active:
                continue
            wr = int(self.slot_pos[i]) % self.ring_len
            if wr // self.block_size < len(self.slot_blocks[i]) \
                    or int(self.slot_reserved[i]) > 0:
                continue
            while not self.allocator.can_reserve(1):
                victim = self._pick_victim(protect=i, now=now)
                if victim is None:
                    victim = i      # last resort: the needy slot itself
                self._preempt(victim, now)
                if victim in active:
                    active.remove(victim)
                if victim == i:
                    break
            if self.slot_req[i] is not None:
                self.allocator.reserve(1)
                self.slot_reserved[i] += 1
        return active

    def _demote(self, e: _Swapped) -> None:
        """Give up a parked entry's pool footprint: drop its kept-chain
        references (registered blocks park retained, shared ones lose
        this alias) and its host K/V; it restores by re-prefill."""
        if e.kept:
            self.allocator.free(e.kept)
            e.kept = []
        e.host_kv = None
        e.n_tail = 0
        e.mode = "reprefill"
        e.cached = 0

    def _demote_one(self, prefer_not: int) -> bool:
        """Demote one demotable parked entry, any but ``prefer_not`` (the
        one being forced in) first.  False when none is left."""
        cand = None
        for k, e in enumerate(self._swapped):
            if e.mode == "swap" or e.kept:
                if k != prefer_not:
                    cand = k
                elif cand is None:
                    cand = k
        if cand is None:
            return False
        self._demote(self._swapped[cand])
        return True

    def _try_restore(self, e: _Swapped, slot: int) -> bool:
        """Put one parked request back into free slot ``slot``.  Swap
        mode: fresh blocks, and the host K/V copied back into them
        (``Model.scatter_blocks``); decode resumes where it stopped.
        Reprefill mode: back to the prefilling state over the prompt and
        generated tokens (the chunk programs recompute the dropped K/V;
        the final chunk re-installs the stored feed token).  Returns
        False, with no side effect, when the pool cannot cover it yet."""
        req = e.req
        bs = self.block_size
        if e.mode == "swap":
            if not self.allocator.can_reserve(e.n_tail):
                return False
            ids = self.allocator.swap_in(e.n_tail)
            self.caches = self.model.scatter_blocks(self.caches, ids,
                                                    e.host_kv)
            self.slot_blocks[slot] = list(e.kept) + ids
            self.slot_reserved[slot] = 0
            self.slot_prefilled[slot] = self.slot_goal[slot] = \
                len(req.prompt)
            self.slot_cached[slot] = e.cached
            self.slot_pos[slot] = e.pos
            self.slot_tok[slot] = e.tok
            self.slot_seq[slot] = None
            self.slot_restore_tok[slot] = -1
            self.stats.swap_in_blocks += e.n_tail
        else:
            # re-prefill the prompt and every generated token but the
            # last, whose K/V is never needed: it is the next token to
            # FEED, which slot_restore_tok re-installs
            seq = req.prompt if not req.tokens else np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
            matched = self.prefix_cache.match(
                req.prompt, namespace=e.adapter_id) \
                if self.prefix_cache is not None else []
            worst = self._worst_blocks(req)

            def need_for(m):
                return min(worst - len(m),
                           blocks_for(len(seq) - len(m) * bs, bs) + 1)

            while matched and self.allocator.available() \
                    < need_for(matched) \
                    + self.allocator.n_would_revive(matched):
                matched.pop()
            need = need_for(matched)
            if self.allocator.available() \
                    < need + self.allocator.n_would_revive(matched):
                return False
            self.allocator.acquire(matched)
            self.allocator.reserve(need)
            n_cached = len(matched) * bs
            self.slot_blocks[slot] = list(matched)
            self.slot_reserved[slot] = need
            self.slot_prefilled[slot] = n_cached
            self.slot_goal[slot] = len(seq)
            self.slot_cached[slot] = n_cached
            self.slot_pos[slot] = n_cached
            self.slot_tok[slot] = 0
            self.slot_seq[slot] = seq if req.tokens else None
            self.slot_restore_tok[slot] = req.tokens[-1] \
                if req.tokens else -1
            self.stats.reprefill_tokens += len(seq) - n_cached
        self.slot_req[slot] = req
        self.slot_aid[slot] = e.adapter_id
        self.block_tables[slot, :] = 0
        blks = self.slot_blocks[slot]
        self.block_tables[slot, :len(blks)] = blks
        self._dev_tables = None
        return True

    def _restore(self, now: float) -> None:
        """Bring preempted requests back into free slots ahead of
        admission, most urgent (least deadline slack) first; entries the
        pool cannot cover yet stay parked.  If nothing else can run (no
        active slot, and no queue or a head that cannot be admitted
        either), the other parked entries' kept chains are demoted to
        re-prefill until the most urgent restore goes through: the
        batcher never livelocks on its own parked work."""
        free = [i for i in range(self.n_slots) if self.slot_req[i] is None]
        if not free:
            return
        order = slack_order(list(range(len(self._swapped))), now,
                            key=lambda k: self._swapped[k].req.deadline)
        restored = set()
        for k in order:
            if not free:
                break
            if self._try_restore(self._swapped[k], free[0]):
                free.pop(0)
                restored.add(k)
        if not restored and free and not self.active_slots():
            blocked_queue = False
            if self.queue:
                # a cold admission's need (a prefix match only shrinks
                # it, so "fits" is exact)
                head = self.queue[0]
                need = min(self._worst_blocks(head),
                           blocks_for(len(head.prompt), self.block_size) + 1)
                blocked_queue = self.allocator.available() \
                    < need + self._headroom_blocks
            if not self.queue or blocked_queue:
                k = order[0]
                while not self._try_restore(self._swapped[k], free[0]):
                    if not self._demote_one(k):
                        break
                if self.slot_req[free[0]] is not None:
                    restored.add(k)
        if restored:
            self._swapped = [e for k, e in enumerate(self._swapped)
                             if k not in restored]

    # --------------------------------------------------------------- decode -
    def _grow_tables(self, active: List[int]) -> None:
        """Make the block each slot's next write lands in writable:
        allocate it when the table doesn't cover it yet (one block at a
        time, against the slot's admission-time reservation); with the
        prefix cache on, copy a covered block that is shared (refcount >
        1: a ring wrap re-entering an aliased prompt block) to a private
        one first, and unregister a registered refcount-1 block, so its
        cache entry never goes stale in place.  A tick's copies run as
        one ``copy_blocks`` call."""
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for i in active:
            bidx = (int(self.slot_pos[i]) % self.ring_len) // self.block_size
            if bidx >= len(self.slot_blocks[i]):
                if self.slot_reserved[i] <= 0:
                    raise RuntimeError(
                        f"slot {i}: growth beyond admission reservation")
                (bid,) = self.allocator.take(1)
                self.slot_reserved[i] -= 1
                self.slot_blocks[i].append(bid)
                self.block_tables[i, bidx] = bid
                self._dev_tables = None
            elif self.prefix_cache is not None:
                bid = self.slot_blocks[i][bidx]
                if self.allocator.ref(bid) > 1:
                    if self.slot_reserved[i] <= 0:
                        raise RuntimeError(
                            f"slot {i}: copy-on-write beyond reservation")
                    (nb,) = self.allocator.take(1)
                    self.slot_reserved[i] -= 1
                    cow_src.append(bid)
                    cow_dst.append(nb)
                    self.allocator.free([bid])   # drop our alias
                    self.slot_blocks[i][bidx] = nb
                    self.block_tables[i, bidx] = nb
                    self._dev_tables = None
                elif self.prefix_cache.is_registered(bid):
                    self.prefix_cache.unregister_block(bid)
        if cow_src:
            self.caches = self.model.copy_blocks(self.caches, cow_src,
                                                 cow_dst)

    def _table_width(self, active: List[int]) -> int:
        """Live-table width: the decode tick only walks blocks up to the
        longest active slot, rounded up to 1, 2, then multiples of 2 (the
        JAX runtime's bucketing; the kernel takes any width)."""
        need = max(len(self.slot_blocks[i]) for i in active)
        width = need if need <= 2 else 2 * (-(-need // 2))
        return min(width, self.blocks_per_slot)

    def step(self, train_batch: Optional[Dict[str, Any]] = None,
             now: float = 0.0) -> List[GenRequest]:
        """One runtime tick: admit, spend the tick's prefill allowance on
        chunks (chunked mode), advance every DECODING slot one token —
        fused with a LoRA train step on ``train_batch`` when one is given
        and the token budget (``tpot_target``) leaves room for it (full,
        half or skipped); a tick with no decoding slot trains alone.
        Returns the requests that finished this tick."""
        if train_batch is not None and self.opt_state is None:
            raise ValueError(
                "step(train_batch=...) requires opt_state (pass it to "
                "the ContinuousBatcher constructor)")
        if train_batch is not None:
            train_batch = self._device_batch(train_batch)
        budget = self.budget
        self.last_tick_trained = False
        self.last_tick_train_rows = 0
        if self._swapped:
            self._restore(now)
        finished = self.admit(now)
        prefill_spent = 0.0
        if self.prefilling_slots():
            allowance = float("inf") if budget is None else \
                budget.prefill_allowance(len(self.decoding_slots()))
            done, prefill_spent = self._advance_prefill(now, allowance)
            finished.extend(done)
        active = self.decoding_slots()
        if self.oversubscribe > 0 and active:
            # reserve, or preempt, BEFORE _grow_tables takes fresh blocks
            active = self._ensure_headroom(active, now)
        if train_batch is not None:
            b, s = train_batch["tokens"].shape[:2]
        if not active:
            if train_batch is not None:
                tt: Optional[int] = 0
                if budget is not None and self.prefilling_slots():
                    # mid-prefill slots wait on TTFT: train only in the
                    # slack this tick has left
                    tt = budget.train_tokens(b, s, prefill_spent)
                if tt is None:
                    self.stats.train_skipped_ticks += 1
                else:
                    t0 = time.perf_counter()
                    self._plain_train(train_batch, train_tokens=tt)
                    rows = b if tt == 0 else max(1, min(b, tt // s))
                    if budget is not None:
                        budget.observe_train(rows * s,
                                             time.perf_counter() - t0)
                    self.last_tick_trained = True
                    self.last_tick_train_rows = rows
            self._record_budget(prefill_spent)
            return finished
        toks = _host_ids(self.slot_tok[:, None], self.device)
        if self.paged:
            self._grow_tables(active)
            pref = self.prefilling_slots()
            pos_host = self.slot_pos
            if pref:
                # parked rows write and read scratch block 0 at offset 0
                # (their table rows are zeroed below), so their lane never
                # indexes past the live table width
                pos_host = pos_host.copy()
                pos_host[pref] = 0
            pos = _host_ids(pos_host, self.device)
            if self._dev_tables is None:
                tbl = self.block_tables
                if pref:
                    tbl = tbl.copy()
                    tbl[pref, :] = 0
                self._dev_tables = _host_ids(tbl, self.device)
            tables = self._dev_tables[:, :self._table_width(active)]
        else:
            pos = _host_ids(self.slot_pos, self.device)
        if self._lsan is not None:
            self._sanitize_wave(active)
        # registry mode: each slot's device adapter slot, -1 for inactive
        # and base-only slots (their rows take the base product bitwise)
        serve_idx = None
        if self.adapters is not None:
            idx = np.full(self.n_slots, -1, np.int32)
            for i in active:
                if self.slot_aid[i] is not None:
                    idx[i] = self.adapters.slot_index(self.slot_aid[i])
            serve_idx = _host_ids(idx, self.device)
        # the budget fits the train microbatch into the tick's slack:
        # full, half or skipped (tt None)
        tt = 0
        train_rows = 0
        if train_batch is not None:
            if budget is not None:
                tt = budget.train_tokens(b, s, prefill_spent)
            if tt is None:
                self.stats.train_skipped_ticks += 1
            else:
                train_rows = b if tt == 0 else max(1, min(b, tt // s))
        t0 = time.perf_counter()
        if train_batch is not None and tt is not None:
            if self.paged:
                (new_tl, self.opt_state, logits, self.caches,
                 metrics) = self.engine.combined_step_paged(
                    self.params, self._train_adapter(), self.opt_state,
                    train_batch, self.caches, toks, pos, tables,
                    ring_len=self.ring_len, serve_lora=self._serve_lora(),
                    grad_accum=self.train_grad_accum, train_tokens=tt,
                    serve_adapter_idx=serve_idx)
            else:
                (new_tl, self.opt_state, logits, self.caches,
                 metrics) = self.engine.combined_step(
                    self.params, self._train_adapter(), self.opt_state,
                    train_batch, self.caches, toks, pos,
                    serve_lora=self._serve_lora(),
                    grad_accum=self.train_grad_accum, train_tokens=tt,
                    serve_adapter_idx=serve_idx)
            self._store_trained(new_tl)
            self._record_train(metrics)
            self.last_tick_trained = True
            self.last_tick_train_rows = train_rows
        elif self.paged:
            logits, self.caches = self.model.decode_step_paged(
                self.params, self._serve_lora(), self.caches, toks, pos,
                tables, ring_len=self.ring_len, adapter_idx=serve_idx)
        else:
            logits, self.caches = self.model.decode_step(
                self.params, self._serve_lora(), self.caches, toks, pos,
                adapter_idx=serve_idx)
        self.stats.decode_steps += 1
        last = logits[:, -1]
        nxt = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per decode wave
        dt = time.perf_counter() - t0
        if budget is not None:
            if self.last_tick_trained:
                # the fused tick's train share: what exceeded the known
                # decode cost
                budget.observe_train(
                    train_rows * s,
                    max(dt - (budget.decode_tick_s or 0.0), 0.0))
            else:
                budget.observe_decode(dt)
        self._record_budget(prefill_spent + dt)
        if any(self.slot_req[i].samples for i in active):
            # ONE batched host fetch of the wave's logits rows
            rows = last.float().cpu().numpy()  # lint: host-sync-ok one batched logits pull per sampling tick
            nxt = nxt.copy()
            for i in active:
                req = self.slot_req[i]
                if req.samples:
                    nxt[i] = sample_token(
                        rows[i], temperature=req.temperature,
                        top_k=req.top_k, top_p=req.top_p, rng=req.rng)
        for i in active:
            req = self.slot_req[i]
            req.tokens.append(int(nxt[i]))
            self.stats.generated_tokens += 1
            self.slot_pos[i] += 1
            self.slot_tok[i] = nxt[i]
            if len(req.tokens) >= req.max_new_tokens \
                    or int(nxt[i]) == self.eos_id:
                self._record_finish(req, now)
                self._evict(i)
                finished.append(req)
        return finished

    def _sanitize_wave(self, active: List[int]) -> None:
        """REPRO_SANITIZE=1 only (``_lsan`` gates the call): check the wave
        the decode program is about to read — every slot holds an active
        request, every gathered block is live, every write target is
        private and not scratch, reservations balance, and every routed
        adapter slot is pinned, resident and not mid-publish."""
        self._lsan.check_decode_wave(self, active)
        if self.paged and self.allocator.san is not None:
            self.allocator.san.check_decode_wave(self, active)
        if self.adapters is not None and self.adapters.san is not None:
            self.adapters.san.check_decode_wave(self, active)

    def _reset_slot(self, i: int) -> None:
        """Clear slot ``i``'s position, feed token (a stale one would leak
        into the next request's first tick), prefill progress and restore
        state, and park its table row on scratch block 0."""
        self.slot_pos[i] = 0
        self.slot_tok[i] = 0
        self.slot_prefilled[i] = 0
        self.slot_cached[i] = 0
        self.slot_goal[i] = 0
        self.slot_seq[i] = None
        self.slot_restore_tok[i] = -1
        if self.paged:
            self.block_tables[i, :] = 0
            self._dev_tables = None

    def _evict(self, i: int) -> None:
        """Free slot ``i`` completely: its request and slot state, its
        adapter pin, plus its blocks and unused reservation in paged
        mode."""
        self.slot_req[i] = None
        self._reset_slot(i)
        if self.slot_aid[i] is not None:
            # unpin the request's adapter: a leaked ref would pin the slot
            # forever and eventually stall admission
            self.adapters.release(self.slot_aid[i])
            self.slot_aid[i] = None
        if self.paged:
            self.allocator.free(self.slot_blocks[i])
            self.slot_blocks[i] = []
            self.allocator.release(int(self.slot_reserved[i]))
            self.slot_reserved[i] = 0
            if self.allocator.san is not None:
                self.allocator.san.check_evicted(self, i)

    def drain_all(self) -> List[GenRequest]:
        """Evict every active slot, clear the queue and the parked
        (preempted) requests, and return all unfinished requests with
        their partial tokens discarded.  In paged mode every block and
        reservation returns to the allocator, and every adapter pin to the
        registry (queued requests hold none; parked ones keep theirs until
        here)."""
        out: List[GenRequest] = list(self.queue)
        self.queue.clear()
        for i in self.active_slots():
            req = self.slot_req[i]
            self._evict(i)
            out.append(req)
        for e in self._swapped:
            if e.kept:
                self.allocator.free(e.kept)
            if e.adapter_id is not None:
                self.adapters.release(e.adapter_id)
            out.append(e.req)
        self._swapped.clear()
        for r in out:
            r.tokens.clear()
            r.prefill_at = None
            r.rng = None
            if self._lsan is not None:
                self._lsan.on_drain(r)
        if self.paged and self.allocator.san is not None:
            self.allocator.san.check_quiescent(self)
        return out

    # ------------------------------------------------------------- train -
    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A train batch (numpy arrays or tensors) on the model's device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _train_adapter(self) -> Any:
        """The tree the optimizer steps: the staged shadow during a
        train session, the published adapter otherwise (in-place
        continuous adaptation); prefill and decode read ``self.lora``
        (or, with a registry, the registry's stacked tree)."""
        return self.train_lora if self.train_lora is not None \
            else self.lora

    def _store_trained(self, new_tl: Any) -> None:
        if self.train_lora is not None:
            self.train_lora = new_tl
        else:
            self.lora = new_tl

    def _plain_train(self, train_batch: Dict[str, Any],
                     train_tokens: int = 0) -> None:
        """A train step alone (a tick with no decoding slot)."""
        new_tl, self.opt_state, metrics = self.engine.train_step(
            self.params, self._train_adapter(), self.opt_state,
            train_batch, grad_accum=self.train_grad_accum,
            train_tokens=train_tokens)
        self._store_trained(new_tl)
        self._record_train(metrics)

    def _record_budget(self, spent_s: float) -> None:
        """Per-tick budget counters (tpot_target > 0 only)."""
        if self.budget is None:
            return
        self.stats.budget_ticks += 1
        self.stats.budget_target_s += self.budget.target_s
        self.stats.budget_spent_s += spent_s

    def _record_train(self, metrics: Dict[str, Any]) -> None:
        """One host pull per train tick: the loss history and the scalar
        gradient stats the noise-scale estimator consumes."""
        names = ("ce_loss", "micro_grad_sqnorm", "grad_sqnorm")
        vals = torch.stack([metrics[k].float() for k in names])
        host = vals.cpu().tolist()  # lint: host-sync-ok one batched metrics pull per train tick
        self.last_train_metrics = dict(zip(names, host))
        loss = self.last_train_metrics["ce_loss"]
        self.train_losses.append(loss)
        self.stats.train_loss = loss
        self.stats.train_steps += 1

    # ------------------------------------------------------------------ run -
    def run(self, requests: Sequence[GenRequest],
            train_data_fn: Optional[Callable[[], Dict[str, Any]]] = None
            ) -> ServeStats:
        """Drain ``requests`` to completion; with ``train_data_fn``, every
        tick co-runs a LoRA train step on the batch it returns."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while not self.idle():
            tb = train_data_fn() if train_data_fn is not None else None
            self.step(train_batch=tb, now=time.perf_counter() - t0)
        # every tick ended in its argmax pull, so the device is done
        self.stats.wall_time += time.perf_counter() - t0
        return self.stats

    # ---------------------------------------------------------- telemetry --
    def cache_bytes(self) -> int:
        """Allocated cache bytes: KV (pool + tables), an SSM stack's conv
        tails and states, or a hybrid's both."""
        leaves = list(self.caches.get("kv", ())) + (
            tree_leaves(self.caches["ssm"]) if self.cfg.has_ssm else [])
        total = sum(t.numel() * t.element_size() for t in leaves)
        if self.paged:
            total += self.block_tables.nbytes
        return total


# =========================================================================
# Lock-step static-batch baseline
# =========================================================================
def static_batch_serve(engine, params, lora, requests: Sequence[GenRequest],
                       *, batch_size: int = 8, prompt_pad: int = 32,
                       max_seq: int = 128,
                       eos_id: Optional[int] = None) -> ServeStats:
    """The serving loop before continuous batching: group requests into
    fixed batches, prefill a batch (``Model.prefill_ragged``), then decode
    it lock-step over contiguous caches (``Model.decode_step``) until every
    request of the batch finishes (max_new_tokens or EOS); finished
    requests ride along as dead slots.  The greedy math and the EOS rule
    are ``ContinuousBatcher``'s, so a throughput difference is pure
    scheduling.

    Under a mesh (``sharding_context``; ``params`` this rank's blocks)
    every rank runs this loop on the same requests: the model returns
    every sequence's logits on every rank, so all ranks pull the same
    argmax and admit, decode and finish alike."""
    model = engine.model
    cfg = model.cfg
    refuse_encoder(cfg)
    if cfg.has_ssm or cfg.family is Family.VLM:
        raise NotImplementedError(
            f"{cfg.name}: the static baseline supports attention-only "
            "stacks")
    dev = model.device
    stats = ServeStats()
    t0 = time.perf_counter()

    def finish(r: GenRequest) -> None:
        r.finished_at = time.perf_counter() - t0
        r.finished_wall = time.perf_counter()
        stats.finished += 1

    reqs = list(requests)
    for lo in range(0, len(reqs), batch_size):
        batch = reqs[lo:lo + batch_size]
        bsz = len(batch)
        lens = np.array([len(r.prompt) for r in batch], np.int32)
        padded = np.zeros((bsz, prompt_pad), np.int32)
        for i, r in enumerate(batch):
            padded[i, :lens[i]] = r.prompt
            r.max_new_tokens = max(
                1, min(r.max_new_tokens, max_seq - int(lens[i])))
        with torch.no_grad():
            logits, pre = model.prefill_ragged(
                params, lora,
                {"tokens": torch.tensor(padded, dtype=torch.long,
                                        device=dev)},
                torch.tensor(lens, device=dev))
            caches = model.write_prefill_slots(
                model.init_caches(bsz, max_seq), pre, np.arange(bsz))
        toks = logits[:, -1].argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per prefill batch
        pos = lens.copy()
        stats.admitted += bsz
        stats.prefill_tokens += int(lens.sum())
        for i, r in enumerate(batch):
            r.tokens.append(int(toks[i]))
            stats.generated_tokens += 1
            if len(r.tokens) >= r.max_new_tokens or int(toks[i]) == eos_id:
                finish(r)
        # lock-step decode: every slot pays until the batch's LAST
        # request finishes; finished requests are dead weight
        while not all(r.done for r in batch):
            with torch.no_grad():
                logits, caches = model.decode_step(
                    params, lora, caches, _host_ids(toks[:, None], dev),
                    _host_ids(pos, dev))
            stats.decode_steps += 1
            toks = logits[:, -1].argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per decode step
            pos += 1
            for i, r in enumerate(batch):
                if r.done:
                    continue
                r.tokens.append(int(toks[i]))
                stats.generated_tokens += 1
                if len(r.tokens) >= r.max_new_tokens \
                        or int(toks[i]) == eos_id:
                    finish(r)
    stats.wall_time += time.perf_counter() - t0
    return stats
