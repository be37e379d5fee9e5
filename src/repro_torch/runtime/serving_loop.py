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
recurrence.  Paged caches and multi-tenant adapters refuse SSM
stacks, as in the reference.

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

Prompts past the dense limit (``prompt_pad``^2 > 1M) prefill blockwise,
on the card through the flash_attention kernels.  Not ported yet (the
constructor raises ``NotImplementedError``): prefix caching, chunked
prefill, the TPOT token budget and oversubscription; the first, second
and last also keep the reference's gate, which refuses them past the
dense limit.  Nor are the registry's sanitizer hook, per-tenant
prefix-cache namespaces and adapter pins kept across preemption, which
come with those features.  VLM stacks are refused, as in the reference:
they serve through ``Engine.prefill_step``/``decode_step``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import Family
from repro_torch.models.lora import lora_shapes
from repro_torch.models.transformer import use_dense_prefill
from repro_torch.runtime.paging import BlockAllocator, blocks_for
from repro_torch.tree import tree_finite, tree_leaves, tree_map


@dataclasses.dataclass
class GenRequest:
    """One generation request: prompt in, sampled tokens out (greedy by
    default — ``temperature <= 0``)."""
    request_id: int
    prompt: np.ndarray                  # [P] int32 token ids
    max_new_tokens: int = 16
    arrival: float = 0.0                # on the caller's ``now`` clock
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
    # that admitted the request, as ``prefill_at`` under monolithic
    # prefill
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
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
    prefill_tokens: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    train_steps: int = 0
    wall_time: float = 0.0
    # latest train CE loss of a combined or plain train tick (NaN until
    # the batcher has trained)
    train_loss: float = float("nan")
    # multi-tenant: finished requests per adapter, and the version each
    # tenant's adapter served at its last finish
    adapter_requests: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    adapter_versions: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # per finished request, on the caller's ``now`` clock: time to first
    # token (arrival -> the admitting tick) and seconds per later output
    # token (first token -> the finishing tick, over the tokens after it)
    ttft: List[float] = dataclasses.field(default_factory=list)
    tpot: List[float] = dataclasses.field(default_factory=list)

    def throughput(self) -> float:
        return self.generated_tokens / max(self.wall_time, 1e-9)


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

    def unregister(self, adapter_id: str) -> None:
        if self.refcount(adapter_id) > 0:
            raise AdapterError(
                f"{adapter_id}: unregister with {self.refcount(adapter_id)} "
                "in-flight refs")
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
            return slot
        if self._free:
            slot = self._free.pop()
        elif self._lru:
            cold, slot = self._lru.popitem(last=False)
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
        return slot

    def release(self, adapter_id: str) -> None:
        refs = self._refs.get(adapter_id, 0)
        if refs <= 0:
            raise AdapterError(f"{adapter_id}: release without acquire")
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
        self._trees[adapter_id] = tree
        if version is not None:
            self._version[adapter_id] = version
        slot = self._slot.get(adapter_id)
        if slot is not None:
            _write_adapter_slot(self._stack, tree, slot)

    def device_lora(self) -> Any:
        """The stacked device tree the multi-tenant paths read."""
        return self._stack


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
                 oversubscribe: float = 0.0):
        cfg = engine.model.cfg
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        refuse_vlm(cfg)
        # the reference's own gates, checked before whether a feature is
        # ported at all: these replay prefill through programs that mirror
        # the DENSE softmax bit for bit, so they refuse a prompt_pad past
        # the dense limit (blockwise prefill)
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
        unported = {"prefix_cache": prefix_cache,
                    "prefill_chunk": prefill_chunk,
                    "tpot_target": tpot_target,
                    "oversubscribe": oversubscribe}
        for name, val in unported.items():
            if val:
                raise NotImplementedError(
                    f"ContinuousBatcher({name}=...) is not ported to "
                    "repro_torch yet; see ROADMAP.md")
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
            self.caches = self.model.init_paged_caches(n_blocks, block_size)
            # all-zero rows park inactive slots on scratch block 0
            self.block_tables = np.zeros((n_slots, self.blocks_per_slot),
                                         np.int32)
            self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
            # worst-case blocks still reserved (not yet taken) per slot
            self.slot_reserved = np.zeros(n_slots, np.int32)
            # device copy of the full table, re-uploaded only when the
            # host table changed; each tick passes a [:, :width] view
            self._dev_tables: Optional[torch.Tensor] = None
        else:
            self.caches = self.model.init_caches(n_slots, max_seq)
        self.queue: Deque[GenRequest] = collections.deque()
        self.slot_req: List[Optional[GenRequest]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)   # next write position
        self.slot_tok = np.zeros(n_slots, np.int32)   # next token to feed
        # registry mode: the adapter id each slot's request pinned
        self.slot_aid: List[Optional[str]] = [None] * n_slots
        self.stats = ServeStats()
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
        self.queue.append(req)

    def active_slots(self) -> List[int]:
        return [i for i in range(self.n_slots)
                if self.slot_req[i] is not None]

    def idle(self) -> bool:
        return not self.queue and not self.active_slots()

    # ------------------------------------------------------------ admission -
    def _worst_blocks(self, req: GenRequest) -> int:
        """Worst-case blocks over the request's lifetime: prompt plus
        ``max_new_tokens - 1`` decode writes, capped by the ring."""
        tokens = min(len(req.prompt) + req.max_new_tokens - 1,
                     self.ring_len)
        return blocks_for(tokens, self.block_size)

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
        req.finished_at = now
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

    def _prefill_wave(self, reqs: List[GenRequest]):
        """ONE ragged (right-padded) prefill for the whole wave and ONE
        batched argmax pull for its first tokens.  Returns (first tokens
        [W] np, prefill caches [.., W, ..], last-position logits [W, V]).
        SSM stacks prefill each request at its exact length (state threads
        through pads) and gather its caches into row j of the wave's
        (fixed-size) caches; their last-position logits are stacked on the
        device, still ONE argmax pull."""
        if self.cfg.has_ssm:
            pre = self.model.init_caches(len(reqs), 0)
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
            self.prefill_waves += 1
            last = torch.stack(lasts)
            firsts = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per prefill wave
            return firsts, pre, last
        lens = np.array([len(r.prompt) for r in reqs], np.int32)
        padded = np.zeros((len(reqs), self.prompt_pad), np.int32)
        for j, r in enumerate(reqs):
            padded[j, :lens[j]] = r.prompt
        tokens = torch.tensor(padded, dtype=torch.long, device=self.device)
        with torch.no_grad():
            logits, pre = self.model.prefill_ragged(
                self.params, self._serve_lora(), {"tokens": tokens},
                torch.tensor(lens, device=self.device),
                adapter_idx=self._wave_adapter_idx(reqs))
        self.prefill_waves += 1
        last = logits[:, -1]
        firsts = last.argmax(-1).cpu().numpy()  # lint: host-sync-ok one batched argmax pull per prefill wave
        return firsts, pre, last

    def admit(self, now: float = 0.0) -> List[GenRequest]:
        """Fill free slots from the queue, FCFS; returns requests that
        finished at admission (max_new_tokens == 1 / instant EOS).  Paged
        mode admits only while the allocator can cover the head request's
        worst case — otherwise the queue waits for an eviction.  With a
        registry, a request whose adapter cannot get a device slot (every
        slot pinned) is skipped for this wave and keeps its place; its
        adapter is pinned at admission."""
        finished: List[GenRequest] = []
        free = [i for i in range(self.n_slots) if self.slot_req[i] is None]
        reqs: List[GenRequest] = []
        reserved: List[int] = []
        picked: List[int] = []      # queue indices claimed this wave
        qi = 0
        while len(reqs) < len(free) and qi < len(self.queue):
            head = self.queue[qi]
            if head.adapter_id is not None \
                    and not self.adapters.can_acquire(head.adapter_id):
                qi += 1
                continue
            if self.paged:
                need = self._worst_blocks(head)
                if not self.allocator.can_reserve(need):
                    break           # strict FCFS backpressure
                self.allocator.reserve(need)
                reserved.append(need)
            if head.adapter_id is not None:
                self.adapters.acquire(head.adapter_id)
            reqs.append(head)
            picked.append(qi)
            qi += 1
        for j in reversed(picked):
            del self.queue[j]
        if not reqs:
            return finished
        firsts, wave_pre, last_logits = self._prefill_wave(reqs)
        # one batched write per wave; rows flagged with an out-of-range
        # id are dropped (requests that finished at admission)
        if self.paged:
            nbp = blocks_for(wave_pre["kv"][0].shape[2], self.block_size)
            wave_tables = np.full((len(reqs), nbp), self.n_blocks, np.int32)
        else:
            wave_slots = np.full(len(reqs), self.n_slots, np.int32)
        admitted_rows = 0
        for k, (slot, req) in enumerate(zip(free, reqs)):
            first = int(firsts[k])
            if req.samples:
                req.rng = np.random.default_rng(
                    req.seed if req.seed is not None else req.request_id)
                first = sample_token(
                    last_logits[k].float().cpu().numpy(),  # lint: host-sync-ok one logits row per sampled admission
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, rng=req.rng)
            req.tokens.append(first)
            req.prefill_at = req.first_token_at = now
            self.stats.admitted += 1
            self.stats.prefill_tokens += len(req.prompt)
            self.stats.generated_tokens += 1
            if len(req.tokens) >= req.max_new_tokens \
                    or first == self.eos_id:
                # done at admission: never occupies the slot
                self._record_finish(req, now)
                if req.adapter_id is not None:
                    self.adapters.release(req.adapter_id)
                if self.paged:
                    self.allocator.release(reserved[k])
                finished.append(req)
                continue
            if self.paged:
                need = blocks_for(len(req.prompt), self.block_size)
                ids = self.allocator.take(need)
                self.slot_blocks[slot] = ids
                self.slot_reserved[slot] = reserved[k] - need
                self.block_tables[slot, :] = 0
                self.block_tables[slot, :need] = ids
                wave_tables[k, :need] = ids
                self._dev_tables = None
            else:
                wave_slots[k] = slot
            admitted_rows += 1
            self.slot_req[slot] = req
            self.slot_aid[slot] = req.adapter_id
            self.slot_pos[slot] = len(req.prompt)
            self.slot_tok[slot] = first
        if admitted_rows and self.paged:
            self.caches = self.model.write_prefill_blocks(
                self.caches, wave_pre, wave_tables)
        elif admitted_rows:
            self.caches = self.model.write_prefill_slots(
                self.caches, wave_pre, wave_slots)
        return finished

    # --------------------------------------------------------------- decode -
    def _grow_tables(self, active: List[int]) -> None:
        """Allocate the block each slot's next write lands in when the
        table doesn't cover it yet (one block at a time, always against
        the slot's admission-time reservation)."""
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

    def _table_width(self, active: List[int]) -> int:
        """Live-table width: the decode tick only walks blocks up to the
        longest active slot, rounded up to 1, 2, then multiples of 2 (the
        JAX runtime's bucketing; the kernel takes any width)."""
        need = max(len(self.slot_blocks[i]) for i in active)
        width = need if need <= 2 else 2 * (-(-need // 2))
        return min(width, self.blocks_per_slot)

    def step(self, train_batch: Optional[Dict[str, Any]] = None,
             now: float = 0.0) -> List[GenRequest]:
        """One runtime tick: admit, then advance every active slot one
        token — fused with a LoRA train step on ``train_batch`` when one
        is given (a tick with no active slot trains alone).  Returns the
        requests that finished this tick."""
        if train_batch is not None and self.opt_state is None:
            raise ValueError(
                "step(train_batch=...) requires opt_state (pass it to "
                "the ContinuousBatcher constructor)")
        if train_batch is not None:
            train_batch = self._device_batch(train_batch)
        finished = self.admit(now)
        active = self.active_slots()
        if not active:
            if train_batch is not None:
                self._plain_train(train_batch)
            return finished
        toks = _host_ids(self.slot_tok[:, None], self.device)
        pos = _host_ids(self.slot_pos, self.device)
        if self.paged:
            self._grow_tables(active)
            if self._dev_tables is None:
                self._dev_tables = _host_ids(self.block_tables, self.device)
            tables = self._dev_tables[:, :self._table_width(active)]
        # registry mode: each slot's device adapter slot, -1 for inactive
        # and base-only slots (their rows take the base product bitwise)
        serve_idx = None
        if self.adapters is not None:
            idx = np.full(self.n_slots, -1, np.int32)
            for i in active:
                if self.slot_aid[i] is not None:
                    idx[i] = self.adapters.slot_index(self.slot_aid[i])
            serve_idx = _host_ids(idx, self.device)
        if train_batch is not None:
            if self.paged:
                (new_tl, self.opt_state, logits, self.caches,
                 metrics) = self.engine.combined_step_paged(
                    self.params, self._train_adapter(), self.opt_state,
                    train_batch, self.caches, toks, pos, tables,
                    ring_len=self.ring_len, serve_lora=self._serve_lora(),
                    grad_accum=self.train_grad_accum,
                    serve_adapter_idx=serve_idx)
            else:
                (new_tl, self.opt_state, logits, self.caches,
                 metrics) = self.engine.combined_step(
                    self.params, self._train_adapter(), self.opt_state,
                    train_batch, self.caches, toks, pos,
                    serve_lora=self._serve_lora(),
                    grad_accum=self.train_grad_accum,
                    serve_adapter_idx=serve_idx)
            self._store_trained(new_tl)
            self._record_train(metrics)
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

    def _evict(self, i: int) -> None:
        """Free slot ``i`` completely: request, position AND feed token,
        its adapter pin, plus its blocks and unused reservation in paged
        mode."""
        self.slot_req[i] = None
        self.slot_pos[i] = 0
        self.slot_tok[i] = 0
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
            self.block_tables[i, :] = 0   # back to scratch block 0
            self._dev_tables = None

    def drain_all(self) -> List[GenRequest]:
        """Evict every active slot, clear the queue, and return all
        unfinished requests with their partial tokens discarded.  In paged
        mode every block and reservation returns to the allocator, and
        every adapter pin to the registry (queued requests hold none)."""
        out: List[GenRequest] = list(self.queue)
        self.queue.clear()
        for i in self.active_slots():
            req = self.slot_req[i]
            self._evict(i)
            out.append(req)
        for r in out:
            r.tokens.clear()
            r.rng = None
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

    def _plain_train(self, train_batch: Dict[str, Any]) -> None:
        """A train step alone (a tick with no active slot)."""
        new_tl, self.opt_state, metrics = self.engine.train_step(
            self.params, self._train_adapter(), self.opt_state,
            train_batch, grad_accum=self.train_grad_accum)
        self._store_trained(new_tl)
        self._record_train(metrics)

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
        """Allocated cache bytes: KV (pool + tables), or an SSM stack's
        conv tails and states."""
        leaves = tree_leaves(self.caches["ssm"]) if self.cfg.has_ssm \
            else self.caches["kv"]
        total = sum(t.numel() * t.element_size() for t in leaves)
        if self.paged:
            total += self.block_tables.nbytes
        return total
