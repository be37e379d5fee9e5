"""The port's copy-on-write prefix sharing (``repro_torch.runtime.paging``
``BlockAllocator`` sharing and ``PrefixCache``; ``Model.prefill_ragged_
suffix`` and ``copy_blocks``; the batcher's ``prefix_cache=True``) on the
CPU, where every decode tick runs the paged kernel's plain version and
every projection ``lora_matmul``'s.  Twins of ``tests/test_prefix_cache.py``
on the JAX package's weights (carried across by ``convert.py``): greedy
tokens equal ``tests/conftest.py::reference_greedy`` on the JAX model with
the cache on and off, and for one trace the port's counters equal the JAX
batcher's exactly.  The port's suffix prefill is held against its full
prefill and against the JAX suffix program; the tenant namespaces keep
two tenants with identical prompts apart."""
import functools

import jax
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from conftest import reference_greedy, sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.runtime.fabric import make_tenant_adapters as jax_tenants
from repro.runtime.serving_loop import AdapterRegistry as JaxRegistry
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.models.model import Model
from repro_torch.runtime import paging
from repro_torch.runtime.paging import (
    BlockAllocator, BlockError, OutOfBlocks, PrefixCache,
)
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest,
)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def pair(kind="mha", window=0, bump=True):
    """The reduced qwen1.5-0.5b in both packages on the same weights (JAX
    init, key 0; adapter key 1, +0.01 when ``bump``, as the JAX suites
    make it): ``kind`` "gqa" takes 2 KV heads, ``window`` a sliding
    window.  One JAX engine per config, so its jitted programs are shared
    by every test that runs the JAX batcher."""
    kw = {"gqa": {"n_kv_heads": 2}}.get(kind, {})
    if window:
        kw["sliding_window"] = window
    jcfg = jax_config("qwen1.5-0.5b").scaled(**kw)
    cfg = get_config("qwen1.5-0.5b").scaled(**kw)
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jeng.model.init_lora(jax.random.key(1))
    if bump:
        jlora = jax.tree.map(lambda x: x + 0.01, jlora)
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, jp=jp, jlora=jlora, eng=eng,
                params=params_from_numpy(cfg, _np(jp), "cpu"),
                lora=lora_from_numpy(_np(jlora), "cpu"))


class _Jitted:
    """The JAX model's methods that ``reference_greedy`` calls, each
    under ``jax.jit``: the same programs, compiled once per shape instead
    of dispatched op by op, so the same tokens several times faster on
    the CPU."""

    def __init__(self, model):
        self.init_caches = model.init_caches
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.write_prefill_slot = jax.jit(model.write_prefill_slot,
                                          static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _reference(key, prompt_bytes, n_new):
    s = pair(*key)
    prompt = np.frombuffer(prompt_bytes, np.int32)
    return reference_greedy(_Jitted(s["jeng"].model), s["jp"], s["jlora"],
                            prompt, n_new)


def reference(key, prompt, n_new):
    """``conftest.reference_greedy`` on the JAX model of ``pair(*key)``
    (cached: several tests share prompts)."""
    return _reference(key, np.asarray(prompt, np.int32).tobytes(), n_new)


def requests(prompts, gens, cls=GenRequest, aids=None):
    return [cls(request_id=i, prompt=np.asarray(p, np.int32).copy(),
                max_new_tokens=g, adapter_id=aids[i] if aids else None)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def run_pair(s, build_reqs, **kw):
    """The port's batcher on one trace with the prefix cache off and on;
    returns (reqs_off, reqs_on, batcher_on)."""
    off = build_reqs()
    ContinuousBatcher(s["eng"], s["params"], s["lora"], paged=True,
                      **kw).run(off)
    on = build_reqs()
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], paged=True,
                          prefix_cache=True, **kw)
    b.run(on)
    return off, on, b


@pytest.fixture
def count_copies(monkeypatch):
    """Counts ``Model.copy_blocks`` calls and the blocks they copy."""
    calls = []
    orig = Model.copy_blocks

    def spy(self, caches, src, dst):
        calls.append(len(src))
        return orig(self, caches, src, dst)

    monkeypatch.setattr(Model, "copy_blocks", spy)
    return calls


# ----------------------------------------------------- allocator units -----
def test_double_free_detected_immediately():
    a = BlockAllocator(n_blocks=8, block_size=4)
    a.reserve(3)
    ids = a.take(3)
    a.free(ids[:1])
    with pytest.raises(BlockError, match="double free"):
        a.free(ids[:1])
    a.free(ids[1:])
    assert a.n_free == 7 and a.n_used == 0


def test_alias_of_free_block_detected():
    a = BlockAllocator(n_blocks=8, block_size=4)
    a.reserve(1)
    (bid,) = a.take(1)
    a.share([bid])
    assert a.ref(bid) == 2
    a.free([bid])
    a.free([bid])
    with pytest.raises(BlockError, match="share of unreferenced"):
        a.share([bid])
    with pytest.raises(BlockError, match="acquire of free"):
        a.acquire([bid])


def test_retained_pool_and_revive():
    a = BlockAllocator(n_blocks=8, block_size=4)
    a.reserve(2)
    ids = a.take(2)
    a.pin(ids[0])
    a.free(ids)
    assert a.n_retained == 1 and a.n_free == 6 and a.n_used == 0
    assert a.available() == 7
    assert a.n_would_revive(ids[:1]) == 1
    a.acquire([ids[0]])
    assert a.ref(ids[0]) == 1 and a.n_retained == 0
    a.free([ids[0]])
    a.unpin(ids[0])
    assert a.n_retained == 0 and a.n_free == 7


def test_take_reclaims_retained_lru_and_notifies():
    a = BlockAllocator(n_blocks=5, block_size=4)
    reclaimed = []
    a.on_reclaim = reclaimed.append
    a.reserve(4)
    ids = a.take(4)
    for b in ids:
        a.pin(b)
    a.free(ids)
    assert a.n_free == 0 and a.n_retained == 4
    a.reserve(2)
    got = a.take(2)
    assert got == ids[:2] and reclaimed == ids[:2]
    assert a.n_retained == 2


def test_recycled_parent_id_cannot_resurrect_stale_chain():
    """Dropping a parent entry drops its children: a reclaimed parent id
    registered again for other content must not revive a chain whose KV
    was computed under another prefix."""
    a = BlockAllocator(n_blocks=5, block_size=4)
    pc = PrefixCache(a)
    A = np.arange(4, dtype=np.int32)
    B = np.arange(4, dtype=np.int32) + 100
    D = np.arange(4, dtype=np.int32) + 200
    a.reserve(3)
    x, c, extra = a.take(3)
    pc.register(np.concatenate([A, B, [7]]), [x, c, extra], 0)
    assert pc.is_registered(x) and pc.is_registered(c)
    a.free([x, c, extra])
    assert a.n_retained == 2
    a.reserve(4)
    got = a.take(4)
    assert x in got
    assert not pc.is_registered(c)
    pc.register(np.concatenate([D, B, [9]]), got[:3], 0)
    assert pc.match(np.concatenate([D, B, [9]]))[:1] == [got[0]]
    assert pc.match(np.concatenate([A, B, [7]])) == []


N_BLOCKS = 12
OPS = st.lists(
    st.tuples(st.sampled_from(["reserve", "release", "take", "share",
                               "acquire", "free", "pin", "unpin",
                               "swap_out", "swap_in"]),
              st.integers(min_value=0, max_value=4),
              st.integers(min_value=0, max_value=96)),
    min_size=1, max_size=64)


def _pick(cands, sel, n):
    cands = sorted(cands)
    if not cands or n <= 0:
        return []
    start = sel % len(cands)
    return [cands[(start + j) % len(cands)]
            for j in range(min(n, len(cands)))]


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_allocator_sharing_invariants(ops):
    """``tests/test_paging_properties.py``'s walk (reserve, take, share,
    free, pin, swap_out, swap_in) with the prefix cache's ``acquire``:
    after every operation the allocator agrees with a shadow model."""
    a = BlockAllocator(N_BLOCKS, 4)
    ref, retained, pinned, reserved = {}, set(), set(), 0

    def live():
        return {b for b, r in ref.items() if r > 0}

    for kind, n, sel in ops:
        if kind == "reserve":
            if a.can_reserve(n):
                a.reserve(n)
                reserved += n
            else:
                with pytest.raises(OutOfBlocks):
                    a.reserve(n)
        elif kind == "release":
            k = min(n, reserved)
            a.release(k)
            reserved -= k
        elif kind == "take":
            k = min(n, reserved, a.n_free + a.n_retained)
            ids = a.take(k)
            reserved -= k
            assert len(ids) == len(set(ids)) == k
            for b in ids:
                assert ref.get(b, 0) == 0
                ref[b] = 1
                retained.discard(b)
                pinned.discard(b)
        elif kind == "share":
            for b in _pick(live(), sel, n):
                a.share([b])
                ref[b] += 1
        elif kind == "acquire":
            # a cache hit: live blocks shared, retained ones revived
            for b in _pick(live() | retained, sel, n):
                assert a.n_would_revive([b]) == (b in retained)
                a.acquire([b])
                ref[b] += 1
                retained.discard(b)
        elif kind == "free":
            for b in _pick(live(), sel, n):
                a.free([b])
                ref[b] -= 1
                if ref[b] == 0 and b in pinned:
                    retained.add(b)
        elif kind == "pin":
            for b in _pick(live(), sel, n):
                a.pin(b)
                pinned.add(b)
        elif kind == "unpin":
            for b in _pick(pinned, sel, n):
                a.unpin(b)
                pinned.discard(b)
                retained.discard(b)
        elif kind == "swap_out":
            sole = {b for b in live() if ref[b] == 1 and b not in pinned}
            for b in _pick(sole, sel, n):
                a.swap_out([b])
                ref[b] = 0
        elif kind == "swap_in":
            if a.can_reserve(n):
                ids = a.swap_in(n)
                assert len(ids) == len(set(ids)) == n
                for b in ids:
                    assert ref.get(b, 0) == 0
                    ref[b] = 1
                    retained.discard(b)
                    pinned.discard(b)
            else:
                with pytest.raises(OutOfBlocks):
                    a.swap_in(n)
        n_live = len(live())
        assert a.n_used == n_live
        assert a.n_retained == len(retained)
        assert a.n_free == a.capacity - n_live - len(retained)
        assert a.reserved == reserved
        assert a.reserved <= a.n_free + a.n_retained
        assert a.available() == a.n_free + a.n_retained - a.reserved
        for b, r in ref.items():
            assert a.ref(b) == r
        assert a.peak_used >= a.n_used
        assert 0 not in ref


# ------------------------------------------------------- model programs ----
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_suffix_prefill_matches_full_prefill_and_jax(kind):
    """A prompt prefilled as (cached prefix blocks + suffix) against the
    same prompt prefilled whole: last-token logits and suffix K/V, on the
    port; and the port's suffix program against the JAX one on the same
    pool.  The port's suffix and full prefill agree bitwise in layer 0's
    K/V (the same rows' projections); past it they are not bitwise (the
    attention reduces over other key widths, the next layer's products
    over other row counts): measured 4.8e-7 relative in logits and 4.0e-7
    in layer 1's K/V, MHA and GQA on the CPU.  Held at 5e-5 relative, the
    tolerance of tests/test_decode_parity.py, as is the port against
    JAX."""
    s = pair(kind)
    m, jm = s["eng"].model, s["jeng"].model
    bs, lens, pre_blocks = 4, np.array([11, 9, 6], np.int32), [2, 1, 0]
    prompts = sample_prompts(s["jcfg"], 3, list(lens), seed=13)
    padded = np.zeros((3, 12), np.int32)
    for j, p in enumerate(prompts):
        padded[j, :lens[j]] = p
    full_logits, full = m.prefill_ragged(
        s["params"], s["lora"], {"tokens": torch.tensor(padded).long()},
        torch.tensor(lens))
    # each row's prefix in its own pool blocks (row j: blocks 1 + 3j ..)
    pool = m.init_paged_caches(10, bs)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    m.write_prefill_blocks(pool, full, tables)
    jpool = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), pool)
    pre_lens = np.array(pre_blocks, np.int32) * bs
    suf_lens = lens - pre_lens
    suf = np.zeros((3, 12), np.int32)
    for j, p in enumerate(prompts):
        suf[j, :suf_lens[j]] = p[pre_lens[j]:]
    pre_tables = np.array([[1, 2], [4, 0], [0, 0]], np.int32)
    logits, kv = m.prefill_ragged_suffix(
        s["params"], s["lora"], {"tokens": torch.tensor(suf).long()},
        suf_lens, pre_lens, pool, pre_tables)
    rel = float((logits - full_logits).abs().max()
                / full_logits.abs().max())
    assert rel < 5e-5
    for k_suf, k_full in zip(kv["kv"], full["kv"]):
        for j in range(3):
            a = k_suf[:, j, :suf_lens[j]]
            b = k_full[:, j, pre_lens[j]:lens[j]]
            assert torch.equal(a[0], b[0]), f"row {j}: layer 0 K/V differ"
            assert float((a - b).abs().max() / b.abs().max()) < 5e-5
    jlogits, jkv = jm.prefill_ragged_suffix(
        s["jp"], s["jlora"], {"tokens": suf}, suf_lens, pre_lens, jpool,
        pre_tables)
    jlogits = np.asarray(jlogits)
    assert float(np.abs(logits.numpy() - jlogits).max()
                 / np.abs(jlogits).max()) < 5e-5
    for t, jt in zip(kv["kv"], jkv["kv"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=5e-5,
                                   atol=5e-5)


def test_copy_blocks_matches_jax():
    s = pair()
    m = s["eng"].model
    pool = m.init_paged_caches(6, 4)
    g = torch.Generator().manual_seed(0)
    for t in pool["kv"]:
        t.copy_(torch.randn(t.shape, generator=g))
    jpool = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), pool)
    jout = s["jeng"].model.copy_blocks(jpool, np.array([2, 5]),
                                       np.array([3, 1]))
    m.copy_blocks(pool, [2, 5], [3, 1])
    for t, jt in zip(pool["kv"], jout["kv"]):
        assert np.array_equal(t.numpy(), np.asarray(jt))
    with pytest.raises(ValueError, match="outside the pool"):
        m.copy_blocks(pool, [6], [1])


# ------------------------------------------------- full-attention path -----
def _family(cfg):
    (shared,) = sample_prompts(cfg, 1, [24])            # 3 blocks of 8
    tails = sample_prompts(cfg, 5, [4, 7, 2, 8, 5], seed=11)
    return [np.concatenate([shared, t]) for t in tails], [5, 3, 6, 2, 4]


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_prefix_cache_matches_uncached_and_reference(kind):
    """Repeated-prefix trace: cache on emits the greedy tokens of cache
    off and of the JAX one-at-a-time reference, the refcounts drain and
    warm prefix blocks stay retained."""
    s = pair(kind)
    prompts, gens = _family(s["jcfg"])
    off, on, b = run_pair(s, lambda: requests(prompts, gens), n_slots=2,
                          max_seq=48, prompt_pad=32, block_size=8)
    for i in range(len(prompts)):
        ref = reference((kind,), prompts[i], gens[i])
        assert on[i].tokens == ref, f"shared diverges on req {i}"
        assert off[i].tokens == ref, f"paged diverges on req {i}"
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0
    assert b.allocator.n_retained > 0
    assert b.allocator.n_free + b.allocator.n_retained \
        == b.allocator.capacity
    assert b.prefix_cache.hits > 0
    assert b.stats.cached_prefix_tokens > 0
    assert b.stats.prefill_tokens < sum(len(p) for p in prompts)


def test_match_cap_leaves_one_suffix_token():
    s = pair()
    (p16,) = sample_prompts(s["jcfg"], 1, [16])
    reqs = requests([p16, p16], [4, 4])
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=1,
                          max_seq=24, prompt_pad=16, paged=True,
                          block_size=8, prefix_cache=True)
    b.run(reqs)
    assert reqs[0].tokens == reqs[1].tokens == reference(("mha",), p16, 4)
    assert b.prefix_cache.hits == 1
    assert b.stats.cached_prefix_tokens == 8
    assert len(b.prefix_cache.match(p16)) == 1      # (16 - 1) // 8


def test_partial_block_boundary_and_hash_collision(monkeypatch):
    """Prefixes ending mid-block share only their full blocks, and a
    constant content hash never aliases other content."""
    s = pair()
    monkeypatch.setattr(paging, "_digest",
                        lambda tokens, namespace=None: b"collide")
    (shared,) = sample_prompts(s["jcfg"], 1, [10])
    tails = sample_prompts(s["jcfg"], 3, [3, 5, 2], seed=7)
    prompts = [np.concatenate([shared, t]) for t in tails]
    off, on, b = run_pair(s, lambda: requests(prompts, [4, 3, 5]),
                          n_slots=1, max_seq=24, prompt_pad=16, block_size=4)
    for i in range(3):
        assert on[i].tokens == off[i].tokens, f"req {i} diverged"
    assert b.stats.cached_prefix_tokens == 2 * 8
    assert b.prefix_cache.hits == 4


def test_allocator_pressure_reclaims_retained():
    s = pair()
    prompts = sample_prompts(s["jcfg"], 6, [12] * 6, seed=5)
    off, on, b = run_pair(s, lambda: requests(prompts, [3] * 6), n_slots=1,
                          max_seq=16, prompt_pad=12, block_size=4, n_blocks=7)
    for i in range(6):
        assert on[i].tokens == off[i].tokens, f"req {i} diverged"
    assert b.prefix_cache.reclaimed > 0
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0
    for bid in list(b.prefix_cache._key_of):
        assert b.allocator.ref(bid) > 0 or bid in b.allocator._retained


# ------------------------------------------------- sliding-window path -----
def _window_trace(cfg, cls=GenRequest):
    """A short seed request registers a 12-token prefix; two sharers then
    decode past the 16-token window, so their ring wrap re-enters the
    aliased prefix blocks."""
    (shared,) = sample_prompts(cfg, 1, [12])
    tails = sample_prompts(cfg, 2, [2, 2], seed=3)
    seed = cls(request_id=0, prompt=shared.copy(), max_new_tokens=4)
    sharers = [cls(request_id=1 + i,
                   prompt=np.concatenate([shared, tails[i]]),
                   max_new_tokens=10) for i in range(2)]
    return seed, sharers


def _run_window(b, seed, sharers):
    b.submit(seed)
    while not b.idle():
        b.step()
    for r in sharers:
        b.submit(r)
    while not b.idle():
        b.step()
    return [seed] + sharers


WINDOW_KW = dict(n_slots=2, max_seq=40, prompt_pad=16, paged=True,
                 block_size=4, n_blocks=13)


def test_sliding_window_sharing_with_cow(count_copies):
    s = pair("mha", 16)

    def run(pc):
        b = ContinuousBatcher(s["eng"], s["params"], s["lora"],
                              prefix_cache=pc, **WINDOW_KW)
        return b, _run_window(b, *_window_trace(s["jcfg"]))

    b_on, on = run(True)
    cows = list(count_copies)
    _, off = run(False)
    for i in range(3):
        assert on[i].tokens == off[i].tokens, f"req {i} diverged"
    assert b_on.prefix_cache.hits > 0
    assert cows, "ring wrap over a shared block must copy-on-write"
    assert b_on.allocator.n_used == 0 and b_on.allocator.reserved == 0


def test_wrapping_request_blocks_not_registered():
    s = pair("mha", 8, False)
    (p,) = sample_prompts(s["jcfg"], 1, [8])
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=1,
                          max_seq=24, prompt_pad=8, paged=True, block_size=4,
                          prefix_cache=True)
    b.run(requests([p], [12]))                  # wraps the 8-row ring
    assert len(b.prefix_cache) == 0
    assert b.allocator.n_retained == 0


def test_prefix_cache_requires_paged():
    s = pair()
    with pytest.raises(ValueError, match="prefix_cache requires paged"):
        ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=1,
                          prefix_cache=True)


def test_windowed_hit_on_tiny_pool_never_deadlocks():
    """On a pool of exactly one worst-case windowed request, a warm hit
    trims its match and admits cold instead of waiting forever."""
    s = pair("mha", 16, False)
    (shared,) = sample_prompts(s["jcfg"], 1, [8])
    (tail,) = sample_prompts(s["jcfg"], 1, [4], seed=9)
    prompts = [shared, np.concatenate([shared, tail])]
    off, on, b = run_pair(s, lambda: requests(prompts, [4, 8]), n_slots=1,
                          max_seq=24, prompt_pad=16, block_size=4, n_blocks=5)
    for i in range(2):
        assert on[i].tokens == off[i].tokens, f"req {i} diverged"
    assert b.stats.finished == 2
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0


# ------------------------------------------------------ against JAX --------
def _counters(b, stats):
    a, pc = b.allocator, b.prefix_cache
    return dict(prefill_tokens=stats.prefill_tokens,
                cached_prefix_tokens=stats.cached_prefix_tokens,
                hits=pc.hits, misses=pc.misses, reclaimed=pc.reclaimed,
                n_retained=a.n_retained, n_free=a.n_free,
                peak_used=a.peak_used, n_used=a.n_used,
                reserved=a.reserved, decode_steps=stats.decode_steps)


def test_counters_match_jax_batcher_under_pressure():
    """A shared-prefix trace on a pool too small to retain every prefix
    (hits, misses and LRU reclaims): the port's tokens and counters equal
    the JAX batcher's exactly."""
    s = pair()
    prompts, gens = _family(s["jcfg"])
    prompts += sample_prompts(s["jcfg"], 3, [20, 26, 17], seed=21)
    gens += [4, 3, 5]
    kw = dict(n_slots=2, max_seq=36, prompt_pad=32, paged=True,
              block_size=8, n_blocks=9, prefix_cache=True)
    jb = JaxBatcher(s["jeng"], s["jp"], s["jlora"], **kw)
    jreqs = requests(prompts, gens, JaxRequest)
    jstats = jb.run(jreqs)
    tb = ContinuousBatcher(s["eng"], s["params"], s["lora"], **kw)
    treqs = requests(prompts, gens)
    tstats = tb.run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    want = _counters(jb, jstats)
    assert _counters(tb, tstats) == want
    assert want["hits"] > 0 and want["reclaimed"] > 0


def test_window_cow_counters_match_jax(count_copies):
    """The sliding-window sharing trace: the port copies exactly the
    blocks the JAX batcher copies (its COW calls pad to a power of two
    with 0 -> 0 copies of the scratch block), with the same tokens and
    counters."""
    s = pair("mha", 16)
    jcows = []
    jb = JaxBatcher(s["jeng"], s["jp"], s["jlora"], prefix_cache=True,
                    **WINDOW_KW)
    orig = jb._jit_copy_blocks

    def spy(c, src, dst):
        jcows.append(int(((np.asarray(src) != 0)
                          | (np.asarray(dst) != 0)).sum()))
        return orig(c, src, dst)

    jb._jit_copy_blocks = spy
    jreqs = _run_window(jb, *_window_trace(s["jcfg"], JaxRequest))
    tb = ContinuousBatcher(s["eng"], s["params"], s["lora"],
                           prefix_cache=True, **WINDOW_KW)
    treqs = _run_window(tb, *_window_trace(s["jcfg"]))
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert list(count_copies) == jcows and sum(jcows) > 0
    assert _counters(tb, tb.stats) == _counters(jb, jb.stats)


def test_tenant_namespaces_never_share():
    """Two tenants send identical prompts: each tenant hits only its own
    cached blocks (the second request of each tenant aliases its first's,
    never the other tenant's), and the tokens equal the JAX registry
    batcher's on the same tenants."""
    s = pair()
    jt = jax_tenants(s["jeng"].model, 3, seed=1)[1:]      # b != 0 both
    tenants = [lora_from_numpy(_np(t), "cpu") for t in jt]
    (shared,) = sample_prompts(s["jcfg"], 1, [16])
    tails = sample_prompts(s["jcfg"], 2, [3, 5], seed=4)
    prompts = [np.concatenate([shared, tails[i // 2]]) for i in range(4)]
    aids = ["tenant0", "tenant1", "tenant0", "tenant1"]
    kw = dict(n_slots=2, max_seq=28, prompt_pad=24, paged=True,
              block_size=4, prefix_cache=True)
    jreg = JaxRegistry(s["jeng"].model, capacity=2)
    reg = AdapterRegistry(s["eng"].model, capacity=2)
    for t in range(2):
        jreg.register(f"tenant{t}", jt[t])
        reg.register(f"tenant{t}", tenants[t])
    jb = JaxBatcher(s["jeng"], s["jp"], jt[0], adapters=jreg, **kw)
    jreqs = requests(prompts, [5] * 4, JaxRequest, aids)
    jb.run(jreqs)
    tb = ContinuousBatcher(s["eng"], s["params"], tenants[0], adapters=reg,
                           **kw)
    treqs = requests(prompts, [5] * 4, aids=aids)
    blocks = {}
    admit = tb.admit

    def spy(now=0.0):
        out = admit(now)
        for i in tb.active_slots():
            blocks.setdefault(tb.slot_req[i].request_id,
                              list(tb.slot_blocks[i]))
        return out

    tb.admit = spy
    tb.run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert treqs[0].tokens != treqs[1].tokens   # the tenants differ
    # requests 2 and 3 alias their own tenant's first 4 blocks only
    assert blocks[2][:4] == blocks[0][:4]
    assert blocks[3][:4] == blocks[1][:4]
    assert not set(blocks[0][:4]) & set(blocks[1][:4])
    assert tb.prefix_cache.hits == jb.prefix_cache.hits == 8
    assert tb.stats.cached_prefix_tokens \
        == jb.stats.cached_prefix_tokens == 2 * 16
    assert all(reg.refcount(a) == 0 for a in reg.registered())
