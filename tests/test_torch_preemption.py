"""The port's oversubscribed KV pool (``ContinuousBatcher(oversubscribe=...,
swap=...)``, ``BlockAllocator.swap_out``/``swap_in``,
``Model.gather_blocks``/``scatter_blocks``) on the CPU.  Twins of
``tests/test_preemption.py``'s first eight tests on the JAX package's
weights (carried across by ``convert.py``): preemption with swap, with
drop and re-prefill, with shared prefixes and with chunked prefill emits
the never-preempted run's greedy tokens and
``tests/conftest.py::reference_greedy``'s on the JAX model; the gates;
drain with parked requests; use-after-swap.  Beside them: the block moves
against JAX's, the allocator's swap refusals, and for one trace in each
mode the port's preemption counters equal the JAX batcher's exactly, with
``_SwapCost.prefer_swap`` fixed in both packages so that the swap-or-drop
choice does not depend on wall time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from conftest import sample_prompts
from repro.runtime import serving_loop as jax_loop
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.runtime import serving_loop
from repro_torch.runtime.paging import BlockAllocator, BlockError
from repro_torch.runtime.sanitize import SanitizeError
from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
from test_torch_prefix_cache import pair, reference, requests

GENS = [24, 4, 20, 4, 6, 18]      # heavy-tail decode lengths
LENS = [7, 16, 13, 10, 6, 15]


def _serve(s, prompts, gens=GENS, cls=ContinuousBatcher, req=GenRequest,
           **kw):
    """One trace through a paged batcher (blocks of 8, 3 slots): the
    port's by default, the JAX one with ``cls=JaxBatcher``."""
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_seq", 48)
    kw.setdefault("prompt_pad", 16)
    reqs = requests(prompts, gens, req)
    if cls is JaxBatcher:
        b = cls(s["jeng"], s["jp"], s["jlora"], paged=True, block_size=8,
                **kw)
    else:
        b = cls(s["eng"], s["params"], s["lora"], paged=True, block_size=8,
                **kw)
    b.run(reqs)
    return [list(r.tokens) for r in reqs], b


def _shared_trace(cfg):
    base = sample_prompts(cfg, 2, [16, 16])
    prompts = [base[0], np.concatenate([base[0][:16], base[1][:4]]),
               base[0].copy(), base[1], base[0][:10],
               np.concatenate([base[0][:16], base[1][4:9]])]
    return prompts, [24, 6, 18, 20, 4, 4]


def _drained(b):
    a = b.allocator
    return a.n_used == 0 and a.reserved == 0 \
        and a.n_free + a.n_retained == a.capacity and b.n_preempted == 0


def _check_reference(prompts, gens, toks):
    for i, (p, g) in enumerate(zip(prompts, gens)):
        assert toks[i] == reference(("mha", 0, True), p, g), f"req {i}"


# ------------------------------------------------ greedy bit-identity -----
def test_swap_preemption_bit_identical():
    """A pool far below worst-case demand: victims swap their private
    chains to host memory and restore into fresh blocks — the unbounded
    run's tokens and the reference's, and the pool drains clean."""
    s = pair()
    prompts = sample_prompts(s["jcfg"], 6, LENS)
    ref, _ = _serve(s, prompts, n_blocks=64)
    toks, b = _serve(s, prompts, n_blocks=10, oversubscribe=1.0)
    assert toks == ref
    _check_reference(prompts, GENS, toks)
    assert b.stats.preemptions > 0 and b.stats.swap_out_blocks > 0
    assert b.stats.swap_in_blocks == b.stats.swap_out_blocks
    assert _drained(b)


def test_reprefill_preemption_bit_identical():
    """``swap=False``: every victim drops its chain and re-prefills its
    prompt and generated tokens through the chunk programs; the stored
    feed token re-enters decode — still the same tokens."""
    s = pair()
    prompts = sample_prompts(s["jcfg"], 6, LENS)
    ref, _ = _serve(s, prompts, n_blocks=64)
    toks, b = _serve(s, prompts, n_blocks=10, oversubscribe=1.0, swap=False)
    assert toks == ref
    _check_reference(prompts, GENS, toks)
    assert b.stats.preemptions > 0 and b.stats.reprefill_tokens > 0
    assert b.stats.swap_out_blocks == 0
    assert _drained(b)


def test_preemption_with_shared_prefixes_bit_identical():
    """Prefix sharing under preemption: the shared or registered start
    of a chain stays in the pool (never copied to host), only the
    private tail moves — sharers and victims decode identically."""
    s = pair()
    prompts, gens = _shared_trace(s["jcfg"])
    kw = dict(prompt_pad=24, prefix_cache=True)
    ref, _ = _serve(s, prompts, gens, n_blocks=64, **kw)
    toks, b = _serve(s, prompts, gens, n_blocks=12, oversubscribe=1.0, **kw)
    assert toks == ref
    _check_reference(prompts, gens, toks)
    assert b.stats.preemptions > 0
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0


def test_oversubscribed_chunked_prefill_bit_identical():
    """Preemption with chunked prefill: chunks, restores and decode share
    the same ticks."""
    s = pair()
    prompts = sample_prompts(s["jcfg"], 6, LENS)
    ref, _ = _serve(s, prompts, n_blocks=64)
    toks, b = _serve(s, prompts, n_blocks=9, oversubscribe=1.0,
                     prefill_chunk=8)
    assert toks == ref
    assert b.stats.preemptions > 0
    assert _drained(b)


# ------------------------------------------------------- ctor gating -----
def test_oversubscribe_requires_paged():
    s = pair()
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(s["eng"], s["params"], s["lora"],
                          oversubscribe=0.9)
    for w in (1.5, -0.5):
        with pytest.raises(ValueError, match=r"in \(0, 1\]"):
            ContinuousBatcher(s["eng"], s["params"], s["lora"], paged=True,
                              block_size=8, oversubscribe=w)


def test_oversubscribe_rejects_sliding_window():
    """A ring wrap overwrites cache rows in place, so a dropped request
    could not re-prefill into the same state: refused up front."""
    s = pair(window=16)
    with pytest.raises(NotImplementedError, match="window"):
        ContinuousBatcher(s["eng"], s["params"], s["lora"], paged=True,
                          block_size=8, prompt_pad=16, max_seq=32,
                          oversubscribe=0.9)


# ---------------------------------------------- lifecycle under drain -----
def _step_until_parked(b, reqs, max_steps=200):
    for r in reqs:
        b.submit(r)
    for _ in range(max_steps):
        b.step()
        if b.n_preempted > 0:
            return
    pytest.fail("no preemption occurred")


def test_drain_with_parked_requests_frees_everything(monkeypatch):
    """drain_all while requests sit parked off the device returns their
    kept blocks, reservations and adapter pins; the armed sanitizers
    check that the pool is quiescent."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    s = pair()
    reqs = requests(sample_prompts(s["jcfg"], 3, [8, 8, 8]), [24] * 3)
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                          max_seq=32, prompt_pad=8, paged=True, block_size=4,
                          n_blocks=9, oversubscribe=1.0)
    assert b.allocator.san is not None and b._lsan is not None
    _step_until_parked(b, reqs)
    out = b.drain_all()      # check_quiescent runs inside when armed
    assert len(out) == sum(1 for r in reqs if r.finished_at is None)
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0
    assert b.n_preempted == 0 and b.idle()


def test_use_after_swap_detected(monkeypatch):
    """Swap a live slot's block out behind the batcher's back: the next
    decode wave dies with the use-after-swap diagnostic instead of
    reading stale pool rows."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    s = pair()
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                          max_seq=24, prompt_pad=8, paged=True, block_size=4)
    b.submit(GenRequest(request_id=0,
                        prompt=sample_prompts(s["jcfg"], 1, [6])[0],
                        max_new_tokens=8))
    b.step()                                 # admit + first decode tick
    victim = b.active_slots()[0]
    b.allocator.swap_out([b.slot_blocks[victim][-1]])   # the mutation
    with pytest.raises(SanitizeError,
                       match=r"\[reprosan:use-after-swap\]"):
        b.step()


# ----------------------------------------------- allocator and blocks -----
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=1, max_value=4))
def test_swap_out_rejects_shared_and_pinned(extra_refs):
    a = BlockAllocator(12, 4)
    a.reserve(2)
    shared, pinned_b = a.take(2)
    for _ in range(extra_refs):
        a.share([shared])
    with pytest.raises(BlockError, match="refcount"):
        a.swap_out([shared])
    a.pin(pinned_b)
    with pytest.raises(BlockError, match="pinned"):
        a.swap_out([pinned_b])
    with pytest.raises(BlockError, match="invalid"):
        a.swap_out([0])                     # scratch block 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_blocks_match_jax(dtype):
    """``gather_blocks`` equals JAX's on the same pool; a round trip
    through host memory onto other ids is bitwise, in the pool's dtype
    (bf16 included: the host copy is a CPU tensor, not numpy)."""
    s = pair()
    m = s["eng"].model
    rng = np.random.default_rng(4)
    pool = m.init_paged_caches(7, 4, dtype=dtype)
    for t in pool["kv"]:
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32)).to(dtype))
    kv32 = [t.float().numpy() for t in pool["kv"]]
    jpool = {"kv": tuple(jnp.asarray(x) for x in kv32)}
    ids = [5, 2, 3]
    got = m.gather_blocks(pool, ids)["kv"]
    want = s["jeng"].model.gather_blocks(jpool, np.array(ids, np.int32))
    for g, w in zip(got, want["kv"]):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w))
    host = tuple(t.cpu() for t in got)
    m.scatter_blocks(pool, [1, 6, 4], host)
    jout = s["jeng"].model.scatter_blocks(
        jpool, np.array([1, 6, 4, 7], np.int32),   # JAX pads with n_blocks
        tuple(np.concatenate([np.asarray(w), np.zeros_like(
            np.asarray(w)[:, :1])], axis=1) for w in want["kv"]))
    for t, w, orig in zip(pool["kv"], jout["kv"], kv32):
        assert torch.equal(t[:, [1, 6, 4]], t[:, [5, 2, 3]])
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(w))
        np.testing.assert_array_equal(t.float().numpy()[:, [0, 2, 3, 5]],
                                      orig[:, [0, 2, 3, 5]])
    with pytest.raises(ValueError, match="outside the pool"):
        m.gather_blocks(pool, [7])
    with pytest.raises(ValueError, match="outside the pool"):
        m.scatter_blocks(pool, [7], tuple(x[:, :1] for x in host))


# ------------------------------------------------------ against JAX --------
def _fixed_choice(self, tail_bytes, reprefill_tokens):
    """A swap-or-drop rule without a clock: swap a victim with more than
    12 rows to recompute, drop a shorter one."""
    return reprefill_tokens > 12


def _counters(b):
    st_, a = b.stats, b.allocator
    return dict(preemptions=st_.preemptions,
                swap_out_blocks=st_.swap_out_blocks,
                swap_in_blocks=st_.swap_in_blocks,
                reprefill_tokens=st_.reprefill_tokens,
                prefill_tokens=st_.prefill_tokens,
                peak_used=a.peak_used, decode_steps=st_.decode_steps,
                generated_tokens=st_.generated_tokens)


@pytest.mark.parametrize("mode", ["swap", "drop", "prefix", "chunked"])
def test_preemption_counters_match_jax(mode, monkeypatch):
    """One trace per mode through the JAX batcher and the port's, the
    swap-or-drop choice fixed in both: the same tokens and exactly the
    same preemption, swap, re-prefill, prefill and pool counters."""
    for cls in (jax_loop._SwapCost, serving_loop._SwapCost):
        monkeypatch.setattr(cls, "prefer_swap", _fixed_choice)
    s = pair()
    prompts, gens = sample_prompts(s["jcfg"], 6, LENS), GENS
    kw = dict(n_blocks=10, oversubscribe=1.0)
    if mode == "drop":
        kw["swap"] = False
    elif mode == "prefix":
        prompts, gens = _shared_trace(s["jcfg"])
        kw = dict(n_blocks=12, oversubscribe=1.0, prompt_pad=24,
                  prefix_cache=True)
    elif mode == "chunked":
        kw = dict(n_blocks=9, oversubscribe=1.0, prefill_chunk=8)
    jtok, jb = _serve(s, prompts, gens, cls=JaxBatcher, req=JaxRequest, **kw)
    ttok, tb = _serve(s, prompts, gens, **kw)
    assert ttok == jtok
    want = _counters(jb)
    assert _counters(tb) == want
    assert want["preemptions"] > 0
    if mode == "swap":
        assert want["swap_out_blocks"] > 0
    elif mode == "drop":
        assert want["reprefill_tokens"] > 0 and want["swap_out_blocks"] == 0
