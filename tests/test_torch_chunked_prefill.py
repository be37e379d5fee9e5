"""The port's chunked prefill and per-tick token budget
(``ContinuousBatcher(prefill_chunk=..., tpot_target=...)``,
``Model.prefill_ragged_continue`` / ``write_prefill_rows``, ``_TickBudget``)
on the CPU.  Twins of ``tests/test_chunked_prefill.py``: chunked prefill
emits the greedy tokens of monolithic prefill and of
``conftest.reference_greedy`` on the JAX model, contiguous,
sliding-window, paged and with the prefix cache; a mid-chunk eviction and
a preemption mid-prefill free everything (under the armed sanitizers);
and under a fixed budget cost model the port plans every tick as the JAX
batcher does (the same ticks, train steps, skipped steps and tokens)."""
import jax
import numpy as np
import pytest
import torch

from conftest import sample_prompts
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro.runtime.serving_loop import _TickBudget as JaxTickBudget
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import make_engine
from repro_torch.core.interfaces import slack_order
from repro_torch.runtime.serving_loop import (
    ContinuousBatcher, GenRequest, _TickBudget,
)
from test_torch_prefix_cache import pair, reference, requests

LENS = [7, 24, 13, 24, 6, 19]


def _tokens(s, prompts, chunk, gen=6, **kw):
    reqs = requests(prompts, [gen] * len(prompts))
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"],
                          prefill_chunk=chunk, **kw)
    b.run(reqs)
    return [list(r.tokens) for r in reqs], b


# ------------------------------------------------ greedy bit-identity -----
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_chunked_matches_monolithic_contiguous(kind):
    s = pair(kind)
    prompts = sample_prompts(s["jcfg"], 6, LENS)
    kw = dict(n_slots=3, max_seq=32, prompt_pad=24)
    mono, _ = _tokens(s, prompts, 0, **kw)
    if kind == "mha":           # GQA's: tests/test_torch_serving.py
        assert mono == [reference((kind,), p, 6) for p in prompts]
    for chunk in (8, 10):       # a chunk dividing and straddling prompts
        assert _tokens(s, prompts, chunk, **kw)[0] == mono


def test_chunked_matches_monolithic_sliding_window():
    s = pair("mha", 16)
    prompts = sample_prompts(s["jcfg"], 5, [5, 16, 9, 16, 12])
    kw = dict(n_slots=3, max_seq=24, prompt_pad=16)
    mono, _ = _tokens(s, prompts, 0, **kw)
    assert _tokens(s, prompts, 6, **kw)[0] == mono


def test_chunked_matches_monolithic_paged():
    s = pair()
    prompts = sample_prompts(s["jcfg"], 6, LENS)
    kw = dict(n_slots=3, max_seq=32, prompt_pad=24, paged=True,
              block_size=8)
    mono, _ = _tokens(s, prompts, 0, **kw)
    assert mono == [reference(("mha",), p, 6) for p in prompts]
    # 8 is block-aligned; 12 rounds up to 16
    for chunk in (8, 12):
        toks, b = _tokens(s, prompts, chunk, **kw)
        assert toks == mono
        assert b.allocator.n_used == 0 and b.allocator.reserved == 0


def _mixed_prompts(cfg):
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    prompts = []
    for i in range(6):
        tail = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(4, 9))).astype(np.int32)
        prompts.append(np.concatenate([shared, tail]) if i % 2 == 0
                       else rng.integers(0, cfg.vocab_size,
                                         size=int(rng.integers(6, 25)))
                       .astype(np.int32))
    return prompts


def test_chunked_matches_monolithic_prefix_cache():
    s = pair()
    prompts = _mixed_prompts(s["jcfg"])
    kw = dict(n_slots=3, max_seq=32, prompt_pad=24, paged=True,
              block_size=8, prefix_cache=True)
    mono, b0 = _tokens(s, prompts, 0, **kw)
    chunked, b1 = _tokens(s, prompts, 8, **kw)
    assert chunked == mono
    assert mono == [reference(("mha",), p, 6) for p in prompts]
    # chunked admission starts from the matched blocks
    assert b1.stats.cached_prefix_tokens == b0.stats.cached_prefix_tokens > 0
    assert b1.allocator.n_used == 0 and b1.allocator.reserved == 0


def test_chunked_prefix_cache_counters_match_jax():
    """Chunked prefill over the prefix cache: the port's tokens, prefill
    waves' token counts and cache counters equal the JAX batcher's."""
    s = pair()
    prompts = _mixed_prompts(s["jcfg"])
    kw = dict(n_slots=3, max_seq=32, prompt_pad=24, paged=True,
              block_size=8, prefix_cache=True, prefill_chunk=8)
    jb = JaxBatcher(s["jeng"], s["jp"], s["jlora"], **kw)
    jreqs = requests(prompts, [6] * 6, JaxRequest)
    jstats = jb.run(jreqs)
    tb = ContinuousBatcher(s["eng"], s["params"], s["lora"], **kw)
    treqs = requests(prompts, [6] * 6)
    tstats = tb.run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    for k in ("prefill_tokens", "cached_prefix_tokens", "decode_steps",
              "generated_tokens"):
        assert getattr(tstats, k) == getattr(jstats, k), k
    for k in ("hits", "misses", "reclaimed"):
        assert getattr(tb.prefix_cache, k) == getattr(jb.prefix_cache, k)
    for k in ("n_retained", "n_free", "peak_used"):
        assert getattr(tb.allocator, k) == getattr(jb.allocator, k), k


def test_continue_and_write_rows_match_jax():
    """One contiguous chunk wave, module against module: the port's
    ``prefill_ragged_continue`` over slot caches that hold each row's
    earlier chunk, then ``write_prefill_rows``, against JAX's."""
    s = pair("gqa")
    m, jm = s["eng"].model, s["jeng"].model
    prompts = sample_prompts(s["jcfg"], 2, [14, 9], seed=5)
    first = np.zeros((2, 8), np.int32)
    lens0 = np.array([8, 5], np.int32)
    for j, p in enumerate(prompts):
        first[j, :lens0[j]] = p[:lens0[j]]
    _, pre0 = m.prefill_ragged(s["params"], s["lora"],
                               {"tokens": torch.tensor(first).long()},
                               torch.tensor(lens0))
    caches = m.init_caches(3, 24)
    slots = np.array([2, 0], np.int32)
    m.write_prefill_rows(caches, pre0, slots, np.zeros(2, np.int32), lens0)
    jcaches = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), caches)
    chunk = np.zeros((2, 8), np.int32)
    lens1 = np.array([6, 4], np.int32)
    for j, p in enumerate(prompts):
        chunk[j, :lens1[j]] = p[lens0[j]:lens0[j] + lens1[j]]
    logits, pre = m.prefill_ragged_continue(
        s["params"], s["lora"], {"tokens": torch.tensor(chunk).long()},
        lens1, lens0, caches, slots)
    jlogits, jpre = jm.prefill_ragged_continue(
        s["jp"], s["jlora"], {"tokens": chunk}, lens1, lens0, jcaches,
        slots)
    jlogits = np.asarray(jlogits)
    assert float(np.abs(logits.numpy() - jlogits).max()
                 / np.abs(jlogits).max()) < 5e-5
    m.write_prefill_rows(caches, pre, slots, lens0, lens1)
    jout = jm.write_prefill_rows(jcaches, jpre, slots, lens0, lens1)
    for t, jt in zip(caches["kv"], jout["kv"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=5e-5,
                                   atol=5e-5)
    # the whole prompt monolithic: the chunk's logits are its last token's
    full = np.zeros((2, 14), np.int32)
    for j, p in enumerate(prompts):
        full[j, :len(p)] = p
    mono, _ = m.prefill_ragged(s["params"], s["lora"],
                               {"tokens": torch.tensor(full).long()},
                               torch.tensor([14, 9]))
    assert float((logits - mono).abs().max() / mono.abs().max()) < 5e-5


# ------------------------------------------------------ lifecycle edges ----
def test_mid_chunk_eviction_frees_everything(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    s = pair()
    prompts = sample_prompts(s["jcfg"], 2, [24, 24])
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                          max_seq=32, prompt_pad=24, paged=True,
                          block_size=8, prefill_chunk=8)
    for r in requests(prompts, [6, 6]):
        b.submit(r)
    b.step()                    # one chunk in: slots parked mid-prefill
    assert b.prefilling_slots(), "expected mid-prefill slots"
    assert b.allocator.n_used > 0
    assert b.allocator.san is not None
    b.drain_all()               # check_quiescent runs inside when armed
    assert b.allocator.n_used == 0
    assert b.allocator.reserved == 0
    assert not b.prefilling_slots()


def test_preempt_during_chunked_prefill_frees_everything(monkeypatch):
    """Oversubscribed pool: an urgent decoder crosses a block boundary
    while a late arrival with more slack is still mid-prefill — the
    prefilling victim takes the drop and re-prefill path (its partial K/V
    is never swapped), every block and reservation it held returns to
    the pool, and both requests finish with the unbounded run's tokens,
    all under the armed sanitizers."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    s = pair()
    prompts = sample_prompts(s["jcfg"], 2, [6, 28])

    def serve(nb, **kw):
        r0 = GenRequest(request_id=0, prompt=prompts[0].copy(),
                        max_new_tokens=24, deadline=1.0)
        r1 = GenRequest(request_id=1, prompt=prompts[1].copy(),
                        max_new_tokens=8)   # inf deadline: most slack
        b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                              max_seq=32, prompt_pad=28, paged=True,
                              block_size=4, prefill_chunk=4, n_blocks=nb,
                              **kw)
        b.submit(r0)
        b.step()
        b.step()                # r0 decoding before r1 even arrives
        b.submit(r1)
        for _ in range(300):
            if b.idle():
                break
            b.step()
        return [list(r0.tokens), list(r1.tokens)], b

    ref, _ = serve(64)
    toks, b = serve(12, oversubscribe=1.0)
    assert toks == ref
    assert b.stats.preemptions > 0
    assert b.stats.reprefill_tokens > 0     # the drop path, not swap:
    assert b.stats.swap_out_blocks == 0     # partial prefill K/V is
    assert b.allocator.n_used == 0          # recomputed, never copied
    assert b.allocator.reserved == 0
    assert b.idle()


def test_ssm_arch_rejects_chunked_prefill():
    cfg = get_config("mamba2-780m").scaled()
    engine = make_engine(cfg, device="cpu")
    params = engine.model.init(torch.Generator().manual_seed(0))
    lora = engine.model.init_lora(torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="attention-only"):
        ContinuousBatcher(engine, params, lora, n_slots=2, max_seq=24,
                          prompt_pad=16, prefill_chunk=8)


def test_paged_chunk_rounds_up_to_block_multiple():
    s = pair()
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                          max_seq=32, prompt_pad=24, paged=True,
                          block_size=8, prefill_chunk=10)
    assert b.prefill_chunk == 16
    b2 = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                           max_seq=32, prompt_pad=24, prefill_chunk=10)
    assert b2.prefill_chunk == 10


def test_slack_order_ranks_by_deadline():
    items = [("a", 5.0), ("b", 1.0), ("c", float("inf")), ("d", 1.0)]
    got = slack_order(items, 0.5, key=lambda it: it[1])
    assert [n for n, _ in got] == ["b", "d", "a", "c"]   # ties stay FCFS


# -------------------------------------------------- budget planner units ---
@pytest.mark.parametrize("cls", [_TickBudget, JaxTickBudget],
                         ids=["port", "jax"])
def test_tick_budget_pricing(cls):
    bud = cls(0.010)
    assert bud.train_tokens(4, 16, 0.0) is None
    bud.observe_decode(0.004)
    assert bud.train_tokens(4, 16, 0.0) is None
    bud.observe_train(64, 0.0016)       # 25 us/token
    assert bud.train_tokens(4, 16, 0.0) == 0
    assert bud.train_tokens(4, 16, 0.005) == 32
    assert bud.train_tokens(4, 16, 0.0092) is None
    assert bud.prefill_allowance(0) == float("inf")
    bud.observe_prefill(32, 0.0032)     # 100 us/token
    assert bud.prefill_allowance(2) == pytest.approx(60.0)
    bud.observe_decode(0.030)
    assert bud.prefill_allowance(2) == 0.0


def test_budget_stats_and_latency_distributions():
    s = pair()
    prompts = sample_prompts(s["jcfg"], 4, [7, 24, 13, 18])
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=2,
                          max_seq=32, prompt_pad=24, prefill_chunk=8,
                          tpot_target=0.004)
    stats = b.run(requests(prompts, [6] * 4))
    assert stats.finished == 4
    assert stats.budget_ticks > 0
    assert stats.budget_target_s == pytest.approx(
        0.004 * stats.budget_ticks)
    assert stats.budget_spent_s > 0
    assert len(stats.ttft) == 4 and all(t >= 0 for t in stats.ttft)
    assert len(stats.tpot) == 4 and all(t >= 0 for t in stats.tpot)


def _fixed_budget(cls, train_tok_s):
    """A ``_TickBudget`` whose costs are fixed (decode 0.5 s a tick,
    prefill 0.5 / 12 s a token, so 12 prefill tokens fit beside a decode
    wave) and whose train plan ignores the measured prefill time: its
    plan depends on no clock."""
    class Fixed(cls):
        def observe_decode(self, dt):
            pass

        def observe_prefill(self, tokens, dt):
            pass

        def observe_train(self, tokens, dt):
            pass

        def train_tokens(self, b, s, prefill_spent_s):
            return super().train_tokens(b, s, 0.0)

    bud = Fixed(1.0)
    bud.decode_tick_s, bud.prefill_tok_s = 0.5, 0.5 / 12
    bud.train_tok_s = train_tok_s
    return bud


def _train_batches(vocab, n, b=4, s=8, seed=50):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


@pytest.mark.parametrize("train_tok_s", [0.01, 0.02, None],
                         ids=["full", "half", "skip"])
def test_budget_plan_matches_jax(train_tok_s):
    """Co-training under a fixed budget cost model, paged, chunk 8: a
    4 x 8 train batch costs 0.32 s (full fits the 0.5 s slack), 0.64 s
    (half fits) or is unpriced (skipped while serving).  The port plans
    every tick as the JAX batcher does — the same budget ticks, train
    steps, skipped steps and rows — and emits the same tokens, its losses
    within 1e-4 relative (float32 sums in another order)."""
    s = pair()
    prompts = sample_prompts(s["jcfg"], 4, [7, 24, 13, 18])
    batches = _train_batches(s["cfg"].vocab_size, 80)
    kw = dict(n_slots=2, max_seq=32, prompt_pad=24, paged=True,
              block_size=8, prefill_chunk=8, tpot_target=1.0)
    out = {}
    for name, cls, batcher, eng, params, lora, req in (
            ("jax", JaxTickBudget, JaxBatcher, s["jeng"], s["jp"],
             s["jlora"], JaxRequest),
            ("port", _TickBudget, ContinuousBatcher, s["eng"], s["params"],
             s["lora"], GenRequest)):
        b = batcher(eng, params, lora, opt_state=eng.optimizer.init(lora),
                    **kw)
        b.budget = _fixed_budget(cls, train_tok_s)
        reqs = requests(prompts, [6] * 4, req)
        for r in reqs:
            b.submit(r)
        feed, rows = iter(batches), []
        while not b.idle():
            b.step(train_batch=next(feed))
            rows.append(b.last_tick_train_rows)
        out[name] = (b, reqs, rows)
    (jb, jreqs, jrows), (tb, treqs, trows) = out["jax"], out["port"]
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert trows == jrows
    for k in ("budget_ticks", "train_steps", "train_skipped_ticks",
              "decode_steps", "prefill_tokens"):
        assert getattr(tb.stats, k) == getattr(jb.stats, k), k
    assert tb.stats.budget_target_s == jb.stats.budget_target_s
    np.testing.assert_allclose(tb.train_losses, jb.train_losses, rtol=1e-4)
    want = {0.01: 4, 0.02: 2, None: 0}[train_tok_s]
    assert want in trows if train_tok_s else tb.stats.train_skipped_ticks
