"""Long-context prefill and co-training through the blockwise attention
path (on the card, the ``flash_attention`` kernels), against the JAX
package on the same weights, float32 on the CPU:

* ``prefill_ragged`` logits and caches of a reduced qwen1.5-0.5b with
  ``attn_impl="blockwise"`` forced, both variants and several
  ``block_kv``: logits within 5e-5 of their largest magnitude
  (``tests/test_decode_parity.py``'s bound), caches within 1e-6;
* three ``train_step``s there against ``Engine.train_step`` (with and
  without ``skip_masked_blocks``), with ``tests/test_torch_train.py``'s
  tolerances;
* the paged co-training ``ContinuousBatcher`` against the JAX one fed the
  same numpy train batches: the same greedy tokens, train losses within
  1e-4 relative, the trained adapter within 1e-5 (as
  ``tests/test_torch_serving.py``);
* ``attn_impl="dense"`` and ``"blockwise"`` on the same inputs within
  5e-5 relative: the boundary the runtime crosses at 1,024 tokens;
* ``attn_impl="auto"`` with a prompt past the dense limit (1,040 tokens,
  at small width): prefill logits against JAX, and the port's batcher
  serving it paged and contiguous with the same tokens;
* the reference's gates: prefix caching, chunked prefill and
  oversubscription need the dense prefill path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.models.model import build as jax_build
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.models.model import build
from repro_torch.models.transformer import use_dense_prefill
from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
from repro_torch.tree import tree_map
from test_torch_model import numpy_lora
from test_torch_train import (
    LORA_TOL, _close_trees, jbatch, numpy_batch, tbatch,
)

LOGIT_REL = 5e-5
CACHE_REL = 1e-6
LENS = np.array([5, 9, 3], np.int32)
PAD = 12


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    t, j = np.asarray(t), np.asarray(j)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


def _pair(impl="blockwise", **kw):
    """(jax model, params, lora), (port model, params, lora) with the same
    weights: the reduced qwen1.5-0.5b, ``attn_impl`` forced."""
    jcfg = jax_config("qwen1.5-0.5b").scaled(attn_impl=impl, **kw)
    tcfg = get_config("qwen1.5-0.5b").scaled(attn_impl=impl, **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    tm = build(tcfg, device="cpu")
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return ((jm, jp, jax.tree.map(jnp.asarray, lora_np)),
            (tm, tp, lora_from_numpy(lora_np, "cpu")))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(vocab, lens, pad, seed=5):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lens), pad), np.int32)
    for j, n in enumerate(lens):
        out[j, :n] = rng.integers(0, vocab, n)
    return out


# ---------------------------------------------------------- prefill -------
@pytest.mark.parametrize("block_kv,skip", [(512, False), (4, False),
                                           (4, True), (8, True)])
def test_blockwise_prefill_matches_jax(pair, block_kv, skip):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = _prompts(tm.cfg.vocab_size, LENS, PAD)
    lj, cj = jm.prefill_ragged(jp, jlora, {"tokens": jnp.asarray(toks)},
                               jnp.asarray(LENS), block_kv=block_kv,
                               skip_masked_blocks=skip)
    lt, ct = tm.prefill_ragged(tp, tlora,
                               {"tokens": torch.from_numpy(toks).long()},
                               torch.from_numpy(LENS), block_kv=block_kv,
                               skip_masked_blocks=skip)
    assert not use_dense_prefill(tm.cfg, PAD)
    assert _rel(lt, lj) < LOGIT_REL
    for t, j in zip(ct["kv"], cj["kv"]):
        assert _rel(t, j) < CACHE_REL


def test_dense_and_blockwise_impls_agree():
    """The same weights and tokens through ``attn_impl="dense"`` and
    ``"blockwise"``: the two sides of the 1,024-token boundary."""
    _, (tm, tp, tlora) = _pair("dense")
    tb = build(dataclasses.replace(tm.cfg, attn_impl="blockwise"), "cpu")
    toks = torch.from_numpy(_prompts(tm.cfg.vocab_size, [40, 40], 40)).long()
    dense = tm.logits(tp, tlora, {"tokens": toks})
    for skip in (False, True):
        blk = tb.logits(tp, tlora, {"tokens": toks}, block_kv=16,
                        skip_masked_blocks=skip)
        assert _rel(blk, dense.numpy()) < LOGIT_REL


# ------------------------------------------------------------ train -------
@pytest.mark.parametrize("skip", [False, True])
def test_blockwise_train_step_matches_jax(skip):
    jcfg = jax_config("qwen1.5-0.5b").scaled(attn_impl="blockwise")
    cfg = get_config("qwen1.5-0.5b").scaled(attn_impl="blockwise")
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    jstep = jax.jit(jeng.train_step,
                    static_argnames=("skip_masked_blocks", "ce_chunk"))
    jlora = jax.tree.map(jnp.asarray, lora_np)
    jopt = jeng.optimizer.init(jlora)
    lora = lora_from_numpy(lora_np, "cpu")
    opt = eng.optimizer.init(lora)
    for step in range(3):
        batch = numpy_batch(cfg, seed=30 + step)
        jlora, jopt, jmet = jstep(jp, jlora, jopt, jbatch(batch),
                                  skip_masked_blocks=skip, ce_chunk=16)
        lora, opt, tmet = eng.train_step(params, lora, opt, tbatch(batch),
                                         skip_masked_blocks=skip,
                                         ce_chunk=16)
        _close_trees(lora, jlora, **LORA_TOL)
        for k in ("loss", "ce_loss", "grad_norm"):
            assert _rel(tmet[k], jmet[k]) < 1e-4, k


# ---------------------------------------------------- co-training ---------
LENS_SERVE = [6, 10, 4, 8, 7]
GENS = [5, 2, 6, 3, 4]


def _train_batches(vocab, n, b=4, s=8, seed=50):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


def test_blockwise_cotraining_batcher_matches_jax():
    """Both batchers, paged, blockwise prefill and training, co-train on
    the same numpy batches, one per tick."""
    jcfg = jax_config("qwen1.5-0.5b").scaled(attn_impl="blockwise")
    cfg = get_config("qwen1.5-0.5b").scaled(attn_impl="blockwise")
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jax.tree.map(lambda x: x + 0.01,
                         jeng.model.init_lora(jax.random.key(1)))
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS_SERVE), LENS_SERVE)
    batches = _train_batches(cfg.vocab_size, 40)
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10, paged=True,
              block_size=4)
    jb = JaxBatcher(jeng, jp, jlora, opt_state=jeng.optimizer.init(jlora),
                    **kw)
    jreqs = [JaxRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i])
             for i in range(len(LENS_SERVE))]
    jfeed = iter(batches)
    jstats = jb.run(jreqs, train_data_fn=lambda: next(jfeed))
    tb = ContinuousBatcher(eng, params, lora,
                           opt_state=eng.optimizer.init(lora), **kw)
    treqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i])
             for i in range(len(LENS_SERVE))]
    tfeed = iter(batches)
    tstats = tb.run(treqs, train_data_fn=lambda: next(tfeed))
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tstats.train_steps == jstats.train_steps == tstats.decode_steps
    np.testing.assert_allclose(tb.train_losses, jb.train_losses, rtol=1e-4)
    for t, j in zip(jax.tree.leaves(tree_map(lambda x: x.numpy(), tb.lora)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jb.lora))):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    assert tb.allocator.n_used == 0 and tb.allocator.reserved == 0


# --------------------------------------- past the dense limit, "auto" -----
LONG = 1040             # 1040^2 > 1M: "auto" takes the blockwise path
TINY = dict(n_layers=1, d_model=64, n_heads=2, d_ff=128, vocab_size=128)


@pytest.fixture(scope="module")
def tiny():
    return _pair("auto", **TINY)


def test_auto_prefill_past_the_dense_limit_matches_jax(tiny):
    (jm, jp, jlora), (tm, tp, tlora) = tiny
    assert use_dense_prefill(tm.cfg, 1024)
    assert not use_dense_prefill(tm.cfg, LONG)
    lens = np.array([LONG, 700], np.int32)
    toks = _prompts(tm.cfg.vocab_size, lens, LONG, seed=7)
    lj, _ = jm.prefill_ragged(jp, jlora, {"tokens": jnp.asarray(toks)},
                              jnp.asarray(lens))
    lt, _ = tm.prefill_ragged(tp, tlora,
                              {"tokens": torch.from_numpy(toks).long()},
                              torch.from_numpy(lens))
    assert _rel(lt, lj) < LOGIT_REL


@pytest.mark.parametrize("combined", [False, True])
def test_batcher_serves_past_the_dense_limit(tiny, combined):
    """Prompts of up to 1,040 tokens serve (and co-train on 2 x 1,040
    rows) paged and contiguous, with the same tokens in both layouts."""
    _, (tm, tp, tlora) = tiny
    eng = make_engine(tm.cfg, lr=1e-3, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (LONG, 1030, 900)]
    batches = _train_batches(tm.cfg.vocab_size, 8, b=2, s=LONG)
    tokens = []
    for paged in (False, True):
        feed = iter(batches)
        b = ContinuousBatcher(eng, tp, tlora, n_slots=2, max_seq=LONG + 3,
                              prompt_pad=LONG, paged=paged, block_size=16,
                              opt_state=eng.optimizer.init(tlora))
        reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=3)
                for i, p in enumerate(prompts)]
        stats = b.run(reqs, train_data_fn=(lambda: next(feed))
                      if combined else None)
        assert stats.finished == 3
        assert all(len(r.tokens) == 3 for r in reqs)
        if combined:
            assert stats.train_steps == stats.decode_steps
            assert np.isfinite(b.train_losses).all()
        tokens.append([r.tokens for r in reqs])
    assert tokens[0] == tokens[1]


def test_features_keep_the_dense_prefill_gate(tiny):
    _, (tm, tp, tlora) = tiny
    eng = make_engine(tm.cfg, device="cpu")
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 64},
               {"oversubscribe": 0.9}):
        with pytest.raises(NotImplementedError, match="dense prefill"):
            ContinuousBatcher(eng, tp, tlora, paged=True, max_seq=LONG + 8,
                              prompt_pad=LONG, **kw)
    # at a dense-path prompt length all three construct
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 64},
               {"oversubscribe": 0.9}):
        ContinuousBatcher(eng, tp, tlora, paged=True, **kw)
