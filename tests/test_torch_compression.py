"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``) on the CPU, inputs
drawn with numpy:

* ``topk_compress`` and ``compress_tree_topk``: values, masks and
  residuals bitwise equal to JAX's, over rounds that feed the residual
  back, including ties at the threshold (``>=`` keeps every tied entry,
  so more than k survive) and k = max(1, int(size * frac)) at tiny
  fractions;
* ``quantize_int8``, ``dequantize_int8`` and ``compress_tree_int8``:
  ``q``, the float32 scale and the residuals bitwise, with values that
  land exactly on .5 (rounded half to even by both) and an all-zero
  tensor (the 1e-12 floor of the scale);
* twins of ``tests/test_optim.py``'s two compression tests (the kept set
  and the error-feedback identity; the int8 error bound under
  hypothesis);
* the stochastic path (``key`` a ``torch.Generator``): unbiased over
  seeded draws, reproducible from the seed; it is not bit-matched to
  ``jax.random``, which draws other numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import compression as jc
from repro_torch.optim import (
    ErrorFeedback, compress_tree_int8, compress_tree_topk, dequantize_int8,
    init_error_feedback, quantize_int8, topk_compress,
)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"q": {"a": rng.standard_normal((6, 5)).astype(np.float32),
                  "b": (rng.standard_normal((5, 7)) * 1e-3)
                  .astype(np.float32)},
            "o": rng.standard_normal((33,)).astype(np.float32)}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(t_tree, j_tree):
    """Bitwise equal leaves (dtype and bits), the trees' leaves in the
    same (sorted-key) order."""
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), t_tree))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert t.dtype == j.dtype and t.shape == j.shape
        assert np.array_equal(t.reshape(-1).view(np.uint8),
                              j.reshape(-1).view(np.uint8)), (t, j)


# ------------------------------------------------------------------ top-k --
@pytest.mark.parametrize("frac", [0.4, 0.05, 1e-4, 1.0])
def test_topk_compress_matches_jax(frac):
    g = np.random.default_rng(1).standard_normal((9, 11)).astype(np.float32)
    tv, tm = topk_compress(torch.from_numpy(g), frac)
    jv, jm = jc.topk_compress(jnp.asarray(g), frac)
    _same((tv, tm), (jv, jm))
    assert int(tm.sum()) == max(1, int(g.size * frac))


def test_topk_keeps_every_tie_at_the_threshold():
    g = np.array([3.0, -2.0, 2.0, 1.0, -2.0, 0.5], np.float32)
    tv, tm = topk_compress(torch.from_numpy(g), 0.34)     # k = 2
    jv, jm = jc.topk_compress(jnp.asarray(g), 0.34)
    _same((tv, tm), (jv, jm))
    assert tm.tolist() == [1.0, 1.0, 1.0, 0.0, 1.0, 0.0]  # 4 kept, k 2


def test_compress_tree_topk_matches_jax_over_rounds():
    """Three rounds, each feeding its residual into the next."""
    tef = init_error_feedback(_t(_grads()))
    jef = jc.init_error_feedback(_j(_grads()))
    _same(tef.residual, jef.residual)
    for r in range(3):
        g = _grads(10 + r)
        tk, tef = compress_tree_topk(_t(g), tef, frac=0.1)
        jk, jef = jc.compress_tree_topk(_j(g), jef, frac=0.1)
        _same(tk, jk)
        _same(tef.residual, jef.residual)
    assert isinstance(tef, ErrorFeedback)


def test_topk_compression_keeps_largest():
    """Twin of tests/test_optim.py::test_topk_compression_keeps_largest."""
    grads = {"a": torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])}
    ef = init_error_feedback(grads)
    kept, ef2 = compress_tree_topk(grads, ef, frac=0.4)
    assert set(torch.nonzero(kept["a"])[:, 0].tolist()) == {1, 3}
    total = kept["a"] + ef2.residual["a"]
    np.testing.assert_allclose(total.numpy(), grads["a"].numpy(), rtol=1e-6)


# ------------------------------------------------------------------- int8 --
@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "bf16"])
def test_quantize_int8_matches_jax(case):
    rng = np.random.default_rng(2)
    g = {"normal": rng.standard_normal((7, 9)).astype(np.float32),
         # max |g| 127 makes the scale exactly 1: every .5 is a tie, and
         # both round half to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
         "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5],
                            np.float32),
         "zeros": np.zeros((4, 3), np.float32),
         "bf16": rng.standard_normal((5, 6)).astype(np.float32)}[case]
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    if case == "bf16":
        tg, jg = tg.to(torch.bfloat16), jg.astype(jnp.bfloat16)
    tq, ts = quantize_int8(tg)
    jq, js = jc.quantize_int8(jg)
    _same((tq, ts), (jq, js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _same(dequantize_int8(tq, ts), jc.dequantize_int8(jq, js))
    if case == "halves":
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, 126]


def test_compress_tree_int8_matches_jax_over_rounds():
    tef = init_error_feedback(_t(_grads()))
    jef = jc.init_error_feedback(_j(_grads()))
    for r in range(3):
        g = _grads(20 + r)
        tq, ts, tef = compress_tree_int8(_t(g), tef)
        jq, js, jef = jc.compress_tree_int8(_j(g), jef)
        _same(tq, jq)
        _same(ts, js)
        _same(tef.residual, jef.residual)


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=4,
                max_size=64))
@settings(max_examples=50, deadline=None)
def test_int8_quantization_error_bounded(vals):
    """Twin of tests/test_optim.py::test_int8_quantization_error_bounded."""
    g = torch.tensor(vals, dtype=torch.float32)
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_stochastic_int8_is_unbiased_and_seeded():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(64)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([dequantize_int8(*quantize_int8(g, gen))
                         for _ in range(4000)])
    scale = float(quantize_int8(g)[1])
    # each draw is within one step of g; the mean within 5 standard
    # errors of g (a draw's spread is at most half a step)
    assert float((draws - g).abs().max()) <= scale * (1 + 1e-6)
    assert float((draws.mean(0) - g).abs().max()) \
        < 5 * 0.5 * scale / np.sqrt(len(draws))
    again = dequantize_int8(*quantize_int8(
        g, torch.Generator().manual_seed(0)))
    assert torch.equal(again, draws[0])
    # not the deterministic rounding everywhere
    assert not torch.equal(draws[0], dequantize_int8(*quantize_int8(g)))
