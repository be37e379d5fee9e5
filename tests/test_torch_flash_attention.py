"""The port's flash attention (``repro_torch.kernels.flash_attention``)
and blockwise layer (``repro_torch.models.layers.attention_blockwise``)
against the JAX package, float32 on the CPU, inputs drawn with numpy:

* ``flash_attention_ref`` (the forward kernel's plain version) against
  the Pallas ``flash_attention`` run in interpret mode, as
  ``tests/test_kernels.py`` runs it: rtol = atol = 2e-5;
* gradients in q, k and v of the port's blockwise plain loop and of
  ``FlashAttentionFn`` (on the CPU: autograd of the plain version, the
  backward kernels' plain version) against ``jax.grad`` of the JAX
  ``attention_blockwise``: within 1e-5 of the largest gradient (float32
  sums over every query or key, in another order);
* the port's ``attention_blockwise`` against the JAX one, both variants,
  at several ``block_kv``: within 1e-5 of the largest output; the two
  variants bitwise equal to each other, as in JAX;
* on the CPU ``FlashAttentionFn`` and the layer never launch (the
  counters stay 0), and a tensor on another device than the CPU or a
  card raises instead of taking the plain version.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.layers import attention_blockwise as jax_blockwise
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, backward_split, flash_attention_backward,
    flash_attention_fwd, flash_attention_grad_ref, flash_attention_ref,
)
from repro_torch.models.layers import attention_blockwise

GRAD_REL = 1e-5
LAYER_REL = 1e-5


def _inputs(b, h, hkv, sq, skv, d, seed=0, layout="bhsd"):
    """q, k, v as numpy float32, in [B,H,S,D] (``bhsd``) or the model's
    [B,S,H,D] (``bshd``)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    if layout == "bshd":
        q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    return q, k, v


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


# ------------------------------------------------ forward vs Pallas -------
@pytest.mark.parametrize("b,h,hkv,sq,skv,causal,window", [
    (2, 4, 2, 256, 256, True, 0),       # GQA
    (1, 8, 2, 200, 200, True, 0),       # ragged: no multiple of the tile
    (2, 4, 4, 128, 256, False, 0),      # Skv > Sq, non-causal
    (1, 4, 2, 256, 256, True, 64),      # sliding window
], ids=["gqa", "ragged", "cross", "window"])
def test_plain_version_matches_pallas(b, h, hkv, sq, skv, causal, window):
    q, k, v = _inputs(b, h, hkv, sq, skv, 64, seed=1)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, bq=128, bk=128,
                        interpret=True)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_fully_masked_rows_are_zero():
    """Queries whose window holds none of the keys (two keys, window 3:
    rows 4 and on) give zeros, the kernels' clamped-l contract."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 8, 8, 64))
    out = flash_attention_ref(q, k[:, :, :2], v[:, :, :2], causal=True,
                              window=3)
    assert torch.all(out[:, :, 4:] == 0)
    assert torch.all(out[:, :, :4] != 0)


# ------------------------------------------------------ gradients ---------
def _jax_grads(q, k, v, w, causal, window, block_kv):
    def loss(q_, k_, v_):
        o = jax_blockwise(q_, k_, v_, causal=causal, window=window,
                          block_kv=block_kv)
        return jnp.sum(o * w)
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("path", ["blockwise", "flash_fn"])
@pytest.mark.parametrize("hkv,window", [(2, 0), (4, 12)],
                         ids=["causal-gqa", "window"])
def test_gradient_matches_jax_grad(path, hkv, window):
    b, sq, hq, d, bk = 2, 40, 4, 16, 16
    q, k, v = _inputs(b, hq, hkv, sq, sq, d, seed=2, layout="bshd")
    w = np.random.default_rng(3).standard_normal(
        (b, sq, hq, d)).astype(np.float32)
    want = _jax_grads(q, k, v, w, True, window, bk)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    if path == "blockwise":
        o = attention_blockwise(tq, tk, tv, causal=True, window=window,
                                block_kv=bk)
    else:
        o = FlashAttentionFn.apply(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), True, window,
                                   None).transpose(1, 2)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, j in zip("qkv", got, want):
        assert _rel(g.numpy(), j) < GRAD_REL, name


def test_grad_ref_is_autograd_of_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 24, 24, 64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    dq, dk, dv = flash_attention_grad_ref(q, k, v, do, causal=True,
                                          window=5)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        flash_attention_ref(qa, ka, va, causal=True, window=5), (qa, ka, va),
        do)
    for g, j in zip((dq, dk, dv), want):
        assert torch.equal(g, j)
    assert dk.shape == k.shape and dv.shape == v.shape


# ---------------------------------------------------------- layer ---------
@pytest.mark.parametrize("block_kv", [8, 16, 64])
@pytest.mark.parametrize("skip", [False, True], ids=["scan", "triangular"])
@pytest.mark.parametrize("window", [0, 10])
def test_blockwise_layer_matches_jax(block_kv, skip, window):
    q, k, v = _inputs(2, 4, 2, 37, 37, 16, seed=4, layout="bshd")
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, block_kv=block_kv,
                         skip_masked_blocks=skip)
    got = attention_blockwise(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, block_kv=block_kv,
                              skip_masked_blocks=skip)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < LAYER_REL


@pytest.mark.parametrize("causal,q_offset,skv", [(False, 0, 50),
                                                 (True, 13, 50)],
                         ids=["non-causal", "q-offset"])
def test_blockwise_scan_matches_jax_beyond_self_attention(causal, q_offset,
                                                          skv):
    q, k, v = _inputs(1, 4, 2, 20, skv, 16, seed=5, layout="bshd")
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, q_offset=q_offset, block_kv=16)
    got = attention_blockwise(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_offset=q_offset, block_kv=16)
    assert _rel(got.numpy(), want) < LAYER_REL


@pytest.mark.parametrize("window", [0, 9, 40])
def test_blockwise_variants_are_bitwise_equal(window):
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(2, 4, 2, 45, 45, 16, seed=6, layout="bshd"))
    scan = attention_blockwise(q, k, v, window=window, block_kv=8)
    tri = attention_blockwise(q, k, v, window=window, block_kv=8,
                              skip_masked_blocks=True)
    assert torch.equal(scan, tri)


def test_triangular_variant_keeps_its_assertion():
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(1, 2, 2, 8, 12, 16, layout="bshd"))
    with pytest.raises(AssertionError, match="causal self-attention"):
        attention_blockwise(q, k, v, skip_masked_blocks=True)
    with pytest.raises(AssertionError, match="causal self-attention"):
        attention_blockwise(q, k[:, :8], v[:, :8], causal=False,
                            skip_masked_blocks=True)


# --------------------------------------------------------- dispatch -------
def test_cpu_calls_never_launch():
    flash_attention_fwd.launches = flash_attention_backward.launches = 0
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(1, 4, 2, 16, 16, 64))
    FlashAttentionFn.apply(q, k, v, True, 0, None).sum().backward()
    with torch.no_grad():
        FlashAttentionFn.apply(q, k, v, True, 0, None)
    attention_blockwise(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), block_kv=8)
    assert flash_attention_fwd.launches == 0
    assert flash_attention_backward.launches == 0


@pytest.mark.parametrize("where", ["all", "k_only"])
def test_non_cpu_tensors_never_take_plain_version(where):
    """A tensor that is neither on the CPU nor on a card raises; nothing
    falls back to the plain version."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16, 16, 64))
    if where == "all":
        q, k, v = (t.to("meta") for t in (q, k, v))
    else:
        k = k.to("meta")
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="flash_attention"):
        FlashAttentionFn.apply(q, k, v, True, 0, None)
    with pytest.raises(ValueError, match="flash_attention"):
        attention_blockwise(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    lse = torch.zeros(q.shape[:3], device=q.device)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention_backward(q, k, v, q, lse, q)
    assert flash_attention_fwd.launches == 0
    assert flash_attention_backward.launches == 0


@pytest.mark.parametrize("b,hkv,group,skv,n_sms,want", [
    (4, 16, 1, 2048, 132, 1),     # qwen train batch: no group to slice
    (8, 8, 4, 2048, 132, 1),      # llama wave: 1,024 blocks fill the card
    (1, 8, 4, 2048, 132, 2),      # llama train batch: 128 blocks
    (1, 8, 4, 1000, 132, 4),      # ragged: 64 blocks
    (1, 2, 8, 300, 132, 8),       # slices never exceed the group
    (1, 1, 6, 128, 132, 2),       # a group of 6: halves, not quarters
])
def test_backward_split_slices_each_group_once(b, hkv, group, skv, n_sms,
                                               want):
    """The bfloat16 backward's host-side plan: slices divide each KV
    head's group of query heads evenly (the kernel gives each slice
    ``group // split`` heads), and only a grid smaller than the card is
    sliced."""
    split = backward_split(b, hkv, group, skv, n_sms)
    assert split == want
    assert group % split == 0
    blocks = -(-skv // 128) * hkv * b
    assert split == 1 or blocks * split // 2 < n_sms
