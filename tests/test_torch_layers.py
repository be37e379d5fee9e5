"""The port's layers (``repro_torch.models.layers``) against the JAX
layers on the same numpy-seeded float32 inputs, on the CPU.  The JAX
decode layers run their ``backend="jnp"`` paths; the port's decode
layers run the paged kernel's plain version (CPU tensors).  Tolerance
2e-5 abs/rel: same math in float32, summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=2e-5, atol=2e-5)


def _pair(arr):
    return jnp.asarray(arr), torch.from_numpy(np.ascontiguousarray(arr))


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 128)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32) * 3)
    sj, st = _pair(rng.standard_normal(shape[-1]).astype(np.float32))
    _close(jl.rms_norm(xj, sj), tl.rms_norm(xt, st))


@pytest.mark.parametrize("ragged", [False, True])
def test_rope(ragged):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 7, 3, 16
    if ragged:                      # per-sequence positions, one token
        pos = np.array([[5], [40]], np.int32)
        s = 1
    else:
        pos = np.arange(s, dtype=np.int32)
    pj, pt = _pair(pos)
    cj, sj = jl.rope_tables(pj, d, 10000.0)
    ct, st = tl.rope_tables(pt, d, 10000.0)
    _close(cj, ct)
    _close(sj, st)
    xj, xt = _pair(rng.standard_normal((b, s, h, d)).astype(np.float32))
    _close(jl.apply_rope(xj, cj, sj), tl.apply_rope(xt, ct, st))


@pytest.mark.parametrize("b,hq,hkv,kv_len,window", [
    (2, 4, 4, None, 0),          # causal MHA
    (2, 4, 2, None, 0),          # causal GQA
    (2, 4, 2, 9, 0),             # scalar kv_len mask
    (1, 4, 2, [6], 0),           # per-sequence kv_len
    (2, 4, 2, None, 5),          # sliding window
])
def test_attention_dense(b, hq, hkv, kv_len, window):
    rng = np.random.default_rng(2)
    s, d = 12, 16
    qj, qt = _pair(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    klj = klt = None
    if kv_len is not None:
        klj, klt = _pair(np.asarray(kv_len, np.int32))
    _close(jl.attention_dense(qj, kj, vj, window=window, kv_len=klj),
           tl.attention_dense(qt, kt, vt, window=window, kv_len=klt))


@pytest.mark.parametrize("b,s,hq,hkv,d,lens", [
    (3, 48, 8, 2, 64, [1, 17, 48]),     # GQA, bk=16 identity tables
    (2, 40, 4, 4, 32, [40, 3]),         # MHA, bk=8
    (2, 7, 4, 1, 16, [7, 2]),           # prime length: bk=1
])
def test_attention_decode(b, s, hq, hkv, d, lens):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    lj, lt = _pair(np.asarray(lens, np.int32))
    _close(jl.attention_decode(qj, kj, vj, lj, backend="jnp"),
           tl.attention_decode(qt, kt, vt, lt))


@pytest.mark.parametrize("b,hq,hkv,n_blocks,bs,nb,d", [
    (2, 8, 2, 16, 16, 4, 64),
    (3, 4, 4, 12, 8, 3, 32),
])
def test_attention_decode_paged(b, hq, hkv, n_blocks, bs, nb, d):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    kpj, kpt = _pair(rng.standard_normal(
        (n_blocks, bs, hkv, d)).astype(np.float32))
    vpj, vpt = _pair(rng.standard_normal(
        (n_blocks, bs, hkv, d)).astype(np.float32))
    tables = np.stack([rng.permutation(np.arange(1, n_blocks))[:nb]
                       for _ in range(b)]).astype(np.int32)
    lens = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    lens[0] = 1
    tj, tt = _pair(tables)
    lj, lt = _pair(lens)
    _close(jl.attention_decode_paged(qj, kpj, vpj, tj, lj, backend="jnp"),
           tl.attention_decode_paged(qt, kpt, vpt, tt, lt))
