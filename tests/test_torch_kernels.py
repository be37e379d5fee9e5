"""The port's paged decode attention (``repro_torch.kernels.
decode_attention``) on the CPU, where the wrapper takes its plain PyTorch
version, against the JAX Pallas kernel run with ``interpret=True`` on the
same numpy-seeded float32 inputs (tolerance 2e-5 abs/rel, as the JAX
kernel tests).  Also: the dispatch contract (CPU tensors never count a
launch, other devices never reach the plain version), the build (a
failed nvcc raises), and the bf16 kernel's host side: its tile plan
covers every live row once without reading a table entry past the live
blocks, and its refusals are named.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged
from repro.models.layers import attention_decode as jax_attention_decode
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.models.layers import attention_decode

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, h, hkv, nb_pool, bs, nb, d, seed=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb_pool, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb_pool, bs, hkv, d)).astype(np.float32)
    # distinct non-scratch blocks per sequence, shuffled pool order
    tables = np.stack([rng.permutation(np.arange(1, nb_pool))[:nb]
                       for _ in range(b)]).astype(np.int32)
    kl = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    return q, kp, vp, tables, kl


def _both(q, kp, vp, tables, kl):
    yj = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, tables, kl)),
                   interpret=True)
    yt = paged_decode_attention(*(torch.from_numpy(a)
                                  for a in (q, kp, vp, tables, kl)))
    return np.asarray(yj), yt.numpy()


@pytest.mark.parametrize("b,h,hkv,nb_pool,bs,nb,d", [
    (2, 8, 2, 16, 16, 4, 64),       # GQA, short tables
    (3, 4, 4, 12, 8, 8, 128),       # MHA, longer walk
    (1, 16, 2, 32, 32, 6, 64),      # wide grouping
])
def test_paged_decode_attention_matches_pallas(b, h, hkv, nb_pool, bs, nb,
                                               d):
    yj, yt = _both(*_inputs(b, h, hkv, nb_pool, bs, nb, d))
    np.testing.assert_allclose(yt, yj, **TOL)


def test_scratch_tail_and_empty_sequence():
    """Entries past the live blocks point at scratch block 0 (filled
    with garbage here) and must not matter; kv_len == 0 gives zeros,
    like the TPU kernel's clamped l."""
    q, kp, vp, tables, _ = _inputs(3, 4, 2, 10, 8, 4, 32, seed=9)
    kp[0] = 1e4
    vp[0] = -1e4
    kl = np.array([0, 9, 32], np.int32)
    tables[1, 2:] = 0                 # 9 rows -> 2 live blocks
    yj, yt = _both(q, kp, vp, tables, kl)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert not yt[0].any()


def test_contiguous_identity_dispatch_matches_jax():
    """The contiguous layer views its cache as a block pool with an
    identity table — against the JAX layer's own identity-table dispatch
    into the Pallas kernel."""
    rng = np.random.default_rng(8)
    b, s, hq, hkv, d = 3, 48, 8, 2, 64
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kl = np.array([1, 17, 48], np.int32)
    yj = jax_attention_decode(*(jnp.asarray(a) for a in (q, kc, vc, kl)),
                              backend="interpret")
    yt = attention_decode(*(torch.from_numpy(a) for a in (q, kc, vc, kl)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_contiguous_identity_dispatch_large_blocks():
    """A 1024-row cache is viewed as 256-row pool blocks (the largest
    identity block), ragged lengths inside and across those blocks."""
    rng = np.random.default_rng(10)
    b, s, hq, hkv, d = 3, 1024, 4, 2, 32
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kl = np.array([1, 300, 1024], np.int32)
    yj = jax_attention_decode(*(jnp.asarray(a) for a in (q, kc, vc, kl)),
                              backend="interpret")
    yt = attention_decode(*(torch.from_numpy(a) for a in (q, kc, vc, kl)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_cpu_call_counts_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 2, 16, 16, 4, 64)]
    before = paged_decode_attention.launches
    paged_decode_attention(*args)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("where", ["all", "pool_only"])
def test_non_cpu_tensors_never_take_plain_version(where):
    """Tensors off the CPU go to the kernel path, whose checks raise for
    a device it has no kernel for (meta) or for mixed devices — the
    plain version is never a fallback."""
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 2, 16, 16, 4, 64)]
    if where == "all":
        args = [a.to("meta") for a in args]
    else:
        args[1] = args[1].to("meta")
    before = paged_decode_attention.launches
    with pytest.raises(ValueError):
        paged_decode_attention(*args)
    assert paged_decode_attention.launches == before


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel that nvcc refuses raises with nvcc's output, and a
    missing nvcc raises too; neither leaves a library behind."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: refused by test' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(_build.KernelBuildError, match="refused by test"):
        _build.library("paged_decode_attention")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library("paged_decode_attention")
    assert not list((tmp_path / "build").glob("*.so"))


# --------------------------------------------- the bfloat16 kernel's plan --
def _paged_loads(bs, nb, kv_len, splits, chunk, box):
    """The loads the bf16 kernel's producer issues for one (sequence, KV
    head): per split, per 64-row tile, the boxes that start below the
    split's end, each as (table index, first row in its pool block,
    rows).  Mirrors the paged producer loop of ``csrc/decode_bf16.cuh``
    (``decode_bf16_body``, lines 153-192), which only the card runs."""
    length = min(kv_len, nb * bs)
    loads = []
    for sp in range(splits):
        lo, hi = sp * chunk, min(sp * chunk + chunk, length)
        for row0 in range(lo, hi, 64):
            for j in range(-(-min(64, hi - row0) // box)):
                r = row0 + j * box
                loads.append((r // bs, r % bs, box))
    return loads


@pytest.mark.parametrize("bs", [1, 2, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,hkv", [(8, 16), (4, 8)])
def test_paged_bf16_tile_plan_covers_each_live_row_once(bs, b, hkv):
    """The bf16 kernel's loads (``_paged_loads``, as its producer
    issues them: per split, per 64-row tile, boxes of gcd(bs, 64) rows
    starting below the split's end) cover every logical row below kv_len
    exactly once, a full tile takes 64 / box loads, no box crosses a pool
    block, and no table entry past the live blocks is read: at ragged
    lengths, 0 and a full table, with the splits the wrapper gives."""
    nb = max(1, 2080 // bs)
    splits, chunk, box = da.paged_plan_bf16(b, hkv, bs, nb, n_sm=132)
    assert box == np.gcd(bs, 64) and bs % box == 0 and 64 % box == 0
    assert chunk % 64 == 0 and (splits - 1) * chunk < nb * bs <= splits * chunk
    rng = np.random.default_rng(bs)
    lengths = [0, 1, 63, 64, 65, nb * bs - 1, nb * bs,
               *rng.integers(1, nb * bs + 1, size=4)]
    for kv_len in lengths:
        loads = _paged_loads(bs, nb, int(kv_len), splits, chunk, box)
        rows = [t * bs + off + r for t, off, n in loads for r in range(n)]
        assert len(rows) == len(set(rows))
        assert set(range(kv_len)) <= set(rows)
        live_blocks = -(-int(kv_len) // bs)
        assert all(t < live_blocks and off + n <= bs for t, off, n in loads)
        if kv_len == nb * bs and nb * bs % 64 == 0:
            assert len(loads) == (nb * bs // 64) * (64 // box)


def test_paged_bf16_split_plan():
    """One split at the serve tick (8 sequences x 16 KV heads = 128 blocks
    for 132 SMs); llama3-8b's GQA (4 x 8 pairs) splits the walk."""
    assert da.paged_plan_bf16(8, 16, 16, 130, n_sm=132)[0] == 1
    assert da.paged_plan_bf16(8, 16, 32, 65, n_sm=132)[0] == 1
    assert da.paged_plan_bf16(4, 8, 16, 64, n_sm=132)[0] > 1


def _bf16_case(case, b=2, hkv=2, bs=16, n_blocks=6, d=64):
    q = torch.zeros((b, 2 * hkv, d), dtype=torch.bfloat16)
    kp = torch.zeros((n_blocks, bs, hkv, d), dtype=torch.bfloat16)
    if case == "head_dim":
        q = torch.zeros((b, 2 * hkv, 32), dtype=torch.bfloat16)
        kp = torch.zeros((n_blocks, bs, hkv, 32), dtype=torch.bfloat16)
    elif case == "heads":
        q = torch.zeros((b, 9 * hkv, d), dtype=torch.bfloat16)
    elif case == "base":
        kp = torch.zeros(n_blocks * bs * hkv * d + 1,
                         dtype=torch.bfloat16)[1:].view(n_blocks, bs, hkv, d)
    elif case == "stride":
        kp = torch.zeros((n_blocks, bs, hkv, d + 1),
                         dtype=torch.bfloat16)[..., :d]
    tables = torch.zeros((b, 3), dtype=torch.int32)
    return q, kp, kp.clone() if case == "stride" else kp, tables, \
        torch.full((b,), 5, dtype=torch.int32)


@pytest.mark.parametrize("case,message", [
    ("head_dim", "head_dim in"),
    ("heads", "at most 8 query heads"),
    ("base", "16-byte aligned"),
    ("stride", "multiples of 16 bytes"),
])
def test_paged_bf16_refusals_are_named(case, message):
    """The bf16 kernel's refusals run before any build or launch, so CPU
    tensors reach them, and each names its reason; a pool that passes
    them is refused only for its device."""
    q, kp, vp, tables, kl = _bf16_case(case)
    if case == "base":
        assert kp.data_ptr() % 16 and kp.stride(-1) == 1
    with pytest.raises(ValueError) as err:
        da._check(q, kp, vp, tables, kl)
    assert message in str(err.value)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        da._check(*_bf16_case("ok"))
