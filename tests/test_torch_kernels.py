"""The port's paged decode attention (``repro_torch.kernels.
decode_attention``) on the CPU, where the wrapper takes its plain PyTorch
version, against the JAX Pallas kernel run with ``interpret=True`` on the
same numpy-seeded float32 inputs (tolerance 2e-5 abs/rel, as the JAX
kernel tests).  Also: the dispatch contract (CPU tensors never count a
launch, other devices never reach the plain version) and the build
(a failed nvcc raises).  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged
from repro.models.layers import attention_decode as jax_attention_decode
from repro_torch.kernels import _build
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
