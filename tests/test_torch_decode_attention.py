"""The port's contiguous decode attention (``repro_torch.kernels.
decode_attention.decode_attention``) on the CPU, where the wrapper takes
its plain PyTorch version, against the JAX Pallas kernel
``repro.kernels.decode_attention.decode_attention`` run with
``interpret=True`` (``bk=128``, as the JAX kernel tests run it) on the
same numpy-seeded float32 inputs, tolerance 2e-5 abs/rel as in
``tests/test_kernels.py``:

* at ``tests/test_kernels.py``'s three shapes and a prime cache length
  (37, no multiple of any tile);
* ``kv_len == 0`` gives zeros in both (the oracle ``kernels/ref.py``
  gives NaN there);
* the model's layout: a ``[B, T, Hkv, D]`` projection passed as its
  transposed view gives the output of a contiguous head-major copy;
* the dispatch contract: a CPU call counts no launch; tensors off the
  CPU go to the kernel path and raise where it has no kernel; the
  kernel path's checks refuse strides it cannot read, and what the bf16
  kernel's TMA loads cannot read (a base off a 16-byte boundary, a stride
  that is no multiple of 16 bytes) or its MMAs do not take (more than 8
  query heads per KV head, a head_dim other than 64 or 128);
* the split of the cache walk the wrapper hands the kernel covers the
  cache in whole tiles: 32 rows in float32, 64 in bfloat16.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (``kernel_decode``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_ref, split_plan, split_plan_bf16,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, h, hkv, s, d, seed=2, empty_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kl = rng.integers(1, s + 1, size=b).astype(np.int32)
    kl[-1] = s
    if empty_row:
        kl[0] = 0
    return q, kc, vc, kl


def _both(q, kc, vc, kl):
    yj = jax_decode(*(jnp.asarray(a) for a in (q, kc, vc, kl)), bk=128,
                    interpret=True)
    yt = decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, kl)))
    return np.asarray(yj), yt.numpy()


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 8, 2, 512, 64),             # tests/test_kernels.py's shapes
    (3, 4, 4, 300, 128),
    (1, 16, 2, 1024, 64),
    (2, 8, 2, 37, 64),              # a prime cache length
])
def test_decode_attention_matches_pallas(b, h, hkv, s, d):
    yj, yt = _both(*_inputs(b, h, hkv, s, d))
    np.testing.assert_allclose(yt, yj, **TOL)


def test_empty_sequence_gives_zeros_as_pallas():
    """kv_len == 0: the Pallas kernel's clamped l gives zeros, and so
    does the plain version; the other rows still match."""
    yj, yt = _both(*_inputs(3, 8, 2, 37, 64, seed=4, empty_row=True))
    assert not yj[0].any() and not yt[0].any()
    np.testing.assert_allclose(yt, yj, **TOL)


def test_transposed_view_equals_contiguous_copy():
    """The model passes ``k.transpose(1, 2)`` of its [B, T, Hkv, D] vision
    K/V: the strided view and a contiguous copy give the same output."""
    rng = np.random.default_rng(5)
    b, t, hkv, h, d = 2, 37, 2, 8, 32
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, hkv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, hkv, d))
                         .astype(np.float32))
    kl = torch.tensor([t, 20], dtype=torch.int32)
    kv, vv = k.transpose(1, 2), v.transpose(1, 2)
    assert not kv.is_contiguous()
    got = decode_attention(q, kv, vv, kl)
    want = decode_attention(q, kv.contiguous(), vv.contiguous(), kl)
    assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), decode_attention_ref(q, kv.contiguous(), vv.contiguous(),
                                          kl).numpy(), **TOL)


def test_cpu_call_counts_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64)]
    before = decode_attention.launches
    decode_attention(*args)
    assert decode_attention.launches == before


@pytest.mark.parametrize("where", ["all", "cache_only"])
def test_non_cpu_tensors_never_take_plain_version(where):
    """Tensors off the CPU go to the kernel path, whose checks raise for
    a device it has no kernel for (meta) or for mixed devices."""
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64)]
    if where == "all":
        args = [a.to("meta") for a in args]
    else:
        args[1] = args[1].to("meta")
    before = decode_attention.launches
    with pytest.raises(ValueError):
        decode_attention(*args)
    assert decode_attention.launches == before


def test_kernel_path_checks_refuse_what_it_cannot_read():
    """The kernel path's checks (run ahead of any build or launch): a
    non-unit last axis, a dtype mismatch, non-int32 lengths and too many
    query heads per KV head raise before the device is even asked."""
    q, kc, vc, kl = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 64))

    def check(*args):
        # the device check comes after these, so CPU tensors reach them
        with pytest.raises((TypeError, ValueError)) as err:
            da._check_contiguous(*args)
        return str(err.value)

    assert "dtype" in check(q, kc.double(), vc, kl)
    assert "int32" in check(q, kc, vc, kl.long())
    assert "do not agree" in check(q, kc[:1], vc[:1], kl)
    assert "no kernel for device" in check(q, kc, vc, kl)
    wide = torch.zeros((2, 2 * 33, 64))       # 33 heads per KV head: 9 x 64
    assert -(-33 // 4) * 64 > da._MAX_COLS
    assert "exceeds" in check(wide, kc, vc, kl)
    strided = torch.zeros((2, 2, 64, 128))[..., ::2]
    assert "unit stride" in check(q, strided, strided, kl)


def _tma_case(case):
    """bf16 inputs whose K/V the TMA loads cannot read (``base``: a view
    starting one element past a 16-byte boundary; ``stride``: rows 65
    elements apart), or whose heads the kernel's MMAs do not take."""
    b, hkv, s, d = 2, 2, 64, 64
    q = torch.zeros((b, 2 * hkv, d), dtype=torch.bfloat16)
    kc = torch.zeros((b, hkv, s, d), dtype=torch.bfloat16)
    if case == "base":
        kc = torch.zeros(b * hkv * s * d + 1,
                         dtype=torch.bfloat16)[1:].view(b, hkv, s, d)
    elif case == "stride":
        kc = torch.zeros((b, hkv, s, d + 1), dtype=torch.bfloat16)[..., :d]
    elif case == "heads":
        q = torch.zeros((b, 9 * hkv, d), dtype=torch.bfloat16)
    elif case == "head_dim":
        q = torch.zeros((b, 2 * hkv, 32), dtype=torch.bfloat16)
        kc = torch.zeros((b, hkv, s, 32), dtype=torch.bfloat16)
    return q, kc, kc.clone() if case == "stride" else kc, \
        torch.full((b,), s, dtype=torch.int32)


@pytest.mark.parametrize("case,message", [
    ("base", "16-byte aligned"),
    ("stride", "multiples of 16 bytes"),
    ("heads", "at most 8 query heads"),
    ("head_dim", "head_dim in"),
])
def test_kernel_path_refuses_what_tma_cannot_read(case, message):
    """The checks run before any build or launch, so CPU tensors reach
    them; each refusal names its reason."""
    q, kc, vc, kl = _tma_case(case)
    if case == "base":
        assert kc.data_ptr() % 16 and kc.stride(-1) == 1
    if case == "stride":
        assert (kc.stride(2) * 2) % 16 and kc.stride(-1) == 1
    with pytest.raises(ValueError) as err:
        da._check_contiguous(q, kc, vc, kl)
    assert message in str(err.value)


@pytest.mark.parametrize("b,hkv,s", [(8, 8, 1601), (2, 2, 512), (1, 1, 37),
                                     (64, 8, 1601), (8, 8, 16), (3, 4, 300),
                                     (1, 8, 1601), (1, 2, 1024)])
def test_split_plan_covers_the_cache_in_whole_tiles(b, hkv, s):
    splits, chunk = split_plan(b, hkv, s, n_sm=132)
    assert chunk % 32 == 0 and 1 <= splits <= da._MAX_SPLITS
    assert (splits - 1) * chunk < s <= splits * chunk
    if b * hkv < 132 and s > 32:
        assert splits > 1              # the VLM's 64 pairs do not fill the card
    # bfloat16: whole 64-row tiles, every split non-empty, the blocks
    # within half the SMs unless the pairs alone are more
    splits, chunk = split_plan_bf16(b, hkv, s, n_sm=132)
    assert chunk % da.BF16_TILE_ROWS == 0 and 1 <= splits <= da._MAX_SPLITS
    assert (splits - 1) * chunk < s <= splits * chunk
    assert splits == 1 or b * hkv * splits <= 132 // 2
    if b * hkv * 2 <= 132 // 2 and s > 2 * da.BF16_TILE_ROWS:
        assert splits > 1              # one sequence's heads are split
