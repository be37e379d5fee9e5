"""The port's fused LoRA matmul (``repro_torch.kernels.lora_matmul``) on
the CPU, where the wrapper takes its plain PyTorch version:

* against the JAX Pallas kernel run with ``interpret=True`` at block
  multiples (``tests/test_kernels.py``'s shapes and tolerances: 1e-5 in
  float32, 3e-2 in bfloat16, where x @ A is rounded to bf16 in both and
  one bf16 ulp of the output is ~1e-2), and against
  ``repro.kernels.ops.lora_matmul(force_kernel=True)`` at ragged shapes
  (1e-5: float32 sums in another order);
* its gradient ``LoRAMatmulFn`` against ``jax.grad`` of the JAX bypass
  ``repro.models.lora.apply(x, x @ w, pair, s)`` (float32, 1e-5 of each
  gradient's largest magnitude), and ``torch.autograd.gradcheck`` in
  float64;
* the bf16 decode path's split of K (M <= 16): whole 16-row steps that
  cover K exactly, about two blocks per SM at every decode shape of the
  port where K has the rows for it (64 a split), the same split for one
  adapter slot and for many (the bitwise
  identity of ``segmented_lora_matmul`` with ``lora_matmul`` rests on
  it), and the scratch the wrappers keep between calls;
* the dispatch contract (CPU tensors never count a launch; meta or mixed
  devices never reach the plain version), and the model's use of it:
  every adapter projection is one kernel call, and a train step's
  backward skips dX where the input needs no gradient (layer 0's q/k/v).
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.  Inputs are numpy-seeded."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lora_matmul import lora_matmul as jax_lora_kernel
from repro.kernels.ops import lora_matmul as jax_ops_lora
from repro.models.lora import apply as jax_apply
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _scratch
from repro_torch.kernels import lora_matmul as lm_mod
from repro_torch.kernels.lora_matmul import (
    LoRAMatmulFn, lora_matmul, lora_matmul_ref,
)
from repro_torch.models import lora as lora_lib
from repro_torch.models.model import build

GRAD_REL = 1e-5


def _inputs(m, k, n, r, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((k, r)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((r, n)) * 0.05).astype(np.float32)
    return x, w, a, b


@pytest.mark.parametrize("m,k,n,r", [(128, 256, 128, 8), (256, 512, 384, 16),
                                     (128, 128, 128, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas(m, k, n, r, dtype):
    x, w, a, b = _inputs(m, k, n, r)
    jd = getattr(jnp, dtype)
    yj = jax_lora_kernel(*(jnp.asarray(t).astype(jd) for t in (x, w, a, b)),
                         2.0, bm=128, bn=128, bk=128, interpret=True)
    td = getattr(torch, dtype)
    yt = lora_matmul(*(torch.from_numpy(t).to(td) for t in (x, w, a, b)),
                     2.0)
    assert yt.dtype == td
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,r,lead", [
    (37, 200, 136, 4, ()),
    (13, 130, 70, 16, (3,)),          # leading batch dim, as the model
    (100, 64, 300, 2, ()),
])
def test_plain_version_matches_ops_at_ragged_shapes(m, k, n, r, lead):
    """ops.lora_matmul pads to block multiples for the Pallas kernel;
    the port masks ragged edges instead and must agree."""
    x, w, a, b = _inputs(m, k, n, r, seed=1, lead=lead)
    yj = jax_ops_lora(*(jnp.asarray(t) for t in (x, w, a, b)), 0.5,
                      force_kernel=True, block=64)
    xt = torch.from_numpy(x)
    yt = lora_lib.project(xt, torch.from_numpy(w),
                          {"a": torch.from_numpy(a),
                           "b": torch.from_numpy(b)}, 0.5)
    assert yt.shape == xt.shape[:-1] + (n,)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


def test_project_without_adapter_is_the_plain_product():
    x, w, _, _ = _inputs(5, 16, 8, 2, lead=(2,))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(lora_lib.project(xt, wt, None, 2.0), xt @ wt)


def test_project_matches_unfused_apply():
    x, w, a, b = _inputs(6, 32, 24, 4, lead=(3,))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pair = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    np.testing.assert_allclose(
        lora_lib.project(xt, wt, pair, 2.0).numpy(),
        lora_lib.apply(xt, xt @ wt, pair, 2.0).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,k,n,r", [(24, 48, 40, 4), (7, 33, 65, 8)])
def test_gradient_matches_jax_grad(m, k, n, r):
    x, w, a, b = _inputs(m, k, n, r, seed=2)
    dy = np.random.default_rng(3).standard_normal((m, n)).astype(np.float32)
    s = 2.0

    def jloss(x_, a_, b_):
        y = jax_apply(x_, x_ @ jnp.asarray(w), {"a": a_, "b": b_}, s)
        return jnp.sum(y * jnp.asarray(dy))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (x, a, b)))
    xt, at, bt = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    y = LoRAMatmulFn.apply(xt, torch.from_numpy(w), at, bt, s)
    tg = torch.autograd.grad(y, (xt, at, bt), torch.from_numpy(dy))
    for name, t, j in zip(("dx", "da", "db"), tg, jg):
        j = np.asarray(j)
        err = np.max(np.abs(t.numpy() - j)) / np.max(np.abs(j))
        assert err < GRAD_REL, f"{name}: relative error {err}"


def test_gradcheck_float64():
    rng = np.random.default_rng(4)
    x, a, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float64,
                            requires_grad=True)
               for shape in ((5, 7), (7, 3), (3, 6)))
    w = torch.tensor(rng.standard_normal((7, 6)), dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x_, a_, b_: LoRAMatmulFn.apply(x_, w, a_, b_, 1.5),
        (x, a, b))


def test_frozen_weight_refuses_a_gradient():
    x, w, a, b = (torch.from_numpy(t) for t in _inputs(4, 8, 8, 2))
    with pytest.raises(ValueError, match="frozen"):
        LoRAMatmulFn.apply(x, w.requires_grad_(), a, b, 1.0)


def test_cpu_call_counts_no_launch():
    args = [torch.from_numpy(t) for t in _inputs(8, 64, 32, 4)]
    before = lora_matmul.launches
    lora_matmul(*args, 2.0)
    assert lora_matmul.launches == before


@pytest.mark.parametrize("where", ["all", "w_only"])
def test_non_cpu_tensors_never_take_plain_version(where, monkeypatch):
    """Tensors off the CPU go to the kernel path, whose checks raise for
    a device it has no kernel for (meta) or for mixed devices — the
    plain version is never a fallback."""
    def fail(*_a, **_k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(lm_mod, "lora_matmul_ref", fail)
    args = [torch.from_numpy(t) for t in _inputs(8, 64, 32, 4)]
    if where == "all":
        args = [t.to("meta") for t in args]
    else:
        args[1] = args[1].to("meta")
    before = lora_matmul.launches
    with pytest.raises(ValueError):
        lora_matmul(*args, 2.0)
    assert lora_matmul.launches == before


def test_model_calls_per_forward_and_backward(monkeypatch):
    """Each adapter projection is one kernel call in the forward; the
    backward calls it once more per projection for dX except for layer
    0's q, k and v, whose input (the frozen embedding) needs no
    gradient: 4L forward + (4L - 3) backward calls."""
    cfg = get_config("qwen1.5-0.5b").scaled()
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lora = {t: {k: v.requires_grad_() for k, v in p.items()}
            for t, p in model.init_lora(torch.Generator().manual_seed(1))
            .items()}
    calls = []
    real = lm_mod.lora_matmul

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(lm_mod, "lora_matmul", counting)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones(2, 8)}
    loss, _ = model.forward_loss(params, lora, batch)
    n_fwd = len(calls)
    torch.autograd.grad(loss, [p["a"] for p in lora.values()]
                        + [p["b"] for p in lora.values()])
    n_layers, n_targets = cfg.n_layers, len(cfg.lora.targets)
    assert n_fwd == n_layers * n_targets
    assert len(calls) - n_fwd == n_layers * n_targets - 3


# (M, K, N): the decode projections of the port's configs: qwen1.5-0.5b's
# q/k/v/o, mamba2-780m's ssm_in / ssm_out, llama3-8b's and
# llama-3.2-vision-90b's q/o and k/v, and a ragged shape
DECODE_SHAPES = [(8, 1024, 1024), (8, 1536, 6448), (8, 3072, 1536),
                 (8, 4096, 4096), (8, 4096, 1024), (8, 8192, 8192),
                 (8, 8192, 1024), (5, 1000, 2816)]


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
def test_decode_split_plan_covers_k_in_whole_steps(m, k, n):
    """Every split holds whole 16-row steps and at least one row of K,
    the splits cover K exactly, none is shorter than DECODE_MIN_ROWS
    (bar a K shorter than that), and the grid of (64-column tile, split)
    blocks gives the card two blocks per SM to within one split of its
    tiles wherever K has the rows for it; where it has not, K is cut into
    as many DECODE_MIN_ROWS-row splits as it holds."""
    n_sm = 132
    splits, chunk = lm_mod.decode_split_plan(k, n, n_sm)
    tiles = -(-n // lm_mod.DECODE_BN)
    assert m <= lm_mod.DECODE_MAX_M
    assert chunk % lm_mod.DECODE_STEP == 0
    assert 1 <= splits <= lm_mod.DECODE_MAX_SPLITS
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits == 1 or chunk >= lm_mod.DECODE_MIN_ROWS
    two_per_sm = tiles * splits >= lm_mod.DECODE_BLOCKS_PER_SM * n_sm - tiles
    assert two_per_sm or splits == k // lm_mod.DECODE_MIN_ROWS


@pytest.mark.parametrize("r", [16, 64])
def test_decode_plan_is_the_same_for_one_slot_and_many(r):
    """``segmented_lora_matmul`` rows are bitwise ``lora_matmul`` of their
    slot only if both split K alike: the plan ignores the slots, and only
    the workspace grows with them (one x @ A record per slot)."""
    k, n = 1024, 1024
    one = lm_mod.decode_workspace(k, n, r, 1, 132)
    rp = 16 if r <= 16 else 64
    for na in (2, 4, 8):
        many = lm_mod.decode_workspace(k, n, r, na, 132)
        assert many[:2] == one[:2] == lm_mod.decode_split_plan(k, n, 132)
        assert many[3] == one[3] == -(-n // lm_mod.DECODE_BN)
        assert many[2] - one[2] == (na - 1) * rp * 16 * one[0] * one[3]


def test_scratch_is_kept_per_stream_and_grows():
    """The split kernels' workspace and tickets: reused while they fit,
    replaced by larger ones when a call needs more, tickets zero, one pair
    per (device, stream)."""
    dev = torch.device("cpu")
    ws, tk = _scratch.buffers(dev, 11, 10, 4)
    assert ws.dtype == torch.float32 and tk.dtype == torch.int32
    assert not tk.any()
    again = _scratch.buffers(dev, 11, 100, 4)
    assert again[0] is ws and again[1] is tk
    bigger = _scratch.buffers(dev, 11, ws.numel() + 1, 4)
    assert bigger[0].numel() > ws.numel() and bigger[1] is tk
    other = _scratch.buffers(dev, 12, 10, 4)
    assert other[0] is not bigger[0] and other[1] is not tk


# (M, K, N) of the bf16 path above M = 16: every M > 16 call of the
# port's serve and combined runs (qwen1.5-0.5b's q/k/v/o from the 4 x 32
# train step to the 8 x 2,048 prefill wave, mamba2-780m's ssm_in / ssm_out
# at a 2,048-token prefill, llama3-8b's q/o and k/v at 2,048 rows, the
# VLM's q/o at its 256-row wave), the dX of the train shapes (K and N
# swapped), ragged shapes and the smallest M the path takes
MMA_SHAPES = [(17, 64, 64), (128, 1024, 1024), (256, 1024, 1024),
              (1024, 1024, 1024), (3968, 1024, 1024), (7936, 1024, 1024),
              (8192, 1024, 1024), (16384, 1024, 1024), (1000, 1000, 2816),
              (1000, 2816, 1000), (2048, 1536, 6448), (2048, 6448, 1536),
              (2048, 3072, 1536), (2048, 4096, 4096), (2048, 4096, 1024),
              (2048, 1024, 4096), (256, 8192, 8192), (300, 512, 520)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("m,k,n", MMA_SHAPES)
def test_mma_tile_plan_covers_every_tile_once(m, k, n, n_sm):
    """The persistent grid's walk (``mma_tile``, the kernel's
    ``tile_mn``; block b of G takes tiles b, b + G, ...) visits every
    128-row output tile exactly once, no block idle; the width is the
    cheapest of MMA_WIDTHS by rounds x (width + MMA_STEP_COST), the widest
    on a tie; at most one block per SM."""
    bn, blocks, group = lm_mod.mma_tile_plan(m, k, n, n_sm)
    tiles_m, tiles_n = -(-m // lm_mod.MMA_BM), -(-n // bn)
    tiles = tiles_m * tiles_n

    def cost(w):
        return (-(-tiles_m * -(-n // w) // n_sm)
                * (w + lm_mod.MMA_STEP_COST))

    assert bn in lm_mod.MMA_WIDTHS
    assert all(cost(bn) < cost(w) for w in lm_mod.MMA_WIDTHS if w > bn)
    assert all(cost(bn) <= cost(w) for w in lm_mod.MMA_WIDTHS)
    assert blocks == min(tiles, n_sm) and group >= 1
    walks = [[lm_mod.mma_tile(t, m, n, bn, group)
              for t in range(b, tiles, blocks)] for b in range(blocks)]
    seen = [tile for walk in walks for tile in walk]
    assert min(map(len, walks)) >= 1 and len(seen) == tiles
    assert set(seen) == {(i, j) for i in range(tiles_m)
                         for j in range(tiles_n)}


@pytest.mark.parametrize("r", [16, 64])
@pytest.mark.parametrize("m,k,n", [(256, 1024, 1024), (7936, 1024, 1024),
                                   (16384, 1024, 1024), (1000, 1000, 2816)])
def test_mma_plan_is_the_same_for_one_slot_and_many(m, k, n, r, monkeypatch):
    """``segmented_lora_matmul`` rows are bitwise ``lora_matmul`` of their
    slot only if both walk the same tiles: the arguments the wrappers
    hand the C entry at M > 16 hold the plan of (M, K, N, SM count)
    alone, whatever the slots, and no decode split or scratch."""
    monkeypatch.setattr(_scratch, "sm_count", lambda index: 132)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    one = lm_mod._plan_args(x, 0, k, n, r, 1)
    assert one == (0, 0, None, None, *lm_mod.mma_tile_plan(m, k, n, 132))
    for na in (2, 4, 8):
        assert lm_mod._plan_args(x, 0, k, n, r, na) == one


def _bf16_views(layout):
    """(x, w, a, b) bf16 CPU views in a layout the wrappers took before
    the M > 16 path moved to TMA: the forward's row-major operands, the
    backward's transposed views (dX = dY @ W^T + ...), slices of wider
    buffers (row strides past the width, N no multiple of 8)."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)
    m, k, n, r = 40, 72, 96, 16
    if layout == "forward":
        return t(m, k), t(k, n), t(k, r), t(r, n)
    if layout == "backward_views":
        return t(m, n), t(k, n).t(), t(r, n).t(), t(k, r).t()
    if layout == "wide_rows":
        return t(m, k + 24)[:, :k], t(k, n + 8)[:, :n], t(k, 24)[:, :r], \
            t(r, n + 8)[:, :n]
    if layout == "ragged_n":
        return t(m, k), t(k, 104)[:, :100], t(k, r), t(r, 104)[:, :100]
    if layout == "backward_ragged_n":     # dX of a width-100 view
        return t(m, 104)[:, :100], t(k, 104)[:, :100].t(), \
            t(r, 104)[:, :100].t(), t(k, r).t()
    raise AssertionError(layout)


@pytest.mark.parametrize("layout", ["forward", "backward_views", "wide_rows",
                                    "ragged_n", "backward_ragged_n"])
def test_bf16_layouts_are_still_taken(layout):
    """Every bf16 operand layout the wrapper took before is taken still;
    a mix of row- and column-major W, A and B is refused, as before."""
    x, w, a, b = _bf16_views(layout)
    lm_mod._check_bf16_layout(x, w, a, b)
    with pytest.raises(ValueError, match="all be row-major"):
        lm_mod._check_bf16_layout(x, w, a.t().contiguous().t()
                                  if a.stride(1) == 1 else a.contiguous(),
                                  b)


@pytest.mark.parametrize("slots", [1, 4, 8])
def test_segmented_bf16_layouts_are_still_taken(slots):
    """The stacks as the adapter registry keeps them (contiguous
    [NA, K, r] / [NA, r, N]), a slice of a wider x, and N no multiple of
    8; a column-major W is refused, as before."""
    m, k, n, r = 40, 72, 100, 16
    x = torch.zeros((m, k + 8), dtype=torch.bfloat16)[:, :k]
    w = torch.zeros((k, 104), dtype=torch.bfloat16)[:, :n]
    a = torch.zeros((slots, k, r), dtype=torch.bfloat16)
    b = torch.zeros((slots, r, 104), dtype=torch.bfloat16)[:, :, :n]
    lm_mod._check_seg_bf16_layout(x, w, a, b)
    with pytest.raises(ValueError, match="unit stride"):
        lm_mod._check_seg_bf16_layout(x, w.t().contiguous().t(), a, b)
