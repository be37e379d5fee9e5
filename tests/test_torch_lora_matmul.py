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
