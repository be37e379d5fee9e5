"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package on the CPU, float32, inputs drawn with numpy from a seed:

* the plain version ``ssd_scan_ref`` against the Pallas kernel in
  interpret mode and the sequential oracle ``repro.kernels.ref.ssd_scan``
  at ``tests/test_kernels.py::test_ssd_scan``'s three shapes and a
  scaled mamba2 one, within that test's 1e-4 (the Pallas layout is
  head-major, so x and dt go in transposed);
* ``init_state`` against ``repro.models.mamba2.ssd_chunked`` given the
  same state, and two halves chained through the state against the
  whole (``tests/test_lora_moe_ssd.py``'s check);
* the wrapper on CPU tensors with chunks of 16, 32 and 256 against the
  oracle within 1e-4: the recurrence does not depend on the chunk;
* the dispatch contract: CPU calls count no launch, tensors off the CPU
  never take the plain version, and an input that requires grad off the
  CPU goes through ``SSDScanFn`` to the backward kernel's entry, never to
  a plain version;
* the kernel's host-side plan (chunks, the main launch's blocks in ticket
  order, scratch sizes) covers every chunk and head once;
* the backward: ``ssd_scan_bwd_ref`` and autograd through ``ssd_scan``
  against ``jax.vjp`` of ``repro.models.mamba2.ssd_chunked`` for dx,
  ddt, da, dB, dC and d(init_state), within ``BWD_REL`` of each
  gradient's largest magnitude, at shapes with S not a multiple of the
  chunk, with and without ``init_state`` and d(final_state); the same
  gradients at any chunk; finite where the reference's vjp overflows;
  the backward's host-side plan;
* the backward kernel's 3xTF32 products emulated in torch at its shapes
  and magnitudes: within a tenth of its tolerance, where one TF32
  product is not.
The CUDA kernels themselves are held against ``ssd_scan_ref`` and
``ssd_scan_bwd_ref`` on the card by ``chip_smoke.py``'s ``kernel_ssd``
phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

TOL = 1e-4


def _inputs(b, s, h, p, n, seed=3):
    """x [B,S,H,P], dt [B,S,H], a [H], B/C [B,S,N] with the distributions
    of ``tests/test_kernels.py::test_ssd_scan``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


# test_kernels.py's three (b, h, s, p, n, chunk), then mamba2-780m at its
# .scaled() size (H = 8 heads of P = 32, N = 16, chunk 32), ragged S
SHAPES = [(2, 4, 256, 32, 16, 64), (1, 2, 300, 64, 32, 128),
          (2, 3, 128, 16, 8, 32), (2, 8, 100, 32, 16, 32)]


@pytest.mark.parametrize("b,h,s,p,n,chunk", SHAPES)
def test_plain_version_matches_pallas_and_oracle(b, h, s, p, n, chunk):
    x, dt, a, bm, cm = _inputs(b, s, h, p, n)
    y, fin = ssd_scan_ref(*_t(x, dt, a, bm, cm), chunk=chunk)
    yk, fk = pallas_ssd_scan(jnp.asarray(x.transpose(0, 2, 1, 3)),
                             jnp.asarray(dt.transpose(0, 2, 1)),
                             jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm),
                             chunk=chunk, interpret=True)
    yr, fr = ref.ssd_scan(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    _close(y, np.asarray(yk).transpose(0, 2, 1, 3))
    _close(fin, fk)
    _close(y, yr)
    _close(fin, fr)


def test_init_state_matches_jax_ssd_chunked():
    x, dt, a, bm, cm = _inputs(2, 70, 3, 16, 8, seed=9)
    st = np.random.default_rng(10).standard_normal(
        (2, 3, 16, 8)).astype(np.float32)
    y, fin = ssd_scan_ref(*_t(x, dt, a, bm, cm), chunk=32,
                          init_state=torch.from_numpy(st))
    yj, fj = jax_ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                             32, init_state=jnp.asarray(st))
    _close(y, yj)
    _close(fin, fj)


def test_two_halves_chain_to_the_whole():
    x, dt, a, bm, cm = _t(*_inputs(2, 64, 2, 16, 4, seed=9))
    y_full, fin_full = ssd_scan(x, dt, a, bm, cm, chunk=16)
    half = 32
    y1, st1 = ssd_scan(x[:, :half], dt[:, :half], a, bm[:, :half],
                       cm[:, :half], chunk=16)
    y2, st2 = ssd_scan(x[:, half:], dt[:, half:], a, bm[:, half:],
                       cm[:, half:], chunk=16, init_state=st1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(st2, fin_full)


@pytest.mark.parametrize("chunk", [16, 32, 256])
def test_wrapper_on_cpu_matches_oracle_at_any_chunk(chunk):
    x, dt, a, bm, cm = _inputs(1, 100, 4, 32, 16, seed=5)
    before = ssd_scan.launches
    y, fin = ssd_scan(*_t(x, dt, a, bm, cm), chunk=chunk)
    assert ssd_scan.launches == before
    yr, fr = ref.ssd_scan(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    _close(y, yr)
    _close(fin, fr)


@pytest.mark.parametrize("where", ["all", "bmat_only"])
def test_non_cpu_tensors_never_take_plain_version(where, monkeypatch):
    """Tensors off the CPU go to the kernel path, whose checks raise for
    a device it has no kernel for (meta) or for mixed devices."""
    def fail(*_a, **_k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(ssd_mod, "ssd_scan_ref", fail)
    args = _t(*_inputs(1, 8, 2, 16, 4))
    if where == "all":
        args = [t.to("meta") for t in args]
    else:
        args[3] = args[3].to("meta")
    before = ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_scan(*args)
    assert ssd_scan.launches == before


class _ReachedBackwardKernel(Exception):
    pass


def test_input_that_requires_grad_reaches_the_backward_kernel_off_the_cpu(
        monkeypatch):
    """Off the CPU an input that requires grad goes through ``SSDScanFn``:
    the forward kernel's launcher (stubbed here to hand back meta
    outputs: there is no card) and, in the backward, the backward
    kernel's launcher, with dy and the inputs; neither plain version is
    ever called."""
    def fail(*_a, **_k):
        raise AssertionError("plain version reached")

    def fwd(x, dt, a, bmat, cmat, init_state):
        b, s, h, p = x.shape
        return (torch.empty_like(x),
                torch.empty((b, h, p, bmat.shape[-1]), device=x.device))

    seen = {}

    def bwd(x, dt, a, bmat, cmat, dy, dfinal, init_state):
        seen.update(x=x, dy=dy, dfinal=dfinal, init_state=init_state)
        raise _ReachedBackwardKernel

    monkeypatch.setattr(ssd_mod, "ssd_scan_ref", fail)
    monkeypatch.setattr(ssd_mod, "ssd_scan_bwd_ref", fail)
    monkeypatch.setattr(ssd_mod, "_launch", fwd)
    monkeypatch.setattr(ssd_mod, "_launch_bwd", bwd)
    x, dt, a, bm, cm = (t.to("meta") for t in _t(*_inputs(1, 8, 2, 16, 4)))
    y, fin = ssd_scan(x.requires_grad_(), dt, a, bm, cm)
    assert y.requires_grad and y.grad_fn is not None
    with pytest.raises(_ReachedBackwardKernel):
        y.sum().backward()
    assert seen["x"].device.type == "meta"
    assert tuple(seen["dy"].shape) == tuple(x.shape)
    assert seen["dfinal"] is None and seen["init_state"] is None
    # the backward entry itself refuses a device it has no kernel for
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd_mod.ssd_scan_bwd(x.detach(), dt, a, bm, cm, torch.empty_like(x))


def _mixer_inputs(b, s, h, p, n, seed=7):
    """x and B/C as ``_inputs``; dt and a as ``mamba2.init_ssm`` and the
    mixer make them: dt = softplus(normal + dt_bias) with dt_bias =
    log(expm1(0.01)), a = -exp(A_log) = -linspace(1, 16, H)."""
    x, _, _, bm, cm = _inputs(b, s, h, p, n, seed)
    rng = np.random.default_rng(seed + 1)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))
                         + np.log(np.expm1(0.01)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    return x, dt, a, bm, cm


def test_carry_between_64_row_chunks_shows_at_mixer_inputs():
    """mamba2-780m's heads (H = 48, P = 64, N = 128) with dt and a as the
    mixer makes them, the inputs ``chip_smoke.py``'s ``mixer_*`` shapes
    hold the kernel at: the plain version at the kernel's own chunk (64)
    matches chunk 256 and the oracle within 1e-4, and scanning each
    64-row chunk from a zero state (a kernel that dropped the carried
    state) moves y and the final state by more than 1e-2 of their
    largest values, so the card's 1e-4 check sees a lost carry."""
    arrs = _mixer_inputs(1, 512, 48, 64, 128)
    x, dt, a, bm, cm = _t(*arrs)
    y, fin = ssd_scan_ref(x, dt, a, bm, cm, chunk=64)
    y256, fin256 = ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
    _close(y, y256)
    _close(fin, fin256)
    yr, fr = ref.ssd_scan(*(jnp.asarray(t) for t in arrs))
    _close(y, yr)
    _close(fin, fr)
    parts = [ssd_scan_ref(x[:, lo:lo + 64], dt[:, lo:lo + 64], a,
                          bm[:, lo:lo + 64], cm[:, lo:lo + 64], chunk=64)
             for lo in range(0, 512, 64)]
    y_cut = torch.cat([yp for yp, _ in parts], 1)
    assert float((y_cut - y).abs().max() / y.abs().max()) > 1e-2
    assert float((parts[-1][1] - fin).abs().max() / fin.abs().max()) > 1e-2


def _block_work(ticket, b, h):
    """(batch, chunk, head) of the main launch's block that takes
    ``ticket``: mirrors the ticket decode of ``csrc/ssd_scan.cu``
    (``ssd_scan_kernel``, lines 294-295), which only the card runs."""
    c, r = divmod(ticket, b * h)
    return r // h, c, r % h


@pytest.mark.parametrize("b,s,h,n", [(1, 32, 48, 128), (1, 1000, 48, 128),
                                     (1, 2048, 48, 128), (2, 512, 48, 128),
                                     (1, 2048, 50, 16), (2, 100, 8, 16),
                                     (3, 65, 5, 64), (1, 4096, 48, 65)])
def test_kernel_plan_covers_every_chunk_and_head_once(b, s, h, n):
    """The kernel's host-side plan: 64-row chunks that cover S, one main
    block per (batch, chunk, head), each taken once by its ticket in
    chunk-major order (so the block a waiter waits on, the same head's
    previous chunk, has an earlier ticket), state columns padded to 64 or
    128, and scratch for C B^T and C^T per chunk plus two state slots and
    a progress counter per warp per (batch, head), and the ticket."""
    nc, blocks, npad = ssd_mod.kernel_plan(b, s, h, n)
    assert ssd_mod.CHUNK == 64 and (nc - 1) * 64 < s <= nc * 64
    assert blocks == b * nc * h and npad in (64, 128) and n <= npad
    assert npad == 64 or n > 64
    seen = {}
    for ticket in range(blocks):
        bi, c, hi = _block_work(ticket, b, h)
        assert 0 <= bi < b and 0 <= c < nc and 0 <= hi < h
        assert (bi, c, hi) not in seen
        seen[(bi, c, hi)] = ticket
        if c:
            assert seen[(bi, c - 1, hi)] < ticket
    assert len(seen) == b * nc * h
    floats, counters = ssd_mod.scratch_sizes(b, s, h, n)
    assert floats == b * nc * 64 * (64 + npad) + b * h * 2 * npad * 64
    assert counters == 1 + b * h * ssd_mod.HANDOFF_WARPS
    assert ssd_mod.LAUNCHES == 2


# ---------------------------------------------------------- backward ----
BWD_REL = 2e-5
GRADS = ("dx", "ddt", "da", "dB", "dC", "dinit")


def _bwd_inputs(b, s, h, p, n, seed=11):
    """The mixer's distributions (``_mixer_inputs``: dt ~ 0.01-0.1, a =
    -linspace(1, 16, H)), so every chunk's decay stays where the
    reference's vjp is finite, plus an entering state, dy and
    d(final_state)."""
    x, dt, a, bm, cm = _mixer_inputs(b, s, h, p, n, seed)
    rng = np.random.default_rng(seed + 2)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, st, dy, dfin


def _jax_vjp(x, dt, a, bm, cm, st, dy, dfin, chunk, jit=True):
    """``jax.vjp`` of ``ssd_chunked``, jitted (one compile a shape, where
    the op-by-op run takes ~10x as long); ``jit=False`` runs it op by op."""
    args = [jnp.asarray(t) for t in (x, dt, a, bm, cm)]
    if st is not None:
        args.append(jnp.asarray(st))

    def grads(args, cot):
        _, vjp = jax.vjp(lambda *t: jax_ssd_chunked(
            *t[:5], chunk, init_state=t[5] if len(t) > 5 else None), *args)
        return vjp(cot)

    grads = jax.jit(grads) if jit else grads
    return [np.asarray(g) for g in grads(tuple(args), (jnp.asarray(dy),
                                                       jnp.asarray(dfin)))]


def _close_rel(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(want).all(), name
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
    assert err < BWD_REL, f"{name}: {err}"


# (b, s, h, p, n, chunk, init_state): S a multiple of the chunk with and
# without a state, ragged S (one and several chunks, with and without), a
# single position, mamba2's head dim with hymba's state
BWD_CASES = [(2, 64, 3, 16, 8, 32, False), (2, 64, 3, 16, 8, 32, True),
             (2, 70, 4, 32, 16, 32, True), (1, 100, 2, 16, 4, 64, False),
             (1, 1, 2, 16, 8, 32, True), (1, 40, 2, 64, 16, 16, False)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", BWD_CASES)
def test_backward_matches_jax_vjp(b, s, h, p, n, chunk, init):
    x, dt, a, bm, cm, st, dy, dfin = _bwd_inputs(b, s, h, p, n)
    st = st if init else None
    want = _jax_vjp(x, dt, a, bm, cm, st, dy, dfin, chunk)
    got = ssd_mod.ssd_scan_bwd_ref(
        *_t(x, dt, a, bm, cm, dy, dfin), chunk=chunk,
        init_state=torch.from_numpy(st) if init else None)
    assert (got[5] is None) == (not init)
    for name, g, w in zip(GRADS, got, want):
        _close_rel(name, g, w)
    # autograd through the wrapper: the same gradients, no launch
    ins = [t.requires_grad_() for t in _t(x, dt, a, bm, cm)]
    st_t = torch.from_numpy(st).requires_grad_() if init else None
    before = (ssd_scan.launches, ssd_mod.ssd_scan_bwd.launches)
    y, fin = ssd_scan(*ins, chunk=chunk, init_state=st_t)
    ((y * torch.from_numpy(dy)).sum()
     + (fin * torch.from_numpy(dfin)).sum()).backward()
    assert (ssd_scan.launches, ssd_mod.ssd_scan_bwd.launches) == before
    for name, t, w in zip(GRADS, ins + ([st_t] if init else []), want):
        _close_rel(name, t.grad, w)


def test_backward_without_final_state_gradient():
    """Only y reaches the loss: d(final_state) is None, as autograd hands
    it over (``set_materialize_grads(False)``), and counts as zeros."""
    x, dt, a, bm, cm, st, dy, _ = _bwd_inputs(2, 50, 3, 16, 8, seed=4)
    zero = np.zeros((2, 3, 16, 8), np.float32)
    want = _jax_vjp(x, dt, a, bm, cm, st, dy, zero, 32)
    ins = [t.requires_grad_() for t in _t(x, dt, a, bm, cm, st)]
    y, _ = ssd_scan(*ins[:5], chunk=32, init_state=ins[5])
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, w in zip(GRADS, ins, want):
        _close_rel(name, t.grad, w)


def test_backward_is_the_same_at_any_chunk():
    """The gradients do not depend on the chunk: 64 (the kernel's own)
    against 16 and 256, within ``BWD_REL``."""
    arrs = _bwd_inputs(1, 150, 4, 32, 16, seed=8)
    x, dt, a, bm, cm, st, dy, dfin = _t(*arrs)
    runs = [ssd_mod.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dfin, chunk=c,
                                     init_state=st) for c in (64, 16, 256)]
    for other in runs[1:]:
        for name, g, w in zip(GRADS, other, runs[0]):
            _close_rel(name, g, w)


def test_backward_stays_finite_where_the_reference_vjp_overflows():
    """A chunk whose decay exceeds 88 (dt = 90 at a = -1 on the second
    of two positions): the reference's vjp differentiates exp over the
    masked upper triangle, exp(90) overflows float32 and ddt and da come
    out NaN (ROADMAP section 3); the plain backward never forms exp of a
    positive difference, and its gradients are finite."""
    x = np.ones((1, 2, 1, 16), np.float32)
    dt = np.array([[[1.0], [90.0]]], np.float32)
    a = np.array([-1.0], np.float32)
    bm = cm = np.full((1, 2, 4), 0.5, np.float32)
    dy = np.ones((1, 2, 1, 16), np.float32)
    dfin = np.ones((1, 1, 16, 4), np.float32)
    want = _jax_vjp(x, dt, a, bm, cm, None, dy, dfin, 2, jit=False)
    assert np.isnan(want[1]).any() and np.isnan(want[2]).any()
    got = ssd_mod.ssd_scan_bwd_ref(*_t(x, dt, a, bm, cm, dy, dfin), chunk=2)
    assert all(torch.isfinite(g).all() for g in got[:5])
    # the gradients JAX does give agree
    for name, g, w in zip(GRADS, got, want):
        if np.isfinite(w).all():
            _close_rel(name, g, w)


# (b, s, h, n, SMs, init, groups, heads a group): mamba2 and hymba at 4 x
# 2,048 (two groups of about half the heads) and at 4 x 32 (one chunk: a
# head a group, every SM busy), ragged, a small card, and one chunk with
# an initial state (its gradient needs the chain launch)
@pytest.mark.parametrize("b,s,h,n,sms,init,groups,per", [
    (4, 2048, 48, 128, 132, False, 2, 24),
    (4, 32, 48, 128, 132, False, 48, 1),
    (1, 2048, 50, 16, 132, False, 5, 10),
    (4, 32, 50, 16, 132, False, 50, 1),
    (2, 100, 3, 8, 132, False, 3, 1),
    (1, 64, 7, 64, 4, False, 4, 2),
    (2, 40, 5, 16, 132, True, 5, 1)])
def test_backward_plan_covers_every_head_once(b, s, h, n, sms, init, groups,
                                              per):
    """The backward's host-side plan: 64-row chunks, head groups that
    cover every head once (the last group may be short, none empty), at
    least ``sms`` main blocks unless every group is one head, state
    columns padded to 16, 32, 64 or 128, the workspace of its launches,
    and the launches: the chain of states past a single chunk or with an
    initial state, main, and the reduce (da, and dB and dC over the head
    groups when there are several)."""
    plan = ssd_mod.bwd_plan(b, s, h, 64, n, init, sms)
    nc = plan.chunks
    assert (nc - 1) * 64 < s <= nc * 64
    assert (plan.groups, plan.per) == (groups, per)
    assert plan.groups * plan.per >= h and (plan.groups - 1) * plan.per < h
    assert b * nc * plan.groups >= sms or plan.per == 1
    heads = [hh for g in range(plan.groups)
             for hh in range(g * plan.per, min(h, (g + 1) * plan.per))]
    assert heads == list(range(h))
    npad = ssd_mod.bwd_state_cols(n)
    assert npad in (16, 32, 64, 128) and n <= npad and (
        npad == 16 or n > npad // 2)
    states = 2 * b * nc * h * 64 * npad if nc > 1 else 0
    parts = b * nc * plan.groups * 2 * 64 * npad if plan.groups > 1 else 0
    assert plan.floats == states + b * nc * h + parts
    assert ssd_mod.LAUNCHES_BWD == ("chain", "main", "reduce")
    assert plan.launches == (("chain",) if nc > 1 or init else ()) \
        + ("main", "reduce")


# ------------------------------------------------------ 3xTF32 products ---
def _tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does it: the 13 low
    mantissa bits cleared, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The backward kernel's products (``csrc/hopper.cuh::split_tf32``):
    each operand split into its TF32 rounding and the TF32 rounding of the
    rest, lo*hi + hi*lo + hi*hi summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chunk_products(seed=0, q=64, p=64, n=128):
    """One 64-row chunk of one head with the mixer's inputs (dt =
    softplus(z + dt_bias), a = -16, the fastest decay, B and C at 0.3):
    the operand pairs of the backward's products, as float32."""
    rng = np.random.default_rng(seed)
    x, dy = (torch.from_numpy(rng.standard_normal((q, p)).astype(np.float32))
             for _ in range(2))
    bm, cm = (torch.from_numpy((rng.standard_normal((q, n)) * 0.3)
                               .astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal(q).astype(np.float32))
    dt = torch.nn.functional.softplus(z + np.log(np.expm1(0.01)))
    cum = torch.cumsum(dt * -16.0, 0)
    w, ecum = torch.exp(cum[-1] - cum) * dt, torch.exp(cum)
    lmat = torch.tril(torch.exp(cum[:, None] - cum[None, :]))
    scores = (cm @ bm.T) * lmat * dt[None, :]
    return {"own": ((x * w[:, None]).T, bm),           # x^T (w o B)
            "rev": ((dy * ecum[:, None]).T, cm),       # dy^T (e o C)
            "bg": (bm, g.T), "dye": (dy, g),           # B G^T, dy E
            "sdy": (scores.T, dy)}                     # scores^T dy


@pytest.mark.parametrize("product", ["own", "rev", "bg", "dye", "sdy"])
def test_3xtf32_products_keep_the_backward_tolerance(product):
    """The backward kernel runs its float32 products on the tensor cores
    as 3xTF32: emulated here on the CPU at the backward's shapes and
    magnitudes, every product is within 1e-5 of float64 (relative to its
    largest output), a tenth of ``chip_smoke.py``'s SSD_BWD_TOL of 1e-4,
    where one TF32 product (10 mantissa bits) is beyond that tolerance."""
    assert float(_tf32(torch.tensor([1 + 2 ** -11]))) == 1 + 2 ** -10
    assert float(_tf32(torch.tensor([-(1 + 2 ** -12)]))) == -1.0
    a, b = _chunk_products()[product]
    ref = a.double() @ b.double()
    scale = ref.abs().max()

    def err(out):
        return float((out.double() - ref).abs().max() / scale)
    assert err(_mm_3xtf32(a, b)) < 1e-5
    assert err(_tf32(a) @ _tf32(b)) > 1e-4
