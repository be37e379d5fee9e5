"""The hybrid hymba-1.5b in the port — ``configs/hymba_1_5b.py``, the
hybrid block of ``models/transformer.py`` (attention and a Mamba2 mixer
over the same ``norm1(x)``, averaged), ``Model``'s K/V ring beside the
SSM caches and the batcher's exact-length path — against the JAX
package on the CPU, float32, at ``get_config("hymba-1.5b").scaled()`` (2
layers, d_model 128, 4 / 1 heads of 32, window 32, 8 SSM heads of 32,
state 16, SSD chunk 32) on the same weights (the JAX ``Model.init``
tree through ``convert.py``, LoRA pairs on q/k/v/o and
``ssm_in``/``ssm_out`` with random a and b):

* the config is the JAX one;
* full-sequence logits against JAX ``Model.logits`` within 5e-5
  relative (``tests/test_decode_parity.py``'s bound); prefill into pool
  slots then decode steps against the JAX sequence (logits, the K/V ring
  and the SSM caches);
* a twin of ``tests/test_decode_parity.py::test_sliding_window_ring_buffer``
  (window 8, 20 tokens): decode through the ring against the forward and
  against JAX's forward, within 5e-5 of the largest logit;
* the port's ``ContinuousBatcher`` against the JAX batcher: the same
  greedy tokens with more requests than slots, ring wraps included;
* ``run_serving`` (serve-only and ``combined=True``) and
  ``run_training`` on the CPU;
* the reference's refusals: paged, adapters, chunked prefill,
  oversubscription (and the prefix cache, which needs paged), the static
  baseline, the attention-only model methods;
* ``convert.py`` keeps the hybrid's ``A_log``, ``D_skip`` and ``dt_bias``
  float32 from a bf16 JAX tree, and ``in_proj`` of a width that is no
  multiple of 8 (hymba's own, 6,482, scaled here to 357) lands in padded
  storage whose row stride is, holding the same values, as ``Model.init``
  keeps it; a LoRA projection over such storage (forward, and its
  gradients) equals the unpadded one, and the bf16 wrapper copies an
  operand of such a width (B, and dY in the dX call) into padded storage
  of its own layout.
Prefill runs ``ssd_scan``'s plain version here; the card runs the kernels
(``chip_smoke.py``)."""
import dataclasses
import sys

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
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.kernels import lora_matmul as lm_mod
from repro_torch.kernels.lora_matmul import pad_columns
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import run_training
from repro_torch.models import lora as lora_lib
from repro_torch.models import mamba2
from repro_torch.models.model import build
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest, static_batch_serve,
)
from test_torch_model import numpy_lora

ARCH = "hymba-1.5b"
REL = 5e-5


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["family"] = cfg.family.value
    return out


def _pair(**kw):
    """(jax model, params, lora), (port model, params, lora) holding the
    same float32 weights, at ``.scaled(**kw)``."""
    jcfg = jax_config(ARCH).scaled(**kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    tm = build(get_config(ARCH).scaled(**kw), device="cpu")
    tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")
    return ((jm, jp, jax.tree.map(jnp.asarray, lora_np)),
            (tm, tp, lora_from_numpy(lora_np, "cpu")))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-6))


def _tokens(cfg, b=2, s=20, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close_caches(tc, jc):
    """A hybrid's caches: the K/V ring and the SSM conv tail and state."""
    for t, j in zip(tc["kv"], jc["kv"]):
        assert _rel(t, j) < REL
    for k in ("conv", "state"):
        assert _rel(tc["ssm"][k], jc["ssm"][k]) < REL, k


def test_config_is_the_jax_config():
    assert ARCH in ARCH_IDS
    assert _fields(get_config(ARCH)) == _fields(jax_config(ARCH))
    assert _fields(get_config(ARCH).scaled()) \
        == _fields(jax_config(ARCH).scaled())
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.sliding_window, cfg.ssm_n_heads,
            cfg.ssm_state) == (32, 1600, 25, 5, 64, 2048, 50, 16)
    assert lora_lib.target_dims(cfg)["ssm_in"] == (1600, 6482)


def test_logits_match_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = _tokens(tm.cfg, s=45)           # past the window of 32
    jl = jm.logits(jp, jlora, {"tokens": jnp.asarray(toks)})
    tl = tm.logits(tp, tlora, {"tokens": torch.from_numpy(toks).long()})
    assert _rel(tl, jl) < REL


def test_prefill_slot_decode_match_jax(pair):
    """Two requests of different lengths prefilled one at a time into
    slots 2 and 0 of a 3-slot pool (slot 1 idle), then six decode steps
    of the whole pool, as the batcher runs them; the ring holds 16 rows,
    so the longer request wraps."""
    (jm, jp, jlora), (tm, tp, tlora) = pair
    prompts = [_tokens(tm.cfg, 1, 12, seed=2), _tokens(tm.cfg, 1, 3, seed=3)]
    slots = [2, 0]
    jpool, tpool = jm.init_caches(3, 16), tm.init_caches(3, 16)
    assert tpool["kv"][0].shape == (2, 3, 16, 1, 32)
    feed = np.zeros((3, 1), np.int32)
    for prompt, slot in zip(prompts, slots):
        jlg, jpre = jm.prefill(jp, jlora, {"tokens": jnp.asarray(prompt)})
        tlg, tpre = tm.prefill(tp, tlora,
                               {"tokens": torch.from_numpy(prompt).long()})
        assert _rel(tlg, jlg) < REL
        _close_caches(tpre, jpre)
        jpool = jm.write_prefill_slot(jpool, jpre, slot)
        tpool = tm.write_prefill_slot(tpool, tpre, slot)
        feed[slot, 0] = int(jnp.argmax(jlg[0, -1]))
    _close_caches(tpool, jpool)
    pos = np.array([3, 0, 12], np.int32)
    for _ in range(6):
        jlg, jpool = jm.decode_step(jp, jlora, jpool, jnp.asarray(feed),
                                    jnp.asarray(pos))
        tlg, tpool = tm.decode_step(tp, tlora, tpool,
                                    torch.from_numpy(feed).long(),
                                    torch.from_numpy(pos))
        assert _rel(tlg, jlg) < REL
        _close_caches(tpool, jpool)
        feed = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
        pos = pos + 1


def test_sliding_window_ring_buffer():
    """Twin of the reference's ring test: window 8, 20 tokens decoded
    one at a time through the 8-row ring agree with the full forward
    (its windowed attention) and with JAX's forward."""
    (jm, jp, jlora), (tm, tp, tlora) = _pair(sliding_window=8)
    toks = _tokens(tm.cfg, 1, 20, seed=4)
    full = tm.logits(tp, tlora, {"tokens": torch.from_numpy(toks).long()})
    jfull = jm.logits(jp, jlora, {"tokens": jnp.asarray(toks)})
    assert _rel(full, jfull) < REL
    caches = tm.init_caches(1, 20)
    assert caches["kv"][0].shape[2] == 8
    worst = 0.0
    for t in range(20):
        lg, caches = tm.decode_step(tp, tlora, caches,
                                    torch.from_numpy(toks[:, t:t + 1]).long(),
                                    torch.tensor(t))
        worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    assert worst / (float(full.abs().max()) + 1e-6) < REL


LENS = [6, 8, 4, 7, 5]
GENS = [5, 9, 6, 3, 8]


def test_batcher_matches_jax_batcher():
    """Five requests of mixed lengths on two slots (admitted mid-flight)
    over an 8-token window: requests whose prompt and generation pass 8
    tokens wrap their ring; the port's batcher emits the JAX batcher's
    greedy tokens."""
    kw = dict(sliding_window=8)
    jcfg = jax_config(ARCH).scaled(**kw)
    jeng = jax_make_engine(jcfg)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jax.tree.map(lambda x: x + 0.01,
                         jeng.model.init_lora(jax.random.key(1)))
    eng = make_engine(get_config(ARCH).scaled(**kw), device="cpu")
    params = params_from_numpy(eng.model.cfg, jax.tree.map(np.asarray, jp),
                               "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS), LENS)
    bkw = dict(n_slots=2, max_seq=24, prompt_pad=8)
    jb = JaxBatcher(jeng, jp, jlora, **bkw)
    jreqs = [JaxRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    jb.run(jreqs)
    tb = ContinuousBatcher(eng, params, lora, **bkw)
    assert tb.ring_len == 8
    treqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    stats = tb.run(treqs)
    assert [r.tokens for r in treqs] == [list(r.tokens) for r in jreqs]
    assert stats.finished == len(LENS)
    assert tb.prefill_waves > 1                     # mid-flight admission
    assert any(n + g - 1 > 8 for n, g in zip(LENS, GENS))   # ring wraps
    assert tb.cache_bytes() == sum(
        t.numel() * t.element_size()
        for t in list(tb.caches["kv"]) + list(tb.caches["ssm"].values()))


@pytest.mark.parametrize("combined", [False, True])
def test_run_serving_on_cpu(combined):
    out = run_serving(ARCH, smoke=True, n_requests=6, prompt_len=12,
                      gen_tokens=5, batch_size=4, device="cpu",
                      combined=combined, verbose=False)
    assert out["finished"] == 6
    assert all(len(t) == 5 for t in out["tokens"])
    if combined:
        losses = out["train_losses"]
        assert len(losses) > 0 and np.isfinite(losses).all()


def test_run_training_on_cpu(tmp_path):
    out = run_training(ARCH, smoke=True, steps=3, batch=2, seq=16,
                       ckpt_dir=str(tmp_path), verbose=False, device="cpu")
    assert out["steps"] == 3
    assert all(np.isfinite(out["losses"]))


def test_refusals_as_in_jax(pair, monkeypatch):
    cfg = get_config(ARCH).scaled()
    eng = make_engine(cfg, device="cpu")
    params = eng.model.init(torch.Generator().manual_seed(0))
    lora = eng.model.init_lora(torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="attention-only"):
        ContinuousBatcher(eng, params, lora, paged=True)
    with pytest.raises(NotImplementedError, match="exact-length"):
        ContinuousBatcher(eng, params, lora,
                          adapters=AdapterRegistry(eng.model, capacity=2))
    with pytest.raises(NotImplementedError, match="attention-only"):
        ContinuousBatcher(eng, params, lora, prefill_chunk=8)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(eng, params, lora, prefix_cache=True)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(eng, params, lora, oversubscribe=1.0)
    with pytest.raises(ValueError, match="window"):
        ContinuousBatcher(eng, params, lora, prompt_pad=64, max_seq=128)
    with pytest.raises(NotImplementedError, match="attention-only"):
        static_batch_serve(eng, params, lora, [])
    for flag in (["--paged"], ["--adapters", "2"]):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH,
                                          "--smoke", "--device", "cpu",
                                          "--requests", "1"] + flag)
        with pytest.raises(NotImplementedError):
            serve_mod.main()
    _, (tm, tp, tlora) = pair
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 6)).long()
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.prefill_ragged(tp, tlora, {"tokens": toks}, torch.tensor([6, 4]))
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.init_paged_caches(8, 4)
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.prefill_ragged_continue(tp, tlora, {"tokens": toks}, [6, 4],
                                   [0, 0], tm.init_caches(2, 8), [0, 1])


# scaled widths whose in_proj is no multiple of 8, as hymba's 6,482:
# d_inner 160, 5 SSM heads of 32, state 16 -> 2 * 160 + 32 + 5 = 357
ODD = dict(d_model=80, n_heads=4)


def test_convert_keeps_float32_leaves_and_pads_in_proj():
    kw = dict(ODD, dtype="bfloat16", param_dtype="bfloat16")
    jm = jax_build(jax_config(ARCH).scaled(**kw))
    jp = jm.init(jax.random.key(0))
    tcfg = get_config(ARCH).scaled(**kw)
    assert lora_lib.target_dims(tcfg)["ssm_in"] == (80, 357)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    own = build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    for tree in (tp, own):
        for k, leaf in tree["blocks"]["ssm"].items():
            want = torch.float32 if k in mamba2.FLOAT32_LEAVES \
                else torch.bfloat16
            assert leaf.dtype == want, k
            assert tuple(leaf.shape) == jp["blocks"]["ssm"][k].shape, k
        w = tree["blocks"]["ssm"]["in_proj"]
        assert w.stride() == (80 * 360, 360, 1)         # padded rows
        assert tuple(tree["blocks"]["attn"]["wq"].shape) \
            == jp["blocks"]["attn"]["wq"].shape
    np.testing.assert_array_equal(
        tp["blocks"]["ssm"]["in_proj"].float().numpy(),
        np.asarray(jp["blocks"]["ssm"]["in_proj"]).astype(np.float32))
    for k in mamba2.FLOAT32_LEAVES:
        np.testing.assert_array_equal(
            tp["blocks"]["ssm"][k].numpy(), np.asarray(jp["blocks"]["ssm"][k]))


def test_padded_projection_equals_the_unpadded_one(monkeypatch):
    """``lora.project`` over padded W (N = 357) gives the unpadded
    product, and its gradients in x, A and B equal autograd of the plain
    version; the bf16 wrapper hands the kernels each operand of those
    calls (B and dY of width 357 compact, W^T and B^T column-major) in a
    layout they take, holding the same values, where the operands as
    given are refused; the logits of the odd-width config match JAX."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 80)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((80, 357)).astype(np.float32))
    pair_ = {"a": torch.from_numpy(rng.standard_normal((80, 4))
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((4, 357))
                                   .astype(np.float32))}
    wp = pad_columns(w)
    assert wp.stride() == (360, 1) and torch.equal(wp, w)
    assert pad_columns(wp) is wp and pad_columns(x) is x
    seen = []
    real = lm_mod.lora_matmul

    def spy(xx, ww, aa, bb, s):
        seen.append((xx, ww, aa, bb))
        return real(xx, ww, aa, bb, s)

    monkeypatch.setattr(lm_mod, "lora_matmul", spy)
    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in pair_.items()}
    y = lora_lib.project(xs, wp, ps, 2.0)
    y.square().sum().backward()
    monkeypatch.undo()
    xr = x.clone().requires_grad_()
    pr = {k: v.clone().requires_grad_() for k, v in pair_.items()}
    yr = lora_lib.apply(xr, xr @ w, pr, 2.0)
    yr.square().sum().backward()
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-5, atol=1e-4)
    for k in ("a", "b"):
        torch.testing.assert_close(ps[k].grad, pr[k].grad, rtol=1e-5,
                                   atol=1e-4)
    # the forward reads padded W and compact B; the dX call (dY, W^T,
    # B^T, A^T) a compact dY and the transposed views of W and B
    assert [[t.stride() for t in call] for call in seen] \
        == [[(80, 1), (360, 1), (4, 1), (357, 1)],
            [(357, 1), (1, 360), (1, 357), (1, 4)]]
    for call in seen:
        # the same operands in bf16, layouts kept (the padded W's too)
        bf = [torch.empty_strided(t.shape, t.stride(), dtype=torch.bfloat16)
              .copy_(t.detach()) for t in call]
        assert [t.stride() for t in bf] == [t.stride() for t in call]
        if any(t.stride(0) == 357 or t.stride(1) == 357 for t in bf):
            with pytest.raises(ValueError, match="multiples of 8"):
                lm_mod._check_bf16_layout(*bf)
        got = [lm_mod._aligned(t) for t in bf]
        lm_mod._check_bf16_layout(*got)
        for g, t in zip(got, bf):
            assert torch.equal(g, t)
        # W (W^T) comes padded: the wrapper takes it as it is
        assert got[1].data_ptr() == bf[1].data_ptr()
    (jm, jp, jlora), (tm, tp, tlora) = _pair(**ODD)
    toks = _tokens(tm.cfg, s=12)
    jl = jm.logits(jp, jlora, {"tokens": jnp.asarray(toks)})
    tl = tm.logits(tp, tlora, {"tokens": torch.from_numpy(toks).long()})
    assert _rel(tl, jl) < REL
