"""The VLM (llama-3.2-vision-90b) in the port — ``transformer.vision_kv``,
``cross_attn``, ``cross_block`` and ``Model``'s VLM branches (init,
init_lora, hidden_states, prefill, prefill_ragged, init_caches,
decode_step) — against the JAX package on the CPU, float32, at two
reduced sizes: ``cfg.scaled(n_layers=6, cross_attn_every=3)`` (2 units
of 2 dense blocks and a cross block) and ``cfg.scaled()`` (1 unit of
1 + 1), 16 vision tokens, on the same weights (the JAX ``Model.init``
tree through ``convert.py``, LoRA pairs with random a and b).

The JAX cross blocks start with both gates at 0, so every cross block
is the identity at init and a wrong cross-attention would not move one
logit: both sides get the gates set to 0.5 in the numpy tree before
conversion, and one test shows the vision input then reaches the decode
logits (and does not at gate 0).

Checks: the converted tree's layout and dtypes (gates float32 from a
bf16 tree); ``vision_kv``/``cross_attn`` (prefill and the one-query
decode path, ``decode_attention``'s plain version here)/``cross_block``;
full-sequence logits; ``prefill`` logits, ``kv`` and ``cross_kv``; a
twin of ``tests/test_decode_parity.py::test_decode_matches_forward``
with ``cross_kv`` from the prefill, at 5e-5 of the largest logit; greedy
tokens after prefill and six decode steps equal to JAX's, each side's
decode caches filled from its prefill by the same slice copy;
``Engine.prefill_step`` against JAX's on full-length prompts;
``prefill_ragged`` on right-padded prompts; and the refusals the
reference has (batcher, paged caches and decode, cache-slot writes) plus
``adapter_idx`` in a VLM decode, which JAX silently drops.

Co-training (gates at 0.5): ``forward_loss`` and the LoRA gradients
(through the cross blocks' dense attention under autograd) against
``jax.grad``, ``Engine.train_step`` (two AdamW steps) and
``Engine.combined_step`` (decode over caches filled from a prefill, its
logits from the pre-update adapter) against the JAX engine's, at
``tests/test_torch_train.py``'s tolerances, the new adapters held to
the AdamW update of the port's moments (``test_torch_encoder.
adamw_gap``); and the train CLI on the scaled VLM (zero vision inputs,
as the reference's CLI)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.models import transformer as jax_tfm
from repro.models.model import build as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.convert import (
    lora_from_numpy, opt_state_from_numpy, params_from_numpy,
)
from repro_torch.core.engine import make_engine
from repro_torch.launch.serve import run_serving
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build
from repro_torch.runtime.serving_loop import ContinuousBatcher
from repro_torch.launch.train import run_training
from repro_torch.tree import tree_leaves, tree_map
from test_torch_encoder import adamw_gap

ARCH = "llama-3.2-vision-90b"
REL = 5e-5
SIZES = {"units2": dict(n_layers=6, cross_attn_every=3), "units1": {}}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["family"] = cfg.family.value
    return out


def _gated(tree, gate=0.5):
    """A numpy params tree with both cross gates of every unit at
    ``gate`` (JAX inits them to 0: each cross block the identity)."""
    cross = dict(tree["cross"])
    for k in ("gate_attn", "gate_mlp"):
        cross[k] = np.full_like(cross[k], gate)
    return {**tree, "cross": cross}


def _setup(size, gate=0.5):
    jcfg = jax_config(ARCH).scaled(**SIZES[size])
    jm = jax_build(jcfg)
    jp = _gated(jax.tree.map(np.asarray, jm.init(jax.random.key(0))), gate)
    rng = np.random.default_rng(11)
    jl = jax.tree.map(np.asarray, jm.init_lora(jax.random.key(1)))
    for pair in jl.values():                 # a live bypass: b != 0
        pair["b"] = (rng.standard_normal(pair["b"].shape) * 0.1) \
            .astype(np.float32)
    tm = build(get_config(ARCH).scaled(**SIZES[size]), device="cpu")
    return ((jm, jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jl)),
            (tm, params_from_numpy(tm.cfg, jp, "cpu"),
             lora_from_numpy(jl, "cpu")), jp)


@pytest.fixture(scope="module", params=list(SIZES))
def pair(request):
    return _setup(request.param)[:2]


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-6))


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)) \
        .astype(np.float32)
    return toks, vis


def _jb(toks, vis):
    return {"tokens": jnp.asarray(toks), "vision": jnp.asarray(vis)}


def _tb(toks, vis):
    return {"tokens": torch.from_numpy(toks).long(),
            "vision": torch.from_numpy(vis)}


def test_config_is_the_jax_config():
    assert _fields(get_config(ARCH)) == _fields(jax_config(ARCH))
    for kw in SIZES.values():
        assert _fields(get_config(ARCH).scaled(**kw)) \
            == _fields(jax_config(ARCH).scaled(**kw))


@pytest.mark.parametrize("size", list(SIZES))
def test_converted_tree_layout_and_dtypes(size):
    """The port's own init has the JAX tree's keys and shapes ([units,
    per, ...] blocks, [units, ...] cross blocks, [units, per, ...] LoRA);
    converting a bf16 JAX tree keeps the gates float32."""
    (jm, jp, jl), (tm, tp, tl), jp_np = _setup(size)
    units = tm.cfg.n_layers // tm.cfg.cross_attn_every
    per = tm.cfg.cross_attn_every - 1
    own = tm.init(torch.Generator().manual_seed(0))
    own_lora = tm.init_lora(torch.Generator().manual_seed(1))
    for jt, tt in ((jp, own), (jl, own_lora), (jp, tp)):
        shapes = jax.tree.map(lambda x: tuple(x.shape), jt)
        assert tree_map(lambda t: tuple(t.shape), tt) == shapes
    assert tp["blocks"]["ln1"].shape[:2] == (units, per)
    assert tp["cross"]["ln1"].shape[:1] == (units,)
    assert own["cross"]["gate_attn"].dtype == torch.float32
    assert not own["cross"]["gate_attn"].any()       # zero, as in JAX
    bf16 = dataclasses.replace(tm.cfg, param_dtype="bfloat16")
    conv = params_from_numpy(bf16, jp_np, "cpu")
    for k in ("gate_attn", "gate_mlp"):
        assert conv["cross"][k].dtype == torch.float32
        assert torch.equal(conv["cross"][k], torch.full((units,), 0.5))
    assert conv["cross"]["attn"]["wq"].dtype == torch.bfloat16
    assert conv["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_cross_attention_pieces_match_jax(pair):
    """Unit 0's ``vision_kv``, ``cross_attn`` at 7 queries (dense) and at
    one (the decode kernel's path) and ``cross_block``."""
    (jm, jp, _), (tm, tp, _) = pair
    cfg = tm.cfg
    jc = jax.tree.map(lambda t: t[0], jp["cross"])
    tc = tree_map(lambda t: t[0], tp["cross"])
    rng = np.random.default_rng(3)
    vis = rng.standard_normal((2, cfg.vision_tokens, cfg.d_model)) \
        .astype(np.float32)
    jkv = jax_tfm.vision_kv(jc["attn"], jnp.asarray(vis), jm.cfg)
    tkv = tfm.vision_kv(tc["attn"], torch.from_numpy(vis), cfg)
    for a, b in zip(tkv, jkv):
        assert _rel(a, b) < REL
    for s in (7, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        ja = jax_tfm.cross_attn(jc["attn"], jnp.asarray(x), jkv, jm.cfg)
        ta = tfm.cross_attn(tc["attn"], torch.from_numpy(x), tkv, cfg)
        assert _rel(ta, ja) < REL, s
        jy = jax_tfm.cross_block(jc, jnp.asarray(x), jkv, jm.cfg)
        ty = tfm.cross_block(tc, torch.from_numpy(x), tkv, cfg)
        assert _rel(ty, jy) < REL, s
        assert _rel(ty, x) > 1e-3            # the gated block moved x


def test_logits_match_jax(pair):
    (jm, jp, jl), (tm, tp, tl) = pair
    toks, vis = _batch(tm.cfg)
    jlog = jm.logits(jp, jl, _jb(toks, vis))
    tlog = tm.logits(tp, tl, _tb(toks, vis))
    assert _rel(tlog, jlog) < REL


def test_prefill_logits_and_caches_match_jax(pair):
    (jm, jp, jl), (tm, tp, tl) = pair
    toks, vis = _batch(tm.cfg, s=9, seed=1)
    jlg, jc = jm.prefill(jp, jl, _jb(toks, vis))
    tlg, tc = tm.prefill(tp, tl, _tb(toks, vis))
    assert _rel(tlg, jlg) < REL
    assert set(tc) == {"kv", "cross_kv"}
    for key in ("kv", "cross_kv"):
        for a, b in zip(tc[key], jc[key]):
            assert _rel(a, b) < REL, key


def test_engine_prefill_step_matches_jax(pair):
    """The port's ``Engine.prefill_step`` (the ragged prefill at full
    lengths) against JAX ``Engine.prefill_step`` (``Model.prefill``)."""
    (jm, jp, jl), (tm, tp, tl) = pair
    jeng = jax_make_engine(jm.cfg)
    eng = make_engine(tm.cfg, device="cpu")
    toks, vis = _batch(tm.cfg, b=3, s=8, seed=2)
    jlg, jc = jeng.prefill_step(jp, jl, _jb(toks, vis))
    tlg, tc = eng.prefill_step(tp, tl, _tb(toks, vis))
    assert _rel(tlg, jlg) < REL
    for key in ("kv", "cross_kv"):
        for a, b in zip(tc[key], jc[key]):
            assert _rel(a, b) < REL, key


def test_prefill_ragged_matches_jax(pair):
    (jm, jp, jl), (tm, tp, tl) = pair
    toks, vis = _batch(tm.cfg, b=3, s=10, seed=3)
    lens = np.array([4, 10, 7], np.int32)
    jlg, jc = jm.prefill_ragged(jp, jl, _jb(toks, vis), jnp.asarray(lens))
    tlg, tc = tm.prefill_ragged(tp, tl, _tb(toks, vis),
                                torch.from_numpy(lens))
    assert _rel(tlg, jlg) < REL
    for key in ("kv", "cross_kv"):
        for a, b in zip(tc[key], jc[key]):
            assert _rel(a, b) < REL, key


def _decode_caches(m, pre, b, s):
    """Decode caches of length ``s`` holding a prefill's K/V in their
    first rows and its vision K/V, by slice copy (the reference has no
    cache-slot writes for VLM stacks)."""
    caches = m.init_caches(b, s)
    p = pre["kv"][0].shape[3]
    for dst, src in zip(caches["kv"], pre["kv"]):
        dst[:, :, :, :p] = src
    for dst, src in zip(caches["cross_kv"], pre["cross_kv"]):
        dst.copy_(src)
    return caches


def test_decode_matches_forward(pair):
    """Incremental decode from position 0 over caches whose cross_kv is
    the prefill's reproduces the full-sequence forward."""
    _, (tm, tp, tl) = pair
    toks, vis = _batch(tm.cfg, s=20, seed=4)
    full = tm.logits(tp, tl, _tb(toks, vis))
    _, pre = tm.prefill(tp, tl, _tb(toks[:, :1], vis))
    caches = tm.init_caches(2, 20)
    for dst, src in zip(caches["cross_kv"], pre["cross_kv"]):
        dst.copy_(src)
    worst = 0.0
    for t in range(20):
        lg, caches = tm.decode_step(tp, tl, caches,
                                    torch.from_numpy(toks[:, t:t + 1]).long(),
                                    torch.tensor(t))
        worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    assert worst / (float(full.abs().max()) + 1e-6) < REL


def test_greedy_tokens_match_jax(pair):
    """Prefill a 7-token prompt, then six greedy decode steps: JAX fills
    its decode caches with ``.at[].set``, the port with slice copies."""
    (jm, jp, jl), (tm, tp, tl) = pair
    toks, vis = _batch(tm.cfg, s=7, seed=5)
    steps, b, p = 6, 2, 7
    jlg, jpre = jm.prefill(jp, jl, _jb(toks, vis))
    jc = jm.init_caches(b, p + steps)
    jc = {"kv": tuple(c.at[:, :, :, :p].set(x)
                      for c, x in zip(jc["kv"], jpre["kv"])),
          "cross_kv": jpre["cross_kv"]}
    tlg, tpre = tm.prefill(tp, tl, _tb(toks, vis))
    tc = _decode_caches(tm, tpre, b, p + steps)
    jtok = np.asarray(jnp.argmax(jlg[:, -1], -1))
    ttok = tlg[:, -1].argmax(-1).numpy()
    jseq, tseq = [jtok], [ttok]
    for s in range(steps):
        jlg, jc = jm.decode_step(jp, jl, jc, jnp.asarray(jtok[:, None]),
                                 jnp.int32(p + s))
        tlg, tc = tm.decode_step(tp, tl, tc,
                                 torch.from_numpy(ttok[:, None]).long(),
                                 torch.tensor(p + s))
        assert _rel(tlg, jlg) < REL
        jtok = np.asarray(jnp.argmax(jlg[:, -1], -1))
        ttok = tlg[:, -1].argmax(-1).numpy()
        jseq.append(jtok)
        tseq.append(ttok)
    assert np.array_equal(np.stack(tseq), np.stack(jseq))


@pytest.mark.parametrize("gate", [0.5, 0.0])
def test_vision_input_reaches_decode_logits(gate):
    """Other vision inputs give other decode logits once the gates are
    open; at the init's zero gates they cannot (the reason every parity
    check here sets them)."""
    _, (tm, tp, tl), _ = _setup("units2", gate)
    toks, vis = _batch(tm.cfg, s=5, seed=6)
    out = []
    for v in (vis, vis[::-1].copy()):
        _, pre = tm.prefill(tp, tl, _tb(toks, v))
        caches = _decode_caches(tm, pre, 2, 6)
        lg, _ = tm.decode_step(tp, tl, caches,
                               torch.from_numpy(toks[:, :1]).long(),
                               torch.tensor(5))
        out.append(lg)
    moved = float((out[0] - out[1]).abs().max())
    assert (moved > 1e-3) if gate else (moved == 0.0)


def test_vlm_refusals_match_the_reference(pair):
    """What the reference refuses on a VLM stack, the port refuses with
    ``NotImplementedError``: the batcher (and so ``run_serving``), paged
    caches and decode, the cache-slot writes; and per-row adapters in a
    VLM decode, which the reference silently drops."""
    _, (tm, tp, tl) = pair
    eng = make_engine(tm.cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="prefill/decode API"):
        ContinuousBatcher(eng, tp, tl)
    with pytest.raises(NotImplementedError, match="prefill/decode API"):
        run_serving(ARCH, smoke=True, n_requests=1, device="cpu",
                    verbose=False)
    with pytest.raises(NotImplementedError, match="VLM"):
        tm.init_paged_caches(8, 4)
    toks = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="VLM"):
        tm.decode_step_paged(tp, tl, {}, toks, torch.tensor([0, 0]),
                             torch.zeros((2, 1), dtype=torch.int32))
    caches = tm.init_caches(2, 4)
    with pytest.raises(NotImplementedError, match="VLM"):
        tm.write_prefill_slot(caches, caches, 0)
    with pytest.raises(NotImplementedError, match="VLM"):
        tm.write_prefill_slots(caches, caches, [0, 1])
    with pytest.raises(NotImplementedError, match="adapter"):
        tm.decode_step(tp, tl, caches, toks, torch.tensor(0),
                       adapter_idx=torch.zeros(2, dtype=torch.int32))
    # nothing of the refused calls touched the caches
    assert not any(t.any() for kv in caches.values() for t in kv)


# ------------------------------------------------------------ training ----
LR = 1e-3
LOSS_REL = 1e-5
GRAD_REL = 1e-4
MOMENT_TOL = {"m": dict(rtol=1e-5, atol=1e-7), "v": dict(rtol=1e-4,
                                                         atol=1e-12)}


def _train_batch(cfg, b=2, s=10, seed=30):
    toks, vis = _batch(cfg, b=b, s=s + 1, seed=seed)
    mask = np.ones((b, s), np.float32)
    mask[0, -2:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask,
            "vision": vis}


def _np_leaves(tree):
    """A port tree's leaves as numpy in JAX's (sorted-key) order."""
    return jax.tree.leaves(tree_map(lambda t: t.detach().numpy(), tree))


def test_forward_loss_and_lora_grads_match_jax(pair):
    (jm, jp, jl), (tm, tp, tl) = pair
    batch = _train_batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jg = jax.value_and_grad(
        lambda lo: jm.forward_loss(jp, lo, jb), has_aux=True)(jl)
    eng = make_engine(tm.cfg, device="cpu")
    loss, met, tg = eng.loss_and_grads(
        tp, tl, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(loss, jloss) < LOSS_REL
    assert _rel(met["ce_loss"], jmet["ce_loss"]) < LOSS_REL
    for t, j in zip(_np_leaves(tg), jax.tree.leaves(jg)):
        assert _rel(t, j) < GRAD_REL
    # the cross blocks are in the gradient's path: other vision inputs
    # give other adapter gradients
    other = dict(batch, vision=batch["vision"][::-1].copy())
    _, _, tg2 = eng.loss_and_grads(
        tp, tl, {k: torch.from_numpy(v) for k, v in other.items()})
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(tg), tree_leaves(tg2))) > 1e-6


def _check_step(new, prev, opt, jopt, step):
    for key in ("m", "v"):
        for t, j in zip(_np_leaves(getattr(opt, key)),
                        jax.tree.leaves(getattr(jopt, key))):
            np.testing.assert_allclose(t, np.asarray(j), **MOMENT_TOL[key])
    for a, b, m, v in zip(*(tree_leaves(t) for t in
                            (new, prev, opt.m, opt.v))):
        assert adamw_gap(a, b, m, v, step, lr=LR) < 1e-6
    assert int(opt.step) == int(jopt.step) == step


def test_train_step_matches_jax(pair):
    """Two AdamW steps from the same adapters; each port step starts
    from JAX's state, so a step's noise does not carry into the next."""
    (jm, jp, jl), (tm, tp, _) = pair
    jeng = jax_make_engine(jm.cfg, lr=LR)
    eng = make_engine(tm.cfg, lr=LR, device="cpu")
    jopt = jeng.optimizer.init(jl)
    for step in (1, 2):
        batch = _train_batch(tm.cfg, seed=40 + step)
        prev = lora_from_numpy(jax.tree.map(np.asarray, jl), "cpu")
        opt = eng.optimizer.init(prev) if step == 1 else \
            opt_state_from_numpy(jax.tree.map(np.asarray, jopt), "cpu")
        jl, jopt, jmet = jeng.train_step(
            jp, jl, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        new, opt, tmet = eng.train_step(
            tp, prev, opt, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
        _check_step(new, prev, opt, jopt, step)
        for k in ("loss", "ce_loss", "grad_norm"):
            assert _rel(tmet[k], jmet[k]) < 1e-4, k


def test_combined_step_matches_jax(pair):
    """A decode tick over caches filled from a 6-token prefill and a
    train step in one call: the logits are the pre-update adapter's
    (equal to a plain decode step's) and match JAX's; the new adapters
    and moments as in ``test_train_step_matches_jax``."""
    (jm, jp, jl), (tm, tp, tl) = pair
    jeng = jax_make_engine(jm.cfg, lr=LR)
    eng = make_engine(tm.cfg, lr=LR, device="cpu")
    toks, vis = _batch(tm.cfg, s=6, seed=7)
    jlg, jpre = jm.prefill(jp, jl, _jb(toks, vis))
    jc = jm.init_caches(2, 9)
    jc = {"kv": tuple(c.at[:, :, :, :6].set(x)
                      for c, x in zip(jc["kv"], jpre["kv"])),
          "cross_kv": jpre["cross_kv"]}
    tlg, tpre = tm.prefill(tp, tl, _tb(toks, vis))
    tok = np.array(jnp.argmax(jlg[:, -1], -1))[:, None]
    assert np.array_equal(tok[:, 0], tlg[:, -1].argmax(-1).numpy())
    batch = _train_batch(tm.cfg, seed=50)
    jopt = jeng.optimizer.init(jl)
    jnew, jopt, jlogits, _, jmet = jeng.combined_step(
        jp, jl, jopt, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
        jnp.asarray(tok), jnp.int32(6))
    opt = eng.optimizer.init(tl)
    snapshot = tree_map(torch.clone, tl)
    new, opt, logits, _, tmet = eng.combined_step(
        tp, tl, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
        _decode_caches(tm, tpre, 2, 9), torch.from_numpy(tok).long(),
        torch.tensor(6))
    assert _rel(logits, jlogits) < REL
    plain, _ = tm.decode_step(tp, snapshot, _decode_caches(tm, tpre, 2, 9),
                              torch.from_numpy(tok).long(), torch.tensor(6))
    assert torch.equal(logits, plain)
    for a, b in zip(tree_leaves(tl), tree_leaves(snapshot)):
        assert torch.equal(a, b)             # the served tree untouched
    _check_step(new, tl, opt, jopt, 1)
    assert _rel(tmet["ce_loss"], jmet["ce_loss"]) < 1e-4


def test_train_cli_trains_the_scaled_vlm(tmp_path):
    out = run_training(ARCH, smoke=True, steps=3, batch=2, seq=8,
                       ckpt_dir=str(tmp_path), verbose=False, device="cpu")
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    again = run_training(ARCH, smoke=True, steps=4, batch=2, seq=8,
                         ckpt_dir=str(tmp_path), restore=True,
                         verbose=False, device="cpu")
    assert again["steps"] == 4 and len(again["losses"]) == 1
