"""The port's training path against the JAX engine on the same weights
(the JAX ``Model.init`` tree and a numpy LoRA tree with nonzero ``b``,
loaded through ``repro_torch.convert``), float32 on the CPU, where every
LoRA projection runs the fused kernel's plain version and its gradient:

* ``chunked_ce_loss`` (with a remainder chunk) and ``forward_loss``:
  values and gradients within 1e-5 relative;
* the LoRA gradients of ``Engine.loss_and_grads`` against ``jax.grad``
  of the JAX ``forward_loss``: within 1e-4 of each leaf's largest
  magnitude (float32 sums over every position, in another order);
* ``train_step`` after 3 AdamW steps (plain, ``grad_accum``,
  ``train_tokens``) against ``repro.core.engine.Engine.train_step``:
  LoRA and moments within 1e-5 relative + 1e-7 absolute (lr 1e-3, so
  the update itself is ~1e-3), metrics within 1e-4 relative;
* ``combined_step`` and ``combined_step_paged`` against the JAX ones:
  decode logits from the pre-update adapter within 5e-5 of their largest
  magnitude (``tests/test_decode_parity.py``'s bound), the new LoRA as
  above;
* torch twins of ``tests/test_engine_combined.py`` for both combined
  steps (combined == separate steps, the loss falls on a fixed batch,
  ``grad_accum`` equivalence) and the ``serve_lora`` shadow split;
* SSM co-training: on mamba2-780m and hymba-1.5b at ``.scaled()`` (the
  gradient through ``ssd_scan``'s plain backward), the LoRA gradients
  against ``jax.grad``, two ``train_step``s and a ``combined_step``
  against the JAX engine's (loss, new adapters and moments, decode
  logits) at the tolerances above."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.models.model import chunked_ce_loss as jax_chunked_ce
from repro_torch.configs.registry import get_config
from repro_torch.convert import (
    lora_from_numpy, opt_state_from_numpy, params_from_numpy,
)
from repro_torch.core.engine import make_engine
from repro_torch.models.model import chunked_ce_loss
from repro_torch.tree import tree_leaves, tree_map
from test_torch_model import numpy_lora

LR = 1e-3
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LORA_TOL = dict(rtol=1e-5, atol=1e-7)
LOGIT_REL = 5e-5
B, S, CHUNK = 4, 24, 16          # CE chunks of 16: one full, one remainder


def numpy_batch(cfg, b=B, s=S, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, -5:] = 0.0                  # masked positions count nothing
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tnp(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


def _close_trees(t_tree, j_tree, **tol):
    tl = jax.tree.leaves(_tnp(t_tree))
    jl = jax.tree.leaves(_np(j_tree))
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t, j, **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen1.5-0.5b").scaled()
    cfg = get_config("qwen1.5-0.5b").scaled()
    jeng = jax_make_engine(jcfg, lr=LR)
    jp = jeng.model.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    eng = make_engine(cfg, lr=LR, device="cpu")
    params = params_from_numpy(cfg, _np(jp), "cpu")
    jits = {
        "train": jax.jit(jeng.train_step,
                         static_argnames=("grad_accum", "train_tokens",
                                          "ce_chunk")),
        "combined": jax.jit(jeng.combined_step),
        "combined_paged": jax.jit(jeng.combined_step_paged,
                                  static_argnames=("ring_len",)),
    }
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, jp=jp, lora_np=lora_np,
                eng=eng, params=params, jits=jits)


def _lora(setup):
    return lora_from_numpy(setup["lora_np"], "cpu")


# ------------------------------------------------------------------ loss --
def test_chunked_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 40, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    y = rng.integers(0, 50, (2, 40)).astype(np.int32)
    m = (rng.random((2, 40)) > 0.2).astype(np.float32)

    def jloss(h_, head_):
        return jax_chunked_ce(h_, head_, jnp.asarray(y), jnp.asarray(m),
                              chunk=16)

    (jl, jmet), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(jnp.asarray(h),
                                                      jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(head).requires_grad_()
    tl, tmet = chunked_ce_loss(th, thead, torch.from_numpy(y),
                               torch.from_numpy(m), chunk=16)
    tg = torch.autograd.grad(tl, (th, thead))
    assert _rel(tl.detach(), jl) < LOSS_REL
    for k in ("loss_sum", "token_count"):
        assert _rel(tmet[k].detach(), jmet[k]) < LOSS_REL
    for t, j in zip(tg, jg):
        assert _rel(t, j) < LOSS_REL


def test_forward_loss_matches_jax(setup):
    batch = numpy_batch(setup["cfg"])
    jl, jm = setup["jeng"].model.forward_loss(
        setup["jp"], jax.tree.map(jnp.asarray, setup["lora_np"]),
        jbatch(batch), ce_chunk=CHUNK)
    tl, tm = setup["eng"].model.forward_loss(
        setup["params"], _lora(setup), tbatch(batch), ce_chunk=CHUNK)
    assert _rel(tl.detach(), jl) < LOSS_REL
    for k in ("ce_loss", "loss_sum", "token_count"):
        assert _rel(tm[k].detach(), jm[k]) < LOSS_REL
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    assert float(tm["token_count"]) == B * S - 5


def test_logits_match_jax(setup):
    batch = numpy_batch(setup["cfg"], b=2, s=10)
    jl = setup["jeng"].model.logits(
        setup["jp"], jax.tree.map(jnp.asarray, setup["lora_np"]),
        jbatch(batch))
    tl = setup["eng"].model.logits(setup["params"], _lora(setup),
                                   tbatch(batch))
    assert _rel(tl.detach(), jl) < LOGIT_REL


def test_lora_grads_match_jax_grad(setup):
    batch = numpy_batch(setup["cfg"])
    jm = setup["jeng"].model

    def jloss(lora_):
        return jm.forward_loss(setup["jp"], lora_, jbatch(batch),
                               ce_chunk=CHUNK)[0]

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, setup["lora_np"]))
    lora = _lora(setup)
    loss, _, tg = setup["eng"].loss_and_grads(setup["params"], lora,
                                              tbatch(batch), ce_chunk=CHUNK)
    assert not loss.requires_grad
    assert not any(t.requires_grad for t in tree_leaves(lora))
    for t, j in zip(jax.tree.leaves(_tnp(tg)), jax.tree.leaves(_np(jg))):
        assert _rel(t, j) < GRAD_REL


# ------------------------------------------------------------ train step --
@pytest.mark.parametrize("grad_accum,train_tokens", [(1, 0), (2, 0),
                                                     (1, 2 * S)])
def test_train_step_three_steps_matches_jax(setup, grad_accum,
                                            train_tokens):
    jlora = jax.tree.map(jnp.asarray, setup["lora_np"])
    jopt = setup["jeng"].optimizer.init(jlora)
    lora = _lora(setup)
    opt = setup["eng"].optimizer.init(lora)
    for step in range(3):
        batch = numpy_batch(setup["cfg"], seed=20 + step)
        jlora, jopt, jmet = setup["jits"]["train"](
            setup["jp"], jlora, jopt, jbatch(batch), grad_accum=grad_accum,
            train_tokens=train_tokens, ce_chunk=CHUNK)
        lora, opt, tmet = setup["eng"].train_step(
            setup["params"], lora, opt, tbatch(batch),
            grad_accum=grad_accum, train_tokens=train_tokens,
            ce_chunk=CHUNK)
        _close_trees(lora, jlora, **LORA_TOL)
        _close_trees(opt.m, jopt.m, **LORA_TOL)
        _close_trees(opt.v, jopt.v, rtol=1e-4, atol=1e-12)
        assert int(opt.step) == int(jopt.step) == step + 1
        for k in ("loss", "ce_loss", "grad_norm", "lr", "micro_grad_sqnorm",
                  "grad_sqnorm"):
            assert _rel(tmet[k], jmet[k]) < 1e-4, k


def test_opt_state_carries_across(setup):
    """A JAX optimizer state converted mid-training continues as the
    JAX run does."""
    jlora = jax.tree.map(jnp.asarray, setup["lora_np"])
    jopt = setup["jeng"].optimizer.init(jlora)
    b1, b2 = numpy_batch(setup["cfg"], seed=30), numpy_batch(setup["cfg"],
                                                            seed=31)
    jlora, jopt, _ = setup["jits"]["train"](setup["jp"], jlora, jopt,
                                            jbatch(b1), ce_chunk=CHUNK)
    lora = lora_from_numpy(_np(jlora), "cpu")
    opt = opt_state_from_numpy(_np(jopt), "cpu")
    assert int(opt.step) == 1
    jlora, jopt, _ = setup["jits"]["train"](setup["jp"], jlora, jopt,
                                            jbatch(b2), ce_chunk=CHUNK)
    lora, opt, _ = setup["eng"].train_step(setup["params"], lora, opt,
                                           tbatch(b2), ce_chunk=CHUNK)
    _close_trees(lora, jlora, **LORA_TOL)


# ----------------------------------------------------------- combined ----
def _decode_inputs(model, paged):
    """Two slots decoding at position 0 (contiguous caches of 16 rows, or
    a pool of 8-row blocks with tables [[1, 2], [3, 4]])."""
    tok = torch.tensor([[3], [7]], dtype=torch.long)
    pos = torch.zeros(2, dtype=torch.int32)
    if paged:
        caches = model.init_paged_caches(5, 8)
        tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        return caches, tok, pos, tables
    return model.init_caches(2, 16), tok, pos, None


def _combined(eng, params, lora, opt, batch, paged, **kw):
    caches, tok, pos, tables = _decode_inputs(eng.model, paged)
    if paged:
        return eng.combined_step_paged(params, lora, opt, batch, caches,
                                       tok, pos, tables, **kw)
    return eng.combined_step(params, lora, opt, batch, caches, tok, pos,
                             **kw)


def _decode(eng, params, lora, paged):
    caches, tok, pos, tables = _decode_inputs(eng.model, paged)
    if paged:
        return eng.model.decode_step_paged(params, lora, caches, tok, pos,
                                           tables)[0]
    return eng.model.decode_step(params, lora, caches, tok, pos)[0]


@pytest.mark.parametrize("paged", [False, True])
def test_combined_matches_jax(setup, paged):
    jm = setup["jeng"].model
    jlora = jax.tree.map(jnp.asarray, setup["lora_np"])
    jopt = setup["jeng"].optimizer.init(jlora)
    batch = numpy_batch(setup["cfg"], seed=40)
    tok = jnp.asarray([[3], [7]], jnp.int32)
    pos = jnp.zeros(2, jnp.int32)
    if paged:
        jl, _, jlogits, _, jmet = setup["jits"]["combined_paged"](
            setup["jp"], jlora, jopt, jbatch(batch),
            jm.init_paged_caches(5, 8), tok, pos,
            jnp.asarray([[1, 2], [3, 4]], jnp.int32))
    else:
        jl, _, jlogits, _, jmet = setup["jits"]["combined"](
            setup["jp"], jlora, jopt, jbatch(batch), jm.init_caches(2, 16),
            tok, pos)
    lora = _lora(setup)
    opt = setup["eng"].optimizer.init(lora)
    tl, _, tlogits, _, tmet = _combined(setup["eng"], setup["params"], lora,
                                        opt, tbatch(batch), paged)
    assert _rel(tlogits, jlogits) < LOGIT_REL
    _close_trees(tl, jl, **LORA_TOL)
    assert _rel(tmet["ce_loss"], jmet["ce_loss"]) < 1e-4


@pytest.mark.parametrize("paged", [False, True])
def test_combined_equals_separate_steps(setup, paged):
    """Decode logits come from the PRE-update adapter (snapshot
    isolation); the trained tree equals a standalone train step."""
    eng, params = setup["eng"], setup["params"]
    lora = _lora(setup)
    opt = eng.optimizer.init(lora)
    snapshot = tree_map(torch.clone, lora)
    batch = tbatch(numpy_batch(setup["cfg"], seed=5))
    new_lora, _, logits, _, metrics = _combined(eng, params, lora, opt,
                                                batch, paged)
    # the pre-update tree is untouched: in-flight decodes keep reading it
    for a, b in zip(tree_leaves(lora), tree_leaves(snapshot)):
        assert torch.equal(a, b)
    ref_logits = _decode(eng, params, lora, paged)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    ref_lora, _, ref_metrics = eng.train_step(params, lora, opt, batch)
    for a, b in zip(tree_leaves(new_lora), tree_leaves(ref_lora)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert float(metrics["ce_loss"]) == pytest.approx(
        float(ref_metrics["ce_loss"]), rel=1e-5)
    # and the post-update adapter would decode differently
    post = _decode(eng, params, new_lora, paged)
    assert not torch.allclose(post, ref_logits, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_combined_step_trains(setup, paged):
    eng, params = setup["eng"], setup["params"]
    lora = _lora(setup)
    opt = eng.optimizer.init(lora)
    batch = tbatch(numpy_batch(setup["cfg"], seed=100))   # fixed batch
    losses = []
    for _ in range(8):
        lora, opt, _, _, m = _combined(eng, params, lora, opt, batch, paged)
        losses.append(float(m["ce_loss"]))
    assert losses[-1] < losses[0], "co-located training must reduce loss"


@pytest.mark.parametrize("paged", [False, True])
def test_grad_accum_equivalence(setup, paged):
    """grad_accum=N must match the single-batch gradient step."""
    eng, params = setup["eng"], setup["params"]
    lora = _lora(setup)
    opt = eng.optimizer.init(lora)
    batch = numpy_batch(setup["cfg"], b=8, s=16, seed=9)
    batch["mask"][:] = 1.0      # equal token counts per microbatch
    batch = tbatch(batch)
    l1, _, _, _, m1 = _combined(eng, params, lora, opt, batch, paged,
                                grad_accum=1)
    l2, _, _, _, m2 = _combined(eng, params, lora, opt, batch, paged,
                                grad_accum=4)
    assert float(m2["ce_loss"]) == pytest.approx(float(m1["ce_loss"]),
                                                 rel=1e-5)
    for a, b in zip(tree_leaves(l1), tree_leaves(l2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_lora_shadow_split(setup, paged):
    """With serve_lora given, decode reads it and only the shadow tree
    trains: logits equal a decode with serve_lora, the result equals a
    train step of the shadow, and serve_lora stays as it was."""
    eng, params = setup["eng"], setup["params"]
    serve = _lora(setup)
    shadow = tree_map(lambda t: t * 0.5, _lora(setup))
    before = tree_map(torch.clone, serve)
    opt = eng.optimizer.init(shadow)
    batch = tbatch(numpy_batch(setup["cfg"], seed=6))
    new_shadow, _, logits, _, _ = _combined(eng, params, shadow, opt, batch,
                                            paged, serve_lora=serve)
    np.testing.assert_allclose(
        logits.numpy(), _decode(eng, params, serve, paged).numpy(),
        rtol=1e-5, atol=1e-5)
    assert not torch.allclose(logits, _decode(eng, params, shadow, paged),
                              rtol=1e-5, atol=1e-5)
    ref, _, _ = eng.train_step(params, shadow, opt, batch)
    for a, b in zip(tree_leaves(new_shadow), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(tree_leaves(serve), tree_leaves(before)):
        assert torch.equal(a, b)


def test_combined_prefill_step(setup):
    eng, params = setup["eng"], setup["params"]
    lora = _lora(setup)
    opt = eng.optimizer.init(lora)
    batch = tbatch(numpy_batch(setup["cfg"], seed=7))
    prompts = {"tokens": torch.from_numpy(
        numpy_batch(setup["cfg"], b=2, s=6, seed=8)["tokens"])}
    new_lora, _, logits, caches, _ = eng.combined_prefill_step(
        params, lora, opt, batch, prompts)
    ref_logits, _ = eng.prefill_step(params, lora, prompts)
    assert torch.equal(logits, ref_logits)
    assert caches["kv"][0].shape[:3] == (setup["cfg"].n_layers, 2, 6)
    ref_lora, _, _ = eng.train_step(params, lora, opt, batch)
    for a, b in zip(tree_leaves(new_lora), tree_leaves(ref_lora)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------ SSM co-training --
SSM_ARCHS = ["mamba2-780m", "hymba-1.5b"]
# the new adapters after AdamW steps: the SSM's gradients are summed in
# another order than JAX's autodiff (the chunk-wise backward), and AdamW
# scales every component's step to about lr (1e-3), so float32 noise in a
# near-zero gradient component moves that component by up to ~1.5% of a
# step (one element of ssm_in's b in 4,416 here); the bound is 3% of a
# step, the moments keep LORA_TOL
SSM_LORA_TOL = dict(rtol=1e-5, atol=3e-5)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_setup(request):
    """The engines of an SSM stack (mamba2) and the hybrid (hymba) at
    ``.scaled()`` on the same float32 weights; CE chunks of 16 over 24
    positions, SSD chunks of 32 (the scaled ``ssm_chunk``)."""
    jcfg = jax_config(request.param).scaled()
    cfg = get_config(request.param).scaled()
    jeng = jax_make_engine(jcfg, lr=LR)
    jp = jeng.model.init(jax.random.key(0))
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, jp=jp,
                lora_np=numpy_lora(jcfg),
                eng=make_engine(cfg, lr=LR, device="cpu"),
                params=params_from_numpy(cfg, _np(jp), "cpu"))


def test_ssm_lora_grads_match_jax_grad(ssm_setup):
    st = ssm_setup
    batch = numpy_batch(st["cfg"])
    jm = st["jeng"].model

    def jloss(lora_):
        return jm.forward_loss(st["jp"], lora_, jbatch(batch),
                               ce_chunk=CHUNK)[0]

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, st["lora_np"]))
    _, _, tg = st["eng"].loss_and_grads(
        st["params"], lora_from_numpy(st["lora_np"], "cpu"), tbatch(batch),
        ce_chunk=CHUNK)
    assert set(tg) == set(jg) and {"ssm_in", "ssm_out"} <= set(tg)
    for t, j in zip(jax.tree.leaves(_tnp(tg)), jax.tree.leaves(_np(jg))):
        assert _rel(t, j) < GRAD_REL


def test_ssm_train_steps_match_jax(ssm_setup):
    st = ssm_setup
    train = jax.jit(st["jeng"].train_step, static_argnames=("ce_chunk",))
    jlora = jax.tree.map(jnp.asarray, st["lora_np"])
    jopt = st["jeng"].optimizer.init(jlora)
    lora = lora_from_numpy(st["lora_np"], "cpu")
    opt = st["eng"].optimizer.init(lora)
    for step in range(2):
        batch = numpy_batch(st["cfg"], seed=60 + step)
        jlora, jopt, jmet = train(st["jp"], jlora, jopt, jbatch(batch),
                                  ce_chunk=CHUNK)
        lora, opt, tmet = st["eng"].train_step(
            st["params"], lora, opt, tbatch(batch), ce_chunk=CHUNK)
        _close_trees(lora, jlora, **SSM_LORA_TOL)
        _close_trees(opt.m, jopt.m, **LORA_TOL)
        for k in ("loss", "ce_loss", "grad_norm"):
            assert _rel(tmet[k], jmet[k]) < 1e-4, k


def test_ssm_combined_step_matches_jax(ssm_setup):
    """One fused tick: two slots decode their first token from zero
    caches (a hybrid's window ring and SSM state, an SSM stack's state)
    while the adapter takes a train step."""
    st = ssm_setup
    jm = st["jeng"].model
    jlora = jax.tree.map(jnp.asarray, st["lora_np"])
    jopt = st["jeng"].optimizer.init(jlora)
    batch = numpy_batch(st["cfg"], seed=70)
    tok = np.array([[3], [7]], np.int32)
    pos = np.array([0, 0], np.int32)
    jl, _, jlogits, _, jmet = jax.jit(st["jeng"].combined_step)(
        st["jp"], jlora, jopt, jbatch(batch), jm.init_caches(2, 16),
        jnp.asarray(tok), jnp.asarray(pos))
    lora = lora_from_numpy(st["lora_np"], "cpu")
    opt = st["eng"].optimizer.init(lora)
    tl, _, tlogits, caches, tmet = st["eng"].combined_step(
        st["params"], lora, opt, tbatch(batch),
        st["eng"].model.init_caches(2, 16), torch.from_numpy(tok).long(),
        torch.from_numpy(pos))
    assert _rel(tlogits, jlogits) < LOGIT_REL
    _close_trees(tl, jl, **SSM_LORA_TOL)
    assert _rel(tmet["ce_loss"], jmet["ce_loss"]) < 1e-4
    assert "ssm" in caches and ("kv" in caches) == (
        st["cfg"].family.value == "hybrid")
