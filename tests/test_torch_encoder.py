"""The encoder-only family (hubert-xlarge) in the port against the JAX
package on the CPU, float32, on the same weights (the JAX ``Model.init``
tree and a numpy LoRA tree with nonzero ``b``, loaded through
``repro_torch.convert``), at ``scaled(d_model=160, n_heads=2)``: two
heads of 80, hubert's head_dim, so the blockwise path is the one that
on the card runs ``flash_attention`` at D 80, non-causal.  Inputs are
numpy frame embeddings (``batch["embeds"]``, the stub frontend's).

* the config, the registry entry and the converted tree's layout;
* ``Engine.encoder_serve_step`` against JAX's: the dense path (S 32),
  the blockwise path (``attn_impl="blockwise"``, S 64) and ``"auto"`` at
  S 1,040 (past the dense limit): within 5e-5 of the largest logit
  (``tests/test_decode_parity.py``'s bound);
* ``forward_loss``, the LoRA gradients and an AdamW ``train_step`` (and
  one capped by ``train_tokens``, whose rows come from ``embeds``) on the
  dense and the blockwise path, at ``tests/test_torch_train.py``'s
  tolerances (the new adapters held to the AdamW update of the port's
  moments, as ``tests/test_torch_train_cli.py`` holds them);
* the train CLI on the CPU: finite losses, the per-step embeddings a
  function of (seed, step), a restart that restores the adapters and
  optimizer state bitwise;
* the twin of ``tests/test_archs_smoke.py::test_encoder_has_no_decode``:
  no decode, and every cache, prefill and decode method raises; the
  decode-serving refusals of ``run_serving`` and the batcher with the
  reference's types and words."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.launch.serve import run_serving as jax_run_serving
from repro.runtime.serving_loop import (
    ContinuousBatcher as JaxBatcher,
)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import (
    encoder_embeds, init_weights, run_training,
)
from repro_torch.runtime.serving_loop import (
    ContinuousBatcher, GenRequest, static_batch_serve,
)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_model import numpy_lora

ARCH = "hubert-xlarge"
SCALE = dict(d_model=160, n_heads=2)
LR = 1e-3
LOGIT_REL = 5e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LORA_TOL = dict(rtol=1e-5, atol=1e-7)
IMPLS = {"dense": ("dense", 32), "blockwise": ("blockwise", 64)}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["family"] = cfg.family.value
    return out


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


def _pair(impl="auto"):
    jcfg = jax_config(ARCH).scaled(attn_impl=impl, **SCALE)
    cfg = get_config(ARCH).scaled(attn_impl=impl, **SCALE)
    jeng = jax_make_engine(jcfg, lr=LR)
    jp = jeng.model.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    eng = make_engine(cfg, lr=LR, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return dict(jeng=jeng, jp=jp, jl=jax.tree.map(jnp.asarray, lora_np),
                lora_np=lora_np, eng=eng, params=params)


@pytest.fixture(scope="module", params=list(IMPLS))
def pair(request):
    impl, seq = IMPLS[request.param]
    return {**_pair(impl), "seq": seq}


def _batch(cfg, b=2, s=32, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    out = {"embeds": rng.standard_normal((b, s, cfg.d_model))
           .astype(np.float32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
        mask = np.ones((b, s), np.float32)
        mask[0, -3:] = 0.0
        out["mask"] = mask
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- config --
def test_config_is_the_jax_config():
    assert ARCH in ARCH_IDS
    assert _fields(get_config(ARCH)) == _fields(jax_config(ARCH))
    assert _fields(get_config(ARCH).scaled(**SCALE)) \
        == _fields(jax_config(ARCH).scaled(**SCALE))
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) \
        == (48, 1280, 16, 16, 80, 5120, 504)
    assert cfg.scaled(**SCALE).head_dim == 80


def test_converted_tree_layout():
    """The port's own init has the JAX tree's keys and shapes (dense
    blocks with an MLP, the embedding table and the frame classifier
    head), and the converted tree is the same tree."""
    p = _pair()
    jshapes = jax.tree.map(lambda x: tuple(x.shape), p["jp"])
    model = p["eng"].model
    own = model.init(torch.Generator().manual_seed(0))
    own_lora = model.init_lora(torch.Generator().manual_seed(1))
    assert tree_map(lambda t: tuple(t.shape), own) == jshapes
    assert tree_map(lambda t: tuple(t.shape), p["params"]) == jshapes
    assert tree_map(lambda t: tuple(t.shape), own_lora) \
        == jax.tree.map(lambda x: tuple(x.shape), p["jl"])
    assert set(own["blocks"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(own_lora) == {"q", "k", "v", "o"}


# --------------------------------------------------------------- serving --
@pytest.mark.parametrize("impl,s", [("dense", 32), ("blockwise", 64),
                                    ("auto", 1040)])
def test_encoder_serve_step_matches_jax(impl, s):
    p = _pair(impl)
    cfg = p["eng"].model.cfg
    batch = _batch(cfg, b=1 if s > 64 else 2, s=s, labels=False)
    want = p["jeng"].encoder_serve_step(p["jp"], p["jl"], _jb(batch))
    got = p["eng"].encoder_serve_step(p["params"],
                                      lora_from_numpy(p["lora_np"], "cpu"),
                                      _tb(batch))
    assert got.shape == (batch["embeds"].shape[0], s, cfg.vocab_size)
    assert not got.requires_grad
    assert _rel(got, want) < LOGIT_REL


def test_embeds_are_cast_to_the_config_dtype():
    cfg = get_config(ARCH).scaled(dtype="bfloat16", **SCALE)
    model = make_engine(cfg, device="cpu").model
    x = model._embed({}, {"embeds": torch.ones((1, 3, cfg.d_model))})
    assert x.dtype == torch.bfloat16


# -------------------------------------------------------------- training --
def test_forward_loss_matches_jax(pair):
    cfg = pair["eng"].model.cfg
    batch = _batch(cfg, s=pair["seq"], seed=1)
    jl, jm = pair["jeng"].model.forward_loss(pair["jp"], pair["jl"],
                                             _jb(batch), ce_chunk=16)
    tl, tm = pair["eng"].model.forward_loss(
        pair["params"], lora_from_numpy(pair["lora_np"], "cpu"), _tb(batch),
        ce_chunk=16)
    assert _rel(tl, jl) < LOSS_REL
    for k in ("ce_loss", "loss_sum", "token_count"):
        assert _rel(tm[k], jm[k]) < LOSS_REL


def test_lora_grads_match_jax_grad(pair):
    cfg = pair["eng"].model.cfg
    batch = _batch(cfg, s=pair["seq"], seed=2)
    jm = pair["jeng"].model

    def jloss(lora_):
        return jm.forward_loss(pair["jp"], lora_, _jb(batch))[0]

    jg = jax.grad(jloss)(pair["jl"])
    _, _, tg = pair["eng"].loss_and_grads(
        pair["params"], lora_from_numpy(pair["lora_np"], "cpu"), _tb(batch))
    for t, j in zip(jax.tree.leaves(tree_map(lambda x: x.numpy(), tg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        assert _rel(t, j) < GRAD_REL


def adamw_gap(new, prev, m, v, step, lr=LR):
    """The largest gap of adapters ``new`` from one AdamW step (no weight
    decay) from ``prev`` with the moments ``m``, ``v`` at ``step``, in
    float64: a gradient component at float32 noise, near eps, moves the
    normalised update by a real fraction of lr, so the adapters are held
    to the update of the port's own moments (the moments are held to
    JAX's), as ``tests/test_torch_train_cli.py`` holds them."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = m.double(), v.double()
    want = prev.double() - lr * (m / (1 - b1 ** step)) / (
        (v / (1 - b2 ** step)).sqrt() + eps)
    return float((new.double() - want).abs().max())


@pytest.mark.parametrize("train_tokens", [0, 32], ids=["full", "capped"])
def test_train_step_matches_jax(pair, train_tokens):
    """One AdamW step (``train_tokens`` 32 keeps the first row: the row
    count comes from ``embeds``, the batch has no ``tokens``)."""
    cfg = pair["eng"].model.cfg
    s = pair["seq"]
    batch = _batch(cfg, s=s, seed=3)
    jopt = pair["jeng"].optimizer.init(pair["jl"])
    jlora, jopt, jmet = pair["jeng"].train_step(
        pair["jp"], pair["jl"], jopt, _jb(batch), train_tokens=train_tokens)
    prev = lora_from_numpy(pair["lora_np"], "cpu")
    opt = pair["eng"].optimizer.init(prev)
    lora, opt, tmet = pair["eng"].train_step(
        pair["params"], prev, opt, _tb(batch), train_tokens=train_tokens)
    for t_tree, j_tree, tol in ((opt.m, jopt.m, LORA_TOL),
                                (opt.v, jopt.v, dict(rtol=1e-4,
                                                     atol=1e-12))):
        for t, j in zip(jax.tree.leaves(tree_map(torch.Tensor.numpy,
                                                 t_tree)),
                        jax.tree.leaves(j_tree)):
            np.testing.assert_allclose(t, np.asarray(j), **tol)
    for new, old, m, v in zip(*(tree_leaves(t) for t in
                                (lora, prev, opt.m, opt.v))):
        assert adamw_gap(new, old, m, v, 1) < 1e-6
    assert int(opt.step) == int(jopt.step) == 1
    for k in ("loss", "ce_loss", "grad_norm"):
        assert _rel(tmet[k], jmet[k]) < 1e-4, k


# ------------------------------------------------------------------- CLI --
def test_encoder_embeds_are_a_function_of_seed_and_step():
    cfg = get_config(ARCH).scaled(**SCALE)
    a = encoder_embeds(cfg, 2, 8, seed=0, step=3, device="cpu")
    assert a.shape == (2, 8, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, encoder_embeds(cfg, 2, 8, 0, 3, "cpu"))
    assert not torch.equal(a, encoder_embeds(cfg, 2, 8, 0, 4, "cpu"))
    assert not torch.equal(a, encoder_embeds(cfg, 2, 8, 1, 3, "cpu"))


def test_train_cli_trains_and_restarts(tmp_path, monkeypatch):
    """3 steps with a checkpoint at 3, then ``restore`` to 4: finite
    losses, the restart resumes at 3 from the checkpoint's adapters and
    moments bitwise, and its step-3 batch carries the embeddings a
    straight run draws at step 3."""
    import repro_torch.launch.train as train_mod
    out = run_training(ARCH, smoke=True, steps=3, batch=2, seq=16,
                       ckpt_dir=str(tmp_path), ckpt_every=3, verbose=False,
                       device="cpu")
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    seen, restored = [], []
    step_batch, restore = train_mod.step_batch, train_mod.Checkpointer.restore

    def rec_batch(cfg, data, rows, seq, seed, step, device):
        b = step_batch(cfg, data, rows, seq, seed, step, device)
        seen.append((step, b["embeds"].clone()))
        return b

    def rec_restore(self, template):
        got = restore(self, template)
        restored.append(got[0])
        return got

    monkeypatch.setattr(train_mod, "step_batch", rec_batch)
    monkeypatch.setattr(train_mod.Checkpointer, "restore", rec_restore)
    again = run_training(ARCH, smoke=True, steps=4, batch=2, seq=16,
                         ckpt_dir=str(tmp_path), restore=True,
                         ckpt_every=3, verbose=False, device="cpu")
    assert again["steps"] == 4 and len(again["losses"]) == 1
    assert np.isfinite(again["losses"]).all()
    lora, opt = restored[0]
    for a, b in zip(tree_leaves(lora), tree_leaves(out["lora"])):
        assert torch.equal(a, b)
    assert int(opt.step) == 3
    cfg = get_config(ARCH).scaled()
    assert [s for s, _ in seen] == [3]
    assert torch.equal(seen[0][1], encoder_embeds(cfg, 2, 16, 0, 3, "cpu"))


# ---------------------------------------------------------------- decode --
def test_encoder_has_no_decode():
    cfg = get_config(ARCH)
    assert not cfg.has_decode
    model = make_engine(cfg.scaled(**SCALE), device="cpu").model
    params, lora = init_weights(make_engine(cfg.scaled(**SCALE),
                                            device="cpu"), 0)
    tok = torch.zeros((1, 1), dtype=torch.long)
    pos = torch.zeros(1, dtype=torch.int32)
    emb = {"embeds": torch.zeros((1, 4, cfg.scaled(**SCALE).d_model))}
    for call in (lambda: model.init_caches(1, 8),
                 lambda: model.init_paged_caches(4, 4),
                 lambda: model.prefill(params, lora, emb),
                 lambda: model.prefill_ragged(params, lora, emb, [4]),
                 lambda: model.decode_step(params, lora, {}, tok, pos),
                 lambda: model.decode_step_paged(
                     params, lora, {"kv": (None, None)}, tok, pos,
                     torch.zeros((1, 1), dtype=torch.int32))):
        with pytest.raises(NotImplementedError, match="encoder-only"):
            call()


def _message(fn):
    try:
        fn()
    except Exception as err:        # noqa: BLE001 -- the type is compared
        return type(err), str(err)
    raise AssertionError("no refusal")


def test_decode_serving_refusals_match_the_reference():
    """``run_serving`` and the batcher refuse an encoder as the
    reference's do: the same exception type and the same words."""
    assert _message(lambda: run_serving(ARCH, n_requests=1, device="cpu",
                                        verbose=False)) \
        == _message(lambda: jax_run_serving(ARCH, n_requests=1,
                                            verbose=False)) \
        == (AssertionError, f"{ARCH} is encoder-only; no decode serving")
    cfg = get_config(ARCH).scaled(**SCALE)
    eng = make_engine(cfg, device="cpu")
    want = _message(lambda: JaxBatcher(
        jax_make_engine(jax_config(ARCH).scaled(**SCALE)), None, None))
    assert want[0] is NotImplementedError
    assert _message(lambda: ContinuousBatcher(eng, None, None)) == want
    req = GenRequest(0, np.zeros(4, np.int32), 2)
    assert _message(lambda: static_batch_serve(eng, None, None, [req])) \
        == want
