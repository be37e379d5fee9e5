"""Mamba2 (the SSM family) in the port — ``repro_torch.models.mamba2``,
its blocks, ``Model.prefill``/``write_prefill_slot``/``decode_step`` on
SSM caches and the batcher's exact-length SSM path — against the JAX
package on the CPU, float32, at ``get_config("mamba2-780m").scaled()``
(2 layers, d_model 128, 8 SSM heads of 32, state 16, chunk 32) on the
same weights (the JAX ``Model.init`` tree through ``convert.py``, LoRA
pairs on ``ssm_in``/``ssm_out`` with random a and b):

* ``ssm_mixer`` prefill (no cache) and decode (with the prefill's
  cache): output and new conv tail and state within 5e-5 of their
  largest magnitude;
* full-sequence logits against JAX ``Model.logits`` within 5e-5
  relative; a twin of ``tests/test_decode_parity.py``: incremental
  decode against the forward within 5e-5 of the largest logit;
* ``prefill`` + ``write_prefill_slot`` + ``decode_step`` over a pool of
  slots against the JAX sequence (logits, conv tails and states);
* the port's ``ContinuousBatcher`` against the JAX batcher: the same
  greedy tokens with more requests than slots and mixed prompt lengths;
* ``Engine.prefill_step`` is the exact-length ``Model.prefill``;
* ``run_serving("mamba2-780m", smoke=True)`` serves every request;
  ``paged=True``, ``adapters=`` and ``--paged``/``--adapters`` raise
  ``NotImplementedError`` as in JAX, and the attention-only model
  methods refuse an SSM stack;
* ``convert.py`` keeps ``A_log``, ``D_skip`` and ``dt_bias`` float32
  from a bf16 JAX tree, as the JAX init makes them.
Prefill runs ``ssd_scan``'s plain version here; the card runs the
kernel (``chip_smoke.py``)."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.models import mamba2 as jax_mamba2
from repro.models.model import build as jax_build
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import run_serving
from repro_torch.models import mamba2
from repro_torch.models.model import build
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest,
)
from repro_torch.tree import tree_map
from test_torch_model import numpy_lora

ARCH = "mamba2-780m"
REL = 5e-5
LENS = [6, 10, 4, 8, 7]
GENS = [5, 2, 6, 3, 4]


@pytest.fixture(scope="module")
def pair():
    """(jax model, params, lora), (port model, params, lora) holding the
    same float32 weights."""
    jcfg = jax_config(ARCH).scaled()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    tm = build(get_config(ARCH).scaled(), device="cpu")
    tp = params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")
    return ((jm, jp, jax.tree.map(jnp.asarray, lora_np)),
            (tm, tp, lora_from_numpy(lora_np, "cpu")))


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-6))


def _tokens(cfg, b=2, s=20, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close_ssm(tc, jc):
    """Port SSM caches (dict) against JAX ones (dict or SSMCache)."""
    jc = jc._asdict() if hasattr(jc, "_asdict") else jc
    for k in ("conv", "state"):
        assert _rel(tc[k], jc[k]) < REL, k


def test_mixer_prefill_and_decode_match_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    cfg = tm.cfg
    jparams = jax_mamba2.SSMParams(
        **jax.tree.map(lambda t: t[0], jp["blocks"]["ssm"]))
    jl = jax.tree.map(lambda t: t[0], jlora)
    tparams = tree_map(lambda t: t[0], tp["blocks"]["ssm"])
    tl = tree_map(lambda t: t[0], tlora)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    jy, jc = jax_mamba2.ssm_mixer(jparams, jnp.asarray(x), jm.cfg, lora=jl)
    ty, tc = mamba2.ssm_mixer(tparams, torch.from_numpy(x), cfg, lora=tl)
    assert _rel(ty, jy) < REL
    _close_ssm(tc, jc)
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy2, jc2 = jax_mamba2.ssm_mixer(jparams, jnp.asarray(xt), jm.cfg,
                                    cache=jc, lora=jl)
    ty2, tc2 = mamba2.ssm_mixer(tparams, torch.from_numpy(xt), cfg,
                                cache=tc, lora=tl)
    assert _rel(ty2, jy2) < REL
    _close_ssm(tc2, jc2)


def test_logits_match_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = _tokens(tm.cfg, s=45)
    jl = jm.logits(jp, jlora, {"tokens": jnp.asarray(toks)})
    tl = tm.logits(tp, tlora, {"tokens": torch.from_numpy(toks).long()})
    assert _rel(tl, jl) < REL


def test_decode_matches_forward(pair):
    _, (tm, tp, tlora) = pair
    toks = torch.from_numpy(_tokens(tm.cfg)).long()
    b, s = toks.shape
    full = tm.logits(tp, tlora, {"tokens": toks})
    caches = tm.init_caches(b, s)
    worst = 0.0
    for t in range(s):
        lg, caches = tm.decode_step(tp, tlora, caches, toks[:, t:t + 1],
                                    torch.tensor(t))
        worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    assert worst / (float(full.abs().max()) + 1e-6) < REL


def test_prefill_slot_decode_match_jax(pair):
    """Two requests of different lengths prefilled one at a time into
    slots 2 and 0 of a 3-slot pool (slot 1 stays idle), then four decode
    steps of the whole pool, as the batcher runs them."""
    (jm, jp, jlora), (tm, tp, tlora) = pair
    prompts = [_tokens(tm.cfg, 1, 9, seed=2), _tokens(tm.cfg, 1, 3, seed=3)]
    slots = [2, 0]
    jpool, tpool = jm.init_caches(3, 16), tm.init_caches(3, 16)
    feed = np.zeros((3, 1), np.int32)
    for prompt, slot in zip(prompts, slots):
        jlg, jpre = jm.prefill(jp, jlora, {"tokens": jnp.asarray(prompt)})
        tlg, tpre = tm.prefill(tp, tlora,
                               {"tokens": torch.from_numpy(prompt).long()})
        assert _rel(tlg, jlg) < REL
        _close_ssm(tpre["ssm"], jpre["ssm"])
        jpool = jm.write_prefill_slot(jpool, jpre, slot)
        tpool = tm.write_prefill_slot(tpool, tpre, slot)
        feed[slot, 0] = int(jnp.argmax(jlg[0, -1]))
    _close_ssm(tpool["ssm"], jpool["ssm"])
    pos = np.array([3, 0, 9], np.int32)
    for _ in range(4):
        jlg, jpool = jm.decode_step(jp, jlora, jpool, jnp.asarray(feed),
                                    jnp.asarray(pos))
        tlg, tpool = tm.decode_step(tp, tlora, tpool,
                                    torch.from_numpy(feed).long(),
                                    torch.from_numpy(pos))
        assert _rel(tlg, jlg) < REL
        _close_ssm(tpool["ssm"], jpool["ssm"])
        feed = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
        pos = pos + 1


def test_wave_gather_and_slot_scatter_equal_per_request_writes(pair):
    """The batcher's SSM admission: each request's exact-length prefill
    gathered into row j of a wave tree (``write_prefill_slot``), then the
    wave written into its slots with one indexed write per leaf
    (``write_prefill_slots``, row 1 dropped as finished at admission),
    equals writing each kept request straight into its slot."""
    _, (tm, tp, tlora) = pair
    pres = [tm.prefill(tp, tlora, {"tokens": torch.from_numpy(
        _tokens(tm.cfg, 1, n, seed=10 + n)).long()})[1] for n in (5, 9, 2)]
    wave = tm.init_caches(3, 0)
    for j, pre in enumerate(pres):
        tm.write_prefill_slot(wave, pre, j)
    got = tm.write_prefill_slots(tm.init_caches(4, 16), wave, [3, 4, 0])
    want = tm.init_caches(4, 16)
    for pre, slot in ((pres[0], 3), (pres[2], 0)):
        tm.write_prefill_slot(want, pre, slot)
    for key in ("conv", "state"):
        assert torch.equal(got["ssm"][key], want["ssm"][key])


def test_batcher_matches_jax_batcher():
    """Five requests of mixed lengths on two slots (admitted mid-flight):
    the port's batcher emits the JAX batcher's greedy tokens."""
    jcfg = jax_config(ARCH).scaled()
    jeng = jax_make_engine(jcfg)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jax.tree.map(lambda x: x + 0.01,
                         jeng.model.init_lora(jax.random.key(1)))
    eng = make_engine(get_config(ARCH).scaled(), device="cpu")
    params = params_from_numpy(eng.model.cfg, jax.tree.map(np.asarray, jp),
                               "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS), LENS)
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10)
    jb = JaxBatcher(jeng, jp, jlora, **kw)
    jreqs = [JaxRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    jb.run(jreqs)
    tb = ContinuousBatcher(eng, params, lora, **kw)
    treqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    stats = tb.run(treqs)
    assert [r.tokens for r in treqs] == [list(r.tokens) for r in jreqs]
    assert stats.finished == len(LENS)
    assert tb.prefill_waves > 1                     # mid-flight admission
    assert tb.cache_bytes() == sum(
        t.numel() * t.element_size() for t in tb.caches["ssm"].values())


def test_engine_prefill_step_is_the_exact_length_prefill(pair):
    _, (tm, tp, tlora) = pair
    eng = make_engine(tm.cfg, device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tm.cfg, 1, 11)).long()}
    lg, caches = eng.prefill_step(tp, tlora, toks)
    want, wcaches = tm.prefill(tp, tlora, toks)
    assert torch.equal(lg, want)
    assert all(torch.equal(caches["ssm"][k], wcaches["ssm"][k])
               for k in ("conv", "state"))
    with pytest.raises(NotImplementedError, match="ragged"):
        eng.prefill_step(tp, tlora, toks,
                         adapter_idx=torch.zeros(1, dtype=torch.int32))


def test_run_serving_on_cpu():
    out = run_serving(ARCH, smoke=True, n_requests=6, prompt_len=12,
                      gen_tokens=5, batch_size=4, device="cpu",
                      verbose=False)
    assert out["finished"] == 6
    assert all(len(t) == 5 for t in out["tokens"])
    assert out["tokens_generated"] == 30


def test_paged_and_adapters_raise_as_in_jax(monkeypatch):
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
        run_serving(ARCH, paged=True, n_requests=1, device="cpu",
                    verbose=False)
    for flag in (["--paged"], ["--adapters", "2"]):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH,
                                          "--smoke", "--device", "cpu",
                                          "--requests", "1"] + flag)
        with pytest.raises(NotImplementedError):
            serve_mod.main()


def test_attention_only_methods_refuse_an_ssm_stack(pair):
    _, (tm, tp, tlora) = pair
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 6)).long()
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.prefill_ragged(tp, tlora, {"tokens": toks}, torch.tensor([6, 4]))
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.init_paged_caches(8, 4)
    with pytest.raises(NotImplementedError, match="attention-only"):
        tm.decode_step_paged(tp, tlora, {}, toks[:, :1], torch.tensor([0, 0]),
                             torch.zeros((2, 1), dtype=torch.int32))


def test_init_and_convert_keep_float32_leaves():
    """The port's own init and a bf16 JAX tree converted into a bf16
    config both keep A_log, D_skip and dt_bias float32 (a bf16 A_log
    would round every layer's decay rate)."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jm = jax_build(jax_config(ARCH).scaled(**kw))
    jp = jm.init(jax.random.key(0))
    tcfg = get_config(ARCH).scaled(**kw)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    own = build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    for tree in (tp, own):
        for k, leaf in tree["blocks"]["ssm"].items():
            want = torch.float32 if k in mamba2.FLOAT32_LEAVES \
                else torch.bfloat16
            assert leaf.dtype == want, k
            assert tuple(leaf.shape) == jp["blocks"]["ssm"][k].shape, k
        assert tree["embed"].dtype == torch.bfloat16
    for k in mamba2.FLOAT32_LEAVES:
        assert jp["blocks"]["ssm"][k].dtype == jnp.float32
        np.testing.assert_array_equal(
            tp["blocks"]["ssm"][k].numpy(), np.asarray(jp["blocks"]["ssm"][k]))
    # the deterministic leaves of the two inits agree exactly
    for k in mamba2.FLOAT32_LEAVES:
        np.testing.assert_allclose(own["blocks"]["ssm"][k].numpy(),
                                   np.asarray(jp["blocks"]["ssm"][k]),
                                   rtol=1e-6)
