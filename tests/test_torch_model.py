"""The port's model (``repro_torch.models.model``) against the JAX model
on the same weights: the JAX ``Model.init`` tree and a LoRA tree with a
nonzero ``b`` (numpy random, so the bypass is exercised) are loaded into
the port through ``repro_torch.convert``.  A ragged prefill wave, its
batched cache write, and six decode steps over the paged pool and over
the contiguous cache must agree: logits within 5e-5 of their largest
magnitude (``tests/test_decode_parity.py``'s bound), caches within 1e-6
of theirs (about 16 float32 ulps: the matmuls sum in another order, so
single elements differ in their last bits).  Float32 on the CPU; the
port runs the plain versions of its kernels here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import lora as jax_lora
from repro.models.model import build as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.models.model import build

LOGIT_REL = 5e-5
CACHE_REL = 1e-6
# one-wave setup: ragged prompt lengths, pad width, decode steps
LENS = np.array([5, 9, 3], np.int32)
PAD, STEPS, BS, N_BLOCKS = 12, 6, 4, 16


def numpy_lora(cfg, seed=11):
    """A LoRA tree of the JAX layout with random a AND b."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, (din, dout) in jax_lora.target_dims(cfg).items():
        if t not in cfg.lora.targets:
            continue
        r = cfg.lora.rank
        out[t] = {
            "a": (rng.standard_normal((cfg.n_layers, din, r))
                  / np.sqrt(din)).astype(np.float32),
            "b": (rng.standard_normal((cfg.n_layers, r, dout))
                  * 0.1).astype(np.float32)}
    return out


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    """(jax model, params, lora), (port model, params, lora) holding the
    same weights."""
    kw = {"gqa": {"n_kv_heads": 2}}.get(request.param, {})
    jcfg = jax_config("qwen1.5-0.5b").scaled(**kw)
    tcfg = get_config("qwen1.5-0.5b").scaled(**kw)
    assert jcfg.n_kv_heads == tcfg.n_kv_heads
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    jlora = jax.tree.map(jnp.asarray, lora_np)
    tm = build(tcfg, device="cpu")
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    tlora = lora_from_numpy(lora_np, device="cpu")
    return (jm, jp, jlora), (tm, tp, tlora)


def prompts(cfg):
    rng = np.random.default_rng(5)
    padded = np.zeros((len(LENS), PAD), np.int32)
    for j, n in enumerate(LENS):
        padded[j, :n] = rng.integers(0, cfg.vocab_size, n)
    return padded


def _rel(t, j):
    j = np.asarray(j)
    return float(np.max(np.abs(t.numpy() - j)) / (np.max(np.abs(j)) + 1e-6))


def _close_caches(tc, jc):
    for t, j in zip(tc["kv"], jc["kv"]):
        assert t.shape == j.shape
        assert _rel(t, j) < CACHE_REL


def test_params_convert_keep_layout_and_dtype(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jleaves:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == getattr(torch, tm.cfg.param_dtype)
    assert tlora["q"]["b"].dtype == torch.float32
    # the port's own init draws other numbers with the same layout
    own = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own["blocks"]["attn"].items()} \
        == {k: tuple(v.shape) for k, v in tp["blocks"]["attn"].items()}


def test_prefill_and_paged_decode_match_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = prompts(tm.cfg)
    lj, prej = jm.prefill_ragged(jp, jlora, {"tokens": jnp.asarray(toks)},
                                 jnp.asarray(LENS))
    lt, pret = tm.prefill_ragged(tp, tlora,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 torch.from_numpy(LENS))
    assert _rel(lt, lj) < LOGIT_REL
    _close_caches(pret, prej)

    # wave tables: each row's prompt blocks, n_blocks marks unused
    nbp = PAD // BS
    wave = np.full((len(LENS), nbp), N_BLOCKS, np.int32)
    # decode tables: prompt blocks + blocks for the 6 decode writes,
    # scratch block 0 past them
    nb = -(-(int(LENS.max()) + STEPS) // BS)
    tables = np.zeros((len(LENS), nb), np.int32)
    nxt = 1
    for j, n in enumerate(LENS):
        need = -(-(int(n) + STEPS) // BS)
        ids = np.arange(nxt, nxt + need, dtype=np.int32)
        nxt += need
        tables[j, :need] = ids
        wave[j, :-(-int(n) // BS)] = ids[:-(-int(n) // BS)]
    cj = jm.write_prefill_blocks(jm.init_paged_caches(N_BLOCKS, BS), prej,
                                 jnp.asarray(wave))
    ct = tm.write_prefill_blocks(tm.init_paged_caches(N_BLOCKS, BS), pret,
                                 wave)
    _close_caches(ct, cj)

    tok = np.array(jnp.argmax(lj[:, -1], axis=-1), np.int32)
    tt = torch.from_numpy(tables)
    for step in range(STEPS):
        pos = LENS + step
        lj, cj = jm.decode_step_paged(jp, jlora, cj,
                                      jnp.asarray(tok[:, None]),
                                      jnp.asarray(pos), jnp.asarray(tables))
        lt, ct = tm.decode_step_paged(tp, tlora, ct,
                                      torch.from_numpy(tok[:, None]),
                                      torch.from_numpy(pos), tt)
        assert _rel(lt, lj) < LOGIT_REL, f"step {step}"
        tok = np.array(jnp.argmax(lj[:, -1], axis=-1), np.int32)
    _close_caches(ct, cj)


def test_contiguous_decode_matches_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = prompts(tm.cfg)
    lj, prej = jm.prefill_ragged(jp, jlora, {"tokens": jnp.asarray(toks)},
                                 jnp.asarray(LENS))
    _, pret = tm.prefill_ragged(tp, tlora,
                                {"tokens": torch.from_numpy(toks).long()},
                                torch.from_numpy(LENS))
    # wave row 1 finished at admission: its out-of-range slot id drops it
    n_slots, seq = 3, PAD + STEPS
    slots = np.array([2, n_slots, 0], np.int32)
    cj = jm.write_prefill_slots(jm.init_caches(n_slots, seq), prej,
                                jnp.asarray(slots))
    ct = tm.write_prefill_slots(tm.init_caches(n_slots, seq), pret, slots)
    _close_caches(ct, cj)

    first = np.array(jnp.argmax(lj[:, -1], axis=-1), np.int32)
    tok = np.zeros(n_slots, np.int32)
    pos = np.zeros(n_slots, np.int32)
    for row, slot in enumerate(slots):
        if slot < n_slots:
            tok[slot], pos[slot] = first[row], LENS[row]
    for step in range(STEPS):
        lj, cj = jm.decode_step(jp, jlora, cj, jnp.asarray(tok[:, None]),
                                jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, tlora, ct,
                                torch.from_numpy(tok[:, None]),
                                torch.from_numpy(pos))
        assert _rel(lt, lj) < LOGIT_REL, f"step {step}"
        tok = np.array(jnp.argmax(lj[:, -1], axis=-1), np.int32)
        pos = pos + 1
    _close_caches(ct, cj)


def test_engine_steps_are_the_model_steps(pair):
    """``Engine.prefill_step`` is a full-length ragged prefill and
    ``Engine.decode_step`` the model's contiguous decode."""
    from repro_torch.core.engine import Engine
    _, (tm, tp, tlora) = pair
    engine = Engine(tm)
    toks = torch.from_numpy(prompts(tm.cfg)).long()
    le, ce = engine.prefill_step(tp, tlora, {"tokens": toks})
    lm, cm = tm.prefill_ragged(tp, tlora, {"tokens": toks},
                               torch.full((toks.shape[0],), PAD))
    assert torch.equal(le, lm) and torch.equal(ce["kv"][0], cm["kv"][0])
    caches = tm.init_caches(toks.shape[0], PAD + 1)
    caches = tm.write_prefill_slots(caches, ce, np.arange(toks.shape[0]))
    tok = le[:, -1].argmax(-1)[:, None]
    pos = torch.full((toks.shape[0],), PAD, dtype=torch.int32)
    ld, _ = engine.decode_step(tp, tlora, caches, tok, pos)
    assert ld.shape == (toks.shape[0], 1, tm.cfg.vocab_size)
    assert torch.isfinite(ld).all()
