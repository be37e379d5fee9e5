"""The port's serving on a device mesh (``repro_torch.models.sharding``,
``models/collectives.py``, ``launch/mesh.py``) on the CPU: four ranks,
spawned once for the module through ``spawn_ranks(..., backend="gloo")``
on a 2 x 2 (data, model) mesh, run every case (``_torch_mesh_cases.
mesh_cases``); the JAX references run in this process.

* Specs: for every registered arch on (2, 2), (1, 4) and (2, 4) meshes,
  the port's ``rules_for`` + ``param_shardings`` / ``batch_shardings``
  give the reference's specs (``rules_for``, ``logical_axes_for``,
  ``_resolve``, called with an object carrying ``.shape`` in place of a
  ``Mesh``: they read only ``mesh.shape``).
* Decode: ``tests/test_shardmap_decode.py``'s config (scaled llama3-8b,
  one KV head: ``rules_for`` already cuts the cache's sequence) from the
  JAX init, B 4, 32 steps, under ``rules_for``'s table, the forced
  ``kv_seq="model", kv_batch="data"`` one and ``rules_for`` over the
  pure-TP preset: within 5e-5 of the largest logit of JAX's unsharded
  decode, as that test holds JAX.
* Prefill and serving: ``prefill_ragged`` then ``static_batch_serve`` of
  4 ragged requests with 2 KV heads (``rules_for`` keeps each rank's
  heads; the forced table cuts the sequence), and a wave of 4 x 272
  tokens (past 1,024: rows cut over data, the FSDP weight dims
  gathered): the logits within 5e-5 (scaled) of JAX's unsharded
  ``prefill_ragged`` and of the port's, the greedy tokens equal to
  ``reference_greedy`` on the JAX model and to the unsharded port's.
* The ``return_lse`` launch's plain version against a float64 softmax:
  kv_len 0 (zeros, -inf), 1 and S.
* Restore: whole -> 2 x 2 -> written from the mesh -> 1 x 4
  (``elastic_restore``) -> whole, bitwise, and the mesh-written
  checkpoint restored by one process, bitwise; ``init_sharded``'s blocks
  are the whole ``init``'s, bitwise.
* Refusals (``NotImplementedError``): a q_seq table (5 heads on a 2-way
  model axis), training, the continuous batcher and the paged pool, an
  SSM stack.
"""
import dataclasses
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from conftest import reference_greedy, sample_prompts
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.models.model import build as jax_build
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_lse_ref,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import build
from repro_torch.runtime.serving_loop import GenRequest, static_batch_serve
from repro_torch.tree import tree_map

DECODE_CFG = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                  vocab_size=256)
SERVE_CFG = dict(n_layers=2, d_model=64, n_heads=8, d_ff=128,
                 vocab_size=256)
LENS = [6, 10, 4, 8]
GENS = [5, 3, 6, 4]
# 4 x 272 = 1,088 tokens: past the 1,024 a call keeps every row whole
LONG_LENS = [264, 270, 250, 272]
LONG_GENS = [3, 2, 4, 3]
LONG_PAD = 272


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(kw, lora_shift):
    jcfg = jax_config("llama3-8b").scaled(**kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    jl = jax.tree.map(lambda x: x + lora_shift,
                      jm.init_lora(jax.random.key(1)))
    return jcfg, jm, jp, jl


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The port's cases on the ranks, while this process computes the JAX
    references."""
    jcfg, jm, jp, jl = _jax_model(DECODE_CFG, 0.01)
    b, s = 4, 32
    toks = np.asarray(jax.random.randint(jax.random.key(2), (b, s), 0,
                                         jcfg.vocab_size))
    payload = {"decode": {"cfg": DECODE_CFG, "params": _numpy(jp),
                          "lora": _numpy(jl), "tokens": toks}}
    sjcfg, sjm, sjp, sjl = _jax_model(SERVE_CFG, 0.01)
    prompts = sample_prompts(sjcfg, len(LENS), LENS)
    payload["serve"] = {"cfg": SERVE_CFG, "params": _numpy(sjp),
                        "lora": _numpy(sjl), "prompts": prompts,
                        "gens": GENS, "prompt_pad": 10, "max_seq": 16}
    # restore: a whole checkpoint of the port's init
    cfg = get_config("llama3-8b").scaled(**SERVE_CFG)
    ckpt = str(tmp_path_factory.mktemp("ckpt_whole"))
    out = str(tmp_path_factory.mktemp("ckpt_mesh"))
    whole = build(cfg, "cpu").init(torch.Generator().manual_seed(3))
    Checkpointer(ckpt).save(7, whole, extra={"note": "whole"}, blocking=True)
    payload["restore"] = {"cfg": SERVE_CFG, "ckpt": ckpt, "out": out}
    # a wave past 1,024 tokens: rows cut over data, weights gathered
    long_prompts = [np.resize(p, n) for p, n in zip(prompts, LONG_LENS)]
    payload["long"] = dict(payload["serve"], prompts=long_prompts,
                           gens=LONG_GENS, prompt_pad=LONG_PAD,
                           max_seq=LONG_PAD + max(LONG_GENS))
    wait = cases.start_ranks(cases.mesh_cases, payload,
                             str(tmp_path_factory.mktemp("store")))

    ref = {"whole": cases._flat(whole)}
    # decode: test_shardmap_decode.py's reference
    caches = jm.init_caches(b, s)
    step = jax.jit(jm.decode_step)
    logits = []
    for t in range(s):
        lg, caches = step(jp, jl, caches, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        logits.append(np.asarray(lg))
    ref["decode"] = np.stack(logits)
    # serving: JAX's prefill_ragged and reference_greedy, and the
    # unsharded port
    jprefill = jax.jit(sjm.prefill_ragged)

    def jax_prefill(prompts, lens, pad):
        lg, _ = jprefill(sjp, sjl, {"tokens": jnp.asarray(
            cases._pad(prompts, pad), jnp.int32)}, jnp.asarray(lens,
                                                              jnp.int32))
        return np.asarray(lg)

    ref["jax_prefill"] = jax_prefill(prompts, LENS, 10)
    ref["greedy"] = [reference_greedy(sjm, sjp, sjl, prompts[i], GENS[i])
                     for i in range(len(LENS))]
    engine = make_engine(cfg, device="cpu")
    params = params_from_numpy(cfg, _numpy(sjp), "cpu")
    lora = lora_from_numpy(_numpy(sjl), "cpu")
    with torch.no_grad():
        lg, _ = engine.model.prefill_ragged(
            params, lora, {"tokens": torch.as_tensor(cases._pad(prompts,
                                                                10))},
            torch.as_tensor(LENS))
    ref["prefill"] = lg.numpy()
    reqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                       max_new_tokens=GENS[i]) for i in range(len(LENS))]
    static_batch_serve(engine, params, lora, reqs, batch_size=4,
                       prompt_pad=10, max_seq=16)
    ref["unsharded"] = [list(r.tokens) for r in reqs]
    d = payload["long"]
    with torch.no_grad():
        lg, _ = engine.model.prefill_ragged(
            params, lora, {"tokens": torch.as_tensor(cases._pad(
                d["prompts"], LONG_PAD))}, torch.as_tensor(LONG_LENS))
    reqs = [GenRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(zip(d["prompts"], LONG_GENS))]
    static_batch_serve(engine, params, lora, reqs, batch_size=4,
                       prompt_pad=LONG_PAD, max_seq=d["max_seq"])
    ref["long"] = (lg.numpy(), [list(r.tokens) for r in reqs])
    ref["long_jax"] = (
        jax_prefill(d["prompts"], LONG_LENS, LONG_PAD),
        [reference_greedy(sjm, sjp, sjl, p, g)
         for p, g in zip(d["prompts"], LONG_GENS)])
    return ref, wait(), cfg, out


def _case(ran, name):
    _, ranks, _, _ = ran
    for r in ranks:
        res = r[name]
        assert not (isinstance(res, dict) and "error" in res), res["error"]
    return [r[name] for r in ranks]


# ------------------------------------------------------------------ specs --
def _jax_specs(tree, cfg, mesh, rules, batch):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        if batch:
            names = (None,) * leaf.ndim
            for pat, axes in jmesh._BATCH_TABLE:
                if re.search(pat, key):
                    lead = leaf.ndim - len(axes)
                    names = ((None,) * max(lead, 0) + tuple(axes))[:leaf.ndim]
                    break
        else:
            names = jmesh.logical_axes_for(key, leaf.ndim, cfg)
        out[key] = tuple(jmesh._resolve(rules, names, leaf.shape, mesh))
    return out


def _port_specs(tree, shardings):
    from repro_torch.checkpoint.checkpointer import _tree_paths
    leaves = dict(_tree_paths(shardings))
    return {k: tuple(leaves[k].spec) for k, _ in _tree_paths(tree)}


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    """The reference's param, adapter and (where it decodes) batch trees
    of ``arch`` at full size, shapes only."""
    jm = jax_build(jax_config(arch))
    trees = [(jm.param_specs(), False), (jm.lora_specs(), False)]
    if jm.cfg.has_decode:
        trees.append(({"tokens": jax.ShapeDtypeStruct((8, 1024), jnp.int32),
                       "caches": jax.eval_shape(
                           lambda: jm.init_caches(8, 1024))}, True))
    return trees


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_batch_specs_equal_reference(arch, shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    mesh = FakeMesh(shape)
    for kind in ("decode", "train"):
        jrules = jmesh.rules_for(jcfg, mesh, kind)
        rules = tmesh.rules_for(cfg, mesh, kind)
        assert dataclasses.asdict(rules) == dataclasses.asdict(jrules)
        for tree, batch in _jax_trees(arch):
            meta = _meta(tree)
            shard = tmesh.batch_shardings if batch else tmesh.param_shardings
            assert _port_specs(meta, shard(meta, cfg, mesh, rules)) == \
                _jax_specs(tree, jcfg, mesh, jrules, batch)


# ----------------------------------------------------------------- decode --
@pytest.mark.parametrize("table", ["rules", "forced", "tp_only"])
def test_decode_on_2x2_matches_jax_unsharded(ran, table):
    ref = ran[0]["decode"]
    got = _case(ran, f"decode_{table}")
    scale = float(np.abs(ref).max())
    for r in got:
        assert r.shape == ref.shape
        assert float(np.abs(r - ref).max()) / scale < 5e-5
    # every rank returns every sequence's logits, the same ones
    for r in got[1:]:
        np.testing.assert_array_equal(r, got[0])


def _held(got, jax_logits, jax_tokens, port_logits, port_tokens):
    """Every rank's prefill logits within 5e-5 of the largest of JAX's
    unsharded ``prefill_ragged`` and of the port's, its greedy tokens
    JAX's ``reference_greedy`` and the unsharded port's."""
    assert port_tokens == jax_tokens
    for want in (jax_logits, port_logits):
        scale = float(np.abs(want).max())
        for logits, _ in got:
            assert logits.shape == want.shape
            assert float(np.abs(logits - want).max()) / scale < 5e-5
    for _, toks in got:
        assert toks == jax_tokens


@pytest.mark.parametrize("table", ["rules", "forced"])
def test_prefill_and_static_serve_on_2x2(ran, table):
    ref = ran[0]
    _held(_case(ran, f"serve_{table}"), ref["jax_prefill"], ref["greedy"],
          ref["prefill"], ref["unsharded"])


@pytest.mark.parametrize("table", ["rules", "forced"])
def test_long_prefill_cut_by_rows_on_2x2(ran, table):
    """Past 1,024 tokens a call cuts its rows over data and gathers the
    FSDP weight dims: JAX's logits and tokens (and the unsharded
    port's)."""
    ref = ran[0]
    _held(_case(ran, f"long_{table}"), *ref["long_jax"], *ref["long"])


# -------------------------------------------------------------------- lse --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_plain_version_matches_float64_softmax(dtype):
    g = torch.Generator().manual_seed(0)
    b, h, hkv, d, bs, nb = 3, 8, 2, 64, 8, 4
    q = torch.randn((b, h, d), generator=g).to(dtype)
    kp = torch.randn((b * nb, bs, hkv, d), generator=g).to(dtype)
    vp = torch.randn((b * nb, bs, hkv, d), generator=g).to(dtype)
    tables = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    kv_len = torch.tensor([0, 1, nb * bs], dtype=torch.int32)
    scale = 1.0 / math.sqrt(d)
    out, lse = paged_decode_attention(q, kp, vp, tables, kv_len,
                                      return_lse=True)
    out_ref, lse_ref = paged_decode_attention_lse_ref(q, kp, vp, tables,
                                                      kv_len, scale)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out, out_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
    assert not torch.isnan(out).any() and not torch.isnan(lse[1:]).any()
    k = kp.double().reshape(b, nb * bs, hkv, d).repeat_interleave(4, dim=2)
    v = vp.double().reshape(b, nb * bs, hkv, d).repeat_interleave(4, dim=2)
    for i in (1, 2):
        n = int(kv_len[i])
        sc = torch.einsum("hd,khd->hk", q[i].double(), k[i, :n]) * scale
        want_lse = torch.logsumexp(sc, dim=-1)
        want = torch.einsum("hk,khd->hd", torch.softmax(sc, dim=-1),
                            v[i, :n])
        torch.testing.assert_close(lse[i].double(), want_lse, rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(out[i].double(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- restore --
def test_restore_whole_to_2x2_to_1x4_to_whole_bitwise(ran):
    ref, _, cfg, out = ran
    got = _case(ran, "restore")
    assert all(r["blocks_ok"] for r in got)
    assert all(r["extra"] == {"note": "whole"} for r in got)
    assert got[0]["n_cut"] > 0
    whole = got[0]["whole"]
    assert sorted(whole) == sorted(ref["whole"])
    for k, v in ref["whole"].items():
        np.testing.assert_array_equal(whole[k], v.numpy())
    template = tree_map(lambda t: t.to("meta"), build(cfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    back, _ = Checkpointer(out).restore(template, device="cpu")
    for k, v in cases._flat(back).items():
        assert torch.equal(v, ref["whole"][k])


def test_init_sharded_blocks_are_the_whole_init(ran):
    assert all(_case(ran, "init_sharded"))


# --------------------------------------------------------------- refusals --
@pytest.mark.parametrize("what", ["q_seq", "train", "batcher", "paged",
                                  "ssm"])
def test_mesh_refuses_what_is_queued(ran, what):
    for r in _case(ran, "refusals"):
        assert r[what].startswith("refused: "), r[what]
        assert "mesh" in r[what]
