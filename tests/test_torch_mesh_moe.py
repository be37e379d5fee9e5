"""The port's expert-parallel and expert-ff tensor-parallel MoE on a 2 x 2
(data, model) CPU mesh: four ranks spawned once for the module
(``spawn_ranks(..., backend="gloo")``) run ``_torch_mesh_cases.
moe_cases``.

* Both layouts of ``tests/test_shardmap_moe.py`` (EP: experts on
  ``model``; TP: each expert's ff on ``model``; ``w_embed`` on ``data``
  in both), from JAX's ``init_moe`` and input: ``moe_mlp`` on the mesh
  (the ``moe_decode_shardmap`` path) within 1e-4 of JAX's ``moe_mlp``
  without a mesh and its aux within 1e-5, as that test holds JAX's own
  shard_map; every rank returns the same output.  Past 1,024 tokens the
  mesh raises ``NotImplementedError`` (a later slice).
* Scaled moonshot-v1-16b-a3b (EP under ``rules_for``) and grok-1-314b
  (TP), 2 layers, from the JAX init: 8 decode steps on the mesh within
  5e-5 of the largest logit of JAX's unsharded decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_cases as cases
from repro.configs.base import Family as JaxFamily
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.registry import get_config as jax_config
from repro.models.model import build as jax_build
from repro.models.moe import init_moe, moe_mlp
from repro_torch.configs.base import Family

CFG = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
           d_ff=64, vocab_size=64, n_experts=4, top_k=2, dtype="float32",
           param_dtype="float32")
LAYOUTS = {"ep": dict(experts="model", expert_ff=None, w_embed="data"),
           "tp": dict(experts=None, expert_ff="model", w_embed="data")}
MODELS = {"moonshot-v1-16b-a3b": dict(n_layers=2),
          "grok-1-314b": dict(n_layers=2)}
STEPS = 8


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The port's cases on the ranks, while this process computes the JAX
    references."""
    payload = {"cfg": dict(CFG, family=Family.MOE), "layouts": LAYOUTS,
               "params": {}, "models": {}}
    x = jax.random.normal(jax.random.key(1), (4, 8, 32), jnp.float32)
    payload["x"] = np.asarray(x)
    moe = {}
    for name in LAYOUTS:
        jcfg = JaxConfig(**CFG, family=JaxFamily.MOE, moe_shard=name)
        moe[name] = (jcfg, init_moe(jax.random.key(0), jcfg))
        payload["params"][name] = _numpy(moe[name][1]._asdict())
    models = {}
    for arch, kw in MODELS.items():
        jcfg = jax_config(arch).scaled(**kw)
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.key(0))
        jl = jax.tree.map(lambda t: t + 0.01, jm.init_lora(jax.random.key(1)))
        toks = np.asarray(jax.random.randint(jax.random.key(2), (4, STEPS), 0,
                                             jcfg.vocab_size))
        models[arch] = (jm, jp, jl, toks)
        payload["models"][arch] = {"cfg": kw, "params": _numpy(jp),
                                   "lora": _numpy(jl), "tokens": toks}
    wait = cases.start_ranks(cases.moe_cases, payload,
                             str(tmp_path_factory.mktemp("store")))
    ref = {}
    for name, (jcfg, p) in moe.items():
        y, aux = moe_mlp(p, x, jcfg)
        ref[name] = (np.asarray(y), float(aux))
    for arch, (jm, jp, jl, toks) in models.items():
        caches = jm.init_caches(4, STEPS)
        step = jax.jit(jm.decode_step)
        logits = []
        for t in range(STEPS):
            lg, caches = step(jp, jl, caches, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
            logits.append(np.asarray(lg))
        ref[arch] = np.stack(logits)
    return ref, wait()


def _case(ran, name):
    out = [r[name] for r in ran[1]]
    for res in out:
        assert not (isinstance(res, dict) and "error" in res), res["error"]
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_layout_matches_jax_unsharded(ran, layout):
    y_ref, aux_ref = ran[0][layout]
    got = _case(ran, layout)
    for y, aux, over in got:
        assert float(np.abs(y - y_ref).max()) < 1e-4
        assert abs(aux - aux_ref) < 1e-5
        assert over is not None and "1,024 tokens" in over
    for y, _, _ in got[1:]:
        np.testing.assert_array_equal(y, got[0][0])


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_moe_model_decode_on_2x2_matches_jax_unsharded(ran, arch):
    ref = ran[0][arch]
    scale = float(np.abs(ref).max())
    for r in _case(ran, arch):
        assert float(np.abs(r - ref).max()) / scale < 5e-5
