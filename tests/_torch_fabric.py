"""Shared pieces of the port's live-fabric twins
(``test_torch_fabric.py``, ``test_torch_combined_fabric.py``,
``test_torch_fault.py``).

``torch_fabric`` builds the port's fabric on the CPU from the weights the
JAX package's ``build_fabric`` draws for the reduced qwen1.5-0.5b (params
key ``seed``, the co-training adapter key ``seed + 1``, tenants from
``make_tenant_adapters(seed=seed + 1)``), carried across by
``convert.py`` and assembled by ``fabric_from_weights``, the function the
port's ``build_fabric`` assembles with.  ``reference`` is
``conftest.reference_greedy`` on the JAX model with the matching JAX tree,
each JAX method under ``jax.jit`` (the same programs, compiled once per
shape)."""
import functools

import jax
import numpy as np

from conftest import reference_greedy
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.runtime.fabric import make_tenant_adapters as jax_tenants
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.runtime.fabric import fabric_from_weights

ARCH = "qwen1.5-0.5b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_weights(seed=0, n_adapters=0):
    """(JAX model, params, co-training adapter, tenant trees) as the JAX
    ``build_fabric`` draws them."""
    jeng = jax_make_engine(jax_config(ARCH).scaled(), lr=3e-3)
    model = jeng.model
    params = model.init(jax.random.key(seed))
    lora = model.init_lora(jax.random.key(seed + 1))
    tenants = jax_tenants(model, n_adapters, seed=seed + 1) \
        if n_adapters else []
    return model, params, lora, tenants


@functools.lru_cache(maxsize=None)
def torch_engine():
    return make_engine(get_config(ARCH).scaled(), lr=3e-3, device="cpu")


def torch_weights(seed=0, n_adapters=0):
    """The port's copies of ``jax_weights``: (engine, params, lora,
    tenant trees), fresh tensors on every call."""
    _, jp, jlora, jten = jax_weights(seed, n_adapters)
    eng = torch_engine()
    return (eng, params_from_numpy(eng.model.cfg, _np(jp), "cpu"),
            lora_from_numpy(_np(jlora), "cpu"),
            [lora_from_numpy(_np(t), "cpu") for t in jten])


def torch_fabric(n_replicas, *, seed=0, n_adapters=0, **kw):
    """The port's fabric of ``n_replicas`` on the CPU over
    ``jax_weights``; returns (fabric, port config)."""
    eng, params, lora, tenants = torch_weights(seed, n_adapters)
    fab = fabric_from_weights(eng, params, lora, n_replicas, seed=seed,
                              tenant_trees=tenants, **kw)
    return fab, eng.model.cfg


class _Jitted:
    def __init__(self, model):
        self.init_caches = model.init_caches
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.write_prefill_slot = jax.jit(model.write_prefill_slot,
                                          static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _jitted(seed, n_adapters):
    return _Jitted(jax_weights(seed, n_adapters)[0])


@functools.lru_cache(maxsize=None)
def _reference(seed, n_adapters, tenant, prompt_bytes, n_new):
    _, params, lora, tenants = jax_weights(seed, n_adapters)
    tree = lora if tenant is None else tenants[tenant]
    return reference_greedy(_jitted(seed, n_adapters), params, tree,
                            np.frombuffer(prompt_bytes, np.int32), n_new)


def reference(prompt, n_new, *, seed=0, n_adapters=0, tenant=None):
    """Greedy tokens of the JAX model with the co-training adapter, or
    with tenant ``tenant``'s tree (cached)."""
    return _reference(seed, n_adapters, tenant,
                      np.asarray(prompt, np.int32).tobytes(), n_new)
