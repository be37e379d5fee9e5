"""The three dense configs the port registers beside qwen1.5-0.5b
(``qwen3-14b``, ``internlm2-1.8b``, ``llama3-8b``), float32 on the CPU at
their ``.scaled()`` size:

* ``get_config`` resolves each id, and every field equals the JAX
  config's (the port's files are copies; ``mamba2-780m`` and the two
  MoE configs too, whose models are tested in ``test_torch_mamba2.py``
  and ``test_torch_moe.py``);
* a torch twin of ``tests/test_decode_parity.py``: incremental decode
  over the contiguous cache reproduces the full-sequence forward within
  5e-5 of the largest logit;
* the port's full-sequence logits against the JAX model's on the same
  weights (``repro_torch.convert``), within 5e-5 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.model import build as jax_build
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.models.model import build
from test_torch_model import numpy_lora

DENSE = ["qwen3-14b", "internlm2-1.8b", "llama3-8b"]
LOGIT_REL = 5e-5


def _fields(cfg):
    """A config's fields with enums as their values (the two packages
    have their own ``Family``)."""
    out = dataclasses.asdict(cfg)
    out["family"] = cfg.family.value
    return out


@pytest.mark.parametrize("arch", DENSE + ["mamba2-780m",
                                          "moonshot-v1-16b-a3b",
                                          "grok-1-314b"])
def test_config_is_the_jax_config(arch):
    assert arch in ARCH_IDS
    assert _fields(get_config(arch)) == _fields(jax_config(arch))
    assert _fields(get_config(arch).scaled()) \
        == _fields(jax_config(arch).scaled())


def test_llama3_8b_published_widths():
    cfg = get_config("llama3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta) \
        == (32, 4096, 32, 8, 128, 14336, 128256, 5e5)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    jcfg = jax_config(request.param).scaled()
    tcfg = get_config(request.param).scaled()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(1))
    lora_np = numpy_lora(jcfg)
    tm = build(tcfg, device="cpu")
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return ((jm, jp, jax.tree.map(jnp.asarray, lora_np)),
            (tm, tp, lora_from_numpy(lora_np, "cpu")))


def _tokens(cfg, b=2, s=20):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


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
    assert worst / (float(full.abs().max()) + 1e-6) < LOGIT_REL


def test_logits_match_jax(pair):
    (jm, jp, jlora), (tm, tp, tlora) = pair
    toks = _tokens(tm.cfg)
    want = np.asarray(jm.logits(jp, jlora, {"tokens": jnp.asarray(toks)}))
    got = tm.logits(tp, tlora, {"tokens": torch.from_numpy(toks).long()})
    err = np.max(np.abs(got.detach().numpy() - want)) / np.max(np.abs(want))
    assert err < LOGIT_REL
