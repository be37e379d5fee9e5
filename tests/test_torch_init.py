"""``Model.init`` writes every layer's draw into stacks allocated once
(no list of per-layer trees held beside the stacks).  The generator's
draws keep their order, so the weights a seed gives are unchanged: here
they equal ``torch.stack`` of a fresh list of per-layer draws from the
same seed, on the reduced dense, SSM and VLM configs (the VLM's blocks
``[units, per, ...]`` and cross blocks ``[units, ...]``, drawn after all
dense blocks)."""
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init
from repro_torch.models.model import build
from repro_torch.tree import tree_leaves, tree_map


def _stack(trees, lead=None):
    out = tree_map(lambda *ts: torch.stack(ts), *trees)
    if lead is None:
        return out
    return tree_map(lambda t: t.reshape(lead + t.shape[1:]), out)


def _list_draws(cfg, seed):
    """The weights as the port drew them before stacks were allocated
    once: every layer's tree in a list, then ``torch.stack``."""
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    params = {"embed": dense_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  scale=1.0)}
    if cfg.cross_attn_every:
        units, per = cfg.n_layers // cfg.cross_attn_every, \
            cfg.cross_attn_every - 1
        params["blocks"] = _stack([tfm.init_block(gen, cfg)
                                   for _ in range(units * per)], (units, per))
        params["cross"] = _stack([tfm.init_cross_block(gen, cfg)
                                  for _ in range(units)])
    else:
        params["blocks"] = _stack([tfm.init_block(gen, cfg)
                                   for _ in range(cfg.n_layers)])
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype)
    params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return params


@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", {}), ("mamba2-780m", {}),
    ("llama-3.2-vision-90b", dict(n_layers=6, cross_attn_every=3))])
def test_init_draws_the_stacked_list_values(arch, kw):
    cfg = get_config(arch).scaled(**kw)
    got = build(cfg, device="cpu").init(torch.Generator().manual_seed(7))
    want = _list_draws(cfg, 7)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), got) \
        == tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))
