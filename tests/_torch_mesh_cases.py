"""Rank bodies of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_mesh_moe.py``): module-level functions that
``repro_torch.launch.mesh.spawn_ranks`` runs on every rank of a CPU mesh
(gloo).  This module imports the port alone, so the spawned ranks never
load JAX; the tests compute the JAX references in their own process and
hand them numpy inputs."""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.launch.mesh import (
    gather_tree, make_mesh, shard_tree, spawn_ranks,
)
from repro_torch.models.model import build
from repro_torch.models.moe import moe_mlp
from repro_torch.models.sharding import (
    RULES_TP_ONLY, MeshSharding, ShardingRules, param_shardings, param_spec,
    rules_for, sharding_context,
)
from repro_torch.runtime.elastic import elastic_restore, shardings_for
from repro_torch.runtime.serving_loop import (
    ContinuousBatcher, GenRequest, static_batch_serve,
)
from repro_torch.tree import tree_map

FORCED_KV_SEQ = dataclasses.replace(ShardingRules(), kv_seq="model",
                                    kv_batch="data")


def start_ranks(fn, payload, store_dir: str):
    """``spawn_ranks(fn, (2, 2), backend="gloo", ...)`` on a thread, so
    the test computes its JAX references while the ranks run; returns a
    function that waits for the ranks' results (or raises what the spawn
    raised)."""
    out = {}

    def run():
        try:
            out["ranks"] = spawn_ranks(fn, (2, 2), backend="gloo",
                                       store_dir=store_dir,
                                       device_type="cpu", args=(payload,),
                                       timeout_s=300)
        except BaseException as e:           # re-raised by the waiter
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["ranks"]

    return wait


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def scaled(arch: str, **kw) -> ModelConfig:
    return get_config(arch).scaled(**kw)


def _local(cfg, mesh, rules, np_params, np_lora):
    params = params_from_numpy(cfg, np_params, "cpu")
    local = shard_tree(params, param_shardings(params, cfg, mesh, rules))
    return local, lora_from_numpy(np_lora, "cpu")


def _decode(mesh, cfg, rules, np_params, np_lora, tokens):
    """Every step's logits of a lock-step decode of ``tokens`` [B, S]
    under ``rules``, positions 0 .. S-1 (a scalar position a step)."""
    model = build(cfg, "cpu")
    with sharding_context(mesh, rules):
        params, lora = _local(cfg, mesh, rules, np_params, np_lora)
        b, s = tokens.shape
        caches = model.init_caches(b, s)
        toks = torch.as_tensor(tokens, dtype=torch.long)
        out = []
        with torch.no_grad():
            for t in range(s):
                lg, caches = model.decode_step(params, lora, caches,
                                               toks[:, t:t + 1], t)
                out.append(_np(lg))
    return np.stack(out)


def _serve(mesh, cfg, rules, np_params, np_lora, prompts, gens, prompt_pad,
           max_seq):
    model_tokens = []
    with sharding_context(mesh, rules):
        params, lora = _local(cfg, mesh, rules, np_params, np_lora)
        engine = make_engine(cfg, device="cpu")
        with torch.no_grad():
            logits, _ = engine.model.prefill_ragged(
                params, lora,
                {"tokens": torch.as_tensor(_pad(prompts, prompt_pad))},
                torch.as_tensor([len(p) for p in prompts]))
        reqs = [GenRequest(request_id=i, prompt=np.asarray(p).copy(),
                           max_new_tokens=g)
                for i, (p, g) in enumerate(zip(prompts, gens))]
        static_batch_serve(engine, params, lora, reqs,
                           batch_size=len(prompts), prompt_pad=prompt_pad,
                           max_seq=max_seq)
        model_tokens = [list(r.tokens) for r in reqs]
    return _np(logits), model_tokens


def _pad(prompts, prompt_pad: int) -> np.ndarray:
    out = np.zeros((len(prompts), prompt_pad), np.int64)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = p
    return out


def _restore(mesh, cfg, ckpt_dir: str, out_dir: str):
    """A whole checkpoint onto this 2 x 2 mesh (each rank's blocks against
    the whole leaves cut locally), written back whole from the mesh,
    then restored onto a 1 x 4 mesh of the same ranks (``elastic_
    restore``) and gathered whole."""
    rules = rules_for(cfg, mesh, "decode")
    template = tree_map(lambda t: t.to("meta"), build(cfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    whole, _ = Checkpointer(ckpt_dir).restore(template, device="cpu")
    shd = param_shardings(template, cfg, mesh, rules)
    mine, extra = Checkpointer(ckpt_dir).restore(template, device="cpu",
                                                 shardings=shd)
    blocks_ok = all(torch.equal(m, s.local(w)) and m.shape != w.shape
                    or torch.equal(m, w) for m, s, w in zip(
                        _leaves(mine), _leaves(shd), _leaves(whole)))
    back = gather_tree(mine, shd)
    if mesh.rank == 0:
        Checkpointer(out_dir).save(3, back, extra=extra, blocking=True)
    torch.distributed.barrier()
    mesh14 = make_mesh((1, 4), ("data", "model"), "cpu")
    rules14 = rules_for(cfg, mesh14, "decode")

    def spec_fn(key, leaf):
        return param_spec(key, tuple(leaf.shape), cfg, mesh14, rules14)

    mine14, extra14 = elastic_restore(Checkpointer(out_dir), template,
                                      mesh14, spec_fn, device="cpu")
    again = gather_tree(mine14, shardings_for(template, mesh14, spec_fn))
    return {"blocks_ok": blocks_ok, "extra": extra14,
            "n_cut": sum(m.shape != w.shape for m, w in zip(
                _leaves(mine14), _leaves(whole))),
            "whole": {k: _np(v) for k, v in _flat(again).items()}
            if mesh.rank == 0 else None}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _refusals(mesh):
    """Which mesh calls raise ``NotImplementedError`` (a later slice)."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = "refused: " + str(e)

    # a 5-head stack on a 2-way model axis: rules_for moves heads to q_seq
    cfg = scaled("qwen3-14b", n_heads=5, d_model=80)
    rules = rules_for(cfg, mesh, "decode")
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lora = model.init_lora(torch.Generator().manual_seed(1))
    toks = torch.zeros((4, 1), dtype=torch.long)
    with sharding_context(mesh, rules), torch.no_grad():
        caches = model.init_caches(4, 8)
        local = shard_tree(params, param_shardings(params, cfg, mesh, rules))
        attempt("q_seq", lambda: model.decode_step(local, lora, caches, toks,
                                                   0))
    dense = scaled("llama3-8b", n_layers=1, d_model=64, n_heads=8, d_ff=128,
                   vocab_size=256)
    dm = build(dense, "cpu")
    dp = dm.init(torch.Generator().manual_seed(0))
    dl = dm.init_lora(torch.Generator().manual_seed(1))
    drules = rules_for(dense, mesh, "train")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.long),
             "labels": torch.zeros((4, 8), dtype=torch.long),
             "mask": torch.ones((4, 8))}
    with sharding_context(mesh, drules):
        local = shard_tree(dp, param_shardings(dp, dense, mesh, drules))
        attempt("train", lambda: dm.forward_loss(local, dl, batch))
        engine = make_engine(dense, device="cpu")
        attempt("batcher", lambda: ContinuousBatcher(engine, local, dl))
        attempt("paged", lambda: dm.init_paged_caches(8, 4))
    ssm = scaled("mamba2-780m")
    with sharding_context(mesh, rules_for(ssm, mesh, "decode")):
        attempt("ssm", lambda: build(ssm, "cpu").init_caches(4, 8))
    return out


def _init_sharded(mesh, cfg):
    """``init_sharded``'s blocks against the whole ``init`` from the same
    seed, cut locally: bitwise."""
    rules = rules_for(cfg, mesh, "decode")
    model = build(cfg, "cpu")
    whole = model.init(torch.Generator().manual_seed(5))
    mine = model.init_sharded(torch.Generator().manual_seed(5), mesh, rules)
    shd = param_shardings(whole, cfg, mesh, rules)
    return all(torch.equal(m, s.local(w)) for m, s, w in zip(
        _leaves(mine), _leaves(shd), _leaves(whole)))


def mesh_cases(mesh, payload):
    """Every case of ``test_torch_mesh.py`` on this rank: {case: result,
    or the traceback of what it raised}."""
    import traceback
    torch.set_num_threads(1)
    out = {}
    for name, fn, kw in [
            ("decode_rules", _decode_case, dict(table="rules")),
            ("decode_forced", _decode_case, dict(table="forced")),
            ("decode_tp_only", _decode_case, dict(table="tp_only")),
            ("serve_rules", _serve_case, dict(table="rules")),
            ("serve_forced", _serve_case, dict(table="forced")),
            ("long_rules", _serve_case, dict(table="rules", key="long")),
            ("long_forced", _serve_case, dict(table="forced", key="long")),
            ("restore", _restore_case, {}),
            ("init_sharded", _init_case, {}),
            ("refusals", lambda mesh, payload: _refusals(mesh), {})]:
        try:
            out[name] = fn(mesh, payload, **kw)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def _rules(cfg, mesh, table):
    """``rules_for``'s table, the forced kv_seq one, or ``rules_for`` over
    the pure-TP preset (no FSDP cut of the weights)."""
    if table == "forced":
        return FORCED_KV_SEQ
    return rules_for(cfg, mesh, "decode",
                     base=RULES_TP_ONLY if table == "tp_only" else None)


def _decode_case(mesh, payload, table):
    d = payload["decode"]
    cfg = scaled("llama3-8b", **d["cfg"])
    return _decode(mesh, cfg, _rules(cfg, mesh, table), d["params"],
                   d["lora"], d["tokens"])


def _serve_case(mesh, payload, table, key="serve"):
    d = payload[key]
    cfg = scaled("llama3-8b", **d["cfg"])
    return _serve(mesh, cfg, _rules(cfg, mesh, table), d["params"],
                  d["lora"], d["prompts"], d["gens"], d["prompt_pad"],
                  d["max_seq"])


def _restore_case(mesh, payload):
    d = payload["restore"]
    return _restore(mesh, scaled("llama3-8b", **d["cfg"]), d["ckpt"],
                    d["out"])


def _init_case(mesh, payload):
    return _init_sharded(mesh, scaled("llama3-8b",
                                      **payload["restore"]["cfg"]))


# ----------------------------------------------------------------- MoE ----
def _moe_layout(mesh, cfg, rules, np_params, x):
    """``moe_mlp`` on this rank's blocks of whole numpy MoE params, every
    token in: (y, aux)."""
    with sharding_context(mesh, rules):
        local = {}
        for name, arr in np_params.items():
            t = torch.as_tensor(np.asarray(arr))
            spec = param_spec("blocks/moe/" + name, (1,) + t.shape, cfg,
                              mesh, rules)[1:]
            local[name] = MeshSharding(mesh, spec).local(t).clone()
        y, aux = moe_mlp(local, torch.as_tensor(np.asarray(x)), cfg)
        over = None
        try:
            moe_mlp(local, torch.zeros((2, 520, cfg.d_model)), cfg)
        except NotImplementedError as e:
            over = str(e)
    return _np(y), float(aux), over


def moe_cases(mesh, payload):
    """Every case of ``test_torch_mesh_moe.py`` on this rank."""
    import traceback
    torch.set_num_threads(1)
    out = {}
    for name, rules_kw in payload["layouts"].items():
        try:
            cfg = ModelConfig(**payload["cfg"], moe_shard=name)
            rules = dataclasses.replace(ShardingRules(), **rules_kw)
            out[name] = _moe_layout(mesh, cfg, rules,
                                    payload["params"][name], payload["x"])
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    for arch, d in payload["models"].items():
        try:
            cfg = scaled(arch, **d["cfg"])
            out[arch] = _decode(mesh, cfg, rules_for(cfg, mesh, "decode"),
                                d["params"], d["lora"], d["tokens"])
        except Exception:
            out[arch] = {"error": traceback.format_exc()}
    return out
