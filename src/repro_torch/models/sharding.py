"""Logical-axis sharding rules of the port — ``repro.models.sharding``'s
tables, MaxText-style: a ``ShardingRules`` table maps each *logical*
tensor axis name ("batch", "heads", "w_embed", ...) to a mesh axis (or a
tuple of axes, or None).

A spec is the port's own tuple, one entry per tensor dim (None, an axis
name, or a tuple of axis names), in place of a JAX ``PartitionSpec``.
Outside a ``sharding_context`` (no mesh) every spec is empty and the
model runs unsharded, as in the reference.

The port runs a mesh as eager SPMD: one process per rank, each holding
its local slice of every sharded tensor, with explicit collectives
(``models/collectives.py``) where the reference lets GSPMD insert them.
So ``shard`` (the reference's ``with_sharding_constraint``) is the
identity on the local tensor, and ``shard_map_compat`` has no
counterpart: every rank runs the body itself.

The second half holds the reference's ``repro.launch.mesh`` tables:
``rules_for`` adapts the rule table per architecture x step kind (archs
whose head counts don't divide the model axis fall back to sequence
sharding for attention balance, which the port refuses:
``models/transformer.py``; GQA caches too big for batch sharding alone
shard their sequence dim; training enables sequence-parallel residual
activations), and ``param_shardings`` / ``batch_shardings`` map the
port's trees (parameters, adapters, caches, batches; nested dicts whose
paths are the reference's, ``blocks/attn/wq``, ``kv/0``) to
``MeshSharding``s by tree path: the table the model, ``init_sharded``,
``launch.mesh.shard_tree`` / ``gather_tree`` and the checkpoint restore
share.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.models import collectives

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of axes, or None)."""
    batch: Axis = ("pod", "data")     # activation batch
    seq: Axis = None                  # sequence (generic)
    act_seq: Axis = None              # residual-stream seq (Megatron-SP)
    q_seq: Axis = None                # attention query seq (head fallback)
    embed: Axis = None                # activation d_model
    heads: Axis = "model"             # attention heads (TP)
    kv_heads: Axis = "model"
    head_dim: Axis = None
    ff: Axis = "model"                # MLP hidden (TP)
    vocab: Axis = "model"             # embedding/logits vocab (TP)
    experts: Axis = "model"           # MoE expert axis (EP)
    expert_ff: Axis = None            # MoE per-expert ff (TP for grok)
    capacity: Axis = None
    layers: Axis = None               # stacked-layer leading axis
    # weight FSDP axes (sharding of the non-TP dim of weights):
    w_embed: Axis = "data"            # d_model dim of weight matrices
    w_ff_in: Axis = "data"            # input dim of down-proj etc.
    conv: Axis = None
    ssm_inner: Axis = "model"         # d_inner of SSD mixer
    ssm_state: Axis = None
    ssm_heads: Axis = "model"
    lora_rank: Axis = None
    kv_batch: Axis = ("pod", "data")  # KV-cache batch
    kv_seq: Axis = None

    def resolve(self, *names: Optional[str]) -> Spec:
        return tuple(None if n is None else getattr(self, n) for n in names)


# Presets -------------------------------------------------------------------
RULES_TP_FSDP = ShardingRules()                       # default: TP + FSDP
RULES_TP_ONLY = dataclasses.replace(
    RULES_TP_FSDP, w_embed=None, w_ff_in=None)        # pure TP (replicated DP)
RULES_FSDP_HEAVY = dataclasses.replace(               # FSDP on both weight dims
    RULES_TP_FSDP, w_embed=("pod", "data"), w_ff_in=("pod", "data"))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules = RULES_TP_FSDP


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[ShardingRules] = None):
    """Activate a mesh (``models.collectives.Mesh``) and a rule table for
    the model code under it."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> ShardingRules:
    return _CTX.rules


def _axes(entry: Axis) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _filter_spec(spec: Spec, mesh, shape) -> Spec:
    """Drop mesh axes whose size does not divide the tensor dim (keeps
    the rules robust for dims like 25 heads or 8 experts on a 16-way
    axis).  ``mesh`` is anything with a ``shape`` dict of axis sizes."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        size = 1
        kept = []
        for a in _axes(entry):
            if a in mesh.shape and dim % (size * mesh.shape[a]) == 0:
                kept.append(a)
                size *= mesh.shape[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def logical_spec(shape, *names: Optional[str]) -> Spec:
    """Resolve logical names to a spec under the current context."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return ()
    return _filter_spec(rules.resolve(*names), mesh, shape)


def shard(x, *names: Optional[str]):
    """The reference's sharding constraint by logical axis names.  In the
    port's eager SPMD each rank already holds its local slice, laid out
    by the code that made it, so this is the identity on the local
    tensor (with or without a mesh)."""
    return x


# ------------------------------------------------------------ tables ----
def rules_for(cfg: ModelConfig, mesh, kind: str,
              base: Optional[ShardingRules] = None) -> ShardingRules:
    """Pick the rule table for (arch x step kind) on this mesh (anything
    with a ``shape`` dict of axis sizes)."""
    rules = base or RULES_TP_FSDP
    model_n = mesh.shape.get("model", 1)
    upd = {}
    if kind == "train":
        # sequence-parallel residual stream
        upd["act_seq"] = "model"
    if cfg.n_heads % model_n != 0:
        # 25/40-head archs: heads can't split the model axis — balance
        # attention by sharding the query sequence dim instead
        upd["heads"] = None
        upd["kv_heads"] = None
        upd["q_seq"] = "model"
    if cfg.n_kv_heads % model_n != 0:
        # GQA caches too big for batch sharding alone: shard the cache
        # sequence dim
        upd["kv_seq"] = "model"
    if cfg.family is Family.MOE:
        if cfg.moe_shard == "ep" and cfg.n_experts % model_n == 0:
            upd["experts"] = "model"
            upd["expert_ff"] = None
        else:  # grok: 8 experts on a 16-way axis -> per-expert ff TP
            upd["experts"] = None
            upd["expert_ff"] = "model"
    return dataclasses.replace(rules, **upd)


# --------------------------------------------------------------------------
# path -> logical axes for every parameter in the model tree
# --------------------------------------------------------------------------
_PARAM_TABLE = [
    # (path regex, logical axes EXCLUDING stacked leading dims)
    (r"embed$", ("vocab", "w_embed")),
    (r"lm_head$", ("w_embed", "vocab")),
    (r"final_norm$", ()),
    (r"attn/w[qkv]$", ("w_embed", "heads")),
    (r"attn/wo$", ("heads", "w_embed")),
    (r"attn/b[qkv]$", ("heads",)),
    (r"attn/[qk]_norm$", ()),
    (r"mlp/w[gu]$", ("w_embed", "ff")),
    (r"mlp/wd$", ("ff", "w_embed")),
    (r"moe/router$", ("w_embed", None)),
    (r"moe/w[gu]$", ("experts", "w_embed", "expert_ff")),
    (r"moe/wd$", ("experts", "expert_ff", "w_embed")),
    (r"ssm/in_proj$", ("w_embed", "ssm_inner")),
    (r"ssm/out_proj$", ("ssm_inner", "w_embed")),
    (r"ssm/conv_w$", (None, "ssm_inner")),
    (r"ssm/conv_b$", ("ssm_inner",)),
    (r"ssm/(A_log|D_skip|dt_bias)$", ()),
    (r"ssm/norm$", ("ssm_inner",)),
    (r"ln[12]$", ()),
    (r"gate_(attn|mlp)$", ()),
    # LoRA adapters + optimizer state over them: tiny, replicated
    (r"(^|/)(a|b)$", None),
]


def _leading(path: str, cfg: ModelConfig) -> int:
    if path.startswith("blocks/"):
        return 2 if cfg.family is Family.VLM else 1
    if path.startswith("cross/"):
        return 1
    return 0


def logical_axes_for(path: str, ndim: int, cfg: ModelConfig
                     ) -> Tuple[Optional[str], ...]:
    lead = _leading(path, cfg)
    for pat, axes in _PARAM_TABLE:
        if re.search(pat, path):
            if axes is None:
                return (None,) * ndim
            out = (None,) * lead + tuple(axes)
            if len(out) < ndim:            # defensive: pad with None
                out = out + (None,) * (ndim - len(out))
            return out[:ndim]
    return (None,) * ndim


def _resolve(rules: ShardingRules, names, shape, mesh) -> Spec:
    spec = _filter_spec(rules.resolve(*names), mesh, shape)
    # drop duplicate mesh-axis usage across dims (illegal in XLA)
    seen = set()
    out = []
    for entry in spec:
        kept = tuple(a for a in _axes(entry) if a not in seen)
        seen.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A whole tensor's layout on a mesh: ``spec`` names the axes each
    dim is cut along (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(n // collectives.axis_size(e, self.mesh)
                     for n, e in zip(shape, self.spec))

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``whole`` (a view)."""
        for d, e in enumerate(self.spec):
            whole = collectives.local_slice(whole, e, d, self.mesh)
        return whole

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective)."""
        for d, e in enumerate(self.spec):
            part = collectives.all_gather(part, e, d, self.mesh)
        return part


def _map_paths(fn: Callable[[str, Any], Any], tree: Any,
               prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_spec(path: str, shape, cfg: ModelConfig, mesh,
               rules: ShardingRules) -> Spec:
    """The spec of the parameter (or adapter) leaf at ``path`` of whole
    shape ``shape``."""
    return _resolve(rules, logical_axes_for(path, len(shape), cfg), shape,
                    mesh)


def param_shardings(tree: Any, cfg: ModelConfig, mesh,
                    rules: ShardingRules) -> Any:
    """A tree of ``MeshSharding`` for a params or adapter tree of whole
    shapes (tensors, ``meta`` tensors, or anything with ``shape``)."""
    return _map_paths(lambda path, leaf: MeshSharding(
        mesh, param_spec(path, tuple(leaf.shape), cfg, mesh, rules)), tree)


# --------------------------------------------------------------- batches --
_BATCH_TABLE = [
    (r"tokens$|labels$|mask$|token$", ("batch", None)),
    (r"embeds$|vision$", ("batch", None, None)),
    (r"pos$", ()),
    # caches (leading dims added below by _leading-style logic)
    (r"kv/[01]$", ("kv_batch", "kv_seq", "kv_heads", None)),
    (r"cross_kv/[01]$", ("kv_batch", None, "kv_heads", None)),
    (r"ssm/conv$", ("kv_batch", None, "ssm_inner")),
    (r"ssm/state$", ("kv_batch", "ssm_heads", None, None)),
]


def batch_spec(path: str, shape, mesh, rules: ShardingRules) -> Spec:
    """The spec of the batch or cache leaf at ``path`` of whole shape
    ``shape``."""
    ndim = len(shape)
    names: Tuple[Optional[str], ...] = (None,) * ndim
    for pat, axes in _BATCH_TABLE:
        if re.search(pat, path):
            lead = ndim - len(axes)
            names = ((None,) * max(lead, 0) + tuple(axes))[:ndim]
            break
    return _resolve(rules, names, shape, mesh)


def batch_shardings(tree: Any, cfg: ModelConfig, mesh,
                    rules: ShardingRules) -> Any:
    """A tree of ``MeshSharding`` for a batch or cache tree of whole
    shapes."""
    return _map_paths(lambda path, leaf: MeshSharding(
        mesh, batch_spec(path, tuple(leaf.shape), mesh, rules)), tree)
