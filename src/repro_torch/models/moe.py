"""Mixture-of-Experts MLP of the port — ``repro.models.moe``: GShard top-k
routing with per-expert capacity and a Switch load-balancing loss, SwiGLU
experts.

Routing is computed per *group* of at most ``group_size`` tokens of the
batch-major flattened ``[Bt, S, D]`` input, as in the reference:

  probs     = softmax(x @ router), float32            [G, T, E]
  top-k     of probs per token (ties to the lower expert index, as
            ``lax.top_k`` breaks them), the k gates renormalised by
            their sum (floored at 1e-9)
  aux       = E * mean_g(sum_e mean_t(probs) * mean_t(onehot(top-1)))
  capacity  = max(k, ceil(group * k * capacity_factor / E)) slots an
            expert, handed out SLOT-MAJOR: every token's first choice
            before any token's second choice, each in token order (an
            exclusive running count); a choice past its expert's
            capacity is dropped (combine weight 0)

``_routing`` returns the reference's dense ``dispatch`` / ``combine``
``[G, T, E, C]`` tensors; ``moe_mlp`` takes the same routing in its
compact form (each token's k experts, slots and kept flags) and copies
the token rows into the expert inputs ``[E, G * C, D]`` (zero rows in
empty slots), which is bit for bit the reference's one-hot dispatch
einsum, and combines each token's kept slots with the gates rounded to
the activation dtype (as the reference's ``combine.astype(x.dtype)``),
summed in float32 and rounded once, as a matmul accumulates.  The expert
SwiGLU runs in the activation dtype.  The probabilities are a float64
softmax rounded to float32, and the gates' sum is added in slot order,
so the card routes with the CPU's bits (a float32 softmax's exp and sums
differ between the two by an ulp, which is enough to flip a near tie);
the reference's float32 softmax is within two float32 ulps of them.

No kernel is written for this module: the reference computes the
experts as einsums outside any Pallas kernel (``src/repro/kernels/``
has no MoE function), so the expert products are ``torch.bmm``.

Under a mesh (``models/sharding.py``), ``moe_mlp`` takes the reference's
``moe_decode_shardmap`` at up to 1,024 tokens where the rule table's
axes divide the weights (``_shardmap_eligible``): the tokens are
replicated and routed alike on every rank, each rank contracts its
resident (D-slice x F-slice) blocks of its experts, and only
capacity-sized float32 partials cross the mesh.  Both expert layouts run
it: EP (experts over the model axis, moonshot) and TP (the per-expert ff
over it, grok).  Past 1,024 tokens, or where the axes do not divide,
the reference lets GSPMD partition the grouped einsums; the port
refuses that (a later slice of the mesh).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import collectives as col
from repro_torch.models.layers import dense_init
from repro_torch.models.sharding import current_mesh, current_rules, param_spec

# an MoE block's leaves the JAX init makes float32 whatever the params'
# dtype (``convert.py`` keeps them so)
MOE_FLOAT32_LEAVES = ("router",)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """``{router [D, E] float32, wg, wu [E, D, F], wd [E, F, D]}``: the
    reference's shapes and scales (N(0, 1/fan_in)), drawn from ``gen``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dtype = getattr(torch, cfg.param_dtype)

    def init(di, do):
        w = torch.randn((e, di, do), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w / math.sqrt(di)).to(dtype)

    return {"router": dense_init(gen, d, e, torch.float32),
            "wg": init(d, f), "wu": init(d, f), "wd": init(f, d)}


def capacity(group: int, cfg: ModelConfig) -> int:
    """Slots an expert takes in a group of ``group`` tokens."""
    k, e = cfg.top_k, cfg.n_experts
    return max(k, int(math.ceil(group * k * cfg.capacity_factor / e)))


def _route(logits: torch.Tensor, top_k: int, capacity: int):
    """Compact routing of ``logits`` [G, T, E]: (expert [G, T, K] long,
    slot [G, T, K] long, kept [G, T, K] bool, gates [G, T, K] float32,
    aux scalar float32)."""
    g, t, e = logits.shape
    # the float32 probabilities rounded from a float64 softmax, and the
    # gates' sum added in slot order: the same bits on the card and the
    # CPU (float32 exp and reductions differ between the two by an ulp)
    probs = torch.softmax(logits.double(), dim=-1).float()
    # a stable descending sort keeps equal probabilities in expert order:
    # lax.top_k's tie order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = vals[..., :top_k], idx[..., :top_k]
    total = gates[..., 0]
    for j in range(1, top_k):
        total = total + gates[..., j]
    gates = gates / torch.clamp(total, min=1e-9)[..., None]
    me = probs.mean(dim=1)                                     # [G, E]
    ce = F.one_hot(expert[..., 0], e).float().mean(dim=1)
    aux = (me * ce).sum(-1).mean() * e
    # slot-major priority: the exclusive running count of each choice's
    # expert over [slot 0 of every token, slot 1 of every token, ...]
    oh = F.one_hot(expert.transpose(1, 2).reshape(g, top_k * t), e)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)        # [G, K*T]
    slot = pos.reshape(g, top_k, t).transpose(1, 2)            # [G, T, K]
    return expert, slot, slot < capacity, gates, aux


def _routing(logits: torch.Tensor, top_k: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_routing``: (dispatch [G, T, E, C] float32 0/1,
    combine [G, T, E, C] float32 gates of the kept choices, aux)."""
    g, t, e = logits.shape
    expert, slot, kept, gates, aux = _route(logits, top_k, capacity)
    dispatch = torch.zeros((g, t, e, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    gi, ti, ki = torch.nonzero(kept, as_tuple=True)
    ei, ci = expert[gi, ti, ki], slot[gi, ti, ki]
    dispatch[gi, ti, ei, ci] = 1.0
    combine[gi, ti, ei, ci] = gates[gi, ti, ki]
    return dispatch, combine, aux


def check_grouping(tokens: int, group_size: int = 512) -> int:
    """The group size ``moe_mlp`` takes for ``tokens`` tokens, ``min(
    group_size, tokens)``; raises ``ValueError`` where the reference
    asserts: more tokens than one group that are no multiple of it."""
    gsz = min(group_size, tokens)
    if tokens % gsz:
        raise ValueError(
            f"moe_mlp: {tokens} tokens are no multiple of the routing "
            f"group of {gsz} (groups of min({group_size}, tokens) tokens; "
            "the reference asserts tokens % group == 0)")
    return gsz


def moe_decode_shardmap(params: Dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's explicit-SPMD MoE for small-token (decode) steps.

    x [Bt, S, D] is every token, the same on every rank; ``params`` hold
    this rank's blocks of the expert weights (cut as ``sharding.
    param_spec`` says; the router is gathered whole).  Every rank routes
    all tokens in one group (the float64-then-float32 softmax: the same
    bits everywhere), copies the kept choices into its experts' inputs
    ``[E_l, C, D_l]``, contracts its resident blocks, and the partials
    meet as in the reference: a sum over ``w_embed``'s axis for the
    up-projections, over ``expert_ff``'s for the down-projection, over
    ``experts``' for the combine, then a tiled gather over ``w_embed``'s
    axis.  Returns ([Bt, S, D], aux)."""
    mesh, rules = current_mesh(), current_rules()
    bt, s, d = x.shape
    e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff
    t = bt * s
    xt = x.reshape(t, d)
    cap = capacity(t, cfg)

    def ax(a):
        return col.axes_of(a if isinstance(a, str) else None, mesh)

    d_ax, e_ax, f_ax = ax(rules.w_embed), ax(rules.experts), \
        ax(rules.expert_ff)

    def resident(name, shape, want):
        have = param_spec("blocks/moe/" + name, (1,) + shape, cfg, mesh,
                          rules)[1:]
        return col.reshard(params[name], have, want, mesh)

    router = resident("router", (d, e), (None, None))
    wg = resident("wg", (e, d, f), (e_ax, d_ax, f_ax))
    wu = resident("wu", (e, d, f), (e_ax, d_ax, f_ax))
    wd = resident("wd", (e, f, d), (e_ax, f_ax, d_ax))
    e_n, d_n = col.axis_size(e_ax, mesh), col.axis_size(d_ax, mesh)
    el, dl = e // e_n, d // d_n
    e0 = col.axis_index(e_ax, mesh) * el
    logits = xt.float() @ router                              # [T, E]
    expert, slot, kept, gates, aux = _route(logits[None], k, cap)
    expert, slot, kept, gates = expert[0], slot[0], kept[0], gates[0]
    # dispatch: this rank's experts' rows of the reference's one-hot
    # einsum, cut to its D-slice
    n_rows = el * cap
    rows = (expert - e0) * cap + slot                         # [T, K]
    mine = kept & (expert >= e0) & (expert < e0 + el)
    dest = torch.where(mine, rows, n_rows).reshape(-1)
    xs = col.local_slice(xt, d_ax, 1, mesh)
    src = xs[:, None].expand(t, k, dl).reshape(-1, dl)
    ein = xs.new_zeros((n_rows + 1, dl)).index_copy(0, dest, src)
    ein = ein[:n_rows].view(el, cap, dl)
    h_g, h_u = col.psum_many([torch.bmm(ein, wg).float(),
                              torch.bmm(ein, wu).float()], d_ax, mesh)
    h = (F.silu(h_g) * h_u).to(x.dtype)                       # [E_l, C, F_l]
    eout = col.psum(torch.bmm(h, wd).float(), f_ax, mesh)     # [E_l, C, D_l]
    # combine: float32 gates of this rank's kept choices
    w = torch.where(mine, gates, 0.0)                         # [T, K]
    picked = eout.reshape(n_rows, dl)[torch.where(mine, rows, 0)]
    y = col.psum((w[..., None] * picked).sum(dim=1), e_ax, mesh)
    y = col.all_gather(y, d_ax, 1, mesh)
    return y.to(x.dtype).reshape(bt, s, d), aux


def _shardmap_eligible(cfg: ModelConfig) -> bool:
    mesh = current_mesh()
    if mesh is None:
        return False
    rules = current_rules()
    for dim, ax in ((cfg.d_model, rules.w_embed),
                    (cfg.n_experts, rules.experts),
                    (cfg.d_ff, rules.expert_ff)):
        if isinstance(ax, str) and ax in mesh.shape \
                and dim % mesh.shape[ax] != 0:
            return False
    return True


def moe_mlp(params: Dict, x: torch.Tensor, cfg: ModelConfig,
            group_size: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [Bt, S, D] -> ([Bt, S, D], aux float32 scalar)."""
    bt, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = bt * s
    if current_mesh() is not None:
        if tokens <= 1024 and _shardmap_eligible(cfg):
            return moe_decode_shardmap(params, x, cfg)
        raise NotImplementedError(
            f"{cfg.name}: MoE on a mesh past 1,024 tokens, or where the "
            "rule table's axes do not divide the expert weights (the "
            "reference's GSPMD-partitioned grouped dispatch) is queued for "
            "a later slice of the mesh (ROADMAP.md)")
    gsz = check_grouping(tokens, group_size)
    g = tokens // gsz
    cap = capacity(gsz, cfg)
    xg = x.reshape(g, gsz, d)
    logits = xg.float() @ params["router"]                     # [G, T, E]
    expert, slot, kept, gates, aux = _route(logits, k, cap)
    # dispatch: each kept choice's token row copied into its slot of the
    # expert inputs [E, G*C, D]; dropped choices land in one extra row,
    # cut off after (no host sync, no data-dependent shape)
    n_rows = e * g * cap
    rows = (expert * g + torch.arange(g, device=x.device)[:, None, None]) \
        * cap + slot                                           # [G, T, K]
    dest = torch.where(kept, rows, n_rows).reshape(-1)
    src = xg[:, :, None].expand(g, gsz, k, d).reshape(-1, d)
    ein = x.new_zeros((n_rows + 1, d)).index_copy(0, dest, src)
    ein = ein[:n_rows].view(e, g * cap, d)
    h = F.silu(torch.bmm(ein, params["wg"])) * torch.bmm(ein, params["wu"])
    eout = torch.bmm(h, params["wd"]).reshape(n_rows, d)
    # combine: each token's kept slots, gates rounded to the activation
    # dtype, summed in float32
    w = torch.where(kept, gates.to(x.dtype).float(), 0.0)      # [G, T, K]
    picked = eout[torch.where(kept, rows, 0)].float()          # [G, T, K, D]
    y = (w[..., None] * picked).sum(dim=2).to(x.dtype)
    return y.reshape(bt, s, d), aux
