"""The port's MoE family (``repro_torch.models.moe``, the MoE blocks, the
two configs) against the JAX package on the CPU, float32, every input
made from a seed with numpy:

* ``_routing`` against the reference's on the same logits (E 4, 8 and
  64; k 1, 2 and 6; capacities with and without drops, planted exact
  ties, every token wanting one expert): dispatch equal, combine within
  2^-22 (two float32 ulps of a gate in [0.5, 1)), aux within 1e-6 of
  its magnitude; twins of ``tests/test_lora_moe_ssd.py``'s
  capacity-drop and normalised-weight tests;
* ``moe_mlp`` against the reference's (one jitted program a shape) at
  ``group_size`` 16 and the default 512 over 128, 512 and 1,024 tokens:
  y within 1e-5 of its largest magnitude, aux within 1e-6 of its
  magnitude; each input's
  gap between the k-th and (k+1)-th router probability is printed and
  must exceed 1e-4, so no choice can flip on float32 noise;
* the grouping rule: 992 tokens (more than one group of 512, no
  multiple of it) raise in both packages (the reference asserts);
* ``init_moe``'s shapes, its float32 router, kept float32 by
  ``params_from_numpy``;
* moonshot-v1-16b-a3b and grok-1-314b at ``.scaled()`` (2 layers, 4
  experts, top 2) on the reference's weights: logits within 1e-5,
  ``forward_loss`` (``ce_loss``, ``aux_loss``) and the LoRA gradients
  against ``jax.grad`` (within 1e-4 of each leaf's largest, the dense
  test's bound; the aux loss reaches the q/k/v/o adapters through the
  attention output into the router);
* incremental decode against the full forward under the reference's
  MoE rule (``tests/test_decode_parity.py``: 60% of positions and the
  median within 5e-5; decode bitwise on repeat); paged decode bitwise
  contiguous decode;
* the batcher, against the JAX batcher (greedy tokens; co-training:
  tokens, losses, adapters); ``run_serving`` on the CPU; ``run_training``
  against the JAX trainer, its trajectory held one step at a time as
  ``tests/test_torch_train_cli.py::_walk`` holds it;
* the batcher's bitwise invariants.  Paged equals contiguous bitwise: a
  free slot decodes token 0 at position 0 (the reference's ``_evict``
  leaves it so), the same row in both layouts; but every slot is routed,
  so a free slot's choices take expert capacity and what a neighbouring
  slot feeds can move a request's logits (shown below, in both
  packages).  Chunked against monolithic prefill, a
  suffix over a cached prefix against the full prompt and a mixed
  tenant wave against each tenant alone route other groups of tokens
  (capacity is per group) and are held to the reference's MoE rule
  over each wave's last-position logits."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.launch import train as jax_train
from repro.models import moe as jmoe
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.base import Family
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import run_training, train_from_weights
from repro_torch.models import moe
from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
from repro_torch.tree import tree_map
import test_torch_train_cli as cli
from test_torch_model import numpy_lora

ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]
LOGIT_REL = 1e-5
GRAD_REL = 1e-4
MOE_REL = 5e-5          # tests/test_decode_parity.py's MoE rule
GAP = 1e-4
# the two packages' float32 softmax: exp differs by an ulp and the sum
# over experts runs in another order, so a gate in [0.5, 1) may be two
# ulps (2^-23 each) from the reference's, and aux (up to E) as many ulps
# of its own magnitude
COMBINE_ATOL = 2 ** -22
AUX_REL = 1e-6


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def moe_rule(rels, what):
    """The reference's MoE rule over a list of relative errors: 60% of
    them and the median within MOE_REL."""
    rels = sorted(rels)
    matched = sum(r < MOE_REL for r in rels)
    assert matched >= int(0.6 * len(rels)), f"{what}: {matched}/{len(rels)}"
    assert rels[len(rels) // 2] < MOE_REL, f"{what}: median {rels}"


# --------------------------------------------------------------- routing --
def _logits(g, t, e, seed, kind):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, t, e)) * 2).astype(np.float32)
    if kind == "tie":
        # exact ties across the top-k boundary and inside it
        x[..., 1] = x[..., 3] = x[..., 0]
        x[:, ::2, 5 % e] = x[:, ::2, 0]
    elif kind == "one_expert":
        x[..., 0] = 5.0
        x[..., 1:] = -5.0
    return x


# (G, T, E, k, capacity, kind): E 4 / 8 / 64, k 1 / 2 / 6; moonshot's
# decode (8 slots: C 6), a 512-token group (C 60), grok's 128 train rows
# (C 40), capacities that drop, ties, one wanted expert
ROUTING = {
    "e4_k1_drops": (2, 16, 4, 1, 3, "normal"),
    "e4_k2_no_drops": (2, 16, 4, 2, 32, "normal"),
    "e8_k2_drops": (2, 32, 8, 2, 5, "normal"),
    "e8_k2_grok_train": (1, 128, 8, 2, 40, "normal"),
    "e64_k6_decode": (1, 8, 64, 6, 6, "normal"),
    "e64_k6_drops": (2, 64, 64, 6, 4, "normal"),
    "e64_k6_group_512": (1, 512, 64, 6, 60, "normal"),
    "e8_k2_ties": (2, 16, 8, 2, 3, "tie"),
    "e64_k6_ties": (1, 32, 64, 6, 3, "tie"),
    "e8_k2_one_expert": (1, 16, 8, 2, 4, "one_expert"),
}


# the reference's routing, compiled once a shape
_jax_routing = jax.jit(jmoe._routing, static_argnums=(1, 2))


@pytest.mark.parametrize("name", list(ROUTING))
def test_routing_matches_reference(name):
    g, t, e, k, cap, kind = ROUTING[name]
    logits = _logits(g, t, e, seed=len(name), kind=kind)
    jd, jc, ja = _jax_routing(jnp.asarray(logits), k, cap)
    td, tc, ta = moe._routing(torch.from_numpy(logits), k, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=COMBINE_ATOL)
    assert abs(float(ta) - float(ja)) <= AUX_REL * abs(float(ja))
    if kind == "one_expert":      # only `cap` tokens reach expert 0
        assert td[0, :, 0].sum() == cap


def test_routing_capacity_drops():
    """Twin of tests/test_lora_moe_ssd.py: tokens past an expert's
    capacity are dropped (combine weight 0)."""
    t, cap = 8, 2
    logits = torch.stack([torch.full((t,), 5.0), torch.full((t,), -5.0)],
                         dim=-1)[None]
    dispatch, combine, _ = moe._routing(logits, 1, cap)
    assert float(dispatch[0, :, 0].sum()) == cap
    assert float(combine[0, :, 1].sum()) == 0.0


def test_routing_weights_normalized():
    """Twin of tests/test_lora_moe_ssd.py: each kept token's gates sum to
    one, a dropped token's to zero."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 8)).astype(np.float32))
    _, combine, _ = moe._routing(logits, 3, 16)
    per_token = combine.sum(dim=(2, 3))
    assert bool(((per_token > 0.99) | (per_token == 0.0)).all())


# ---------------------------------------------------------------- moe_mlp -
@functools.lru_cache(maxsize=None)
def _jax_moe(tokens, group_size):
    """The reference's ``moe_mlp``, one jitted program a shape."""
    jcfg = jax_config("moonshot-v1-16b-a3b").scaled()
    return jax.jit(lambda p, x: jmoe.moe_mlp(p, x, jcfg, group_size))


# the inputs' seed: one whose least top-k gap exceeds GAP at every size
# (seed 0's is 2.1e-5 at 512 tokens)
MOE_SEED = 2


def _moe_inputs(tokens, seed=MOE_SEED):
    jcfg = jax_config("moonshot-v1-16b-a3b").scaled()
    jp = jmoe.init_moe(jax.random.key(7), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens // 64, 64, jcfg.d_model)).astype(
        np.float32)
    return jcfg, jp, x


def _topk_gap(x, router, k):
    """The least gap between the k-th and (k+1)-th router probability
    over every token (float64)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) \
        @ np.asarray(router, np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min())


@pytest.mark.parametrize("group_size", [16, 512])
@pytest.mark.parametrize("tokens", [128, 512, 1024])
def test_moe_mlp_matches_reference(tokens, group_size):
    jcfg, jp, x = _moe_inputs(tokens)
    gap = _topk_gap(x, jp.router, jcfg.top_k)
    print(f"tokens {tokens}: least top-{jcfg.top_k} probability gap {gap}")
    assert gap > GAP
    jy, jaux = _jax_moe(tokens, group_size)(jp, jnp.asarray(x))
    cfg = get_config("moonshot-v1-16b-a3b").scaled()
    params = {k: torch.tensor(np.asarray(v)) for k, v in
              jp._asdict().items()}
    ty, taux = moe.moe_mlp(params, torch.from_numpy(x), cfg, group_size)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    assert _rel(ty, jy) < LOGIT_REL
    assert abs(float(taux) - float(jaux)) <= AUX_REL * abs(float(jaux))


def test_grouping_rule_raises_where_the_reference_asserts():
    jcfg, jp, _ = _moe_inputs(128)
    cfg = get_config("moonshot-v1-16b-a3b").scaled()
    x = np.zeros((1, 992, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="992"):
        jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    params = {k: torch.tensor(np.asarray(v)) for k, v in
              jp._asdict().items()}
    with pytest.raises(ValueError, match="992 tokens"):
        moe.moe_mlp(params, torch.from_numpy(x), cfg)
    # one group up to 512 tokens, any number of whole groups past it
    assert moe.check_grouping(500) == 500 and moe.check_grouping(1536) == 512
    with pytest.raises(ValueError):
        moe.check_grouping(8 * 224)           # an 8 x 224 suffix wave


def test_init_moe_shapes_and_float32_router():
    cfg = get_config("moonshot-v1-16b-a3b").scaled(param_dtype="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (d, e), "wg": (e, d, f), "wu": (e, d, f), "wd": (e, f, d)}
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}
    jcfg = jax_config("moonshot-v1-16b-a3b").scaled(param_dtype="bfloat16")
    jp = jax_make_engine(jcfg).model.init(jax.random.key(0))
    tp = params_from_numpy(cfg, _np(jp), "cpu")
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["wg"].dtype == torch.bfloat16
    assert "mlp" not in tp["blocks"]


# ----------------------------------------------------------------- models -
@functools.lru_cache(maxsize=None)
def pair(arch):
    """The scaled arch in both packages on the reference's weights (JAX
    init, key 0) and a numpy LoRA tree with nonzero ``b``; the JAX
    model's decode step and logits jitted (compiled once a shape)."""
    jcfg, cfg = jax_config(arch).scaled(), get_config(arch).scaled()
    assert cfg.family is Family.MOE and cfg.n_experts == 4
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    lora_np = numpy_lora(jcfg)
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, jp=jp, lora_np=lora_np,
                jdecode=jax.jit(jeng.model.decode_step),
                jlogits=jax.jit(jeng.model.logits),
                jlora=jax.tree.map(jnp.asarray, lora_np), eng=eng,
                params=params_from_numpy(cfg, _np(jp), "cpu"),
                lora=lora_from_numpy(lora_np, "cpu"))


def _batch(cfg, b=4, s=24, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, -5:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    s = pair(arch)
    toks = _batch(s["cfg"])["tokens"]
    jl = s["jeng"].model.logits(s["jp"], s["jlora"],
                                {"tokens": jnp.asarray(toks)})
    tl = s["eng"].model.logits(s["params"], s["lora"],
                               {"tokens": torch.from_numpy(toks)})
    assert _rel(tl, jl) < LOGIT_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_matches_reference(arch):
    s = pair(arch)
    b = _batch(s["cfg"])
    jt, jm = s["jeng"].model.forward_loss(
        s["jp"], s["jlora"], {k: jnp.asarray(v) for k, v in b.items()})
    tt, tm = s["eng"].model.forward_loss(
        s["params"], s["lora"], {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tm["aux_loss"]) > 0
    assert abs(float(tm["aux_loss"]) - float(jm["aux_loss"])) \
        <= AUX_REL * abs(float(jm["aux_loss"]))
    assert _rel(tm["ce_loss"], jm["ce_loss"]) < LOGIT_REL
    assert _rel(tt, jt) < LOGIT_REL
    assert abs(float(tt) - float(tm["ce_loss"]) - 0.01 * float(
        tm["aux_loss"])) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_grads_match_jax_grad(arch):
    s = pair(arch)
    b = _batch(s["cfg"])
    jm = s["jeng"].model

    def jloss(lora_):
        return jm.forward_loss(s["jp"], lora_,
                               {k: jnp.asarray(v) for k, v in b.items()})[0]

    jg = jax.grad(jloss)(s["jlora"])
    loss, metrics, tg = s["eng"].loss_and_grads(
        s["params"], s["lora"], {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(metrics["aux_loss"]) > 0
    for t, j in zip(jax.tree.leaves(tree_map(lambda x: x.numpy(), tg)),
                    jax.tree.leaves(_np(jg))):
        assert _rel(t, j) < GRAD_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_under_the_moe_rule(arch):
    """Twin of tests/test_decode_parity.py's MoE case on the port: each
    decode step's logits within 1e-5 of the JAX model's decode step, and
    decode against the full forward under the reference's MoE rule, which
    the JAX model meets on the same tokens.  (The rule depends on the
    data: on seed 9's tokens moonshot's JAX decode matches 7 of 20
    positions, its forward's 40-token group dropping choices that the
    2-token decode groups keep; ROADMAP.md §3.)"""
    s = pair(arch)
    m, params, lora = s["eng"].model, s["params"], s["lora"]
    jm = s["jeng"].model
    b_, s_ = 2, 20
    np_toks = _batch(s["cfg"], b=b_, s=s_, seed=1)["tokens"]
    toks = torch.from_numpy(np_toks)
    full = m.logits(params, lora, {"tokens": toks})
    jfull = s["jlogits"](s["jp"], s["jlora"],
                         {"tokens": jnp.asarray(np_toks)})
    assert _rel(full, jfull) < LOGIT_REL
    caches, jcaches = m.init_caches(b_, s_), jm.init_caches(b_, s_)
    errs, jerrs = [], []
    for t in range(s_):
        lg, caches = m.decode_step(params, lora, caches, toks[:, t:t + 1],
                                   torch.full((b_,), t))
        jlg, jcaches = s["jdecode"](s["jp"], s["jlora"], jcaches,
                                    jnp.asarray(np_toks[:, t:t + 1]),
                                    jnp.full((b_,), t, jnp.int32))
        assert _rel(lg, jlg) < LOGIT_REL
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
        jerrs.append(float(jnp.max(jnp.abs(jlg[:, 0] - jfull[:, t]))))
    scale = float(full.abs().max()) + 1e-6
    moe_rule([e / scale for e in jerrs], f"{arch} JAX decode")
    moe_rule([e / scale for e in errs], f"{arch} decode")
    last = toks[:, -1:]
    lg2, _ = m.decode_step(params, lora, caches, last, torch.full((b_,),
                                                                  s_ - 1))
    lg3, _ = m.decode_step(params, lora, caches, last, torch.full((b_,),
                                                                  s_ - 1))
    assert torch.equal(lg2, lg3)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_equals_contiguous_bitwise(arch):
    """The same K/V rows in a paged pool (shuffled blocks of 4) and in
    contiguous caches: every decode step's logits bitwise equal."""
    s = pair(arch)
    m, params, lora = s["eng"].model, s["params"], s["lora"]
    lens = np.array([5, 9, 3], np.int32)
    pad, bs, steps = 12, 4, 4
    rng = np.random.default_rng(2)
    toks = np.zeros((3, pad), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, s["cfg"].vocab_size, n)
    _, pre = m.prefill_ragged(params, lora, {"tokens": torch.from_numpy(toks)},
                              torch.from_numpy(lens))
    cont = m.init_caches(3, pad + steps)
    m.write_prefill_slots(cont, pre, [0, 1, 2])
    nb = -(-(pad + steps) // bs)
    ids = 1 + rng.permutation(3 * nb)
    tables = ids.reshape(3, nb).astype(np.int32)
    paged = m.init_paged_caches(1 + 3 * nb, bs)
    m.write_prefill_blocks(paged, pre, tables[:, :pad // bs])
    tok = torch.from_numpy(rng.integers(0, s["cfg"].vocab_size, (3, 1)))
    pos = torch.from_numpy(lens.astype(np.int64))
    for _ in range(steps):
        lc, _ = m.decode_step(params, lora, cont, tok, pos)
        lp, _ = m.decode_step_paged(params, lora, paged, tok, pos,
                                    torch.from_numpy(tables))
        assert torch.equal(lc, lp)
        tok, pos = lc[:, -1].argmax(-1, keepdim=True), pos + 1


def test_free_slot_takes_expert_capacity():
    """The reference's decode routes every slot, free ones included (they
    feed token 0 at position 0), and their choices take expert capacity:
    an active slot's logits can depend on what its neighbour feeds.
    grok's scaled decode of 3 slots has capacity 2 an expert; some token
    in slot 2 moves slot 0's logits, in the JAX model and the port
    alike."""
    s = pair("grok-1-314b")
    m, jm = s["eng"].model, s["jeng"].model
    assert moe.capacity(3, s["cfg"]) == 2
    rng = np.random.default_rng(4)
    caches = m.init_caches(3, 8)
    jcaches = jm.init_caches(3, 8)
    pos = np.zeros(3, np.int32)
    base = None
    moved = 0
    for other in rng.integers(0, s["cfg"].vocab_size, 12):
        tok = np.array([[11], [23], [other]], np.int32)
        lt, _ = m.decode_step(s["params"], s["lora"], caches,
                              torch.from_numpy(tok).long(),
                              torch.from_numpy(pos).long())
        lj, _ = s["jdecode"](s["jp"], s["jlora"], jcaches, jnp.asarray(tok),
                             jnp.asarray(pos))
        assert _rel(lt, lj) < LOGIT_REL
        if base is None:
            base = lt[0]
        moved += not torch.equal(lt[0], base)
    assert moved > 0


# ---------------------------------------------------------------- batcher -
def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _train_batches(cfg, n, b=4, s=8, seed=50):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


LENS = [6, 10, 4, 8, 7]
GENS = [5, 2, 6, 3, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_jax_batcher(arch):
    """Two paged slots, requests admitted mid-flight (free slots decode):
    the port's greedy tokens are the JAX batcher's."""
    s = pair(arch)
    prompts = _prompts(s["cfg"], LENS)
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10, paged=True, block_size=4)
    jreqs = [JaxRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    JaxBatcher(s["jeng"], s["jp"], s["jlora"], **kw).run(jreqs)
    treqs = [GenRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    b = ContinuousBatcher(s["eng"], s["params"], s["lora"], **kw)
    b.run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0


def test_cotraining_batcher_matches_jax_batcher():
    """Both batchers co-train moonshot on the same numpy batches, one per
    tick: tokens, losses (aux included in the objective) and adapters."""
    s = pair("moonshot-v1-16b-a3b")
    prompts = _prompts(s["cfg"], LENS)
    batches = _train_batches(s["cfg"], 40)
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10, paged=True, block_size=4)
    jb = JaxBatcher(s["jeng"], s["jp"], s["jlora"],
                    opt_state=s["jeng"].optimizer.init(s["jlora"]), **kw)
    jreqs = [JaxRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    jfeed = iter(batches)
    jb.run(jreqs, train_data_fn=lambda: next(jfeed))
    tb = ContinuousBatcher(s["eng"], s["params"], s["lora"],
                           opt_state=s["eng"].optimizer.init(s["lora"]), **kw)
    treqs = [GenRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    tfeed = iter(batches)
    tstats = tb.run(treqs, train_data_fn=lambda: next(tfeed))
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tstats.train_steps == tstats.decode_steps > 0
    np.testing.assert_allclose(tb.train_losses, jb.train_losses, rtol=1e-4)
    for t, j in zip(jax.tree.leaves(tree_map(lambda x: x.numpy(), tb.lora)),
                    jax.tree.leaves(_np(jb.lora))):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_combined_step_paged_metrics_carry_aux(arch):
    s = pair(arch)
    eng, lora = s["eng"], s["lora"]
    m = eng.model
    batch = {k: torch.from_numpy(v) for k, v in _batch(s["cfg"]).items()}
    _, _, logits, _, met = eng.combined_step_paged(
        s["params"], lora, eng.optimizer.init(lora), batch,
        m.init_paged_caches(5, 8), torch.tensor([[3], [7]]),
        torch.zeros(2, dtype=torch.long),
        torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    assert float(met["aux_loss"]) > 0
    assert np.isfinite(float(met["loss"])) and logits.shape[:2] == (2, 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("traffic", ["uniform", "ragged"])
def test_paged_equals_contiguous_tokens(arch, traffic):
    """8 requests on 4 slots, of one length and budget (every wave fills
    the slots and ends together) or ragged (free slots decode beside
    busy ones): paged and contiguous serve the same tokens bit for bit."""
    s = pair(arch)
    if traffic == "uniform":
        prompts, gens = _prompts(s["cfg"], [6] * 8, seed=8), [5] * 8
    else:
        prompts = _prompts(s["cfg"], [6, 2, 5, 3, 6, 4, 1, 5], seed=8)
        gens = [5, 2, 6, 3, 4, 1, 5, 2]
    out = {}
    for paged in (False, True):
        reqs = [GenRequest(request_id=i, prompt=p.copy(), max_new_tokens=g)
                for i, (p, g) in enumerate(zip(prompts, gens))]
        b = ContinuousBatcher(s["eng"], s["params"], s["lora"], n_slots=4,
                              max_seq=16, prompt_pad=6, paged=paged,
                              block_size=4)
        b.run(reqs)
        out[paged] = [r.tokens for r in reqs]
    assert out[True] == out[False]


def _last_rel(a, b):
    """Each row's relative error of last-position logits ``a`` against
    ``b`` (the row's largest magnitude)."""
    return [float((x - y).abs().max() / (y.abs().max() + 1e-6))
            for x, y in zip(a[:, -1], b[:, -1])]


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_and_suffix_prefill_under_the_moe_rule(arch):
    """A wave of 8 prompts of 24 tokens prefilled whole, in chunks of 8
    over the contiguous caches (``prefill_ragged_continue``), and as a
    16-token suffix over its cached 8-token prefix in a paged pool
    (``prefill_ragged_suffix``): each row's last logits against the
    whole prefill's, under the reference's MoE rule."""
    s = pair(arch)
    m, params, lora = s["eng"].model, s["params"], s["lora"]
    w, p, c = 8, 24, 8
    toks = torch.from_numpy(np.stack(_prompts(s["cfg"], [p] * w, seed=6)))
    full, pre = m.prefill_ragged(params, lora, {"tokens": toks},
                                 torch.full((w,), p))
    caches = m.init_caches(w, p)
    lg, one = m.prefill_ragged(params, lora, {"tokens": toks[:, :c]},
                               torch.full((w,), c))
    m.write_prefill_slots(caches, one, range(w))
    for off in range(c, p, c):
        lg, one = m.prefill_ragged_continue(
            params, lora, {"tokens": toks[:, off:off + c]}, np.full(w, c),
            np.full(w, off), caches, np.arange(w))
        m.write_prefill_rows(caches, one, np.arange(w), np.full(w, off),
                             np.full(w, c))
    moe_rule(_last_rel(lg, full), f"{arch} chunked")
    bs = 4
    pool = m.init_paged_caches(1 + w * p // bs, bs)
    tables = np.arange(1, 1 + w * p // bs, dtype=np.int32).reshape(w, -1)
    m.write_prefill_blocks(pool, pre, tables)
    suf, _ = m.prefill_ragged_suffix(
        params, lora, {"tokens": toks[:, c:]}, np.full(w, p - c),
        np.full(w, c), pool, tables[:, :c // bs])
    moe_rule(_last_rel(suf, full), f"{arch} suffix")


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_tenant_wave_differs_from_solo_only_where_choices_drop(
        arch, monkeypatch):
    """A wave of 8 rows over 3 tenant slots and the base model (-1)
    against each tenant's rows prefilled alone as the single adapter.
    The solo waves route fewer tokens a group, so fewer slots an expert
    (15 for 24 tokens, 60 for the mixed wave's 96): mixed against solo
    meets neither bitwise identity nor the MoE rule here (ROADMAP.md
    §3).  What holds: a row none of whose choices was dropped, in any
    layer of either wave, has the same last logits bit for bit, and every
    row whose logits differ had a choice dropped."""
    s = pair(arch)
    kept = []
    route = moe._route

    def tap(*args):
        out = route(*args)
        kept.append(out[2])
        return out

    monkeypatch.setattr(moe, "_route", tap)
    m, params = s["eng"].model, s["params"]
    w, p = 8, 12
    toks = torch.from_numpy(np.stack(_prompts(s["cfg"], [p] * w, seed=12)))
    trees = [lora_from_numpy(numpy_lora(s["jcfg"], seed=20 + a), "cpu")
             for a in range(3)]
    stack = tree_map(lambda *ts: torch.stack(ts, dim=1), *trees)
    idx = torch.tensor([0, 1, 2, -1, 2, 1, 0, -1])

    def dropped(rows):
        """Per row of the last wave: whether any choice was dropped."""
        flags = torch.stack([~k.reshape(rows, p, -1).all(-1).all(-1)
                             for k in kept]).any(0)
        kept.clear()
        return flags

    mixed, _ = m.prefill_ragged(params, stack, {"tokens": toks},
                                torch.full((w,), p), adapter_idx=idx)
    mixed_drop = dropped(w)
    n_equal = 0
    for a in (-1, 0, 1, 2):
        rows = (idx == a).nonzero()[:, 0]
        solo, _ = m.prefill_ragged(params, trees[a] if a >= 0 else None,
                                   {"tokens": toks[rows]},
                                   torch.full((len(rows),), p))
        solo_drop = dropped(len(rows))
        for j, r in enumerate(rows.tolist()):
            same = torch.equal(mixed[r], solo[j])
            n_equal += same
            if not (mixed_drop[r] or solo_drop[j]):
                assert same, f"{arch}: row {r} kept every choice, differs"
            assert same or mixed_drop[r] or solo_drop[j]
    assert n_equal > 0


# ------------------------------------------------------------ entry points -
@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_and_combined_on_cpu(arch):
    for paged in (False, True):
        out = run_serving(arch, smoke=True, n_requests=5, prompt_len=8,
                          gen_tokens=4, batch_size=2, paged=paged,
                          block_size=4, combined=paged, device="cpu",
                          verbose=False)
        assert out["finished"] == 5 and out["tokens_generated"] == 20
        if paged:
            assert out["blocks_used_at_end"] == 0
            assert np.isfinite(out["train_losses"]).all()
            assert len(out["train_losses"]) == out["decode_steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_on_cpu(tmp_path, arch):
    out = run_training(arch, smoke=True, steps=2, batch=2, seq=16,
                       ckpt_dir=str(tmp_path), verbose=False, device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()


TRAIN_STEPS = 5


def test_run_training_matches_jax_per_step(tmp_path):
    """``run_training`` on the scaled moonshot (4 x 32, lr 3e-3) against
    the JAX trainer's run: the same losses, and its trajectory one step
    at a time (``tests/test_torch_train_cli.py::_walk``: each package
    steps from JAX's state on batches drawn once in this process; losses
    within 1e-5, moments within float32 noise, adapters within 1e-6 of
    their AdamW update)."""
    arch = "moonshot-v1-16b-a3b"
    ref = jax_train.run_training(arch, smoke=True, steps=TRAIN_STEPS,
                                 batch=4, seq=32, verbose=False,
                                 ckpt_dir=str(tmp_path / "jax"))
    jcfg, cfg = jax_config(arch).scaled(), get_config(arch).scaled()
    jmodel = jax_make_engine(jcfg).model
    params = _np(jmodel.init(jax.random.key(0)))
    lora = jmodel.init_lora(jax.random.key(1))
    out = train_from_weights(
        make_engine(cfg, lr=cli.LR, device="cpu"),
        params_from_numpy(cfg, params, device="cpu"),
        lora_from_numpy(_np(lora), device="cpu"), arch=arch,
        steps=TRAIN_STEPS, batch=4, seq=32, ckpt_dir=str(tmp_path / "port"),
        verbose=False)
    assert out["steps"] == ref["steps"] == TRAIN_STEPS
    assert set(out["lora"]) == {"q", "k", "v", "o"}
    np.testing.assert_allclose(out["losses"], ref["losses"],
                               rtol=cli.LOSS_RTOL)
    jeng = jax_make_engine(jcfg, lr=cli.LR)
    steppers = {"jstep": jax.jit(jeng.train_step),
                "jparams": jax.tree.map(jnp.asarray, params),
                "engine": make_engine(cfg, lr=cli.LR, device="cpu"),
                "params": params_from_numpy(cfg, params, device="cpu")}
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size, seq_len=32,
                            seed=0)
    batches = [data.batch(4) for _ in range(TRAIN_STEPS)]
    _, losses = cli._walk(steppers, (lora, jeng.optimizer.init(lora)),
                          batches, 0)
    np.testing.assert_allclose(losses, ref["losses"], rtol=cli.LOSS_RTOL)
