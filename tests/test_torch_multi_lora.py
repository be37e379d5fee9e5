"""Multi-tenant LoRA serving in the port (``segmented_lora_matmul``,
``models/lora.py``'s segmented paths, ``AdapterRegistry`` and the
batcher's ``adapters=``) on the CPU, against the JAX package:

* the plain ``segmented_lora_matmul`` against ``repro.kernels.ref`` and
  against the Pallas kernel in interpret mode
  (``ops.segmented_lora_matmul(force_kernel=True)``) at
  ``tests/test_multi_lora.py``'s three shapes and a ragged one whose rows
  mix every slot and -1: 1e-5 relative and absolute in float32 (sums in
  another order);
* rows with ``adapter_idx < 0`` are the base product bitwise even with
  NaN in the stacks, and an all-(-1) call is ``x @ W`` bitwise;
* on the reduced qwen1.5-0.5b in float32, with a 3-tenant stack and a
  per-row index that includes -1: ``prefill_ragged`` (dense and
  blockwise), ``decode_step``, ``decode_step_paged`` and
  ``Engine.combined_step_paged(serve_adapter_idx=...)`` against JAX,
  logits within 5e-5 of their largest magnitude
  (``tests/test_decode_parity.py``'s bound), the train loss within 1e-4;
* torch twins of ``test_multi_lora.py``'s registry and batcher
  invariants, paged and contiguous, and the mixed wave's tokens against
  the JAX batcher's on the same weights;
* ``run_serving(n_adapters=3)`` with and without co-training.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.  Inputs are numpy-seeded."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.kernels import ops, ref
from repro.models import lora as jax_lora
from repro.runtime.fabric import make_tenant_adapters as jax_tenants
from repro.runtime.serving_loop import AdapterRegistry as JaxRegistry
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.kernels import lora_matmul as lm_mod
from repro_torch.kernels.lora_matmul import (
    segmented_lora_matmul, segmented_lora_matmul_ref,
)
from repro_torch.launch.serve import run_serving
from repro_torch.models import lora as lora_lib
from repro_torch.runtime.fabric import make_tenant_adapters
from repro_torch.runtime.serving_loop import (
    AdapterError, AdapterRegistry, ContinuousBatcher, GenRequest,
    OutOfAdapterSlots,
)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train import jbatch, numpy_batch, tbatch

LOGIT_REL = 5e-5
IDX = np.array([2, -1, 0, 1], np.int32)       # every slot, and base only


def _rel(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    t, j = np.asarray(t), np.asarray(j)
    return float(np.max(np.abs(t - j)) / (np.max(np.abs(j)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seg_inputs(m, k, n, r, na, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((na, k, r)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((na, r, n)) * 0.05).astype(np.float32)
    idx = rng.integers(-1, na, m).astype(np.int32)
    idx[:na + 1] = np.arange(-1, na)          # every slot and -1 present
    return x, w, a, b, idx


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------------------ the kernel --
@pytest.mark.parametrize("m,k,n,r,na", [(128, 256, 128, 8, 3),
                                        (256, 128, 256, 16, 2),
                                        (128, 128, 128, 4, 5),
                                        (37, 200, 136, 16, 4)])   # ragged
def test_plain_version_matches_jax(m, k, n, r, na):
    x, w, a, b, idx = _seg_inputs(m, k, n, r, na)
    got = segmented_lora_matmul(*_t(x, w, a, b, idx), 2.0)
    assert got.shape == (m, n) and got.dtype == torch.float32
    jx = [jnp.asarray(v) for v in (x, w, a, b, idx)]
    want_ref = ref.segmented_lora_matmul(*jx, 2.0)
    want_pallas = ops.segmented_lora_matmul(*jx, 2.0, force_kernel=True)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_base_rows_bitwise_with_nan_stacks():
    """-1 rows are the plain f32 base product bitwise although every slot
    of both stacks is NaN (the select follows the products)."""
    x, w, _, _, idx = _seg_inputs(64, 96, 80, 8, 3, seed=2)
    a = np.full((3, 96, 8), np.nan, np.float32)
    b = np.full((3, 8, 80), np.nan, np.float32)
    got = segmented_lora_matmul(*_t(x, w, a, b, idx), 2.0)
    base = torch.from_numpy(x) @ torch.from_numpy(w)
    off = torch.from_numpy(idx < 0)
    assert torch.equal(got[off], base[off])
    assert torch.isnan(got[~off]).all()


def test_all_disabled_is_base_matmul():
    x, w, a, b, _ = _seg_inputs(32, 64, 48, 4, 2, seed=3)
    idx = np.full(32, -1, np.int32)
    got = segmented_lora_matmul(*_t(x, w, a, b, idx), 2.0)
    assert torch.equal(got, torch.from_numpy(x) @ torch.from_numpy(w))


def test_rows_equal_their_single_adapter_product():
    """Each row is ``lora_matmul`` of its own slot (clamped past the last
    one, as the reference clips), a -1 row ``lora_matmul`` with B = 0."""
    x, w, a, b, idx = _seg_inputs(24, 48, 40, 4, 3, seed=4)
    idx[5] = 7                                  # past the last slot: 2
    got = segmented_lora_matmul(*_t(x, w, a, b, idx), 1.5)
    xt, wt, at, bt = _t(x, w, a, b)
    for i, s in enumerate(idx):
        s = min(int(s), 2)
        bs = bt[s] if s >= 0 else torch.zeros_like(bt[0])
        one = lm_mod.lora_matmul(xt[i:i + 1], wt, at[max(s, 0)], bs, 1.5)
        np.testing.assert_allclose(got[i:i + 1].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_bf16_rounds_x_a_like_the_pallas_kernel():
    x, w, a, b, idx = _seg_inputs(128, 128, 128, 16, 2, seed=5)
    got = segmented_lora_matmul(
        *(t.bfloat16() for t in _t(x, w, a, b)), torch.from_numpy(idx), 2.0)
    jx = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, w, a, b)]
    want = ops.segmented_lora_matmul(*jx, jnp.asarray(idx), 2.0,
                                     force_kernel=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_cpu_call_counts_no_launch():
    args = _t(*_seg_inputs(8, 32, 16, 4, 2))
    before = segmented_lora_matmul.launches
    segmented_lora_matmul(*args, 2.0)
    assert segmented_lora_matmul.launches == before


@pytest.mark.parametrize("where", ["all", "idx_only"])
def test_non_cpu_tensors_never_take_plain_version(where, monkeypatch):
    def fail(*_a, **_k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(lm_mod, "segmented_lora_matmul_ref", fail)
    args = _t(*_seg_inputs(8, 32, 16, 4, 2))
    if where == "all":
        args = [t.to("meta") for t in args]
    else:
        args[4] = args[4].to("meta")
    with pytest.raises(ValueError):
        segmented_lora_matmul(*args, 2.0)


def test_segmented_project_has_no_gradient():
    x, w, a, b, _ = _seg_inputs(4, 16, 8, 2, 2)
    pair = {"a": torch.from_numpy(a).requires_grad_(),
            "b": torch.from_numpy(b)}
    with pytest.raises(ValueError, match="no gradient"):
        lora_lib.project(torch.from_numpy(x)[None], torch.from_numpy(w),
                         pair, 2.0, torch.tensor([0], dtype=torch.int32))


def test_project_matches_unfused_apply_segmented():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 5, 32)).astype(np.float32))
    _, w, a, b, _ = _seg_inputs(4, 32, 24, 4, 3, seed=6)
    pair = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    wt, idx = torch.from_numpy(w), torch.from_numpy(IDX)
    fused = lora_lib.project(x, wt, pair, 2.0, idx)
    plain = lora_lib.apply(x, x @ wt, pair, 2.0, idx)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)
    jplain = jax_lora.apply(jnp.asarray(x.numpy()),
                            jnp.asarray((x @ wt).numpy()), _np(pair), 2.0,
                            jnp.asarray(IDX))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- model vs JAX ----
@pytest.fixture(scope="module")
def setup():
    """The reduced qwen1.5-0.5b in both packages on the same weights,
    three JAX tenants (``make_tenant_adapters``) and their stack."""
    jcfg = jax_config("qwen1.5-0.5b").scaled()
    cfg = get_config("qwen1.5-0.5b").scaled()
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    jtenants = jax_tenants(jeng.model, 3, seed=1)
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    params = params_from_numpy(cfg, _np(jp), "cpu")
    tenants = [lora_from_numpy(_np(t), "cpu") for t in jtenants]
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, jp=jp, jtenants=jtenants,
                eng=eng, params=params, tenants=tenants)


def test_stack_adapters_matches_jax(setup):
    got = lora_lib.stack_adapters(setup["tenants"])
    want = _np(jax_lora.stack_adapters(setup["jtenants"]))
    for t in want:
        for k in ("a", "b"):
            assert got[t][k].shape == want[t][k].shape
            np.testing.assert_array_equal(got[t][k].numpy(), want[t][k])


def _stacks(setup):
    return (jax_lora.stack_adapters(setup["jtenants"]),
            lora_lib.stack_adapters(setup["tenants"]))


def _prompts(vocab, n=4, pad=12, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, pad)).astype(np.int32)
    lens = np.array([5, 9, 3, 12], np.int32)[:n]
    return toks, lens


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
def test_prefill_ragged_matches_jax(setup, impl):
    from repro.models.model import build as jax_build
    from repro_torch.models.model import build
    jm = jax_build(setup["jcfg"].scaled(attn_impl=impl))
    tm = build(setup["cfg"].scaled(attn_impl=impl), "cpu")
    jstack, tstack = _stacks(setup)
    toks, lens = _prompts(setup["cfg"].vocab_size)
    jlogits, jc = jm.prefill_ragged(
        setup["jp"], jstack, {"tokens": jnp.asarray(toks)},
        jnp.asarray(lens), adapter_idx=jnp.asarray(IDX))
    tlogits, tc = tm.prefill_ragged(
        setup["params"], tstack, {"tokens": torch.from_numpy(toks).long()},
        torch.from_numpy(lens), adapter_idx=torch.from_numpy(IDX))
    assert _rel(tlogits, jlogits) < LOGIT_REL
    for t, j in zip(tc["kv"], jc["kv"]):
        assert _rel(t, j) < LOGIT_REL
    # the tenants differ, and the -1 row is the base model's
    base, _ = tm.prefill_ragged(
        setup["params"], None, {"tokens": torch.from_numpy(toks).long()},
        torch.from_numpy(lens))
    assert _rel(tlogits[1], base[1]) < 1e-6
    assert _rel(tlogits[3], base[3]) > 1e-3


def _decode_args(model, paged):
    tok = torch.tensor([[3], [7], [11], [5]], dtype=torch.long)
    pos = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    if paged:
        tables = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]],
                              dtype=torch.int32)
        return model.init_paged_caches(9, 4), tok, pos, tables
    return model.init_caches(4, 8), tok, pos, None


@pytest.mark.parametrize("paged", [False, True])
def test_decode_matches_jax(setup, paged):
    jm, tm = setup["jeng"].model, setup["eng"].model
    jstack, tstack = _stacks(setup)
    caches, tok, pos, tables = _decode_args(tm, paged)
    jidx = jnp.asarray(IDX)
    jtok, jpos = jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(pos.numpy())
    if paged:
        jl, _ = jm.decode_step_paged(setup["jp"], jstack,
                                     jm.init_paged_caches(9, 4), jtok, jpos,
                                     jnp.asarray(tables.numpy()),
                                     adapter_idx=jidx)
        tl, _ = tm.decode_step_paged(setup["params"], tstack, caches, tok,
                                     pos, tables,
                                     adapter_idx=torch.from_numpy(IDX))
    else:
        jl, _ = jm.decode_step(setup["jp"], jstack, jm.init_caches(4, 8),
                               jtok, jpos, adapter_idx=jidx)
        tl, _ = tm.decode_step(setup["params"], tstack, caches, tok, pos,
                               adapter_idx=torch.from_numpy(IDX))
    assert _rel(tl, jl) < LOGIT_REL


def test_combined_step_paged_matches_jax(setup):
    """Decode reads the tenant stack per row while the optimizer trains
    tenant 0's tree; logits and loss against JAX."""
    jeng, eng = setup["jeng"], setup["eng"]
    jstack, tstack = _stacks(setup)
    batch = numpy_batch(setup["cfg"], seed=8)
    caches, tok, pos, tables = _decode_args(eng.model, True)
    jtrain = setup["jtenants"][1]
    _, _, jlogits, _, jmet = jeng.combined_step_paged(
        setup["jp"], jtrain, jeng.optimizer.init(jtrain), jbatch(batch),
        jeng.model.init_paged_caches(9, 4), jnp.asarray(tok.numpy(),
                                                        jnp.int32),
        jnp.asarray(pos.numpy()), jnp.asarray(tables.numpy()),
        serve_lora=jstack, serve_adapter_idx=jnp.asarray(IDX))
    ttrain = setup["tenants"][1]
    new, _, tlogits, _, tmet = eng.combined_step_paged(
        setup["params"], ttrain, eng.optimizer.init(ttrain), tbatch(batch),
        caches, tok, pos, tables, serve_lora=tstack,
        serve_adapter_idx=torch.from_numpy(IDX))
    assert _rel(tlogits, jlogits) < LOGIT_REL
    assert _rel(tmet["ce_loss"], jmet["ce_loss"]) < 1e-4
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                    tree_leaves(ttrain)))


def test_segmented_projection_calls(setup, monkeypatch):
    """Every adapter projection of a multi-tenant prefill and decode is
    one segmented call over all the wave's rows, and none goes through
    ``lora_matmul``."""
    calls = {"seg": [], "single": 0}
    real = lm_mod.segmented_lora_matmul

    def seg(x, *args):
        calls["seg"].append(x.shape[0])
        return real(x, *args)

    def single(*_a):
        calls["single"] += 1
        raise AssertionError("lora_matmul reached")

    monkeypatch.setattr(lora_lib, "segmented_lora_matmul", seg)
    monkeypatch.setattr(lora_lib, "lora_matmul", single)
    tm = setup["eng"].model
    _, tstack = _stacks(setup)
    toks, lens = _prompts(setup["cfg"].vocab_size)
    tm.prefill_ragged(setup["params"], tstack,
                      {"tokens": torch.from_numpy(toks).long()},
                      torch.from_numpy(lens),
                      adapter_idx=torch.from_numpy(IDX))
    caches, tok, pos, _ = _decode_args(tm, False)
    tm.decode_step(setup["params"], tstack, caches, tok, pos,
                   adapter_idx=torch.from_numpy(IDX))
    n = 4 * setup["cfg"].n_layers
    assert calls["seg"] == [4 * 12] * n + [4] * n
    assert calls["single"] == 0


# -------------------------------------------------------------- registry --
def _registry(setup, capacity, tenants=None):
    reg = AdapterRegistry(setup["eng"].model, capacity=capacity)
    for t, tree in enumerate(tenants or setup["tenants"]):
        reg.register(f"tenant{t}", tree)
    return reg


def test_registry_refcount_lru_eviction(setup):
    reg = _registry(setup, capacity=2)
    assert reg.registered() == ["tenant0", "tenant1", "tenant2"]
    assert reg.resident_ids() == ()          # residency is lazy

    s0 = reg.acquire("tenant0")
    assert reg.refcount("tenant0") == 1 and reg.slot_index("tenant0") == s0
    reg.acquire("tenant0")
    assert reg.refcount("tenant0") == 2 and reg.hits == 1
    s1 = reg.acquire("tenant1")
    assert reg.resident_ids() == ("tenant0", "tenant1")
    # the device stack holds each resident tenant's tree in its slot
    stack = reg.device_lora()
    for t, s in (("tenant0", s0), ("tenant1", s1)):
        tree = setup["tenants"][int(t[-1])]
        for tgt in tree:
            for k in ("a", "b"):
                assert torch.equal(stack[tgt][k][:, s], tree[tgt][k])

    # every slot pinned: tenant2 cannot be admitted, and acquire raises
    assert not reg.can_acquire("tenant2")
    with pytest.raises(OutOfAdapterSlots):
        reg.acquire("tenant2")

    # releasing tenant1 leaves it warm (LRU); tenant2 now evicts it
    reg.release("tenant1")
    assert reg.refcount("tenant1") == 0
    assert reg.resident_ids() == ("tenant0", "tenant1")
    assert reg.can_acquire("tenant2")
    assert reg.acquire("tenant2") == s1
    assert reg.evictions == 1
    assert reg.resident_ids() == ("tenant0", "tenant2")

    # re-acquiring the evicted tenant reloads it
    reg.release("tenant2")
    loads = reg.loads
    reg.acquire("tenant1")
    assert reg.loads == loads + 1
    with pytest.raises(AdapterError):
        reg.release("tenant2")               # release without acquire


def test_registry_register_update_guards(setup):
    reg = _registry(setup, capacity=2)
    tenants = setup["tenants"]
    s = reg.acquire("tenant0")
    with pytest.raises(AdapterError):
        reg.register("tenant0", tenants[0])   # resident: must use update
    with pytest.raises(AdapterError):
        reg.unregister("tenant0")             # pinned by an in-flight ref
    reg.update("tenant0", tenants[1], version=7)
    assert reg.version("tenant0") == 7
    assert reg.refcount("tenant0") == 1       # publish never drops refs
    stack = reg.device_lora()
    assert all(torch.equal(stack[t]["b"][:, s], tenants[1][t]["b"])
               for t in tenants[1])
    # the publish gate refuses a non-finite tree and keeps the slot
    bad = tree_map(lambda t: torch.full_like(t, float("nan")), tenants[2])
    with pytest.raises(AdapterError, match="non-finite"):
        reg.update("tenant0", bad)
    assert all(torch.equal(stack[t]["b"][:, s], tenants[1][t]["b"])
               for t in tenants[1])
    reg.release("tenant0")
    reg.unregister("tenant0")
    assert not reg.is_registered("tenant0")
    with pytest.raises(AdapterError):
        reg.acquire("tenant0")


# --------------------------------------------------------------- batcher --
def _serve(setup, lora, prompts, gen, *, registry=None, adapter_ids=None,
           n_slots=4, paged=False):
    pad = max(len(p) for p in prompts)
    b = ContinuousBatcher(setup["eng"], setup["params"], lora,
                          n_slots=n_slots, max_seq=pad + gen, prompt_pad=pad,
                          adapters=registry, paged=paged, block_size=4)
    reqs = [GenRequest(request_id=i, prompt=np.asarray(p, np.int32),
                       max_new_tokens=gen,
                       adapter_id=adapter_ids[i] if adapter_ids else None)
            for i, p in enumerate(prompts)]
    stats = b.run(reqs)
    return b, reqs, stats


AIDS = [None, "tenant0", "tenant1", "tenant2"]


@pytest.fixture(scope="module")
def jax_mixed_tokens(setup):
    """The JAX batcher's tokens for the mixed wave, same weights."""
    reg = JaxRegistry(setup["jeng"].model, capacity=3)
    for t, tree in enumerate(setup["jtenants"]):
        reg.register(f"tenant{t}", tree)
    prompts = sample_prompts(setup["jcfg"], 4, [8, 8, 8, 8])
    b = JaxBatcher(setup["jeng"], setup["jp"], setup["jtenants"][0],
                   n_slots=4, max_seq=14, prompt_pad=8, adapters=reg)
    reqs = [JaxRequest(request_id=i, prompt=p, max_new_tokens=6,
                       adapter_id=AIDS[i]) for i, p in enumerate(prompts)]
    b.run(reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_vs_solo_bit_identity(setup, jax_mixed_tokens, paged):
    """One mixed wave (base + 3 tenants) emits the tokens of each served
    alone with its tree as the plain single-adapter ``lora``, and the JAX
    batcher's tokens for the same wave."""
    prompts = sample_prompts(setup["jcfg"], 4, [8, 8, 8, 8])
    reg = _registry(setup, capacity=3)
    _, mixed, stats = _serve(setup, setup["tenants"][0], prompts, 6,
                             registry=reg, adapter_ids=AIDS, paged=paged)
    assert all(r.done for r in mixed)
    assert mixed[1].tokens != mixed[2].tokens
    assert mixed[2].tokens != mixed[3].tokens
    assert [r.tokens for r in mixed] == jax_mixed_tokens
    base = setup["eng"].model.init_lora(torch.Generator().manual_seed(9))
    for i, aid in enumerate(AIDS):
        tree = base if aid is None else setup["tenants"][int(aid[-1])]
        _, solo, _ = _serve(setup, tree, [prompts[i]], 6, paged=paged)
        assert solo[0].tokens == mixed[i].tokens, \
            f"{aid or 'base'}: mixed wave drifted from solo serving"
    assert stats.adapter_requests == {"tenant0": 1, "tenant1": 1,
                                      "tenant2": 1}
    assert stats.adapter_versions == {"tenant0": 0, "tenant1": 0,
                                      "tenant2": 0}


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_releases_refs_on_drain(setup, paged):
    prompts = sample_prompts(setup["jcfg"], 6, [8] * 6)
    aids = [f"tenant{i % 3}" for i in range(6)]
    reg = _registry(setup, capacity=3)
    b, _, stats = _serve(setup, setup["tenants"][0], prompts, 4,
                         registry=reg, adapter_ids=aids, n_slots=3,
                         paged=paged)
    assert stats.finished == 6
    assert all(reg.refcount(f"tenant{t}") == 0 for t in range(3))
    assert all(aid is None for aid in b.slot_aid)
    assert stats.adapter_requests == {"tenant0": 2, "tenant1": 2,
                                      "tenant2": 2}
    # drain_all mid-flight hands back every pin (and every block)
    for i, p in enumerate(prompts[:3]):
        b.submit(GenRequest(request_id=10 + i, prompt=p, max_new_tokens=4,
                            adapter_id=aids[i]))
    b.step()
    assert sum(reg.refcount(f"tenant{t}") for t in range(3)) == 3
    assert len(b.drain_all()) == 3
    assert all(reg.refcount(f"tenant{t}") == 0 for t in range(3))
    if paged:
        assert b.allocator.n_used == 0 and b.allocator.reserved == 0


@pytest.mark.parametrize("paged", [False, True])
def test_capacity_backpressure_evicts_and_serves_all(setup, paged):
    """More tenants than device slots: admission waits on can_acquire,
    the LRU rotates residency, every request finishes with the tokens of
    an uncontended run."""
    prompts = sample_prompts(setup["jcfg"], 6, [8] * 6)
    aids = [f"tenant{i % 3}" for i in range(6)]
    reg = _registry(setup, capacity=2)
    _, reqs, stats = _serve(setup, setup["tenants"][0], prompts, 4,
                            registry=reg, adapter_ids=aids, n_slots=2,
                            paged=paged)
    assert stats.finished == 6
    assert reg.evictions > 0
    assert all(reg.refcount(f"tenant{t}") == 0 for t in range(3))
    _, roomy, _ = _serve(setup, setup["tenants"][0], prompts, 4,
                         registry=_registry(setup, capacity=3),
                         adapter_ids=aids, n_slots=2, paged=paged)
    assert [r.tokens for r in reqs] == [r.tokens for r in roomy]


@pytest.mark.parametrize("paged", [False, True])
def test_publish_isolation_across_update(setup, paged):
    """Rewriting one tenant's slot (the publish path) does not perturb
    another tenant's greedy stream."""
    prompts = sample_prompts(setup["jcfg"], 1, [8]) * 2
    aids = ["tenant1", "tenant2"]
    reg = _registry(setup, capacity=3)
    _, before, _ = _serve(setup, setup["tenants"][0], prompts, 6,
                          registry=reg, adapter_ids=aids, paged=paged)
    reg.update("tenant1", setup["tenants"][2], version=5)
    _, after, stats = _serve(setup, setup["tenants"][0], prompts, 6,
                             registry=reg, adapter_ids=aids, paged=paged)
    assert after[1].tokens == before[1].tokens      # tenant2 untouched
    assert after[0].tokens == before[1].tokens      # tenant1 now = t2 tree
    assert stats.adapter_versions["tenant1"] == 5


def test_adapter_misuse_raises(setup):
    prompt = np.arange(4, dtype=np.int32)
    b = ContinuousBatcher(setup["eng"], setup["params"], setup["tenants"][0])
    with pytest.raises(AdapterError, match="no AdapterRegistry"):
        b.submit(GenRequest(request_id=0, prompt=prompt,
                            adapter_id="tenant0"))
    b = ContinuousBatcher(setup["eng"], setup["params"], setup["tenants"][0],
                          adapters=_registry(setup, capacity=1))
    with pytest.raises(AdapterError, match="not registered"):
        b.submit(GenRequest(request_id=1, prompt=prompt,
                            adapter_id="tenant9"))
    with pytest.raises(ValueError):
        AdapterRegistry(setup["eng"].model, capacity=0)


def test_make_tenant_adapters_are_distinct():
    from repro_torch.models.model import build
    model = build(get_config("qwen1.5-0.5b").scaled(), "cpu")
    t0, t1, t2 = make_tenant_adapters(model, 3, seed=1)
    assert all(torch.count_nonzero(p["b"]) == 0 for p in t0.values())
    assert all(torch.count_nonzero(p["b"]) > 0 for p in t1.values())
    assert not torch.equal(t1["q"]["b"], t2["q"]["b"])
    again = make_tenant_adapters(model, 2, seed=1)[1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(t1)))


# ------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("combined", [False, True])
def test_run_serving_with_adapters(combined):
    out = run_serving("qwen1.5-0.5b", smoke=True, n_requests=7,
                      prompt_len=8, gen_tokens=4, batch_size=3, paged=True,
                      block_size=4, combined=combined, n_adapters=3,
                      device="cpu", verbose=False)
    assert out["finished"] == 7
    assert all(len(t) == 4 for t in out["tokens"])
    assert out["adapter_requests"] == {"tenant0": 3, "tenant1": 2,
                                       "tenant2": 2}
    assert out["adapter_ids"] == [f"tenant{i % 3}" for i in range(7)]
    assert out["adapter_loads"] == 3 and out["adapter_evictions"] == 0
    assert out["adapter_hits"] == 4
    assert set(out["adapter_refs_at_end"].values()) == {0}
    assert out["blocks_used_at_end"] == 0
    assert out["train_steps"] == (out["decode_steps"] if combined else 0)
