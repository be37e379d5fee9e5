"""The port's serving runtime (``repro_torch.runtime.serving_loop``,
``repro_torch.launch.serve``) on the CPU, where every decode tick runs
the paged kernel's plain version.  The batcher, paged and contiguous,
with two slots so requests are admitted mid-flight, must produce exactly
the greedy tokens of ``tests/conftest.py::reference_greedy`` run on the
JAX model with the same weights; paged and contiguous must agree token
for token; eviction must return every block and reservation.  With a
train batch on every tick (co-training), the batcher must emit the same
greedy tokens as the JAX batcher fed the same numpy train batches, with
train losses within 1e-4 relative and the trained adapter within 1e-5
relative + 1e-5 absolute: float32 sums in another order, compounded
over a dozen Adam steps of lr 1e-3, where an element whose gradient is
near zero can move by a fraction of a step (1e-5 is 1% of one).  Entry
points asked for the default CUDA device must raise on a machine without
one instead of running on the CPU."""
import jax
import numpy as np
import pytest
import torch

from conftest import reference_greedy, sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.core.engine import make_engine as jax_make_engine
from repro.models.model import build as jax_build
from repro.runtime.serving_loop import ContinuousBatcher as JaxBatcher
from repro.runtime.serving_loop import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.core.engine import make_engine
from repro_torch.launch.serve import run_serving
from repro_torch.models.model import build
from repro_torch.runtime.paging import BlockAllocator, BlockError, OutOfBlocks
from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest

LENS = [6, 10, 4, 8, 7]
GENS = [5, 2, 6, 3, 4]


@pytest.fixture(scope="module", params=["mha", "gqa"])
def setup(request):
    kw = {"gqa": {"n_kv_heads": 2}}.get(request.param, {})
    jcfg = jax_config("qwen1.5-0.5b").scaled(**kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    jlora = jax.tree.map(lambda x: x + 0.01,
                         jm.init_lora(jax.random.key(1)))
    cfg = get_config("qwen1.5-0.5b").scaled(**kw)
    engine = make_engine(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS), LENS)
    refs = [reference_greedy(jm, jp, jlora, prompts[i], GENS[i])
            for i in range(len(LENS))]
    return engine, params, lora, prompts, refs


def _serve(setup, **kw):
    engine, params, lora, prompts, _ = setup
    reqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                       max_new_tokens=GENS[i]) for i in range(len(LENS))]
    b = ContinuousBatcher(engine, params, lora, n_slots=2, max_seq=16,
                          prompt_pad=10, **kw)
    stats = b.run(reqs)
    return b, stats, [r.tokens for r in reqs]


def test_contiguous_matches_jax_reference(setup):
    _, stats, toks = _serve(setup)
    assert toks == setup[4]
    assert stats.finished == stats.admitted == len(LENS)
    assert stats.generated_tokens == sum(GENS)


def test_paged_matches_jax_reference_and_contiguous(setup):
    b, _, paged = _serve(setup, paged=True, block_size=4)
    _, _, cont = _serve(setup)
    assert paged == setup[4]
    assert paged == cont
    # eviction returned every block and reservation, cleared slot state
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0
    assert b.allocator.peak_used > 0
    assert all(not blks for blks in b.slot_blocks)
    assert (b.block_tables == 0).all()
    assert (b.slot_tok == 0).all() and (b.slot_pos == 0).all()


def test_paged_backpressure_and_table_growth(setup):
    """A pool that covers one worst-case request at a time: admission
    waits FCFS, tables grow a block at a time across boundaries, and
    the tokens still match the reference."""
    b, stats, toks = _serve(setup, paged=True, block_size=4, n_blocks=5)
    assert toks == setup[4]
    assert b.allocator.peak_used <= 4
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0
    assert stats.decode_steps >= sum(g - 1 for g in GENS)


def test_drain_all_returns_everything(setup):
    engine, params, lora, prompts, _ = setup
    b = ContinuousBatcher(engine, params, lora, n_slots=2, max_seq=16,
                          prompt_pad=10, paged=True, block_size=4)
    reqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                       max_new_tokens=GENS[i]) for i in range(len(LENS))]
    for r in reqs:
        b.submit(r)
    b.step()
    out = b.drain_all()
    assert sorted(r.request_id for r in out) \
        == [r.request_id for r in reqs if not r.done]
    assert len(out) == len(LENS) - b.stats.finished
    assert all(not r.tokens for r in out)
    assert b.idle()
    assert b.allocator.n_used == 0 and b.allocator.reserved == 0


def test_allocator_invariants():
    a = BlockAllocator(n_blocks=6, block_size=4)   # capacity 5
    a.reserve(4)
    ids = a.take(3)
    assert 0 not in ids and a.n_used == 3 and a.available() == 1
    with pytest.raises(OutOfBlocks):
        a.reserve(2)
    with pytest.raises(BlockError):
        a.take(2)                                  # beyond reservation
    a.free(ids)
    with pytest.raises(BlockError):
        a.free(ids[:1])                            # double free
    a.release(1)
    assert a.n_used == 0 and a.reserved == 0 and a.peak_used == 3


def test_unported_features_raise(setup):
    engine, params, lora, _, _ = setup
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 8},
               {"tpot_target": 0.01}, {"oversubscribe": 0.9}):
        with pytest.raises(NotImplementedError):
            ContinuousBatcher(engine, params, lora, paged=True, **kw)
    b = ContinuousBatcher(engine, params, lora)
    # co-training is ported; as in JAX it needs an optimizer state
    with pytest.raises(ValueError, match="opt_state"):
        b.step(train_batch={"tokens": np.zeros((1, 4), np.int32)})


@pytest.mark.parametrize("paged", [False, True])
def test_run_serving_on_cpu(paged):
    out = run_serving("qwen1.5-0.5b", smoke=True, n_requests=5,
                      prompt_len=8, gen_tokens=4, batch_size=2,
                      paged=paged, block_size=4, device="cpu",
                      verbose=False)
    assert out["finished"] == 5
    assert out["tokens_generated"] == 5 * 4
    assert out["prefill_tokens"] == 5 * 8
    assert out["decode_steps"] == 3 * 3        # 3 waves of 3 decode ticks
    assert all(len(t) == 4 for t in out["tokens"])
    if paged:
        assert out["blocks_used_at_end"] == 0
        assert out["blocks_reserved_at_end"] == 0


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_config("qwen1.5-0.5b").scaled()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("qwen1.5-0.5b", n_requests=1, verbose=False)


def test_unported_arch_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("hymba-1.5b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ------------------------------------------------------------ co-training -
def _train_batches(cfg, n, b=4, s=8, seed=50):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((b, s), np.float32)})
    return out


def _cotrain_both(paged, grad_accum=1):
    """The JAX and the port batcher co-train on the same numpy batches,
    one per tick, with ``grad_accum`` microbatches per train step."""
    jcfg = jax_config("qwen1.5-0.5b").scaled()
    cfg = get_config("qwen1.5-0.5b").scaled()
    jeng = jax_make_engine(jcfg, lr=1e-3)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jax.tree.map(lambda x: x + 0.01,
                         jeng.model.init_lora(jax.random.key(1)))
    eng = make_engine(cfg, lr=1e-3, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS), LENS)
    batches = _train_batches(cfg, 40)
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10, paged=paged,
              block_size=4)

    jb = JaxBatcher(jeng, jp, jlora, opt_state=jeng.optimizer.init(jlora),
                    **kw)
    jb.train_grad_accum = grad_accum
    jreqs = [JaxRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    jfeed = iter(batches)
    jstats = jb.run(jreqs, train_data_fn=lambda: next(jfeed))

    tb = ContinuousBatcher(eng, params, lora,
                           opt_state=eng.optimizer.init(lora), **kw)
    tb.train_grad_accum = grad_accum
    treqs = [GenRequest(request_id=i, prompt=prompts[i].copy(),
                        max_new_tokens=GENS[i]) for i in range(len(LENS))]
    tfeed = iter(batches)
    tstats = tb.run(treqs, train_data_fn=lambda: next(tfeed))
    return jb, jreqs, jstats, tb, treqs, tstats


@pytest.mark.parametrize("paged,grad_accum", [(False, 1), (True, 1),
                                               (True, 2)],
                         ids=["False", "True", "True-accum2"])
def test_cotraining_batcher_matches_jax(paged, grad_accum):
    """Both batchers co-train on the same numpy batches, one per tick;
    each tick's decode reads the adapter trained by the ticks before.
    ``train_grad_accum`` = 2 splits each 4-row batch into two
    microbatches in both."""
    jb, jreqs, jstats, tb, treqs, tstats = _cotrain_both(paged, grad_accum)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tstats.train_steps == jstats.train_steps == tstats.decode_steps
    np.testing.assert_allclose(tb.train_losses, jb.train_losses, rtol=1e-4)
    assert tstats.train_loss == tb.train_losses[-1]
    # the noise-scale estimator's inputs; float32 sums in another order
    m = tb.last_train_metrics
    assert set(m) == {"ce_loss", "micro_grad_sqnorm", "grad_sqnorm"}
    for k in m:
        np.testing.assert_allclose(m[k], jb.last_train_metrics[k],
                                   rtol=1e-4)
    if grad_accum > 1:   # mean microbatch |g|^2 > |mean g|^2: both ran
        assert m["micro_grad_sqnorm"] > m["grad_sqnorm"] > 0
    for t, j in zip(jax.tree.leaves(tree_map(lambda x: x.numpy(), tb.lora)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jb.lora))):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    if paged:
        assert tb.allocator.n_used == 0 and tb.allocator.reserved == 0


def test_tick_without_active_slot_trains_alone(setup):
    """Requests that finish at admission leave no slot to decode; the
    tick still runs its train step."""
    engine, params, lora, prompts, _ = setup
    b = ContinuousBatcher(engine, params, lora, n_slots=2, max_seq=16,
                          prompt_pad=10,
                          opt_state=engine.optimizer.init(lora))
    b.submit(GenRequest(request_id=0, prompt=prompts[0].copy(),
                        max_new_tokens=1))
    done = b.step(train_batch=_train_batches(engine.model.cfg, 1)[0])
    assert [r.request_id for r in done] == [0]
    assert b.stats.decode_steps == 0 and b.stats.train_steps == 1
    assert b.lora is not lora                    # trained in place


def test_train_session_trains_the_shadow_only(setup):
    """With ``train_lora`` staged, decode keeps reading ``self.lora``
    (untouched) while the shadow tree trains."""
    engine, params, lora, prompts, _ = setup
    b = ContinuousBatcher(engine, params, lora, n_slots=2, max_seq=16,
                          prompt_pad=10,
                          opt_state=engine.optimizer.init(lora))
    shadow = tree_map(torch.clone, lora)
    b.train_lora = shadow
    b.submit(GenRequest(request_id=0, prompt=prompts[0].copy(),
                        max_new_tokens=4))
    for tbatch in _train_batches(engine.model.cfg, 2):
        b.step(train_batch=tbatch)
    assert b.lora is lora
    assert b.train_lora is not shadow
    assert any(not torch.equal(x, y) for x, y in
               zip(tree_leaves(b.train_lora), tree_leaves(lora)))
    assert b.stats.train_steps == 2


@pytest.mark.parametrize("paged", [False, True])
def test_run_serving_combined_on_cpu(paged):
    out = run_serving("qwen1.5-0.5b", smoke=True, n_requests=5,
                      prompt_len=8, gen_tokens=4, batch_size=2,
                      combined=True, train_batch=2, paged=paged,
                      block_size=4, device="cpu", verbose=False)
    assert out["finished"] == 5
    assert all(len(t) == 4 for t in out["tokens"])
    assert out["decode_steps"] == 3 * 3 and out["prefill_waves"] == 3
    # every tick decoded, and every tick trained once
    assert out["train_steps"] == out["decode_steps"]
    assert len(out["train_losses"]) == out["train_steps"]
    assert np.isfinite(out["train_losses"]).all()


def _serve_on_clock(batcher, make_req, arrive_tick, dt=0.25):
    """Tick ``batcher`` on a caller clock (tick k at k * dt), submitting
    request i just before tick ``arrive_tick[i]`` (arrival 0.1 s
    earlier), until every request has finished."""
    pending = sorted(range(len(arrive_tick)), key=lambda i: arrive_tick[i])
    reqs, k = [], 0
    while pending or not batcher.idle():
        while pending and arrive_tick[pending[0]] <= k:
            i = pending.pop(0)
            reqs.append(make_req(i, arrival=k * dt - 0.1))
            batcher.submit(reqs[-1])
        batcher.step(now=k * dt)
        k += 1
        assert k < 200
    return reqs


@pytest.mark.parametrize("paged", [False, True])
def test_ttft_tpot_match_jax(paged):
    """Both batchers serve one trace on one caller clock, requests
    arriving between ticks and queueing for the two slots: the same
    per-request time to first token (arrival -> the admitting tick) and
    time per output token, in finish order, and the same tokens."""
    jcfg = jax_config("qwen1.5-0.5b").scaled()
    cfg = get_config("qwen1.5-0.5b").scaled()
    jeng = jax_make_engine(jcfg)
    jp = jeng.model.init(jax.random.key(0))
    jlora = jeng.model.init_lora(jax.random.key(1))
    eng = make_engine(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    lora = lora_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    prompts = sample_prompts(jcfg, len(LENS), LENS)
    arrive = [0, 0, 1, 3, 3]
    kw = dict(n_slots=2, max_seq=16, prompt_pad=10, paged=paged,
              block_size=4)
    jb = JaxBatcher(jeng, jp, jlora, **kw)
    jreqs = _serve_on_clock(
        jb, lambda i, arrival: JaxRequest(
            request_id=i, prompt=prompts[i].copy(), max_new_tokens=GENS[i],
            arrival=arrival), arrive)
    tb = ContinuousBatcher(eng, params, lora, **kw)
    treqs = _serve_on_clock(
        tb, lambda i, arrival: GenRequest(
            request_id=i, prompt=prompts[i].copy(), max_new_tokens=GENS[i],
            arrival=arrival), arrive)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert [r.first_token_at for r in treqs] \
        == [r.first_token_at for r in jreqs]
    assert tb.stats.ttft == jb.stats.ttft
    assert tb.stats.tpot == jb.stats.tpot
    assert len(tb.stats.ttft) == len(tb.stats.tpot) == len(LENS)
    assert max(tb.stats.ttft) > 0.1      # someone queued behind a slot
