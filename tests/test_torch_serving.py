"""The port's serving runtime (``repro_torch.runtime.serving_loop``,
``repro_torch.launch.serve``) on the CPU, where every decode tick runs
the paged kernel's plain version.  The batcher, paged and contiguous,
with two slots so requests are admitted mid-flight, must produce exactly
the greedy tokens of ``tests/conftest.py::reference_greedy`` run on the
JAX model with the same weights; paged and contiguous must agree token
for token; eviction must return every block and reservation.  Entry
points asked for the default CUDA device must raise on a machine without
one instead of running on the CPU."""
import jax
import numpy as np
import pytest
import torch

from conftest import reference_greedy, sample_prompts
from repro.configs.registry import get_config as jax_config
from repro.models.model import build as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.convert import lora_from_numpy, params_from_numpy
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
               {"tpot_target": 0.01}, {"oversubscribe": 0.9},
               {"adapters": object()}):
        with pytest.raises(NotImplementedError):
            ContinuousBatcher(engine, params, lora, paged=True, **kw)
    b = ContinuousBatcher(engine, params, lora)
    with pytest.raises(NotImplementedError):
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
        get_config("llama3-8b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
