"""The port's shadow sanitizers (``repro_torch.runtime.sanitize``, armed by
``REPRO_SANITIZE=1``) on the CPU: twins of ``tests/test_sanitize.py``.
Each test breaks one hand-maintained runtime invariant of the port's
batcher, allocator or adapter registry and expects the reference's
``[reprosan:<check>]`` diagnostic; a clean paged, prefix-cache and
multi-tenant run reports nothing.  The reference's
``test_terminal_request_retried_detected`` drives the fabric's
``RetryPolicy``, which the port does not have yet (ROADMAP item 2):
``RequestFSM.check_requeue`` is tested directly in its place, on the
reference's ``Request``.

Factories read ``REPRO_SANITIZE`` once at construction, so every test
arms the variable BEFORE building its objects."""
import types

import numpy as np
import pytest

from conftest import sample_prompts
from repro.core.interfaces import Request
from repro_torch.runtime import sanitize
from repro_torch.runtime.fabric import make_tenant_adapters
from repro_torch.runtime.sanitize import (
    AdapterSanitizer, RequestFSM, RequestLifecycle, SanitizeError,
)
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest,
)
from test_torch_prefix_cache import pair


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize.enabled()


def _batcher(**kw):
    s = pair()
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 24)
    kw.setdefault("prompt_pad", 8)
    return ContinuousBatcher(s["eng"], s["params"], s["lora"], paged=True,
                             block_size=4, **kw)


def _one_request(b, n_new=8):
    """Admit one 6-token request and run its first decode tick."""
    b.submit(GenRequest(request_id=0,
                        prompt=sample_prompts(pair()["jcfg"], 1, [6])[0],
                        max_new_tokens=n_new))
    b.step()


# ------------------------------------------------------ block sanitizer ----
def test_use_after_free_gather_detected(armed):
    """Freeing a slot's blocks behind the batcher's back must fail the
    NEXT decode wave, not corrupt K/V."""
    b = _batcher()
    _one_request(b)
    victim = b.active_slots()[0]
    b.allocator.free(list(b.slot_blocks[victim]))   # the mutation
    with pytest.raises(SanitizeError, match="use-after-free-gather"):
        b.step()


def test_skipped_cow_shared_write_detected(armed):
    """A write into a refcount > 1 prefix block means copy-on-write was
    skipped: sharers would read torn K/V."""
    b = _batcher(prefix_cache=True)
    common = sample_prompts(pair()["jcfg"], 1, [8])[0]   # two full blocks
    b.run([GenRequest(request_id=0, prompt=common.copy(), max_new_tokens=6)])
    for i in (1, 2):
        b.submit(GenRequest(request_id=i, prompt=common.copy(),
                            max_new_tokens=6))
    b.step()                                  # both share prefix blocks
    a0 = b.active_slots()[0]
    shared = [k for k, bk in enumerate(b.slot_blocks[a0])
              if b.allocator.ref(bk) > 1]
    assert shared, "fixture bug: no shared prefix block materialized"
    # the mutation: skip the copy-on-write pass (prefix_cache gates it)
    # and point the slot's write cursor into the still-shared block
    b.prefix_cache = None
    b.slot_pos[a0] = shared[0] * b.block_size
    with pytest.raises(SanitizeError, match="shared-write"):
        b.step()


def test_reservation_leak_detected(armed):
    """Reserved headroom no slot accounts for is a leak that slowly
    starves admission."""
    b = _batcher()
    _one_request(b)
    b.allocator.reserve(2)                    # the mutation
    with pytest.raises(SanitizeError, match="reservation-leak"):
        b.step()


def test_refcount_drift_detected(armed):
    """The mirror cross-check pinpoints accounting bugs INSIDE the
    allocator: a refcount bumped without going through a hook."""
    b = _batcher()
    _one_request(b)
    blk = b.slot_blocks[b.active_slots()[0]][0]
    b.allocator._ref[blk] += 1                # the mutation: silent bump
    with pytest.raises(SanitizeError, match="refcount-drift"):
        b.step()


# ---------------------------------------------------- adapter sanitizer ----
def _tenant_registry(n, capacity):
    model = pair()["eng"].model
    reg = AdapterRegistry(model, capacity=capacity)
    trees = make_tenant_adapters(model, n, seed=1)
    for t, tree in enumerate(trees):
        reg.register(f"tenant{t}", tree, version=1)
    return reg, trees


def test_adapter_evict_with_live_refs_detected(armed):
    """A pinned tenant leaking into the LRU cold list (a lost refcount)
    is caught at eviction, before its slot is reused."""
    reg, _ = _tenant_registry(2, capacity=1)
    reg.acquire("tenant0")                    # pinned: 1 live ref
    reg._lru["tenant0"] = reg._slot["tenant0"]   # the mutation
    with pytest.raises(SanitizeError, match="evict-live-refs"):
        reg.acquire("tenant1")                # needs the slot -> evicts


def test_adapter_version_regression_detected(armed):
    """Publishing an older version after a newer one was served rolls a
    tenant back silently; the sanitizer makes it loud."""
    reg, trees = _tenant_registry(1, capacity=1)
    reg.update("tenant0", trees[0], version=5)
    with pytest.raises(SanitizeError, match="version-regression"):
        reg.update("tenant0", trees[0], version=3)


def test_adapter_mid_publish_read_detected(armed):
    """A decode wave reading a slot whose in-place publish is still in
    flight would read torn weights."""
    reg, _ = _tenant_registry(1, capacity=1)
    reg.acquire("tenant0")
    san = AdapterSanitizer()
    san.on_acquire("tenant0")
    san.begin_publish("tenant0", 2)           # publish never completed
    fake = types.SimpleNamespace(adapters=reg, slot_aid=["tenant0"])
    with pytest.raises(SanitizeError, match="mid-publish-read"):
        san.check_decode_wave(fake, [0])


def test_adapter_release_without_acquire_detected(armed):
    san = AdapterSanitizer()
    with pytest.raises(SanitizeError, match="release-without-acquire"):
        san.on_release("tenant0")


# --------------------------------------------------- lifecycle sanitizer ---
def test_terminal_replay_detected(armed):
    """Resubmitting a FINISHED request fails at submit: its tokens would
    be generated and counted twice."""
    b = _batcher()
    req = GenRequest(request_id=0,
                     prompt=sample_prompts(pair()["jcfg"], 1, [6])[0],
                     max_new_tokens=3)
    b.run([req])
    assert req.done
    with pytest.raises(SanitizeError, match="terminal-replay"):
        b.submit(req)


def test_evicted_slot_decoding_detected():
    """A decode wave advancing a slot whose request is not active means
    the runtime generates tokens into freed state."""
    lsan = RequestLifecycle()
    req = GenRequest(request_id=7, prompt=np.zeros(4, np.int32))
    lsan.on_submit(req)
    lsan.on_admit(req)
    lsan.on_finish(req)                       # slot was evicted...
    fake = types.SimpleNamespace(slot_req=[req])   # ...but still decodes
    with pytest.raises(SanitizeError, match="evicted-decoding"):
        lsan.check_decode_wave(fake, [0])


def test_terminal_request_requeue_detected():
    """``RequestFSM.check_requeue``, the check the fabric's retry policy
    runs: a served or failed request handed back for a retry is a
    control-plane lifecycle bug; a pending one passes."""
    fsm = RequestFSM()
    req = Request(request_id=0, stream_id="s", arrival=0.0, deadline=9.0)
    fsm.check_requeue(req)                    # pending: retryable
    req.completed_at = 1.0                    # terminal: already served
    with pytest.raises(SanitizeError, match="terminal-retried"):
        fsm.check_requeue(req)
    failed = Request(request_id=1, stream_id="s", arrival=0.0, deadline=9.0,
                     status="failed", failed_reason="shed")
    with pytest.raises(SanitizeError, match=r"terminal-retried.*shed"):
        fsm.check_requeue(failed)


# --------------------------------------------------------- clean run -------
def test_clean_sanitized_run_reports_nothing(armed):
    """The paged, prefix-cache and multi-tenant serving path runs under
    REPRO_SANITIZE=1 with no report: the sanitizers flag only injected
    mutations, never the runtime."""
    baseline = len(sanitize.reports())
    reg, _ = _tenant_registry(2, capacity=2)
    b = _batcher(prefix_cache=True, adapters=reg)
    assert b.allocator.san is not None and reg.san is not None
    prompts = sample_prompts(pair()["jcfg"], 4, [6, 6, 7, 5])
    reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=4,
                       adapter_id=f"tenant{i % 2}")
            for i, p in enumerate(prompts)]
    b.run(reqs)
    assert all(r.done for r in reqs)
    assert len(sanitize.reports()) == baseline
