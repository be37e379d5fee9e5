"""Multi-replica live serving fabric: one ``ClusterController`` routing
dispatcher subflows across a pool of ``ContinuousBatcher``-backed
``LiveReplica``s — the paper's shared-cluster system over the port's
runtime on the card instead of ``SimReplica`` surfaces.

The fabric owns the wall-clock control loop:

  tick        ``ClusterController.tick(now)`` runs the two-timescale
              dispatcher (macro: latency-model refits + b_max budgets,
              micro: Eq. 18-19 priority reallocation + queued-request
              rebalancing) and, with fine-tuning enabled, the launcher/
              coordinator replanning of per-replica train/infer splits;
  pump        every live replica advances ONE runtime tick
              (``pump_once``: gated ingest → decode step → emit), so
              replicas interleave on a shared device instead of one
              ``pump`` monopolizing it; a replica with an active train
              session fuses ITS tick with one shadow-adapter
              ``combined_step`` (incremental rounds — no blocking
              ``train_round`` call ever stalls the pool);
  placement   the dispatcher fires subflows in *headroom* order (free
              pool blocks / free slots / queue depth via
              ``ReplicaHandle.pressure``) and routes requests whose
              prompts match a replica's registered prefix-cache chains
              to that replica (``prefix_affinity``);
  failover    ``fail_replica`` tears a replica down mid-flight
              (``drain_pending``: all pool blocks freed) and requeues
              its unfinished requests on the survivors — no request is
              lost, and greedy outputs are unchanged because survivors
              regenerate from the prompt.

``build_fabric`` is the one-call constructor used by
``launch/serve.py --replicas N``: every replica shares the same frozen
base params (one device copy, the paper's model-sharing premise) but
owns its adapter, optimizer state, and KV cache pool.
``fabric_from_weights`` assembles a fabric the same way over weights the
caller already holds.  The replicas run one after the other on the
current CUDA stream, so the kernels' split workspaces
(``kernels/_scratch.py``) are shared in order.  On the card both warm
the replicas' shapes up before they return (``warm_up``): the first
calls build the kernels and would otherwise fail a healthy replica's
heartbeats inside the loop.
"""
from __future__ import annotations

import dataclasses
import logging
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cluster import ClusterConfig, ClusterController
from repro_torch.core.interfaces import BatchResult, Request
from repro_torch.runtime.fault import (
    FaultInjector, HealthConfig, HealthMonitor, RetryPolicy,
)
from repro_torch.runtime.metrics import aggregate_serve_stats
from repro_torch.runtime.replica import LiveReplica
from repro_torch.tree import tree_map

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class FabricConfig:
    """Throughput-oriented defaults for live multi-replica serving."""
    slo: float = 120.0              # generous: live smoke runs are slow
    in_flight_limit: int = 2        # keep each replica double-buffered
    monitor_interval: float = 0.05
    t_fit: float = 2.0
    t_adjust: float = 0.5
    bootstrap_b_max: int = 8
    enable_finetuning: bool = False
    # live COMBINED sessions (enable_finetuning=True): cohort + round
    # pacing sized for wall-clock smoke fabrics — the simulator's
    # 50-step / 5-second-decision defaults would starve a live loop
    min_cohort: int = 2
    decision_interval: float = 0.25
    bootstrap_steps: int = 4
    steps_per_round: int = 4
    train_batch: int = 4            # B0 bootstrap train batch
    max_rounds: int = 1000
    # fault tolerance (runtime/fault.py): pump-driven health + retries
    beat_timeout: float = 1.0       # silent seconds = one missed beat
    max_missed_beats: int = 3
    health_poll_interval: float = 0.1
    straggler_threshold: float = 3.0
    straggler_window: int = 32
    straggler_min_samples: int = 8
    straggler_warmup: int = 4       # jit-compile grace per replica
    quarantine_cooldown: float = 1.0
    max_retries: int = 4            # re-admissions per request
    max_request_failures: int = 3   # replica deaths before poison verdict
    retry_backoff: float = 0.05     # base of the exponential backoff
    # token-level co-scheduling (chunked prefill + SLO tick budgets):
    # prefill_chunk > 0 splits prompt prefill into fixed-token chunks
    # interleaved with decode ticks; tpot_target > 0 (seconds/token)
    # budgets each tick — decode first, prefill chunks in slack order,
    # leftover slack admits (possibly shrunk) train microbatches
    prefill_chunk: int = 0
    tpot_target: float = 0.0
    # oversubscribed KV pool (paged only): oversubscribe in (0, 1]
    # reserves only near-term need against that pool watermark and
    # preempts on exhaustion (victims swap to host or drop+re-prefill,
    # swap=False forces drop); 0 keeps preemption-free worst-case
    # reservations
    oversubscribe: float = 0.0
    swap: bool = True


class ServingFabric:
    """Dispatcher-routed pool of live replicas with placement-aware
    admission, micro-cycle rebalancing, and mid-flight failover.  With
    ``enable_finetuning=True`` the fabric tick also drives the
    Launcher/Coordinator two-timescale loop over the SAME replicas:
    incremental COMBINED train sessions advance one fused step per
    ``pump_once`` tick, and round aggregation publishes merged adapters
    at round boundaries only (shadow-adapter double buffering keeps
    in-round serving bit-identical to serve-only)."""

    def __init__(self, cfg: Optional[FabricConfig] = None):
        self.cfg = cfg or FabricConfig()
        ccfg = ClusterConfig(slo=self.cfg.slo,
                             monitor_interval=self.cfg.monitor_interval,
                             enable_finetuning=self.cfg.enable_finetuning)
        ccfg.dispatcher.in_flight_limit = self.cfg.in_flight_limit
        ccfg.dispatcher.t_fit = self.cfg.t_fit
        ccfg.dispatcher.t_adjust = self.cfg.t_adjust
        ccfg.dispatcher.bootstrap_b_max = self.cfg.bootstrap_b_max
        if self.cfg.enable_finetuning:
            ccfg.launcher.min_cohort = self.cfg.min_cohort
            ccfg.launcher.decision_interval = self.cfg.decision_interval
            ccfg.launcher.max_rounds = self.cfg.max_rounds
            ccfg.launcher.coordinator.bootstrap_steps = \
                self.cfg.bootstrap_steps
            ccfg.launcher.coordinator.steps_per_round = \
                self.cfg.steps_per_round
            ccfg.launcher.coordinator.bootstrap_train_batch = \
                self.cfg.train_batch
        self.cluster = ClusterController(ccfg)
        self.replicas: Dict[str, LiveReplica] = {}
        # failed/removed replicas' serving counters: their pre-kill work
        # must stay in the cluster totals
        self.retired_stats: Dict[str, Any] = {}
        self.results: List[BatchResult] = []
        # fault tolerance: pump-driven health verdicts + the request
        # retry budget the failover drain path charges
        self.health = HealthMonitor(HealthConfig(
            beat_timeout=self.cfg.beat_timeout,
            max_misses=self.cfg.max_missed_beats,
            poll_interval=self.cfg.health_poll_interval,
            straggler_threshold=self.cfg.straggler_threshold,
            straggler_window=self.cfg.straggler_window,
            straggler_min_samples=self.cfg.straggler_min_samples,
            straggler_warmup=self.cfg.straggler_warmup,
            quarantine_cooldown=self.cfg.quarantine_cooldown))
        self.retry_policy = RetryPolicy(
            max_retries=self.cfg.max_retries,
            max_failures=self.cfg.max_request_failures,
            backoff_base=self.cfg.retry_backoff)
        self.cluster.retry_policy = self.retry_policy
        self.injector: Optional[FaultInjector] = None
        # fault log: (now, replica_id, action) — failover/quarantine
        # decisions for telemetry and post-mortems
        self.fault_log: List[Tuple[float, str, str]] = []
        # contained pump exceptions: (now, replica_id, "Type: text" and
        # the traceback) -- the health monitor keeps only the type name,
        # which cannot tell a kernel's refusal or a failed launch from an
        # injected crash
        self.pump_errors: List[Tuple[float, str, str]] = []
        # seconds ``warm_up`` took (0 off the card)
        self.warm_s = 0.0
        self.quarantines = 0
        self.failovers = 0

    # ------------------------------------------------------------ registry -
    def on_result(self, result: BatchResult, stream_id: str) -> None:
        """Completion callback wired into every replica at build time."""
        self.results.append(result)
        self.cluster.on_batch_result(result, stream_id)

    def add_replica(self, rep: LiveReplica) -> None:
        from repro_torch.core.states import ReplicaState
        if self.injector is not None and getattr(rep, "injector",
                                                 None) is None:
            rep.injector = self.injector
        self.replicas[rep.replica_id] = rep
        # with fine-tuning on, fresh replicas join IDLE so the launcher
        # can cohort them immediately (a new replica has served nothing
        # — waiting for the Eq. 1 EWMAs to notice would be pure delay);
        # unselected ones roll back to SERVING after T' decisions
        self.cluster.add_replica(
            rep, ReplicaState.IDLE if self.cfg.enable_finetuning
            else ReplicaState.SERVING)

    def fail_replica(self, replica_id: str, now: float) -> LiveReplica:
        """Mid-flight failure: the controller drains the dead replica
        (all pool blocks freed) and requeues its unfinished requests on
        the survivors.  Returns the removed handle for post-mortems."""
        rep = self.replicas.pop(replica_id)
        self.cluster.remove_replica(replica_id, now)
        self.retired_stats[replica_id] = rep.batcher.stats
        self.health.forget(replica_id)
        self.failovers += 1
        self.fault_log.append((now, replica_id, "failover"))
        # multi-tenant failover: every tenant the dead replica served
        # must stay servable — re-register its host tree (at the dead
        # replica's version) on any survivor that lacks it; survivors
        # already serving the tenant keep their own copy
        if rep.adapters is not None:
            for aid in rep.adapters.registered():
                tree = rep.adapters.host_tree(aid)
                ver = rep.adapters.version(aid)
                for peer in self.replicas.values():
                    if peer.adapters is not None \
                            and not peer.adapters.is_registered(aid):
                        peer.adapters.register(aid, tree, version=ver)
        return rep

    # ------------------------------------------------------------ serving --
    def submit(self, req: Request) -> None:
        self.cluster.submit_request(req)

    def tick(self, now: float) -> bool:
        """ONE fabric tick: run the control plane (dispatcher macro/
        micro cycles AND — with fine-tuning enabled — the launcher's
        session polling / round aggregation), then advance every live
        replica one runtime tick (``pump_once``: serving decode fused
        with its session's train step).  Returns True while any replica
        holds unfinished serving work.

        Fault containment: an exception escaping a pump NEVER crashes
        the loop — it is reported to the HealthMonitor as a detected
        failure, and the tick closes by acting on health verdicts
        (dead -> ``fail_replica`` failover, straggler -> quarantine
        drain + dispatcher suspension)."""
        self.cluster.tick(now)
        busy = False
        for rid, rep in list(self.replicas.items()):
            if rid not in self.replicas:
                continue        # removed by an earlier verdict this tick
            t0 = time.perf_counter()
            try:
                served = rep.pump_once(now)
            except Exception as e:          # noqa: BLE001 — containment
                self.health.failure(rid, now,
                                    reason=type(e).__name__)
                self.pump_errors.append((now, rid, traceback.format_exc()))
                _log.warning("%s: pump raised %s: %s (contained: the "
                             "replica fails over)", rid, type(e).__name__, e)
                continue
            # heartbeat off REAL pump progress; serving ticks feed
            # their wall latency to the straggler watch (idle ticks
            # are ~free and would drag the medians toward zero)
            self.health.beat(rid, now,
                             busy_s=time.perf_counter() - t0
                             if served else None)
            busy = served or busy
        dead, stragglers = self.health.poll(now)
        for rid in dead:
            if rid in self.replicas:
                self.fail_replica(rid, now)
        for rid in stragglers:
            if rid in self.replicas:
                self.quarantine_replica(rid, now)
        return busy

    def quarantine_replica(self, replica_id: str, now: float) -> None:
        """Straggler mitigation: drain the replica's pending work back
        through the SAME ``drain_pending`` path failover uses (charged
        to the retry budget as a non-fatal re-admission), requeue it on
        the stream queues, and suspend the replica's subflows for the
        health cooldown.  The replica stays a pool member — after the
        cooldown the dispatcher resumes routing to it and the watch
        re-evaluates from fresh samples."""
        rep = self.replicas[replica_id]
        until = self.health.quarantine(replica_id, now)
        drained = rep.drain_pending(now)
        survivors = self.retry_policy.filter_requeue(
            drained, now, replica_died=False)
        by_stream: Dict[str, List[Request]] = {}
        for req in survivors:
            by_stream.setdefault(req.stream_id, []).append(req)
        for sid, reqs in by_stream.items():
            self.cluster.dispatcher_for(sid).requeue(reqs)
        for d in self.cluster.dispatchers.values():
            d.suspend_replica(replica_id, until)
        self.quarantines += 1
        self.fault_log.append((now, replica_id, "quarantine"))

    @property
    def training(self) -> bool:
        """True while any FL session is open on the fabric."""
        return bool(self.cluster.launcher.sessions)

    def run(self, requests: Sequence[Request], *,
            timeout: float = 600.0,
            failures: Sequence[Tuple[float, str]] = (),
            min_rounds: int = 0) -> Dict:
        """Drive the fabric until every request completes (or re-queues
        are impossible).  ``requests`` are submitted when the wall clock
        passes their ``arrival``; ``failures`` is a list of
        ``(time, replica_id)`` kill events injected mid-run.  With
        fine-tuning enabled, ``min_rounds`` keeps the loop ticking until
        that many FL rounds have aggregated (bounded by ``timeout``).
        Returns the aggregate serving summary (see
        ``aggregate_serve_stats``) plus dispatcher/routing telemetry
        and, when training ran, the launcher's round history."""
        todo = sorted(requests, key=lambda r: r.arrival)
        kills = sorted(failures)
        next_req = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while next_req < len(todo) and todo[next_req].arrival <= now:
                self.submit(todo[next_req])
                next_req = next_req + 1
            while kills and kills[0][0] <= now:
                _, rid = kills.pop(0)
                if rid in self.replicas:
                    self.fail_replica(rid, now)
            busy = self.tick(now)
            rounds_ok = self.cluster.launcher.completed_rounds \
                >= min_rounds
            # a request is settled once TERMINAL: served, or
            # terminally rejected (retry budget / poison / deadline) —
            # waiting on a failed request would spin out the timeout
            if next_req >= len(todo) and not kills and not busy \
                    and all(r.terminal for r in todo) \
                    and (rounds_ok or not self.training):
                break
            if not self.replicas:
                # every replica failed: requeued requests have nowhere
                # to go — report the stranding instead of spinning out
                # the timeout
                break
            if now > timeout:
                break
            if not busy and not self.training:
                # idle until the next arrival / subflow fire instead of
                # hot-spinning the control loop (a live session keeps
                # the loop hot: every tick is one fused train step)
                time.sleep(0.002)
        out = self.summary()
        out["incomplete_requests"] = sum(
            1 for r in todo if r.completed_at is None)
        out["failed_requests"] = sum(
            1 for r in todo if r.status == "failed")
        return out

    # ---------------------------------------------------------- telemetry --
    def summary(self) -> Dict:
        out = aggregate_serve_stats(
            {**self.retired_stats,
             **{rid: rep.batcher.stats
                for rid, rep in self.replicas.items()}})
        out["dispatchers"] = {
            sid: {"dispatched": d.dispatched, "dropped": d.dropped,
                  "affinity_routed": d.affinity_routed,
                  "adapter_routed": d.adapter_routed,
                  "rebalanced": d.rebalanced,
                  "overload_promotions": d.overload_promotions}
            for sid, d in self.cluster.dispatchers.items()}
        launcher = self.cluster.launcher
        out["fl_rounds"] = launcher.completed_rounds
        out["rounds"] = [dict(r) for r in launcher.round_history]
        out["adapter_versions"] = dict(launcher.adapter_versions)
        out["fault_tolerance"] = {
            "failovers": self.failovers,
            "quarantines": self.quarantines,
            "failures_detected": len(self.health.failures),
            "retried_requests": self.retry_policy.retried,
            "rejected_requests": len(self.retry_policy.rejected),
            "nan_publishes_blocked":
                out["cluster"]["nan_publishes_blocked"],
            "injected": list(self.injector.injected)
                if self.injector is not None else [],
            "log": list(self.fault_log),
            "pump_errors": list(self.pump_errors),
        }
        return out


def make_tenant_adapters(model, n: int, *, seed: int = 0) -> List[Any]:
    """``n`` distinct tenant LoRA trees on the model's device.

    A fresh adapter has ``b = 0`` (a no-op), which would make every tenant
    serve the base model's tokens, so tenants t >= 1 draw a nonzero ``b``
    per target at scale 0.5 (much smaller perturbations shift the logits
    without flipping an argmax on small configs).  Tenant 0 keeps the
    no-op init: it is the co-training tenant.  Tenant t draws from its
    own ``torch.Generator`` seeded ``seed + 101 * t``, ``a`` first, then
    each target's ``b`` in sorted target order."""
    out = []
    for t in range(n):
        gen = torch.Generator(device=model.device).manual_seed(seed + 101 * t)
        tree = model.init_lora(gen)
        if t > 0:
            for tgt in sorted(tree):
                b = tree[tgt]["b"]
                tree[tgt]["b"] = 0.5 * torch.randn(
                    b.shape, generator=gen, dtype=b.dtype, device=b.device)
        out.append(tree)
    return out


def build_fabric(arch: str, n_replicas: int, *, smoke: bool = True,
                 n_slots: int = 4, prompt_len: int = 32,
                 gen_tokens: int = 16, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefix_cache: bool = False, seed: int = 0,
                 train_pool: int = 0, n_adapters: int = 0,
                 adapter_slots: Optional[int] = None,
                 cfg: Optional[FabricConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 device="cuda") -> Tuple[ServingFabric, Any]:
    """Build a fabric of ``n_replicas`` live replicas on ``device`` over
    ONE shared set of frozen base params (each replica owns its adapter,
    optimizer state, and cache pool).  Returns ``(fabric, model_cfg)``.
    The base params come from ``torch.Generator(seed)``, the co-training
    adapter from ``seed + 1`` and the tenants from
    ``make_tenant_adapters(seed=seed + 1)``.

    ``train_pool > 0`` fixes the fine-tuning corpus to that many
    batches cycled epoch-style (a finite finetuning set, the realistic
    FL PEFT workload — and a train-loss signal strong enough to gate
    on); 0 streams fresh synthetic batches every step.

    ``n_adapters > 0`` turns on multi-tenant serving: every replica
    gets an ``AdapterRegistry`` (``adapter_slots`` device slots, all
    tenants by default) with the SAME ``tenant0..tenant{k-1}`` trees
    registered, so any replica can serve any tenant and failover
    regeneration stays bit-identical.  ``tenant0``'s tree IS the
    replica's co-training adapter: each publish writes through to its
    registry slot (``LiveReplica.publish_adapter``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.runtime.serving_loop import refuse_vlm

    mcfg = get_config(arch)
    refuse_vlm(mcfg)                    # before building a model for it
    if smoke:
        mcfg = mcfg.scaled()
    assert mcfg.has_decode, f"{arch} is encoder-only; no decode serving"
    engine = make_engine(mcfg, lr=3e-3, device=device)
    model = engine.model
    params = model.init(
        torch.Generator(device=model.device).manual_seed(seed))
    tenant_trees: List[Any] = []
    if n_adapters > 0:
        tenant_trees = make_tenant_adapters(model, n_adapters,
                                            seed=seed + 1)
        lora = tenant_trees[0]
    else:
        lora = model.init_lora(
            torch.Generator(device=model.device).manual_seed(seed + 1))
    fabric = fabric_from_weights(
        engine, params, lora, n_replicas, n_slots=n_slots,
        prompt_len=prompt_len, gen_tokens=gen_tokens, paged=paged,
        block_size=block_size, n_blocks=n_blocks,
        prefix_cache=prefix_cache, seed=seed, train_pool=train_pool,
        tenant_trees=tenant_trees, adapter_slots=adapter_slots, cfg=cfg,
        injector=injector)
    return fabric, mcfg


def fabric_from_weights(engine, params, lora, n_replicas: int, *,
                        n_slots: int = 4, prompt_len: int = 32,
                        gen_tokens: int = 16, paged: bool = False,
                        block_size: int = 16,
                        n_blocks: Optional[int] = None,
                        prefix_cache: bool = False, seed: int = 0,
                        train_pool: int = 0,
                        tenant_trees: Sequence[Any] = (),
                        adapter_slots: Optional[int] = None,
                        cfg: Optional[FabricConfig] = None,
                        injector: Optional[FaultInjector] = None
                        ) -> ServingFabric:
    """``build_fabric``'s assembly over weights already on the engine's
    device: every replica reads the one ``params`` tree, and starts from
    its own copy of ``lora`` (or, with ``tenant_trees``, from tenant 0's
    tree, registered with every tenant on its ``AdapterRegistry``;
    ``lora`` is then unused).  Train batches come from
    ``SyntheticDataset("alpaca", seed=seed)``."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import AdapterRegistry

    model = engine.model
    data = SyntheticDataset("alpaca", vocab_size=model.cfg.vocab_size,
                            seq_len=max(prompt_len, 16), seed=seed)
    pools: Dict[int, List[Dict[str, Any]]] = {}

    def make_data_fn() -> Callable[[int], Dict[str, Any]]:
        """Per-replica cursor over the SHARED batch pool: every member
        walks the same finite corpus in the same epoch order (the FL
        local-dataset pass), independent of how the fabric interleaves
        replica ticks — pool consumption stays deterministic."""
        cursors: Dict[int, int] = {}

        def data_fn(b: int) -> Dict[str, Any]:
            def fresh():
                return {k: torch.as_tensor(v, device=model.device)
                        for k, v in data.batch(b).items()}

            if train_pool <= 0:
                return fresh()
            if b not in pools:
                pools[b] = [fresh() for _ in range(train_pool)]
            i = cursors.get(b, 0)
            cursors[b] = i + 1
            return pools[b][i % train_pool]

        return data_fn

    n_adapters = len(tenant_trees)
    fabric = ServingFabric(cfg)
    if train_pool > 0:
        # prewarm the shared pool at build time: materializing
        # train_pool device batches lazily would land on the first
        # train-due tick — usually a SERVING tick — and charge data
        # prep to measured serving wall time
        make_data_fn()(fabric.cfg.train_batch)
    fabric.injector = injector
    for i in range(n_replicas):
        if n_adapters > 0:
            # tenant0's no-op tree doubles as the replica's co-training
            # adapter — identical on every replica, so mixed placement
            # and failover keep greedy streams bit-identical
            rep_lora = tenant_trees[0]
        else:
            rep_lora = tree_map(torch.clone, lora)
        opt_state = engine.optimizer.init(rep_lora)
        registry = None
        train_tenant = None
        if n_adapters > 0:
            registry = AdapterRegistry(
                model, capacity=adapter_slots or n_adapters)
            for t, tree in enumerate(tenant_trees):
                registry.register(f"tenant{t}", tree)
            train_tenant = "tenant0"
        fabric.add_replica(LiveReplica(
            f"r{i}", model.cfg.name, engine, params, rep_lora, opt_state,
            on_result=fabric.on_result, data_fn=make_data_fn(),
            serve_slots=n_slots, serve_prompt_len=prompt_len,
            max_gen_tokens=gen_tokens, serve_paged=paged,
            serve_block_size=block_size, serve_n_blocks=n_blocks,
            serve_prefix_cache=prefix_cache, adapters=registry,
            train_tenant=train_tenant,
            serve_prefill_chunk=fabric.cfg.prefill_chunk,
            serve_tpot_target=fabric.cfg.tpot_target,
            serve_oversubscribe=fabric.cfg.oversubscribe,
            serve_swap=fabric.cfg.swap))
    if model.device.type == "cuda":
        fabric.warm_s = warm_up(fabric, seed=seed)
    return fabric


def warm_up(fabric: ServingFabric, seed: int = 0) -> float:
    """Run the replicas' first calls before the fabric's clock starts, on
    a throwaway batcher of their shapes over their engine, weights and
    tenants: one prefill wave of every slot, its decode ticks and, with
    fine-tuning on, fused train steps at the bootstrap train batch in
    the microbatches ``LiveReplica.begin_round`` splits it into; then the
    eval probe's no-grad loss on 4 rows (``LiveReplica._probe_loss``,
    which the control tick runs).  On the card the first calls build the
    kernels (nvcc), create cuBLAS's handles and grow the allocator;
    inside the loop they would stall a replica past ``beat_timeout`` x
    ``max_missed_beats`` and fail it over.  The replicas share one engine
    and one set of shapes, so the first replica's warms them all; no
    replica's state, adapter or data stream is touched.  Returns the
    seconds it took."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import (
        AdapterRegistry, ContinuousBatcher, GenRequest,
    )

    t0 = time.perf_counter()
    rep = next(iter(fabric.replicas.values()))
    b, engine = rep.batcher, rep.engine
    reg = None
    if b.adapters is not None:
        reg = AdapterRegistry(engine.model, b.adapters.capacity)
        for aid in b.adapters.registered():
            reg.register(aid, b.adapters.host_tree(aid))
    lora = tree_map(torch.clone, rep.lora)
    wb = ContinuousBatcher(
        engine, rep.params, lora, n_slots=b.n_slots, max_seq=b.max_seq,
        prompt_pad=b.prompt_pad, opt_state=engine.optimizer.init(lora),
        paged=b.paged, block_size=b.block_size, adapters=reg)
    aids = reg.registered() if reg is not None else [None]
    for i in range(b.n_slots):
        wb.submit(GenRequest(
            request_id=i,
            prompt=(np.arange(b.prompt_pad, dtype=np.int32) + 7 * i)
            % engine.model.cfg.vocab_size,
            max_new_tokens=2, adapter_id=aids[i % len(aids)]))
    data = SyntheticDataset("alpaca", vocab_size=engine.model.cfg.vocab_size,
                            seq_len=max(b.prompt_pad, 16), seed=seed)
    tb = None
    if fabric.cfg.enable_finetuning:
        rows = fabric.cfg.train_batch
        tb = wb._device_batch(data.batch(rows))
        wb.train_lora = lora
        wb.train_grad_accum = 2 if rows >= 2 and rows % 2 == 0 else 1
    while not wb.idle():
        wb.step(train_batch=tb)
    with torch.no_grad():
        engine.model.forward_loss(rep.params, lora,
                                  wb._device_batch(data.batch(4)))
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize(engine.model.device)
    return time.perf_counter() - t0
