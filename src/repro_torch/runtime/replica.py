"""Replica implementations of the ReplicaHandle protocol.

``SimReplica``  — discrete-event replica with analytic interference
                  surfaces (ground truth the control plane must learn).
``LiveReplica`` — real PyTorch execution: serve/train/combined steps
                  on the model's device (the card, or the CPU in the
                  tests), wall-clock latencies.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time as _time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.interfaces import (
    BatchResult, ReplicaHandle, ReplicaPressure, Request, TrainRoundStats,
)
from repro_torch.optim.grad_noise import (
    NoiseScaleEMA, noise_scale_from_microbatches,
)
from repro_torch.tree import tree_finite, tree_map


def _host_tokens(tokens: Any) -> np.ndarray:
    """A drawn batch's token ids as a host array (``data_fn`` batches may
    already sit on the device)."""
    if isinstance(tokens, torch.Tensor):
        return tokens.cpu().numpy()  # lint: host-sync-ok prompts drawn for requests without one, once per admitted group
    return np.asarray(tokens)


# =========================================================================
# Simulated replica
# =========================================================================
@dataclasses.dataclass
class InterferenceSurface:
    """Ground-truth latency surfaces (bivariate + noise, §2.2).

    Defaults are calibrated to an 8B-class model on a 2-accelerator
    replica: exclusive inference latency 0.02·b + 0.05 s (b=16 ⇒ 0.37 s,
    inside the 0.5 s SLO), training step 0.03·B + 0.10 s, with cross
    terms producing the Fig. 4b interference regime.
    """
    infer_alpha: float = 0.020    # s per inference-batch element
    infer_beta: float = 0.008     # interference from co-running train batch
    infer_gamma: float = 0.050    # fixed cost
    train_alpha: float = 0.030
    train_beta: float = 0.010
    train_gamma: float = 0.100
    noise_frac: float = 0.04      # lognormal-ish multiplicative noise

    def t_infer(self, b: int, train_b: int, rng: np.random.Generator
                ) -> float:
        base = self.infer_alpha * b + self.infer_beta * train_b \
            + self.infer_gamma
        return float(base * rng.lognormal(0.0, self.noise_frac))

    def t_train(self, train_b: int, b: int, rng: np.random.Generator
                ) -> float:
        base = self.train_alpha * train_b + self.train_beta * b \
            + self.train_gamma
        return float(base * rng.lognormal(0.0, self.noise_frac))


@dataclasses.dataclass
class LossCurve:
    """Per-replica fine-tuning dynamics: exponential-decay loss toward a
    data-dependent floor, driven by samples seen; FedAvg pulls members
    toward the cohort mean (heterogeneous data, §4.2)."""
    init_loss: float = 2.4
    floor: float = 0.8
    rate: float = 1.0 / 6000.0    # per training sample
    # effective samples: statistical-efficiency scaling accumulates
    # fractional ``samples * eff`` increments, so this is a float
    seen: float = 0.0

    def loss(self) -> float:
        return self.floor + (self.init_loss - self.floor) \
            * math.exp(-self.rate * self.seen)

    def advance(self, samples: int, batch_size: int = 0
                ) -> Tuple[float, float]:
        """Advance by ``samples``; with a batch size given, apply
        Pollux-style statistical efficiency (McCandlish): per-sample
        progress decays once the batch exceeds the gradient-noise scale
        — the ground truth the Coordinator's Eq. 8 has to learn."""
        before = self.loss()
        eff = 1.0
        if batch_size > 0:
            noise = self.noise_scale()
            eff = (noise + 1.0) / (noise + float(batch_size))
        self.seen += samples * eff
        return before, self.loss()

    def noise_scale(self) -> float:
        """Gradient noise scale grows as loss approaches the floor
        (empirically: later training tolerates larger batches)."""
        prog = 1.0 - (self.loss() - self.floor) \
            / max(self.init_loss - self.floor, 1e-9)
        return 4.0 + 60.0 * prog


class SimReplica:
    """Discrete-event replica.  One batch executes at a time (Eq. 13d);
    a COMBINED-mode training round occupies a parallel 'stream' whose
    only coupling to serving is the interference surface — the simulator
    analogue of the fused combined step."""

    def __init__(self, replica_id: str, model_id: str, simulator,
                 on_result: Callable[[BatchResult, str], None],
                 surface: Optional[InterferenceSurface] = None,
                 loss_curve: Optional[LossCurve] = None,
                 seed: int = 0, slow_factor: float = 1.0):
        self.replica_id = replica_id
        self.model_id = model_id
        self.sim = simulator
        self.on_result = on_result
        self.surface = surface or InterferenceSurface()
        self.loss_curve = loss_curve or LossCurve()
        self.rng = np.random.default_rng(seed)
        self.slow_factor = slow_factor          # straggler injection
        self.failed = False

        self.busy_until: float = 0.0
        self.pending: Deque[Tuple[float, List[Request]]] = collections.deque()
        # scheduled-but-unfinished work: (finish_time, n_requests)
        self.outstanding: Deque[Tuple[float, int]] = collections.deque()
        self.train_batch: int = 0               # active co-running B
        self.training_until: float = 0.0
        self.adapter: Any = {"version": 0}
        self.adapter_version: int = 0
        # active incremental round:
        # ((train_batch, infer_batch, steps, step_time), started, done)
        self._round: Optional[Tuple[Tuple[int, int, int, float],
                                    float, float]] = None
        # busy-interval bookkeeping for utilization()
        self.busy_intervals: Deque[Tuple[float, float]] = collections.deque(
            maxlen=4096)
        self.served_requests: int = 0
        self.served_tokens: int = 0
        self.total_infer_time: float = 0.0
        self.total_train_time: float = 0.0

    # ------------------------------------------------------------- serving -
    def submit_batch(self, requests: Sequence[Request], now: float) -> None:
        if self.failed or not requests:
            return
        self.pending.append((now, list(requests)))
        self._drain(now)

    def _drain(self, now: float) -> None:
        while self.pending:
            submit_t, batch = self.pending.popleft()
            start = max(now, self.busy_until)
            train_b = self.train_batch if start < self.training_until else 0
            lat = self.surface.t_infer(len(batch), train_b, self.rng) \
                * self.slow_factor
            finish = start + lat
            self.busy_until = finish
            self.busy_intervals.append((start, finish))
            self.outstanding.append((finish, len(batch)))
            q = self.quality_score(now)
            self.sim.schedule(
                finish,
                lambda t, b=batch, s=submit_t, st=start, l=lat,
                tb=train_b, qq=q: self._complete(t, b, s, st, l, tb, qq),
                tag=f"batch:{self.replica_id}")

    def _complete(self, now: float, batch: List[Request], submit_t: float,
                  start: float, lat: float, train_b: int, q: float) -> None:
        tokens = 0
        queue_waits = []
        for r in batch:
            r.completed_at = now
            r.quality = q
            tokens += r.tokens
            # T_queue per the paper §6.2: everything before processing
            # starts — dispatcher pacing wait included ("the cost of
            # controllability"), not just replica-side queueing.
            queue_waits.append(start - r.arrival)
        self.served_requests += len(batch)
        self.served_tokens += tokens
        self.total_infer_time += lat
        stream = batch[0].stream_id
        self.on_result(BatchResult(
            replica_id=self.replica_id, batch_size=len(batch),
            infer_latency=lat, total_latency=now - submit_t,
            queue_latency=float(np.mean(queue_waits)), finished_at=now,
            quality=q, tokens=tokens, train_batch=train_b), stream)

    # ------------------------------------------------------------ telemetry
    def _prune_outstanding(self, now: float) -> None:
        while self.outstanding and self.outstanding[0][0] <= now:
            self.outstanding.popleft()

    def queue_length(self, now: float) -> int:
        """Requests accepted but not yet finished."""
        self._prune_outstanding(now)
        return sum(n for _, n in self.outstanding) \
            + sum(len(b) for _, b in self.pending)

    def outstanding_batches(self, now: float) -> int:
        self._prune_outstanding(now)
        return len(self.outstanding) + len(self.pending)

    def utilization(self, now: float, window: float = 10.0) -> float:
        lo = now - window
        busy = 0.0
        for s, e in self.busy_intervals:
            if e <= lo or s >= now:   # outside window / scheduled ahead
                continue
            busy += max(min(e, now) - max(s, lo), 0.0)
        util = busy / window
        if now < self.training_until and self.train_batch > 0:
            util += 0.75  # co-running fine-tuning soaks spare compute
        return float(min(util, 1.0))

    # ------------------------------------------------- placement signals ---
    def pressure(self, now: float) -> ReplicaPressure:
        """Analytic stand-in for the live runtime's pressure export: one
        execution unit, queue depth as the load signal, no block pool."""
        self._prune_outstanding(now)
        return ReplicaPressure(
            queue_len=self.queue_length(now),
            pending=sum(len(b) for _, b in self.pending),
            active_slots=1 if self.busy_until > now else 0,
            total_slots=1)

    def prefix_affinity(self, prompt: Any,
                        adapter_id: Optional[str] = None) -> int:
        return 0    # analytic latencies never look at prompt content

    def reclaim_queued(self, max_n: int, now: float) -> List[Request]:
        # ``_drain`` schedules every submitted batch synchronously, so
        # there is never unstarted work to hand back
        return []

    def drain_pending(self, now: float) -> List[Request]:
        # nothing to hand back: ``_drain`` schedules every submitted
        # batch synchronously, and scheduled sim events run to
        # completion (like a batch already on the accelerator)
        return []

    # ------------------------------------------------------------ training -
    def set_adapter(self, adapter: Any, version: int) -> None:
        self.adapter = adapter
        self.adapter_version = version

    def get_adapter(self) -> Any:
        return self.adapter

    def train_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> TrainRoundStats:
        step_time = self.surface.t_train(train_batch, infer_batch,
                                         self.rng) * self.slow_factor
        samples = train_batch * steps
        before, after = self.loss_curve.advance(samples, train_batch)
        self.train_batch = train_batch
        self.training_until = max(self.training_until,
                                  now + steps * step_time)
        self.total_train_time += steps * step_time
        return TrainRoundStats(
            replica_id=self.replica_id, steps=steps,
            train_batch=train_batch, infer_batch=infer_batch,
            avg_step_time=step_time, loss_before=before, loss_after=after,
            noise_scale=self.loss_curve.noise_scale(), samples=samples)

    # ------------------------------------------- incremental sessions ------
    def begin_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> None:
        """Non-blocking round: the training WINDOW is billed up front
        (the interference surface sees the co-running batch for its
        duration), but the round's EFFECTS — loss-curve advance, train
        time — land only at ``finish_round``, so an aborted round
        leaves quality at the last published state exactly like the
        live path's discarded shadow."""
        if self._round is not None:
            raise RuntimeError(
                f"{self.replica_id}: train round already active")
        step_time = self.surface.t_train(train_batch, infer_batch,
                                         self.rng) * self.slow_factor
        self.train_batch = train_batch
        self.training_until = max(self.training_until,
                                  now + steps * step_time)
        self._round = ((train_batch, infer_batch, steps, step_time),
                       now, now + steps * step_time)

    def round_progress(self, now: float) -> float:
        if self._round is None:
            return 1.0
        _, t0, t1 = self._round
        if t1 <= t0:
            return 1.0
        return float(min(max((now - t0) / (t1 - t0), 0.0), 1.0))

    def finish_round(self, now: float) -> TrainRoundStats:
        if self._round is None:
            raise RuntimeError(f"{self.replica_id}: no active round")
        (train_batch, infer_batch, steps, step_time), _, _ = self._round
        self._round = None
        self.train_batch = 0
        samples = train_batch * steps
        before, after = self.loss_curve.advance(samples, train_batch)
        self.total_train_time += steps * step_time
        return TrainRoundStats(
            replica_id=self.replica_id, steps=steps,
            train_batch=train_batch, infer_batch=infer_batch,
            avg_step_time=step_time, loss_before=before,
            loss_after=after,
            noise_scale=self.loss_curve.noise_scale(), samples=samples)

    def publish_adapter(self) -> int:
        # the analytic replica has no shadow tree — ``finish_round``
        # already advanced the loss curve the adapter stands for
        return self.adapter_version

    def abort_round(self, now: float) -> None:
        """§8.2 suspension: drop the pending round WITHOUT its effects
        (no loss advance, no train-time billing) and stop the
        co-running interference at ``now``."""
        self._round = None
        self.train_batch = 0
        self.training_until = min(self.training_until, now)

    def quality_score(self, now: float) -> float:
        """§8.1: response quality = 1 / CE-loss of the current model."""
        return 1.0 / max(self.loss_curve.loss(), 1e-6)

    # --------------------------------------------------------------- faults
    def fail(self, now: float) -> None:
        self.failed = True
        self.pending.clear()

    def recover(self, now: float) -> None:
        self.failed = False
        self.busy_until = now


# =========================================================================
# Live replica (real PyTorch execution)
# =========================================================================
@dataclasses.dataclass
class TrainSession:
    """One incremental COMBINED train round, advanced ONE fused
    ``combined_step`` tick at a time inside ``pump_once`` — the fabric
    loop interleaves it with every other replica's serving instead of a
    blocking whole-round call monopolizing the device.

    The optimizer donates into the replica's SHADOW adapter for the
    whole session; prefill/decode keep reading the published snapshot,
    so greedy serving output is bit-identical to serve-only until
    ``publish_adapter`` swaps the trees at the round boundary."""
    train_batch: int
    infer_batch: int
    steps: int
    started_at: float               # caller's clock
    grad_accum: int = 1             # microbatch split for the p_t probe
    steps_done: int = 0
    busy_time: float = 0.0          # wall seconds inside session ticks
    samples_done: int = 0           # train rows actually stepped (budget
    #                                 scheduler may shrink a tick's batch)
    losses: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.steps_done >= self.steps

    @property
    def progress(self) -> float:
        if self.steps <= 0:
            return 1.0      # a zero-step round is born complete
        return min(self.steps_done / self.steps, 1.0)


class LiveReplica:
    """Runs actual PyTorch serving + training on the model's device and
    measures wall-clock — the end-to-end integration path.

    Serving goes through the slot-based ``ContinuousBatcher``
    (``runtime.serving_loop``): submitted requests become real
    prefill-then-decode generation over shared caches, and a COMBINED
    train round executes the fused ``combined_step`` per decode tick
    whenever serving work is in flight (training + decode over one copy
    of the base weights)."""

    def __init__(self, replica_id: str, model_id: str, engine,
                 params, lora, opt_state,
                 on_result: Callable[[BatchResult, str], None],
                 data_fn: Callable[[int], Dict[str, Any]],
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 serve_slots: int = 4, serve_prompt_len: int = 16,
                 max_gen_tokens: int = 8, serve_paged: bool = False,
                 serve_block_size: int = 16,
                 serve_n_blocks: Optional[int] = None,
                 serve_prefix_cache: bool = False,
                 adapters: Any = None,
                 train_tenant: Optional[str] = None,
                 injector: Any = None,
                 serve_prefill_chunk: int = 0,
                 serve_tpot_target: float = 0.0,
                 serve_oversubscribe: float = 0.0,
                 serve_swap: bool = True):
        from repro_torch.runtime.serving_loop import ContinuousBatcher
        self.replica_id = replica_id
        self.model_id = model_id
        self.engine = engine
        self.params = params
        self.on_result = on_result
        self.data_fn = data_fn          # batch_size -> training batch dict
        self.eval_fn = eval_fn          # lora -> eval CE loss
        self.adapter_version = 0
        self.train_batch = 0
        self.serve_prompt_len = serve_prompt_len
        self.max_gen_tokens = max_gen_tokens
        # (submit_t on the caller's clock, submit wall stamp, [Request])
        self._queue: Deque[Tuple[float, float, List[Request]]] = \
            collections.deque()
        # submitted-but-unfinished groups: (submit_t, submit_wall,
        # [Request], {gen_id: GenRequest}, ingest wall stamp)
        self._inflight: List[Tuple[float, float, List[Request],
                                   Dict[int, Any], float]] = []
        self._gen_counter = 0
        self._busy_frac = 0.0
        self._last_loss = float("nan")
        # incremental COMBINED round state
        self._session: Optional[TrainSession] = None
        self._pending_tb: Optional[Dict[str, Any]] = None
        self._noise_ema = NoiseScaleEMA()
        # per-tick busy-time accounting: (wall stamp at tick end, tick
        # seconds) over a trailing window — the replica's REAL busy
        # fraction, train and serve ticks alike
        self._busy_log: Deque[Tuple[float, float]] = collections.deque(
            maxlen=1024)
        self._busy_window = 2.0
        # multi-tenant serving: the AdapterRegistry routing decode rows
        # per tenant, and which tenant mirrors the co-training adapter
        # (publish_adapter/set_adapter write through to its registry
        # entry so its requests see each published round)
        self.adapters = adapters
        self.train_tenant = train_tenant
        # chaos hooks (runtime.fault.FaultInjector or None): consulted
        # at pump top (crash/stall), admission (oom), and after train
        # ticks (nan_grads) — injected crashes/OOMs RAISE out of
        # pump_once; the fabric tick contains them as detected failures
        self.injector = injector
        self.batcher = ContinuousBatcher(
            engine, params, lora, n_slots=serve_slots,
            max_seq=serve_prompt_len + max_gen_tokens,
            prompt_pad=serve_prompt_len, opt_state=opt_state,
            paged=serve_paged, block_size=serve_block_size,
            n_blocks=serve_n_blocks, prefix_cache=serve_prefix_cache,
            adapters=adapters, prefill_chunk=serve_prefill_chunk,
            tpot_target=serve_tpot_target,
            oversubscribe=serve_oversubscribe, swap=serve_swap)

    # adapter + optimizer state live in the batcher so the fused path
    # can donate/update them in place
    @property
    def lora(self):
        return self.batcher.lora

    @lora.setter
    def lora(self, value):
        self.batcher.lora = value
        # new adapter -> any cached CE probe is stale
        self._last_loss = float("nan")

    @property
    def opt_state(self):
        return self.batcher.opt_state

    @opt_state.setter
    def opt_state(self, value):
        self.batcher.opt_state = value

    # ------------------------------------------------------------- serving -
    def submit_batch(self, requests: Sequence[Request], now: float) -> None:
        self._queue.append((now, _time.perf_counter(), list(requests)))

    def _ingest(self, now: float) -> None:
        """Move admissible groups from the replica's admission queue to
        the continuous batcher.  Ingestion is HEADROOM-GATED: groups
        stay in the admission queue while the batcher already holds a
        full slot wave of queued work, so the micro-cycle can still
        reclaim them for rebalancing (work inside the batcher queue is
        committed to this replica).  Prompts come from the control-plane
        Request when it carries one (multi-replica routing needs
        identical prompts on every replica), the replica's data
        distribution otherwise."""
        from repro_torch.runtime.serving_loop import GenRequest
        while self._queue \
                and len(self.batcher.queue) < self.batcher.n_slots:
            if self.injector is not None:
                self.injector.at_admission(self.replica_id, now)
            submit_t, submit_wall, batch = self._queue.popleft()
            drawn = None
            if any(r.prompt is None for r in batch):
                drawn = _host_tokens(self.data_fn(
                    len(batch))["tokens"])[:, :self.serve_prompt_len]
            group: Dict[int, Any] = {}
            for j, r in enumerate(batch):
                prompt = np.asarray(
                    r.prompt, np.int32)[:self.serve_prompt_len] \
                    if r.prompt is not None else drawn[j]
                g = GenRequest(
                    request_id=self._gen_counter, prompt=prompt,
                    max_new_tokens=min(r.tokens, self.max_gen_tokens),
                    arrival=now, adapter_id=r.adapter_id,
                    deadline=r.deadline,
                    temperature=r.temperature,
                    top_k=r.top_k, top_p=r.top_p,
                    # seed from the CONTROL-plane id, never the
                    # per-replica gen counter: sampled streams must not
                    # depend on placement or failover re-queues
                    seed=r.seed if r.seed is not None else r.request_id)
                self._gen_counter += 1
                self.batcher.submit(g)
                group[g.request_id] = g
            self._inflight.append((submit_t, submit_wall, batch, group,
                                   _time.perf_counter()))

    def _emit_finished(self, now: float) -> None:
        still = []
        q = None
        for submit_t, submit_wall, batch, group, t0 in self._inflight:
            if not all(g.done for g in group.values()):
                still.append((submit_t, submit_wall, batch, group, t0))
                continue
            if q is None:
                q = self.quality_score(now)
            # every latency is a WALL-CLOCK duration measured on one
            # clock: queue wait = submit -> ingest, serving = ingest ->
            # the LAST request's finish stamp (not whenever the control
            # plane got around to emitting), total = their sum.
            lat = max(g.finished_wall for g in group.values()) - t0
            queue_wait = max(t0 - submit_wall, 0.0)
            tokens = sum(len(g.tokens) for g in group.values())
            # timestamps stay on the CALLER's clock (``now`` may be
            # simulated time): completion is observed at ``now``.  The
            # old ``now + lat`` stamped a timestamp off BOTH clocks —
            # SLO attainment then compared a hybrid against sim
            # deadlines.
            for r, g in zip(batch, group.values()):
                r.completed_at = now
                r.quality = q
                r.output_tokens = list(g.tokens)
            self.on_result(BatchResult(
                replica_id=self.replica_id, batch_size=len(batch),
                infer_latency=lat, total_latency=queue_wait + lat,
                queue_latency=queue_wait,
                finished_at=now, quality=q, tokens=tokens,
                train_batch=self.train_batch), batch[0].stream_id)
        self._inflight = still

    def pump(self, now: float) -> None:
        """Synchronously drain queued serving work through the
        continuous batcher (examples drive this)."""
        self._ingest(now)
        while not self.batcher.idle():
            self.batcher.step(now=now)
            self._emit_finished(now)
            self._ingest(now)

    def pump_once(self, now: float) -> bool:
        """ONE runtime tick: ingest admissible groups, advance every
        active slot one token, emit finished groups.  The multi-replica
        fabric round-robins this so replicas interleave instead of one
        ``pump`` monopolizing the device.  With a train session active,
        the same tick runs the fused ``combined_step``: the shadow
        adapter takes one optimizer step while the decode wave reads the
        published snapshot — and a tick with no serving work still
        advances the session through a plain shadow train step.  Returns
        True while the replica holds unfinished SERVING work (training
        progress is the Launcher's to poll, not a reason to spin the
        trace loop)."""
        if self.injector is not None:
            # chaos hooks: an injected crash raises out of this pump
            # (the fabric tick converts it into a detected failure); a
            # stall sleeps here, inflating this tick's latency into the
            # straggler watch
            self.injector.before_pump(self.replica_id, now)
        self._ingest(now)
        sess = self._session
        train_due = sess is not None and not sess.done
        serving = not self.batcher.idle()
        if serving or train_due:
            # sticky train batch: a budget-skipped tick re-offers the
            # SAME drawn batch next tick, so the trained sequence walks
            # the finite pool in deterministic epoch order no matter
            # which wall-clock ticks had slack
            tb = None
            if train_due:
                tb = self._pending_tb
                if tb is None:
                    tb = self.data_fn(sess.train_batch)
            t0 = _time.perf_counter()
            self.batcher.step(train_batch=tb, now=now)
            dt = _time.perf_counter() - t0
            if serving:
                # per-replica busy time: this replica's share of the
                # device (per-replica throughput = its tokens / its
                # stepping time); train-only ticks generate no tokens
                # and must not dilute serving throughput
                self.batcher.stats.wall_time += dt
                self._emit_finished(now)
            self._account_busy(dt)
            if train_due:
                self._pending_tb = None \
                    if self.batcher.last_tick_trained else tb
            if train_due and self.batcher.last_tick_trained:
                # budget-gated co-scheduling: the batcher may SKIP the
                # train leg on a tick whose SLO slack is spent (tt is
                # None) — a skipped tick advances neither steps_done nor
                # the loss log, so rounds report only real steps
                sess.steps_done += 1
                sess.busy_time += dt
                sess.samples_done += self.batcher.last_tick_train_rows
                m = self.batcher.last_train_metrics
                sess.losses.append(m["ce_loss"])
                if self.batcher.last_tick_train_rows >= sess.train_batch:
                    # shrunk microbatches fold grad_accum to 1 — their
                    # |g|² is not the probe's microbatch statistic
                    self._observe_noise(m, sess)
            if train_due and self.injector is not None and self.injector \
                    .poison_grads(self.replica_id, now):
                self._poison_shadow()
        self._busy_frac = self._measured_busy_frac()
        return bool(self._queue or self._inflight
                    or not self.batcher.idle())

    def queue_length(self, now: float) -> int:
        return sum(len(b) for _, _w, b in self._queue) \
            + sum(len(b) for _, _w, b, g, _t in self._inflight
                  if not all(x.done for x in g.values()))

    def outstanding_batches(self, now: float) -> int:
        """Submitted-but-unfinished groups — the dispatcher's in-flight
        backpressure unit."""
        return len(self._queue) \
            + sum(1 for _, _w, b, g, _t in self._inflight
                  if not all(x.done for x in g.values()))

    def utilization(self, now: float) -> float:
        return self._busy_frac

    # --------------------------------------------- busy-time accounting ----
    def _account_busy(self, dt: float) -> None:
        self._busy_log.append((_time.perf_counter(), dt))

    def _measured_busy_frac(self) -> float:
        """Busy fraction over the trailing window of per-tick busy-time
        accounting: wall seconds spent stepping (serve + train ticks)
        divided by the window actually covered.  Decays to 0 once the
        replica stops ticking — the SERVING→IDLE signal the state
        manager's Eq. 1 consumes."""
        if not self._busy_log:
            return 0.0
        t_now = _time.perf_counter()
        lo = t_now - self._busy_window
        first_end, first_dt = self._busy_log[0]
        span = max(min(self._busy_window,
                       t_now - (first_end - first_dt)), 1e-6)
        busy = sum(d for t, d in self._busy_log if t >= lo)
        return float(min(busy / span, 1.0))

    # ------------------------------------------------- placement signals ---
    def pressure(self, now: float) -> ReplicaPressure:
        """Real runtime pressure off the batcher + block allocator:
        free/reserved pool blocks, active slots, admission-queue depth,
        prefix-cache occupancy — the dispatcher's routing inputs."""
        b = self.batcher
        # pending = RECLAIMABLE work only (admission queue, not yet
        # ingested); requests already in the batcher queue are committed
        # to this replica and show up in queue_len alone
        pending = sum(len(g) for _, _w, g in self._queue)
        # parked (preempted) requests are committed work too: each one
        # re-takes a slot and pool capacity on restore
        committed = pending + len(b.queue) + b.n_preempted
        active = len(b.active_slots())
        p = ReplicaPressure(
            queue_len=self.queue_length(now),
            pending=pending,
            active_slots=active,
            total_slots=b.n_slots,
            # one wave decoding + one wave queued behind it
            admit_capacity=max(2 * b.n_slots - active - committed, 0))
        if b.adapters is not None:
            p.resident_adapters = b.adapters.resident_ids()
        if b.paged:
            p.free_blocks = max(b.allocator.available(), 0)
            p.reserved_blocks = b.allocator.reserved
            p.pool_blocks = b.allocator.capacity
            if b.prefix_cache is not None:
                p.cached_blocks = len(b.prefix_cache)
            # oversubscribed pool: advertise the thrash signal so the
            # dispatcher discounts this replica while requests sit
            # parked off-device waiting for capacity
            p.oversubscribe = b.oversubscribe
            p.preempted = b.n_preempted
        return p

    def prefix_affinity(self, prompt: Any,
                        adapter_id: Optional[str] = None) -> int:
        """Prompt tokens this replica's prefix cache would serve without
        prefill — the dispatcher routes matching requests here.  The
        lookup is scoped to ``adapter_id``'s namespace (cached KV is
        adapter-specific, so another tenant's blocks never count)."""
        pc = self.batcher.prefix_cache
        if pc is None or prompt is None or len(pc) == 0:
            # empty-cache early-out: the dispatcher probes affinity per
            # scanned queue entry on every fire — skip the hashing
            # until something is actually registered
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        return len(pc.match(prompt[:self.serve_prompt_len],
                            namespace=adapter_id)) \
            * self.batcher.block_size

    # ------------------------------------------------ elastic / failover ---
    def reclaim_queued(self, max_n: int, now: float) -> List[Request]:
        """Hand back up to ``max_n`` requests from the admission queue
        (newest groups first — they have waited the least here), whole
        groups only; work already inside the batcher is committed."""
        groups: List[List[Request]] = []
        taken = 0
        while self._queue and taken + len(self._queue[-1][2]) <= max_n:
            _, _w, batch = self._queue.pop()
            groups.append(batch)
            taken += len(batch)
        return [r for g in reversed(groups) for r in g]

    def drain_pending(self, now: float) -> List[Request]:
        """Failover teardown: emit every ALREADY-FINISHED generation
        (including finished members of partially-done groups — those
        results were produced; re-serving them would double-count), then
        stop serving and hand back every unfinished request (admission
        queue + in-flight groups) for re-placement on a survivor.
        Partial generations are discarded; the batcher frees all pool
        blocks."""
        self._emit_finished(now)
        out: List[Request] = []
        q = None
        for submit_t, submit_wall, batch, group, t0 in self._inflight:
            gens = list(group.values())
            done = [(r, g) for r, g in zip(batch, gens) if g.done]
            out.extend(r for r, g in zip(batch, gens) if not g.done)
            if not done:
                continue
            if q is None:
                q = self.quality_score(now)
            lat = max(g.finished_wall for _, g in done) - t0
            queue_wait = max(t0 - submit_wall, 0.0)
            tokens = 0
            for r, g in done:
                r.completed_at = now
                r.quality = q
                r.output_tokens = list(g.tokens)
                tokens += len(g.tokens)
            self.on_result(BatchResult(
                replica_id=self.replica_id, batch_size=len(done),
                infer_latency=lat, total_latency=queue_wait + lat,
                queue_latency=queue_wait, finished_at=now, quality=q,
                tokens=tokens, train_batch=self.train_batch),
                batch[0].stream_id)
        self._inflight.clear()
        for _s, _w, batch in self._queue:
            out.extend(batch)
        self._queue.clear()
        self.batcher.drain_all()
        self._busy_frac = 0.0
        for r in out:
            r.completed_at = None
        return out

    # ------------------------------------------------------------ training -
    def set_adapter(self, adapter: Any, version: int) -> None:
        """Publish ``adapter`` as the served snapshot (round boundaries /
        deployment).  A new global landing mid-session ABORTS the
        session outright — shadow and progress discarded — rather than
        silently retargeting the remaining ticks at the served tree
        (which would break the within-round snapshot isolation).

        Publish gate: a non-finite incoming tree (e.g. a FedAvg merge
        over a poisoned member that slipped past the member gates) is
        REJECTED — the served adapter stays at its current finite
        version and the rejection is counted."""
        if not tree_finite(adapter):
            self.batcher.stats.nan_publishes_blocked += 1
            return
        if self._session is not None:
            self.abort_round(0.0)
        self.lora = adapter
        self.adapter_version = version
        self.batcher.train_lora = None
        self.batcher.stats.adapter_version = version
        self._mirror_train_tenant()

    def get_adapter(self) -> Any:
        return self.lora

    # ------------------------------------------- incremental sessions ------
    def begin_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> None:
        """Open an incremental train session: stage the shadow tree (a
        reference to the published snapshot — the optimizer returns new
        tensors and never writes an adapter leaf in place, so the first
        step forks it) and let ``pump_once`` advance one fused step per
        fabric tick."""
        if self._session is not None:
            raise RuntimeError(
                f"{self.replica_id}: train session already active")
        # microbatch split for the gradient-noise probe (Eq. 8's p_t):
        # an even batch trains as 2 microbatches inside the same fused
        # step; odd/unit batches keep the EMA from previous rounds
        accum = 2 if train_batch >= 2 and train_batch % 2 == 0 else 1
        self.batcher.train_lora = self.lora
        self.batcher.train_grad_accum = accum
        self.train_batch = train_batch
        self._pending_tb = None     # batch size may change per round
        self._session = TrainSession(
            train_batch=train_batch, infer_batch=infer_batch,
            steps=steps, started_at=now, grad_accum=accum)

    def round_progress(self, now: float) -> float:
        return 1.0 if self._session is None else self._session.progress

    def finish_round(self, now: float) -> TrainRoundStats:
        """Close the session and report MEASURED round stats: wall time
        per fused step and the gradient-noise scale estimated from the
        session's microbatch gradients (EMA across ticks/rounds) — not
        a hardcoded prior."""
        sess = self._session
        if sess is None:
            raise RuntimeError(f"{self.replica_id}: no active round")
        self._session = None
        # publish gate, round edition: a NaN/Inf shadow (poisoned
        # gradients) aborts the round HERE — the shadow is dropped so
        # the subsequent publish_adapter is a no-op and serving stays
        # at the last finite published version
        if self.batcher.train_lora is not None \
                and not tree_finite(self.batcher.train_lora):
            self.batcher.train_lora = None
            self.batcher.stats.nan_publishes_blocked += 1
        self.batcher.train_grad_accum = 1
        # no training co-runs past this point: results emitted before
        # the next begin_round must not carry a stale interference
        # label (the dispatcher's Eq. 14 fit skips train_batch > 0 rows)
        self.train_batch = 0
        self._busy_frac = self._measured_busy_frac()
        dt = sess.busy_time / max(sess.steps_done, 1)
        noise = self._noise_ema.value if self._noise_ema.initialized \
            else 8.0    # prior until the first even-batch round measures
        # poisoned ticks log NaN CE — report only the finite losses so
        # the Coordinator's Eq. 8 fits never ingest NaN
        fin = [l for l in sess.losses if math.isfinite(l)]
        return TrainRoundStats(
            replica_id=self.replica_id, steps=sess.steps_done,
            train_batch=sess.train_batch, infer_batch=sess.infer_batch,
            avg_step_time=dt,
            loss_before=fin[0] if fin else float("nan"),
            loss_after=fin[-1] if fin else float("nan"),
            noise_scale=noise,
            samples=sess.samples_done if sess.samples_done
            else sess.train_batch * sess.steps_done)

    def publish_adapter(self) -> int:
        """Round boundary: atomically swap the trained shadow into the
        published slot.  Host-side pointer swap — in-flight decodes read
        whichever tree the next tick's program is handed, never a
        half-updated one.

        Publish gate: a non-finite shadow is REJECTED — dropped without
        the swap, so the served adapter (and its registry mirror) stays
        bit-identical at the last published finite version."""
        shadow = self.batcher.train_lora
        if shadow is not None and not tree_finite(shadow):
            self.batcher.train_lora = None
            self.batcher.stats.nan_publishes_blocked += 1
            return self.adapter_version
        if shadow is not None:
            self.lora = shadow          # resets the cached CE probe
            self.batcher.train_lora = None
            if self.batcher.train_losses:
                # the shadow's final train CE is the published model's
                # best available quality estimate (refreshed lazily by
                # the eval probe on the next cold quality_score)
                self._last_loss = self.batcher.train_losses[-1]
            self.adapter_version += 1
            self.batcher.stats.adapter_version = self.adapter_version
            self._mirror_train_tenant()
        return self.adapter_version

    def _mirror_train_tenant(self) -> None:
        """Write the freshly published co-training adapter through to
        its registry tenant: resident slot rewritten in place, so every
        in-flight row of that tenant reads the new version on its next
        tick while other tenants' tokens stay bit-identical."""
        if self.adapters is not None and self.train_tenant is not None:
            self.adapters.update(self.train_tenant, self.lora,
                                 version=self.adapter_version)

    def abort_round(self, now: float) -> None:
        """§8.2 load-surge suspension: drop the session and the shadow
        tree outright — the served adapter stays at the last PUBLISHED
        version, so suspending fine-tuning never perturbs serving."""
        self._session = None
        self.batcher.train_lora = None
        self.batcher.train_grad_accum = 1
        self.train_batch = 0

    def _poison_shadow(self) -> None:
        """Chaos: NaN-fill the session's shadow tree (an injected
        gradient blow-up).  Serving is untouched — the published
        snapshot is a different tree — and the publish gates must
        refuse to ever swap this one in."""
        if self.batcher.train_lora is not None:
            self.batcher.train_lora = tree_map(
                lambda x: torch.full_like(x, float("nan")),
                self.batcher.train_lora)

    def _observe_noise(self, metrics: Dict[str, float],
                       sess: TrainSession) -> None:
        """Per-tick gradient-noise-scale measurement (McCandlish
        small/big estimator over the fused step's microbatches)."""
        if sess.grad_accum <= 1:
            return
        est = float(noise_scale_from_microbatches(  # lint: host-sync-ok the host floats of last_train_metrics, once per train tick
            metrics["micro_grad_sqnorm"], metrics["grad_sqnorm"],
            micro_batch=sess.train_batch // sess.grad_accum,
            n_micro=sess.grad_accum))
        if math.isfinite(est):
            # the small/big estimator is ill-conditioned when the signal
            # term ~vanishes (near-random gradients on tiny smoke
            # models): one such tick would dominate the EMA forever, so
            # clip to a band that still spans every plausible B* regime
            self._noise_ema.update(min(max(est, 0.0), 1e4))

    def train_round(self, train_batch: int, infer_batch: int, steps: int,
                    now: float) -> TrainRoundStats:
        """Blocking convenience over the session surface: begin a round,
        drive it to completion through ``pump_once`` ticks (serving
        interleaves exactly as it would under the fabric loop), then
        finish and publish the trained shadow."""
        self.begin_round(train_batch, infer_batch, steps, now)
        while self._session is not None and not self._session.done:
            self.pump_once(now)
        stats = self.finish_round(now)
        self.publish_adapter()
        return stats

    def quality_score(self, now: float) -> float:
        if self.eval_fn is not None:
            return 1.0 / max(self.eval_fn(self.lora), 1e-6)
        if math.isnan(self._last_loss):
            # serving-only replica with no training signal yet: probe
            # the current adapter's CE on a held-out-style batch so
            # BatchResult.quality tracks the real model, not a constant
            self._last_loss = self._probe_loss()
        return 1.0 / max(self._last_loss, 1e-6)

    def _probe_loss(self) -> float:
        """CE of the served adapter on a drawn batch of 4 (the eval
        probe): a forward without gradients."""
        batch = self.batcher._device_batch(self.data_fn(4))
        with torch.no_grad():
            loss = self.engine.model.forward_loss(
                self.params, self.lora, batch)[0]
        return float(loss)  # lint: host-sync-ok cold quality probe, cached in _last_loss — not per-token
