"""Training driver of the port (``repro.launch.train``): LoRA fine-tuning
with checkpoint/restart fault tolerance and a NaN guard.

Every LoRA projection runs the fused ``lora_matmul`` kernel, forward and
the backward's dX; sequences past 1,024 tokens take ``flash_attention``,
forward and backward.  The dense decoders train on the card and the CPU;
mamba2-780m trains on the CPU only (the ``ssd_scan`` kernel has no
backward yet, and its wrapper says so), and the VLM not at all (ROADMAP
item 4).  Weights are random, drawn from ``--seed``'s generators;
checkpoints use the reference's format (``checkpoint/checkpointer.py``),
so either package resumes from the other's.

Usage (on a machine with an NVIDIA Hopper card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 50 --batch 8 --seq 64 --ckpt /tmp/ck
  ... --restore            # resume from the latest checkpoint
  ... --full               # the published widths
  ... --device cpu         # on the CPU (plain PyTorch versions)
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import Family, ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.engine import Engine, make_engine
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_map


def refuse_untrainable(cfg: ModelConfig) -> None:
    """The VLM's gradients are held against the reference nowhere yet."""
    if cfg.family is Family.VLM:
        raise NotImplementedError(
            f"{cfg.name}: training a VLM stack is not ported yet; see "
            "ROADMAP.md, item 4, 'Other families' (VLM co-training)")


def init_weights(engine: Engine, seed: int) -> Tuple[Any, Any]:
    """(params, lora) drawn from generators seeded ``seed`` and
    ``seed + 1`` on the engine's device: what ``run_training`` starts
    from."""
    model = engine.model
    params = model.init(
        torch.Generator(device=model.device).manual_seed(seed))
    lora = model.init_lora(
        torch.Generator(device=model.device).manual_seed(seed + 1))
    return params, lora


def _snap(tree: Any) -> Any:
    """A copy of every leaf: the rollback state owns its buffers, whatever
    a later step does to the tensors it was taken from."""
    if isinstance(tree, AdamWState):
        return AdamWState(*(_snap(x) for x in tree))
    return tree_map(torch.clone, tree)


def train_from_weights(engine: Engine, params: Any, lora: Any, *,
                       arch: str, steps: int = 100, batch: int = 8,
                       seq: int = 64, ckpt_dir: Optional[str] = None,
                       restore: bool = False, ckpt_every: int = 25,
                       seed: int = 0, log_every: int = 10,
                       inject_nan_at: int = -1, verbose: bool = True
                       ) -> dict:
    """``run_training``'s loop over weights already on the engine's
    device: ``steps`` AdamW steps of the LoRA tree on synthetic
    ``alpaca`` batches, a checkpoint every ``ckpt_every`` steps and at
    the end (``arch`` goes into each one's ``extra``), a non-finite loss
    (or ``inject_nan_at``, a fault hook for tests) rolled back to the last
    checkpointed state.  Returns ``losses``, ``final_loss``, ``lora`` and
    ``steps``."""
    cfg = engine.model.cfg
    refuse_untrainable(cfg)
    device = engine.model.device
    opt_state = engine.optimizer.init(lora)
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=seq, seed=seed)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and restore:
        lat = ckpt.latest_step()
        if lat is not None:
            (lora, opt_state), _ = ckpt.restore((lora, opt_state))
            start_step = lat
            if verbose:
                print(f"restored step {lat}")

    losses = []
    last_good = (_snap(lora), _snap(opt_state), start_step)
    t0 = time.time()
    step = start_step
    while step < steps:
        b = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch(batch).items()}
        new_lora, new_opt, metrics = engine.train_step(params, lora,
                                                       opt_state, b)
        loss = float(metrics["ce_loss"])  # lint: host-sync-ok the NaN guard reads each step's loss
        if inject_nan_at == step:
            loss = float("nan")   # fault-injection hook for tests
        if not math.isfinite(loss):
            # fault tolerance: roll back to the last good state
            if verbose:
                print(f"step {step}: non-finite loss; restoring "
                      f"step {last_good[2]}")
            lora, opt_state, step = last_good
            if ckpt:
                lat = ckpt.latest_step()
                if lat is not None:
                    (lora, opt_state), _ = ckpt.restore((lora, opt_state))
                    step = lat
            inject_nan_at = -1
            continue
        lora, opt_state = new_lora, new_opt
        losses.append(loss)
        step += 1
        if ckpt and step % ckpt_every == 0:
            ckpt.save(step, (lora, opt_state),
                      extra={"arch": arch, "loss": loss})
            last_good = (_snap(lora), _snap(opt_state), step)
        if verbose and step % log_every == 0:
            gnorm = float(metrics["grad_norm"])  # lint: host-sync-ok log line
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"{(time.time() - t0) / max(step - start_step, 1):.3f}"
                  f" s/step")
    if ckpt:
        ckpt.save(steps, (lora, opt_state), extra={"arch": arch})
        ckpt.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "lora": lora, "steps": step}


def run_training(arch: str, *, smoke: bool = True, steps: int = 100,
                 batch: int = 8, seq: int = 64,
                 ckpt_dir: Optional[str] = None, restore: bool = False,
                 ckpt_every: int = 25, lr: float = 3e-3,
                 seed: int = 0, log_every: int = 10,
                 inject_nan_at: int = -1, verbose: bool = True,
                 device="cuda") -> dict:
    """Build ``arch`` (its reduced config when ``smoke``) on ``device``,
    draw its weights from ``seed`` and train the adapter
    (``train_from_weights``)."""
    cfg = get_config(arch)
    refuse_untrainable(cfg)           # before building a model for it
    if smoke:
        cfg = cfg.scaled()
    engine = make_engine(cfg, lr=lr, device=device)
    params, lora = init_weights(engine, seed)
    return train_from_weights(
        engine, params, lora, arch=arch, steps=steps, batch=batch, seq=seq,
        ckpt_dir=ckpt_dir, restore=restore, ckpt_every=ckpt_every,
        seed=seed, log_every=log_every, inject_nan_at=inject_nan_at,
        verbose=verbose)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args()
    out = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt, restore=args.restore,
                       lr=args.lr, device=args.device)
    fl = out["final_loss"]
    # final_loss is None when a restore lands at step >= --steps (no
    # new step runs, so there is no loss to report)
    print(f"done: {out['steps']} steps, final loss "
          + (f"{fl:.4f}" if fl is not None else "n/a (already complete)"))


if __name__ == "__main__":
    main()
