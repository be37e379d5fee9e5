"""Device meshes for the port — the counterpart of ``repro.launch.mesh``.

The rule selection and the parameter and batch tables (``rules_for``,
``logical_axes_for``, ``param_shardings``, ``batch_shardings``) live in
``models/sharding.py``, beside the rule tables the model code reads;
this module re-exports them under the reference's names.

``make_mesh`` names the axes of the ranks of a process group that
``spawn_ranks`` starts: one process per rank, joined through a
``FileStore`` (no socket), with the caller's backend (gloo on CPU
tensors, or on CUDA tensors of ranks that share one card; NCCL with one
card per rank).  ``shard_tree`` / ``gather_tree`` cut each rank's blocks
from whole trees and put them back.  The reference's
``make_production_mesh`` builds the 256- and 512-chip TPU meshes of its
XLA dry run, which the port scopes out with the dry run (``README.md``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import traceback
from typing import Any, Callable, Sequence

import torch

from repro_torch.models.collectives import Mesh
from repro_torch.models.sharding import (  # noqa: F401  (re-exported)
    batch_shardings, logical_axes_for, param_shardings, rules_for,
)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str) -> Mesh:
    """The (``axes``) mesh of ``shape`` over the default process group's
    ranks, row-major; its collectives run on ``device_type`` tensors."""
    return Mesh(shape, axes, device_type)


# ------------------------------------------------------- whole <-> local --
def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each rank's block of every whole leaf, as a tensor of its own (so
    the whole one can be freed)."""
    return _zip_map(lambda t, s: s.local(t).clone(), tree, shardings)


def gather_tree(tree: Any, shardings: Any) -> Any:
    """The whole leaves back from every rank's blocks (collectives, so
    every rank calls it)."""
    return _zip_map(lambda t, s: s.gather(t), tree, shardings)


def _zip_map(fn, tree: Any, other: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


# ---------------------------------------------------------------- ranks --
def _rank_main(rank: int, world: int, fn, shape, axes, backend: str,
               device_type: str, store_path: str, timeout_s: float, args,
               queue) -> None:
    import faulthandler

    import torch.distributed as dist
    faulthandler.enable()          # a rank that dies hard leaves its stack
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(shape, axes, device_type)
            # by value: a tensor put on the queue as it is would be shared
            # through a file descriptor this process closes when it exits
            queue.put((rank, True, pickle.dumps(fn(mesh, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:                     # reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, shape: Sequence[int], *, backend: str,
                store_dir: str, device_type: str,
                axes: Sequence[str] = ("data", "model"), args: tuple = (),
                timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    spawned process a rank, and return the ranks' results in rank order.

    The ranks join through a ``FileStore`` under ``store_dir`` (which
    must exist and be empty of a previous store) with ``backend``; both
    it and ``device_type`` are the caller's choice ("cpu", or "cuda": rank
    r on card ``r % device_count``, all
    on card 0 when there is one: gloo only, NCCL refuses two ranks on a
    card).  ``fn`` must be importable by name (a module-level function)
    and return picklable results.  A rank that raises fails the call
    with its traceback; the other ranks are then terminated."""
    import queue as queue_lib

    import torch.multiprocessing as mp
    world = 1
    for n in shape:
        world *= n
    store_path = os.path.join(store_dir, "filestore")
    if os.path.exists(store_path):
        raise ValueError(f"{store_path} exists: a store from another run")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, fn, tuple(shape), tuple(axes),
                               backend, device_type, store_path, timeout_s,
                               args, queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, {}
    try:
        wait = timeout_s
        while len(results) + len(failed) < world:
            try:
                rank, ok, value = queue.get(timeout=wait)
            except queue_lib.Empty:
                if failed:
                    break
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results}
                raise RuntimeError(f"spawn_ranks: no result in {timeout_s} "
                                   f"s (ranks exited early, exit codes: "
                                   f"{dead})")
            if ok:
                results[rank] = pickle.loads(value)
            else:
                # the other ranks' errors, a rank's own fault among the
                # collectives it broke for the rest, for a few seconds
                failed[rank] = value
                wait = 10.0
        if failed:
            codes = {r: p.exitcode for r, p in enumerate(procs)}
            raise RuntimeError(
                f"spawn_ranks: ranks {sorted(failed)} raised (exit codes "
                f"{codes}):\n" + "\n".join(
                    f"--- rank {r} ---\n{tb}"
                    for r, tb in sorted(failed.items())))
    finally:
        for p in procs:
            p.join(timeout=5 if failed else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
