"""Probe: which collectives gloo takes on CUDA tensors when several ranks
share one card, and how fast.

Spawns four ranks (processes) on ``cuda:0``, joined by a ``FileStore``
(no socket for the rendezvous), with the gloo backend.  Each rank runs
``all_reduce`` SUM and MAX and the list ``all_gather`` on float32 and
bfloat16 CUDA tensors over the whole group and over the two rows and
two columns of a 2 x 2 (data, model) mesh, and checks the values; then
times a 2-rank ``all_gather`` and ``all_reduce`` at a few sizes (CUDA
events around 5 calls after 2 warm ones), and tries to build a
``torch.distributed.device_mesh.DeviceMesh`` over the four ranks.

    python3 scripts/gloo_cuda_probe.py

Prints one JSON line per rank and ``{"ok": true}`` last; exits 1 on any
failure.  Needs a card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _rank(rank: int, store_path: str, q) -> None:
    out = {"rank": rank}
    try:
        store = dist.FileStore(store_path, WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        groups = {"world": (None, WORLD, list(range(WORLD))),
                  "data_row": (rows[rank // 2], 2,
                               [0, 1] if rank < 2 else [2, 3]),
                  "model_col": (cols[rank % 2], 2,
                                [0, 2] if rank % 2 == 0 else [1, 3])}
        checks = {}
        for gname, (grp, n, members) in groups.items():
            for dt in (torch.float32, torch.bfloat16):
                key = f"{gname}/{str(dt).split('.')[-1]}"
                x = torch.full((1024,), float(rank + 1), dtype=dt,
                               device=dev)
                s = x.clone()
                dist.all_reduce(s, op=dist.ReduceOp.SUM, group=grp)
                m = x.clone()
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=grp)
                want_sum = float(sum(r + 1 for r in members))
                want_max = float(max(members) + 1)
                ok_sum = bool((s.float() == want_sum).all())
                ok_max = bool((m.float() == want_max).all())
                ok_ag = all(bool((p.float() == r + 1).all())
                            for p, r in zip(parts, members))
                ok_dev = all(t.device == dev for t in [s, m] + parts)
                checks[key] = {"sum": ok_sum, "max": ok_max,
                               "all_gather": ok_ag, "on_card": ok_dev}
        out["checks"] = checks
        # timings over this rank's data row (2 ranks)
        grp = rows[rank // 2]
        times = {}
        for mib in (1, 16, 128):
            n = mib * (1 << 20) // 2
            x = torch.randn(n, device=dev).to(torch.bfloat16)
            parts = [torch.empty_like(x) for _ in range(2)]
            for op in ("all_gather", "all_reduce"):
                def run():
                    if op == "all_gather":
                        dist.all_gather(parts, x, group=grp)
                    else:
                        dist.all_reduce(x, group=grp)
                for _ in range(2):
                    run()
                torch.cuda.synchronize()
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(5):
                    run()
                ev1.record()
                torch.cuda.synchronize()
                times[f"{op}_{mib}MiB_bf16_ms"] = ev0.elapsed_time(ev1) / 5
        out["times"] = times
        try:
            from torch.distributed.device_mesh import DeviceMesh
            mesh = DeviceMesh("cuda", torch.arange(WORLD).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
            g = mesh.get_group("model")
            y = torch.ones(4, device=dev)
            dist.all_reduce(y, group=g)
            out["device_mesh"] = {"ok": bool((y == 2).all()),
                                  "device": str(torch.cuda.current_device())}
        except Exception as e:                        # recorded, not fatal
            out["device_mesh"] = {"ok": False, "error": repr(e)[:300]}
        dist.barrier()
        dist.destroy_process_group()
        out["ok"] = all(all(v.values()) for v in checks.values())
    except Exception:
        out["ok"] = False
        out["error"] = traceback.format_exc()[-2000:]
    q.put(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank,
                             args=(r, os.path.join(tmp, "store"), q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        results = [q.get(timeout=600) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    ok = True
    for r in sorted(results, key=lambda o: o["rank"]):
        print(json.dumps(r))
        ok = ok and r.get("ok", False)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
