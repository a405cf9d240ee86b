"""Scaling-efficiency benchmark — BASELINE.json configs 4-5 measurement
harness: distributed Schur-complement BA throughput against world size.

Runs the same BA problem on 1, 2, 4, ... ranks (one rank per device, each
world size its own spawned process group through
``parallel.distributed.initialize``) and reports solves/s and parallel
efficiency. On CUDA the world sizes go up to the device count, over NCCL;
with ``--cpu`` up to ``--ranks`` gloo processes (numbers then about
correctness, not speed). World size 1 still runs through a one-rank
group, so the reduction path runs.

Usage: python -m svi_mapper_tpu_torch.tools.bench_scaling [--points 8192]
           [--kfs 16] [--reps 3] [--device cuda | --cpu [--ranks N]]
Prints one JSON line per world size.
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import time


def make_problem(K: int, L: int, seed: int = 0) -> dict:
    """Points in front of a forward-moving camera chain, observed with
    0.3 px noise, the landmark estimates 0.3 m off (numpy)."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.io.synthetic import default_camera

    cam = default_camera(width=1241, height=376, device="cpu")
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                  rng.uniform(5, 60, L)], -1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -0.5 * np.arange(K)          # camera advances in z
    obs = np.zeros((K, L, 4), np.float32)
    mask = np.zeros((K, L), bool)
    for k in range(K):
        p_cam = X @ T[k, :3, :3].T + T[k, :3, 3]
        uvl, uvr = (u.numpy() for u in cam.project_stereo(torch.from_numpy(p_cam)))
        vis = (p_cam[:, 2] > 1.0) & (uvl[:, 0] > 0) & (uvl[:, 0] < cam.width)
        obs[k] = np.concatenate([uvl, uvr], -1) + rng.normal(0, 0.3, (L, 4))
        mask[k] = vis
    X0 = (X + rng.normal(0, 0.3, X.shape)).astype(np.float32)
    fix = np.zeros(K, bool)
    fix[0] = True
    return dict(T=T, X0=X0, obs=obs, mask=mask, fix=fix)


def _rank(rank: int, n: int, address: str, device_type: str, K: int, L: int,
          reps: int, results) -> None:
    """One rank of a world of ``n``: join the group, solve ``reps + 1``
    times (the first warms up), put rank 0's seconds per solve and chi^2
    into ``results``."""
    import torch
    import torch.distributed as dist

    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.parallel import distributed
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh
    from svi_mapper_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded

    distributed.initialize(address, n, rank, device=device_type)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device_type == "cuda" else torch.device("cpu"))
        p = make_problem(K, L)
        cam = default_camera(width=1241, height=376, device=dev)
        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        args = (on(p["T"]), on(p["X0"]), on(p["obs"]), on(p["mask"]), cam, on(p["fix"]))
        mesh = make_map_mesh(device=dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        res = bundle_adjust_sharded(mesh, *args, device=dev)      # warm
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = bundle_adjust_sharded(mesh, *args, device=dev)
        sync()
        dt = (time.perf_counter() - t0) / reps
        if rank == 0:
            results.put((dt, float(res.chi2_final)))
    finally:
        dist.destroy_process_group()


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_world(n: int, device_type: str, K: int, L: int, reps: int,
              timeout: float = 600.0) -> tuple[float, float]:
    """Spawn ``n`` ranks; returns rank 0's ``(seconds per solve, chi2)``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = _free_address()
    procs = [ctx.Process(target=_rank, args=(r, n, address, device_type, K, L, reps,
                                            results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:            # drain the queue before joining its writer
            try:
                out = results.get(timeout=1.0)
                break
            except queue.Empty:
                if (any(p.exitcode not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    raise RuntimeError(
                        f"world size {n}: a rank failed or hung (exit codes "
                        f"{[p.exitcode for p in procs]})") from None
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"world size {n}: exit codes {[p.exitcode for p in procs]}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--kfs", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="largest world size (default: the CUDA device count; "
                         "1 with --cpu)")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import torch

    top = args.ranks or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    base_dt = None
    for n in (1, 2, 4, 8, 16, 32):
        if n > top:
            break
        dt, chi2 = run_world(n, dev.type, args.kfs, args.points, args.reps)
        if base_dt is None:
            base_dt = dt
        print(json.dumps({
            "metric": "sharded_ba_solves_per_sec",
            "devices": n,
            "value": round(1.0 / dt, 3),
            "unit": "solves/s",
            "efficiency_vs_1dev": round(base_dt / (dt * n), 3),
            "chi2_final": chi2,
        }), flush=True)


if __name__ == "__main__":
    main()
