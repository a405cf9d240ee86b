#!/usr/bin/env python3
"""The bench's SV loop under photometric stress, through one package on the CPU.

    python3 compare_stress_loop.py jax|port [--stress moderate] [--frames N]
                                   [--threads T]

Runs the loop of ``bench.py:bench_full_slam`` — 208 frames of the 26 m loop
at 376 x 1241 in the corridor world, the bench's parameters, ``chunk=32`` —
with its frames rendered by ``io.stress.StressedSequence(stress=...)``
(sensor noise, exposure and gamma drift, blur, vignetting, a blank-wall span,
sheen and an occluder panel) through the JAX package's ``SLAMSystem`` or the
port's (``device="cpu"``): ``process_many(chunk=32)`` then
``finalize_backend()``. Prints one JSON line: keyframes, the closures
accepted and how far each lies from the true transform, BA and pose-graph
runs, the least landmark count tracked after frame 5, the pose solve's
refusals, and the aligned ATE of the recorded and of the optimised trajectory
(each package's ``eval.trajectory.ate_rmse``). The JAX package's line is the
CPU reference that ``chip_smoke.py``'s ``stress_loop`` phase bounds the
port's ATE by.

This script imports the JAX package only when asked to run it; it is not
part of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from chip_smoke import closure_errors

LOOP_FRAMES, LOOP_RADIUS, CHUNK = 208, 26.0, 32
H, W = 376, 1241
BENCH_PARAMS = dict(max_landmarks=1024, max_detections=1024, keyframe_translation_m2=4.0,
                    keyframe_rotation_rad2=0.02, max_motion_scaling_for_optimization=2.5)


def run_jax(n: int, stress: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.eval import trajectory as ev
    from svi_mapper_tpu.io.stress import StressedSequence
    from svi_mapper_tpu.models.slam import SLAMSystem

    seq = StressedSequence(n_frames=n, width=W, height=H, trajectory="loop",
                           loop_radius=LOOP_RADIUS, stress=stress)
    t0 = time.perf_counter()
    frames = [seq.frame(i) for i in range(n)]
    L = np.stack([np.asarray(f[0]) for f in frames])
    R = np.stack([np.asarray(f[1]) for f in frames])
    render_s = time.perf_counter() - t0
    params = dataclasses.replace(DEFAULT_PARAMS, **BENCH_PARAMS)
    t0 = time.perf_counter()
    s = SLAMSystem(seq.cam, params)
    outs = s.process_many(L, R, chunk=CHUNK)
    s.finalize_backend()
    return report("jax", s, outs, seq.poses_wc, ev, time.perf_counter() - t0, render_s)


def run_port(n: int, stress: str) -> dict:
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.stress import StressedSequence
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    seq = StressedSequence(n_frames=n, width=W, height=H, trajectory="loop",
                           loop_radius=LOOP_RADIUS, stress=stress, device="cpu")
    t0 = time.perf_counter()
    frames = [seq.frame(i) for i in range(n)]
    L = torch.stack([f[0] for f in frames])
    R = torch.stack([f[1] for f in frames])
    render_s = time.perf_counter() - t0
    params = dataclasses.replace(DEFAULT_PARAMS, **BENCH_PARAMS)
    t0 = time.perf_counter()
    s = SLAMSystem(seq.cam, params, device="cpu")
    outs = s.process_many(L, R, chunk=CHUNK)
    s.finalize_backend()
    return report("port", s, outs, seq.poses_wc, ev, time.perf_counter() - t0, render_s)


def report(package, slam, outs, poses, ev, seconds, render_s) -> dict:
    import numpy as np

    opt = slam.optimized_trajectory()
    raw = slam.trajectory_array
    return {
        "package": package, "frames": len(outs), "image": [H, W], "chunk": CHUNK,
        "seconds": seconds, "render_seconds": render_s,
        "keyframes": len(slam.slam_keyframes),
        "stats": {k: int(v) for k, v in slam.stats.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
        "closure_transform_err_m": closure_errors(slam, np.asarray(poses)),
        "n_tracked_min_after_5": min(int(o.n_tracked) for o in outs[5:]),
        "frames_tracked_below_40": {i: int(o.n_tracked) for i, o in enumerate(outs)
                                    if i >= 5 and int(o.n_tracked) < 40},
        "posit_rejected_at_frames": [i for i, o in enumerate(outs[1:], 1)
                                     if not bool(o.posit_ok)],
        "ate_recorded_m": ev.ate_rmse(raw, poses),
        "ate_optimised_m": ev.ate_rmse(opt, poses),
        "finite": bool(np.isfinite(opt).all()),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("--stress", default="moderate")
    ap.add_argument("--frames", type=int, default=LOOP_FRAMES)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("OMP_NUM_THREADS", str(args.threads))
    if args.package == "port":
        import torch

        torch.set_num_threads(args.threads)
        print(json.dumps(run_port(args.frames, args.stress)), flush=True)
    else:
        print(json.dumps(run_jax(args.frames, args.stress)), flush=True)


if __name__ == "__main__":
    main()
