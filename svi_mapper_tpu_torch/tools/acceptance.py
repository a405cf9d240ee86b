"""Real-data acceptance harness: ONE command from a KITTI tree to pass/fail.

    python -m svi_mapper_tpu_torch.tools.acceptance KITTI_ROOT [--sequence 00]
        [--device cuda | --cpu]

It replays the sequence through the FULL SLAM system (the reference's
``tracker_sv`` operating mode, tracker_sv.cpp + CTrackerSV.cpp:239-456),
evaluates against the ground-truth poses with the reference's metric family
(evaluate_trajectory.cpp:196-303), checks the BASELINE.json targets, prints
a PASS/FAIL table, and exits nonzero on failure. Runs on CUDA unless
``--device`` / ``--cpu`` say otherwise.

Default gates (override by flag):
  * ATE RMSE <= --max-ate (default 10 m on KITTI 00's 3.7 km — the bound a
    working stereo SLAM with loop closure clears comfortably; the reference
    publishes no number, BASELINE.md);
  * per-frame relative translation error <= --max-rel (default 2.5% — the
    KITTI odometry leaderboard's "working method" regime);
  * throughput >= --min-fps (default 20.8 = 3x the 6.9 fps CPU anchor,
    BASELINE.json ">=3x frames/s of the CPU baseline per chip"; a target
    from the baseline, not a figure measured on any card);
  * >= --min-closures accepted loop closures on sequences with revisits
    (default 1 on KITTI 00; pass --min-closures 0 for closure-free routes).
"""

from __future__ import annotations

import argparse
import sys
import time

# 3x the 6.9 fps CPU anchor (BASELINE.json); a target, not a card's figure
DEFAULT_MIN_FPS = 20.8


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="KITTI odometry root (sequences/, poses/)")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--max-ate", type=float, default=10.0)
    ap.add_argument("--max-rel", type=float, default=0.025)
    ap.add_argument("--min-fps", type=float, default=DEFAULT_MIN_FPS)
    ap.add_argument("--min-closures", type=int, default=1)
    ap.add_argument("--save", default="", help="write KITTI-format trajectory")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import dataclasses

    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.kitti import KittiSequence, validate_sequence
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    seq = KittiSequence(args.root, args.sequence, device=dev)
    for p in validate_sequence(seq):
        print(f"WARNING: {p}")
    n = seq.n_frames if args.frames == 0 else min(args.frames, seq.n_frames)

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=args.landmarks, max_detections=args.landmarks)
    slam = SLAMSystem(seq.cam, params, device=dev)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"acceptance: {args.sequence} ({n} frames) on {kind} ...")
    t_proc = 0.0
    for s in range(0, n, args.chunk):
        e = min(s + args.chunk, n)
        frames = [seq.frame(i) for i in range(s, e)]
        L = np.stack([f[0] for f in frames])
        R = np.stack([f[1] for f in frames])
        t0 = time.perf_counter()
        slam.process_many(L, R, chunk=args.chunk)
        t_proc += time.perf_counter() - t0
    t0 = time.perf_counter()
    slam.finalize_backend()
    t_proc += time.perf_counter() - t0
    fps = n / t_proc

    traj = slam.optimized_trajectory()
    if args.save:
        ev.save_kitti_trajectory(args.save, traj)
        print(f"trajectory -> {args.save}")

    checks: list[tuple[str, bool, str]] = []
    closures = slam.stats.get("closures_accepted", 0)
    checks.append((
        "throughput", fps >= args.min_fps,
        f"{fps:.1f} fps (gate >= {args.min_fps}; 3x CPU anchor)"))
    checks.append((
        "loop closures", closures >= args.min_closures,
        f"{closures} accepted (gate >= {args.min_closures})"))
    if seq.poses_wc is not None:
        m = ev.evaluate(traj, seq.poses_wc[:n])
        checks.append((
            "ATE RMSE", m.ate_rmse_m <= args.max_ate,
            f"{m.ate_rmse_m:.2f} m (gate <= {args.max_ate})"))
        checks.append((
            "rel trans err", m.rel_trans_ratio <= args.max_rel,
            f"{100 * m.rel_trans_ratio:.2f}% (gate <= "
            f"{100 * args.max_rel:.1f}%)"))
        checks.append((
            "rot err", np.isfinite(m.rel_rot_err_rad),
            f"{m.rel_rot_err_rad:.5f} rad/frame (finite)"))
    else:
        print("WARNING: no ground-truth poses — accuracy gates skipped")

    ok = True
    print("-" * 60)
    for name, passed, detail in checks:
        ok &= passed
        print(f"  [{'PASS' if passed else 'FAIL'}] {name:14s} {detail}")
    print("-" * 60)
    print("ACCEPTANCE " + ("PASSED" if ok else "FAILED"))
    slam.close()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
