"""KITTI sequence playback — the ``tracker_sv`` / ``tracker_gt`` mains
(tracker_sv.cpp, tracker_gt.cpp:29-308).

Usage:
  python -m svi_mapper_tpu_torch.tools.run_kitti KITTI_ROOT [--sequence 00]
      [--gt] [--slam] [--frames N] [--chunk N] [--log-dir DIR]
      [--save traj.txt] [--device cuda | --cpu]

Runs on CUDA unless ``--device`` / ``--cpu`` say otherwise. Reading KITTI
images needs cv2 or PIL.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--gt", action="store_true", help="ground-truth pose playback")
    ap.add_argument("--slam", action="store_true", help="loop closure + BA")
    ap.add_argument("--save", default="")
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=0,
                    help="throughput mode: process in chunks of N frames "
                         "(one device->host copy per chunk)")
    ap.add_argument("--log-dir", default="",
                    help="write the CLogger-family text logs here")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import dataclasses

    import numpy as np

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.eval.timing import StageTimer
    from svi_mapper_tpu_torch.io.kitti import KittiSequence, validate_sequence
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.models.tracker import StereoTracker
    from svi_mapper_tpu_torch.utils import loggers

    seq = KittiSequence(args.root, args.sequence, device=dev)
    for p in validate_sequence(seq):
        print(f"WARNING: {p}")
    if args.gt and seq.poses_wc is None:
        raise SystemExit("--gt requires a poses file")

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=args.landmarks, max_detections=args.landmarks)
    cls = SLAMSystem if args.slam else StereoTracker
    tracker = cls(seq.cam, params, use_gt_pose=args.gt, device=dev)
    logger = loggers.attach(tracker, args.log_dir) if args.log_dir else None

    n = seq.n_frames if args.frames == 0 else min(args.frames, seq.n_frames)
    timer = StageTimer()
    t0 = time.perf_counter()
    with timer.recording():    # the program's spans join the report
        if args.chunk > 1:
            for s in range(0, n, args.chunk):
                e = min(s + args.chunk, n)
                with timer.stage("io"):
                    frames = [seq.frame(i) for i in range(s, e)]
                    L = np.stack([f[0] for f in frames])
                    R = np.stack([f[1] for f in frames])
                    T = np.stack([f[2] for f in frames]) if args.gt else None
                with timer.stage("track"):
                    outs = tracker.process_many(L, R, T_gt=T, chunk=args.chunk)
                out = outs[-1]
                print(f"[{e - 1:05d}] tracked={int(out.n_tracked):4d} "
                      f"optimal={int(out.n_optimal):4d} ok={int(bool(out.posit_ok))}")
        else:
            for i in range(n):
                with timer.stage("io"):
                    L, R, T_gt = seq.frame(i)
                with timer.stage("track"):
                    out = tracker.process(L, R, T_gt=T_gt if args.gt else None)
                if i % 50 == 0:
                    print(f"[{i:05d}] tracked={int(out.n_tracked):4d} "
                          f"optimal={int(out.n_optimal):4d} ok={int(bool(out.posit_ok))}")
    wall = time.perf_counter() - t0
    print(timer.report(n, wall))
    if logger is not None:
        loggers.finalize(tracker, logger)

    if seq.poses_wc is not None:
        m = ev.evaluate(tracker.trajectory_array, seq.poses_wc[:n])
        print(f"ATE RMSE: {m.ate_rmse_m:.3f} m   "
              f"rel err: {m.rel_trans_ratio * 100:.2f} %   "
              f"rot err: {m.rel_rot_err_rad:.5f} rad")
    if args.save:
        ev.save_kitti_trajectory(args.save, tracker.trajectory_array)
        print(f"trajectory -> {args.save}")


if __name__ == "__main__":
    main()
