"""Demo entry point: run the stereo SLAM slice on a synthetic sequence.

Usage:
  python -m svi_mapper_tpu_torch.run_demo [--frames N] [--gt] [--slam]
      [--trajectory corridor|loop] [--width W] [--height H]
      [--device cuda | --cpu]

Prints per-frame tracking stats and the final trajectory metric block —
the equivalent of the reference's on-exit report (tracker_gt.cpp:285-308)
plus the evaluate_trajectory summary (evaluate_trajectory.cpp:270-284).
Runs on CUDA unless ``--device`` / ``--cpu`` say otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--step", type=float, default=0.5)
    ap.add_argument("--gt", action="store_true", help="ground-truth pose playback (tracker_gt mode)")
    ap.add_argument("--slam", action="store_true",
                    help="full SLAM (loop closure + windowed BA) instead of pure VO")
    ap.add_argument("--trajectory", choices=["corridor", "loop"], default="corridor")
    ap.add_argument("--loop-radius", type=float, default=12.0)
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--save", type=str, default="", help="write KITTI trajectory here")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.models.tracker import StereoTracker

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({kind})")
    seq = SyntheticSequence(
        args.frames, args.width, args.height, step=args.step,
        trajectory=args.trajectory, loop_radius=args.loop_radius, device=dev)
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=args.landmarks, max_detections=args.landmarks)
    cls = SLAMSystem if args.slam else StereoTracker
    tracker = cls(seq.cam, params, use_gt_pose=args.gt, device=dev)

    t_start = time.perf_counter()
    for i, (L, R, T_gt) in enumerate(seq):
        out = tracker.process(L, R, T_gt=T_gt if args.gt else None)
        print(
            f"[{i:04d}] ok={int(bool(out.posit_ok))} tracked={int(out.n_tracked):4d} "
            f"active={int(out.n_active):4d} optimal={int(out.n_optimal):4d} "
            f"new={int(out.n_new):3d} inliers={int(out.inliers):4d} "
            f"err={float(out.avg_error_px2):6.3f}px^2 kf={int(bool(out.is_keyframe))}"
        )
    wall = time.perf_counter() - t_start

    m = ev.evaluate(tracker.trajectory_array, seq.poses_wc)
    if args.slam:
        m_opt = ev.evaluate(tracker.optimized_trajectory(), seq.poses_wc)
    fps = args.frames / wall
    print("-" * 70)
    print(f"frames: {args.frames}  wall: {wall:.2f}s  fps(incl. build+render): {fps:.2f}")
    print(f"pure tracking fps: {tracker.fps():.2f}")
    print(f"keyframes: {len(tracker.keyframes)}")
    print(f"ATE RMSE:            {m.ate_rmse_m * 100:.2f} cm")
    print(f"rel translation err: {m.rel_trans_err_m * 100:.3f} cm/frame ({m.rel_trans_ratio * 100:.2f} %)")
    print(f"rel rotation err:    {m.rel_rot_err_rad:.5f} rad/frame")
    print(f"relative translation precision: {m.precision:.4f}")
    if args.slam:
        print(f"SLAM stats: {tracker.stats}")
        print(f"OPTIMIZED ATE RMSE:  {m_opt.ate_rmse_m * 100:.2f} cm "
              f"(raw VO {m.ate_rmse_m * 100:.2f} cm)")
    if args.save:
        ev.save_kitti_trajectory(args.save, tracker.trajectory_array)
        print(f"trajectory written to {args.save}")


if __name__ == "__main__":
    main()
