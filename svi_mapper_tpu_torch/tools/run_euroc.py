"""Run the stereo-inertial tracker on a EuRoC/ASL sequence — the
``tracker_svi`` runnable (tracker_svi.cpp: pre-loop IMU calibration
:145-177, then process(imgL, imgR, imu) :216-261).

Usage:
    python -m svi_mapper_tpu_torch.tools.run_euroc DATASET_DIR \
        [--frames N] [--out traj.txt] [--no-loop-closure] [--device cpu]

Runs on CUDA unless ``--device`` says otherwise. Reading EuRoC files needs
PyYAML and cv2 or PIL.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default="trajectory_euroc.txt")
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--calib-seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.imu import interpolator as imu_mod
    from svi_mapper_tpu_torch.io.euroc import EurocSequence
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    seq = EurocSequence(args.root, device=args.device)
    print(f"{seq.n_frames} paired stereo frames, {len(seq.imu)} IMU rows, "
          f"baseline {float(seq.cam.baseline):.4f} m")

    static = seq.static_imu_window(args.calib_seconds)
    calib = imu_mod.calibrate(static[:, 1:4], static[:, 4:7], device=args.device)
    print(f"IMU calibrated over {calib.n_samples} samples: "
          f"gyro bias {calib.bias_gyro}, accel bias {calib.bias_accel}")

    tracker = StereoInertialTracker(
        seq.cam, calib,
        rectify_maps=seq.rectify_maps,
        T_cam_imu=seq.T_cam_imu,
        enable_loop_closure=not args.no_loop_closure,
        device=args.device,
    )
    n_max = args.frames or seq.n_frames
    prev_t = None
    for i, (t, L, R, imu) in enumerate(seq):
        if i >= n_max:
            break
        dt = (t - prev_t) if prev_t is not None else 0.05
        prev_t = t
        if len(imu):
            # per-sample integration over the frame interval's 200 Hz rows
            # (ref CTrackerSVI.cpp:356-399; imu rows are [t, w_xyz, a_xyz])
            ts = imu[:, 0]
            dts = np.diff(np.concatenate([[ts[0] - (ts[1] - ts[0])
                                           if len(ts) > 1 else t - dt], ts]))
            dts = np.clip(dts, 0.0, imu_mod.MAX_DT_SECONDS)
            out = tracker.process_imu_samples(
                L, R, dts, imu[:, 1:4], imu[:, 4:7])
        else:
            out = tracker.process_imu(L, R, np.zeros(3), np.zeros(3), dt)
        if i % 50 == 0:
            print(f"frame {i}: tracked={int(out.n_tracked)} "
                  f"active={int(out.n_active)} kf={bool(out.is_keyframe)}")

    T = tracker.optimized_trajectory()
    ev.save_kitti_trajectory(args.out, T)
    print(f"{len(T)} poses -> {args.out}  "
          f"(keyframes {len(tracker.slam_keyframes)}, "
          f"closures {len(tracker.accepted_closures)})")
    if seq.gt_T_wc is not None and len(T) >= 2:
        # resample GT to the frame timestamps and evaluate
        times = np.asarray([f[0] for f in seq.frames[:len(T)]])
        gt = ev.interpolate_trajectory(seq.gt_times, seq.gt_T_wc, times)
        m = ev.evaluate(T, gt)
        print(f"ATE RMSE {m.ate_rmse_m:.4f} m | rel trans "
              f"{m.rel_trans_err_m:.4f} m ({m.rel_trans_ratio * 100:.2f} %) | "
              f"rel rot {m.rel_rot_err_rad:.6f} rad")


if __name__ == "__main__":
    main()
