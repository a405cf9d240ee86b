"""Trajectory evaluation CLI — the ``evaluate_trajectory`` runnable
(evaluate_trajectory.cpp:196-303).

Usage: python -m svi_mapper_tpu_torch.tools.evaluate_trajectory EST.txt GT.txt
Both files in KITTI format (12 numbers per line, camera->world 3x4). Host
only (numpy).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("ground_truth")
    args = ap.parse_args(argv)

    from svi_mapper_tpu_torch.eval import trajectory as ev

    est = ev.load_kitti_trajectory(args.estimate)
    gt = ev.load_kitti_trajectory(args.ground_truth)
    n = min(len(est), len(gt))
    if n < 2:
        raise SystemExit("need at least 2 matching poses")
    m = ev.evaluate(est[:n], gt[:n])
    # summary block mirroring evaluate_trajectory.cpp:270-284
    print(f"frames evaluated:            {m.n_frames}")
    print(f"ATE RMSE:                    {m.ate_rmse_m:.4f} m")
    print(f"avg rel translation error:   {m.rel_trans_err_m:.4f} m ({m.rel_trans_ratio * 100:.2f} %)")
    print(f"avg rel rotation error:      {m.rel_rot_err_rad:.6f} rad")
    print(f"relative translation precision: {m.precision:.4f}")


if __name__ == "__main__":
    main()
