"""Trajectory alignment CLI — the ``compute_rotation_icp`` runnable
(compute_rotation_icp.cpp: rigid alignment of an estimated trajectory onto
ground truth).

Usage:
    python -m svi_mapper_tpu_torch.tools.align_trajectory EST.txt GT.txt [-o OUT.txt]

Prints the aligning rotation/translation and ATE RMSE before/after; with
``-o`` also writes the aligned trajectory (KITTI format). Host only
(numpy).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("ground_truth")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)

    from svi_mapper_tpu_torch.eval import trajectory as ev

    est = ev.load_kitti_trajectory(args.estimate)
    gt = ev.load_kitti_trajectory(args.ground_truth)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]

    before = ev.ate_rmse(est, gt, align=False)
    aligned, R, t = ev.align_trajectory(est, gt)
    after = ev.ate_rmse(aligned, gt, align=False)

    with np.printoptions(precision=6, suppress=True):
        print(f"poses aligned:   {n}")
        print(f"rotation:\n{R}")
        print(f"translation:     {t}")
    print(f"ATE RMSE before: {before:.4f} m")
    print(f"ATE RMSE after:  {after:.4f} m")
    if args.output:
        ev.save_kitti_trajectory(args.output, aligned)
        print(f"aligned trajectory written to {args.output}")


if __name__ == "__main__":
    main()
