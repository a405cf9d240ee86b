"""Trajectory resampling CLI — the ``interpolate_trajectory`` runnable
(interpolate_trajectory.cpp: resample an estimated trajectory to the KITTI
timebase).

Usage:
    python -m svi_mapper_tpu_torch.tools.interpolate_trajectory \
        EST.txt --times-src SRC_TIMES.txt --times-dst DST_TIMES.txt -o OUT.txt

Times files: one timestamp (seconds) per line (KITTI ``times.txt`` format).
Trajectories in KITTI format (12 numbers per line, camera->world 3x4). Host
only (numpy).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("--times-src", required=True)
    ap.add_argument("--times-dst", required=True)
    ap.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)

    from svi_mapper_tpu_torch.eval import trajectory as ev

    T = ev.load_kitti_trajectory(args.estimate)
    ts = np.loadtxt(args.times_src, usecols=0)
    td = np.loadtxt(args.times_dst, usecols=0)
    if len(ts) != len(T):
        raise SystemExit(f"{len(T)} poses but {len(ts)} source timestamps")
    out = ev.interpolate_trajectory(ts, T, td)
    ev.save_kitti_trajectory(args.output, out)
    print(f"resampled {len(T)} poses -> {len(out)} at {args.output}")


if __name__ == "__main__":
    main()
