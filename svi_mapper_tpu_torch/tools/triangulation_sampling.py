"""Rectified-geometry invariant self-check — the ``triangulation_sampling``
runnable (triangulation_sampling.cpp:49-80): verifies on random scene points
that the rectified stereo model satisfies its invariants and that
depth-from-disparity round-trips.

Checks (the reference's asserts, Types.h:48-51 / CTriangulator.cpp:24-31):
  * v_L == v_R (rectified rows align)
  * u_L > u_R (positive disparity)
  * z = -P_R(0,3) / (u_L - u_R) recovers the true depth
  * triangulate(project(p)) == p

Usage: python -m svi_mapper_tpu_torch.tools.triangulation_sampling
           [--samples N] [--calib LEFT RIGHT] [--device cuda | --cpu]
Exits non-zero on any violated invariant.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--calib", nargs=2, metavar=("LEFT", "RIGHT"), default=None,
                    help="hardware_parameters-style calibration files (optional)")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import numpy as np
    import torch

    if args.calib:
        from svi_mapper_tpu_torch.config import load_stereo_camera

        cam = load_stereo_camera(args.calib[0], args.calib[1], device=dev)
    else:
        from svi_mapper_tpu_torch.io.synthetic import default_camera

        cam = default_camera(width=1241, height=376, device=dev)

    rng = np.random.default_rng(0)
    n = args.samples
    # sample camera-frame points across the depth range
    z = rng.uniform(1.0, 80.0, n)
    u = rng.uniform(40, cam.width - 40, n)
    v = rng.uniform(40, cam.height - 40, n)
    fx, fy, cx, cy = cam.left.fx, cam.left.fy, cam.left.cx, cam.left.cy
    p = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1).astype(np.float32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host = lambda t: t.cpu().numpy()  # noqa: E731

    uv_l, uv_r = (host(t) for t in cam.project_stereo(on(p)))

    fails = 0
    row_err = np.abs(uv_l[:, 1] - uv_r[:, 1]).max()
    if row_err > 1e-3:
        print(f"FAIL rectified-row invariant: max |v_L - v_R| = {row_err}")
        fails += 1
    disparity = uv_l[:, 0] - uv_r[:, 0]
    if (disparity <= 0).any():
        print(f"FAIL disparity positivity: min = {disparity.min()}")
        fails += 1
    z_rec = host(cam.depth_from_disparity(on(disparity)))
    z_err = np.abs(z_rec - z).max()
    if z_err > 1e-1:
        print(f"FAIL depth-from-disparity: max |dz| = {z_err}")
        fails += 1
    p_rec = host(cam.triangulate(on(uv_l), on(uv_r)))
    tri_err = np.abs(p_rec - p).max()
    if tri_err > 1e-1:
        print(f"FAIL triangulation round-trip: max err = {tri_err}")
        fails += 1

    print(f"{n} samples: row_err={row_err:.2e} min_disparity="
          f"{disparity.min():.4f} depth_err={z_err:.2e} tri_err={tri_err:.2e}")
    if fails:
        raise SystemExit(f"{fails} invariant(s) violated")
    print("all rectified-geometry invariants hold")


if __name__ == "__main__":
    main()
