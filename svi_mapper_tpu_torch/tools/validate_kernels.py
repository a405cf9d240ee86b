"""Validate the hand-written CUDA kernels against their plain PyTorch
versions ON THE LIVE CARD.

The CPU tests hold each plain version against the JAX package; this tool
holds each kernel against its plain version on the card's own tensors, at
the shapes of the JAX package's ``tools/validate_tpu_kernels`` (a 1248x376
field, 1024 landmarks, 512 stereo keypoints, BA 16 x 2048 for 8 LM
iterations, Hamming 256 x 384), with the port's other two kernels beside
them: K3 (blur + dense BRIEF) at that field and K5 (the tiled Schur
assembly) at 64 x 2048. K4 and K5 are held twice: one assembly against
its plain version, and the bundle adjuster through the kernel against its
materialised route. One OK/FAIL line per kernel; exits 1 on any
mismatch. Without a CUDA device there is nothing to validate (the plain
versions would be compared with themselves): it says so and exits 1.

Usage: python -m svi_mapper_tpu_torch.tools.validate_kernels [--size WxH]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def compare(name: str, got, want, mask=None, detail: str = "") -> int:
    """Print one OK/FAIL line for tensors ``got`` against ``want`` (each a
    tensor or a tuple of them), exact over ``mask`` (a bool tensor over the
    leading axis) or everywhere; returns the number of entries that
    differ."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bad = 0
    for g, w in zip(got, want, strict=True):
        diff = g != w
        if mask is not None:
            diff = diff[mask]
        bad += int(torch.count_nonzero(diff))
    print(f"  {name:20s} {'OK ' if bad == 0 else 'FAIL'} ({bad} mismatches{detail})")
    return bad


def schur_mismatches(got, want) -> dict:
    """The outputs of a Schur assembly (``ops.ba_kernel.schur_assemble``'s
    tuple) that are further from the plain version's ``want`` than
    ``ops.ba_kernel.SCHUR_TOL`` allows: name -> relative error."""
    from svi_mapper_tpu_torch.ops import ba_kernel

    return {nm: e for nm, e in ba_kernel.schur_errors(got, want).items()
            if not e < ba_kernel.SCHUR_TOL[nm]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1248x376", help="field WxH")
    from svi_mapper_tpu_torch.utils.device import add_device_arguments

    add_device_arguments(ap)
    args = ap.parse_args(argv)

    import torch

    if args.cpu or torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
        print("validate_kernels: the kernels run only on a CUDA device, and none "
              "is in use here; nothing was validated", file=sys.stderr)
        return 1
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
        stereo_kernel,
        track_kernel,
    )
    from svi_mapper_tpu_torch.solvers import ba as ba_mod
    from svi_mapper_tpu_torch.tools.bench_scaling import make_problem
    from svi_mapper_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    print(f"device: {torch.cuda.get_device_name(dev)} (hand-written kernels "
          f"against their plain versions) field {w}x{h}")
    rng = np.random.default_rng(20)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    words = lambda *shape: on(  # noqa: E731
        rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))
    failures = 0

    # ---- K3: blur + dense BRIEF ------------------------------------------
    img = on(rng.uniform(0, 255, (h, w)).astype(np.float32))
    failures += compare("brief_dense_fused", descriptors.brief_dense_fused(img),
                        descriptors.smooth_brief_dense_plain(img)) > 0

    # ---- K1: tracking window scores ---------------------------------------
    L = 1024
    dense = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([rng.uniform(29, w - 30, L), rng.uniform(29, h - 30, L)], 1).astype(np.float32)
    dlast = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
    theta = rng.uniform(0, 2 * np.pi, L)
    band = np.stack([np.round(np.cos(theta) * 256), np.round(np.sin(theta) * 256),
                     rng.integers(-600, 600, L), rng.integers(8, 29, L),
                     rng.integers(8, 21, L)]).astype(np.int32)
    for i in range(0, L, 2):   # plant on-band matches for half the landmarks
        nx, ny, c0 = band[0, i] / 256, band[1, i] / 256, band[2, i] / 256
        s = float(rng.uniform(-10, 10))
        dx = int(np.clip(round(-s * ny - c0 * nx), -28, 28))
        dy = int(np.clip(round(s * nx - c0 * ny), -20, 20))
        d = dlast[i].copy()
        d[0] ^= np.uint32(0b1111)
        dense[int(round(uv[i, 1])) + dy, int(round(uv[i, 0])) + dx] = d
    field = on(dense.view(np.int32))
    targs = (field, on(uv), on(dlast.view(np.int32)), on(dlast.view(np.int32)), on(band))
    cuts = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)
    want = track_kernel.window_scores(*targs, **cuts)
    accepted = int((want[0] < track_kernel.BIG).sum())
    failures += compare("track_scores", track_kernel.track_scores(*targs, **cuts), want,
                        detail=f", {accepted} accepted") > 0

    # ---- K2: stereo scanline profiles and the fused match ------------------
    K = 512
    uv_l = np.stack([rng.uniform(130, w - 30, K), rng.uniform(29, h - 30, K)], 1).astype(np.float32)
    dq = np.stack([dense[int(round(v)), int(round(u)) - int(rng.integers(2, 60))]
                   for (u, v) in uv_l])
    sargs = (field, on(uv_l), on(dq.view(np.int32)))
    De = min(128, w)
    _, v_r, x0 = stereo_kernel.span_origin(sargs[1], h, w, De)
    u_r = stereo_kernel.span_origin(sargs[1], h, w, De)[0]
    failures += compare(
        "stereo_profiles", stereo_kernel.stereo_profiles(*sargs, max_disparity=128),
        (stereo_kernel.row_span_profiles(field, v_r, x0, sargs[2], De), u_r, x0)) > 0
    center = on(rng.uniform(2, 60, K).astype(np.float32))
    mkw = dict(max_disparity=128, disparity_center=center,
               search_range=on(np.full(K, 12.0, np.float32)))
    got = stereo_kernel.stereo_match(*sargs, **mkw)
    want = stereo_kernel.stereo_match_plain(*sargs, **mkw)
    matched = int((want[1] < (1 << 20)).sum())
    failures += compare("stereo_match", got, want, detail=f", {matched} matched") > 0

    # ---- K4 / K5: the fused Schur assembly, alone and inside the bundle ----
    # adjuster: one assembly at the starting estimate against the plain
    # version (within ops.ba_kernel.SCHUR_TOL), then 8 LM iterations through
    # the kernel against the materialised route (the JAX tool's check)
    camb = default_camera(width=1241, height=376, device=dev)
    intr = dict(fx=camb.left.fx, fy=camb.left.fy, cx=camb.left.cx, cy=camb.left.cy,
                bq=camb.right.p03)
    for name, Kb in (("schur_assemble", 16), ("schur_assemble_tiled", 64)):
        p = make_problem(Kb, 2048, seed=20)
        argsb = (on(p["T"]), on(p["X0"]), on(p["obs"]), on(p["mask"]), camb, on(p["fix"]))
        window = (*argsb[:3], argsb[3].float(), 1e-4)
        bad = schur_mismatches(getattr(ba_kernel, name)(*window, **intr),
                               getattr(ba_kernel, name + "_plain")(*window, **intr))
        kw = dict(max_iterations=8, min_rel_improvement=0.0, device=dev)
        rx = ba_mod.bundle_adjust(*argsb, use_schur_kernel=False, **kw)
        rk = ba_mod.bundle_adjust(*argsb, use_schur_kernel=True, **kw)
        c_plain, c_kern = float(rx.chi2_final), float(rk.chi2_final)
        dT = float((rk.T_wc - rx.T_wc).abs().max())
        ok = not bad and abs(c_kern - c_plain) < 0.02 * c_plain + 1.0 and dT < 5e-3
        failures += not ok
        print(f"  {name:20s} {'OK ' if ok else 'FAIL'} (K={Kb} x 2048: assembly "
              f"{'within tolerance' if not bad else f'off by {bad}'}; chi2 {c_plain:.1f} "
              f"materialised vs {c_kern:.1f} kernel, max pose delta {dT:.1e})")

    # ---- K6: Hamming matrix and the pool count ------------------------------
    a, b = words(256, 8), words(384, 8)
    failures += compare("hamming_matrix", hamming.hamming_distance_matrix(a, b),
                        hamming.hamming_packed(a, b)) > 0
    q, r = words(8, 256, 8), words(8, 4, 96, 8)
    r[:, :, :32] = q[:, :32, None, :].transpose(1, 2)        # planted matches
    vq = on(rng.random((8, 256)) > 0.1)
    vr = on(rng.random((8, 4, 96)) > 0.1)
    failures += compare("pool_nn_counts", hamming.pool_nn_counts(q, vq, r, vr, 25),
                        hamming.pool_nn_counts_plain(q, vq, r, vr, 25)) > 0

    print("ALL KERNELS AGREE WITH THEIR PLAIN VERSIONS" if failures == 0
          else f"{failures} KERNEL(S) FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
