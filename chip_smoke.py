#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a ``torch.profiler`` breakdown of four warm frames to the
main-path line and of ten LM iterations to the map-optimisation line.) Needs
one CUDA card, ``nvcc`` and nothing from the network. It

1. names the card (``nvidia-smi`` name and power limit);
2. builds the hand-written CUDA kernels from ``svi_mapper_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card and
   times kernel and plain version with CUDA events: the front-end kernels
   at the shapes of the main path (376x1248 field, 1024 landmarks /
   keypoints, 128 disparities) and at two ragged small shapes, exact
   equality; the Schur assembly through both entry points (K4, K5; three
   kernels) at (K, L) = (8, 640), (5, 1000), (1, 640), (31, 4097),
   (32, 4097), (32, 4096), (64, 4096), (128, 4096), at the windows of the
   whole system's loop, (8, 1024) and (64, 1024), and at a 64 x 1024 window
   padded as the loop pads its windows, within the stated relative
   tolerances, no further from float64 than the plain version, the same
   bits twice, each kernel's registers and spills (none allowed); the
   Hamming-matrix kernel at 256 x 4096, ragged and batched shapes, exact
   equality; every kernel's device time from a ``torch.profiler`` trace;
4. compares the port on the card with the port on the CPU (plain versions)
   on a short small sequence, SV and GT mode, on a small BA window and
   pose graph, and on the closure query below;
5. drives the main paths. The front-end: the KITTI-00 calibration at
   376x1241 with ``DEFAULT_PARAMS``, 16 frames through
   ``StereoTracker.process`` and 8 through ``process_many(chunk=8)``,
   frames rendered on the card by the port's corridor renderer; checks pose
   acceptance, track counts, the trajectory error against the exact ground
   truth. The map optimisation: ``prepare_ba_window`` -> ``bundle_adjust``
   at 32 / 64 / 128 keyframes x 4096 landmarks, ``optimize_pose_graph`` at
   680 keyframes, ``align_clouds_batch`` at 4 x 256; checks that chi^2
   falls and the errors against the generating truth. The closure query:
   a database of 680 keyframes x 256 pool entries with planted revisits and
   decoys, ``find_closures_batch`` of 8 queries. The whole system: a
   208-frame loop of 26 m radius at 376x1241 through
   ``SLAMSystem.process_many(chunk=32)`` -> ``finalize_backend`` ->
   ``optimized_trajectory``, which must close the loop, and every BA window
   it assembles must have a shape at which the kernels were held against
   their plain versions. Each path must have launched its kernels.

Every phase prints one line of JSON. Any failure raises, so the exit code
is non-zero and the final line is not printed. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# bytes/s and simple operations/s of one H100 SXM (data sheet): device
# memory rate, and the float32 rate outside the tensor cores taken as the
# rate of 32-bit ALU operations (generous for integer work, so the bound
# stays a lower bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

H, W_RAW = 376, 1241
N_LANDMARKS = 1024
MAX_DISPARITY = 128


def require(cond, msg: str) -> None:
    """A check that also holds under ``python -O``."""
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, repeats: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def max_abs_err(a, b) -> int:
    import torch

    # int32 bit patterns: compare as int64 so the difference cannot wrap
    return int(torch.max(torch.abs(a.to(torch.int64) - b.to(torch.int64))))


def unique_pixels(h, w, ys, xs) -> int:
    """Number of distinct field pixels a set of gathers touches."""
    import torch

    mask = torch.zeros((h, w), dtype=torch.bool, device=ys.device)
    mask[ys.reshape(-1).long(), xs.reshape(-1).long()] = True
    return int(mask.sum())


def sm_clock_hz() -> float | None:
    """The card's highest SM clock, as ``nvidia-smi`` gives it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout
        return float(out.split()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.CalledProcessError):
        return None


def ceiling_ms(count: float, per_clock: float, sms: int = 132) -> float | None:
    """A design's ceiling: the time ``count`` operations of one kind take
    when each SM issues ``per_clock`` of them per clock at its highest
    clock (None when ``nvidia-smi`` does not give the clock)."""
    hz = sm_clock_hz()
    return None if hz is None else count / (per_clock * sms * hz) * 1e3


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# predictions far outside the image (held against the plain version's
# saturating rule) and on exact halves (round half to even)
EXTREME_UV = [[3e9, 40.0], [-3e9, 41.0], [1e20, 42.0], [-1e20, 43.0],
              [60.0, 3e9], [61.0, -3e9], [62.0, 1e20], [63.0, -1e20]]
HALF_UV = [[20.5, 30.5], [21.5, 31.5], [22.5, 32.5], [23.5, 33.5]]


def kernel_inputs(seed: int, h: int, w_raw: int, n: int, device):
    """Images and per-landmark inputs made from a seed, at a given shape:
    a rendered stereo pair, predictions (some on the border, some
    non-finite, some far outside the image, some on exact halves),
    descriptors sampled near the predictions so that matches exist, and
    random oriented bands as one ``[5, n]`` tensor, among them bands with
    ``nxq = 0`` or ``nyq = 0``, bands that miss the window and the full
    reach (ru = 28, rv = 20)."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.ops import track_kernel as tk

    rng = np.random.default_rng(seed)
    cam = synthetic.default_camera(w_raw, h, device=device)
    T = synthetic.corridor_trajectory(3, step=0.5)[2]
    img_l, img_r = synthetic.render_stereo(cam, T)
    uv = np.stack([rng.uniform(-5, w_raw + 5, n), rng.uniform(-5, h + 5, n)], 1)
    uv = uv.astype(np.float32)
    uv[0] = [np.nan, 3.0]
    uv[1] = [np.inf, -np.inf]
    uv[2] = [0.0, 0.0]
    uv[3] = [w_raw - 1, h - 1]
    extreme = np.arange(4, 4 + len(EXTREME_UV))
    uv[extreme] = EXTREME_UV
    uv[extreme[-1] + 1:extreme[-1] + 1 + len(HALF_UV)] = HALF_UV
    theta = rng.uniform(0, 2 * np.pi, n)
    band = np.stack([np.round(np.cos(theta) * 256), np.round(np.sin(theta) * 256),
                     rng.integers(-800, 800, n), rng.integers(1, tk.REACH_X + 1, n),
                     rng.integers(1, tk.REACH_Y + 1, n)]).astype(np.int64)
    k = np.arange(n)
    sign = np.where(rng.random(n) < 0.5, -256, 256)
    # unit normals along an axis: nxq = 0 (a horizontal band), nyq = 0
    band[:2, k % 7 == 1] = [[0], [1]] * sign[k % 7 == 1]
    band[:2, k % 7 == 2] = [[1], [0]] * sign[k % 7 == 2]
    band[2, k % 11 == 3] = 90000                  # misses the window
    band[3:, k % 5 == 4] = [[tk.REACH_X], [tk.REACH_Y]]   # the full reach
    # the near predictions: the far ones read the image's edge pixels
    near = np.clip(np.nan_to_num(uv, nan=0.0, posinf=0.0, neginf=0.0), -1e6, 1e6)
    near += rng.integers(-6, 7, (n, 2))
    flip = rng.integers(0, 2 ** 31, (n, 8)) * (rng.random((n, 8)) < 0.05)
    flip[extreme] = 0            # so the far predictions do find their match
    to = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(device)  # noqa: E731
    return dict(
        img_l=img_l, img_r=img_r, uv=to(uv, np.float32),
        uv_near=to(near, np.float32), band=to(band, np.int32), flip=to(flip, np.int32),
        extreme=torch.from_numpy(extreme).to(device),
    )


def check_kernels(device, h: int, w_raw: int, n: int, max_disparity: int,
                  timed: bool) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from svi_mapper_tpu_torch.ops import (
        cuda_build,
        descriptors,
        stereo_kernel,
        track_kernel,
    )

    inp = kernel_inputs(17, h, w_raw, n, device)
    wp = -(-w_raw // 16) * 16
    ext = lambda im: F.pad(im[None, None], (0, wp - w_raw, 0, 0),  # noqa: E731
                           mode="replicate")[0, 0].contiguous()
    img_l, img_r = ext(inp["img_l"]), ext(inp["img_r"])
    results = []

    # --- K3: fused blur + dense BRIEF ------------------------------------
    field_l = descriptors.brief_dense_fused(img_l)
    field_r = descriptors.brief_dense_fused(img_r)
    torch.cuda.synchronize()
    plain_l = descriptors.smooth_brief_dense_plain(img_l)
    plain_r = descriptors.smooth_brief_dense_plain(img_r)
    err3 = max(max_abs_err(field_l, plain_l), max_abs_err(field_r, plain_r))
    require(field_l.shape == (h, wp, 8) and field_l.dtype == torch.int32,
            "field_l.shape == (h, wp, 8) and field_l.dtype == torch.int32")
    require(torch.equal(field_l, plain_l) and torch.equal(field_r, plain_r),
            "brief_dense_fused disagrees with brief_dense(box_blur(img, 5))")
    k3 = dict(name="brief_dense_fused", max_abs_err=err3)
    if timed:
        px = h * wp
        k3["ms"] = time_ms(lambda: descriptors.brief_dense_fused(img_l), 50)
        k3["launch_only_ms"] = k3["ms"]     # the wrapper does nothing else
        k3["device_ms"] = traced_device_ms(
            lambda: descriptors.brief_dense_fused(img_l), ("brief_dense_kernel",))
        k3["plain_ms"] = time_ms(lambda: descriptors.smooth_brief_dense_plain(img_l), 3, 1)
        k3["bound_ms"], k3["bound_by"] = bound(px * 4 + px * 32 + 256 * 16,
                                               px * (256 + 20))
        # the design's shared loads per pixel, and the time they take at
        # one warp-wide load per clock and SM
        design = descriptors.brief_schedule_stats(descriptors.BRIEF_ROWS)
        loads = design["compare_loads_per_pixel"] + design["blur_loads_per_pixel"]
        k3["design"] = {**design, "ceiling_ms": ceiling_ms(px * loads / 32, 1)}
    results.append(k3)

    # --- K1: window scoring ----------------------------------------------
    desc_last = descriptors.brief_at(field_l, inp["uv_near"]) ^ inp["flip"]
    desc_ref = descriptors.brief_at(field_l, inp["uv_near"])
    args = (field_l, inp["uv"], desc_last, desc_ref, inp["band"])
    cuts = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)
    got = track_kernel.track_scores(*args, **cuts)
    torch.cuda.synchronize()
    want = track_kernel.window_scores(*args, **cuts)
    err1 = max(max_abs_err(g, w) for g, w in zip(got, want))
    n_accept = int((want[0] < track_kernel.BIG).sum())
    require(n_accept > n // 20, f"only {n_accept} of {n} windows accept a match")
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "track_scores disagrees with window_scores")
    # the far predictions are rounded and clamped in the kernel: they find
    # their match at the image's edge, as the plain version says
    require(bool((want[0][inp["extreme"]] < track_kernel.BIG).all()),
            "a prediction far outside the image found no match")
    origin = track_kernel.window_origin(inp["uv"], h, wp)
    mask = track_kernel.listed_mask(*track_kernel.tier_row_intervals(*origin, inp["band"]))
    listed = mask.sum((1, 2))
    win = track_kernel.WIN_H * track_kernel.WIN_W
    k1 = dict(name="track_scores", max_abs_err=err1, accepted=n_accept,
              pixels_scored_per_landmark={"mean": float(listed.float().mean()),
                                          "max": int(listed.max()), "window": win})
    if timed:
        _, _, x0, y0 = origin
        rows = torch.arange(track_kernel.WIN_H, device=device)
        cols = torch.arange(track_kernel.WIN_W, device=device)
        ys = (y0[:, None, None] + rows[None, :, None]).expand(-1, -1, track_kernel.WIN_W)
        xs = (x0[:, None, None] + cols[None, None, :]).expand(-1, track_kernel.WIN_H, -1)
        # the field pixels the tiers can accept: all the function needs
        touched = unique_pixels(h, wp, ys[mask], xs[mask])
        scored = int(listed.sum())
        k1["ms"] = time_ms(lambda: track_kernel.track_scores(*args, **cuts), 50)
        # the launch alone, without the wrapper's checks
        launch1 = lambda: track_kernel.launch_track_scores(  # noqa: E731
            cuda_build.load_library(), field_l, inp["uv"], inp["band"], desc_last,
            desc_ref, 25, 50, 50)
        k1["launch_only_ms"] = time_ms(launch1, 50)
        k1["device_ms"] = traced_device_ms(launch1, ("track_scores_kernel",))
        k1["plain_ms"] = time_ms(lambda: track_kernel.window_scores(*args, **cuts), 3, 1)
        # field pixels touched, 2 floats + 5 ints + 2 descriptors in and
        # 4 ints out per landmark; 16 xor + 16 popcount + 14 add + ~20 for
        # the tiers and the key per scored pixel
        k1["bound_ms"], k1["bound_by"] = bound(
            touched * 32 + n * (2 * 4 + 5 * 4 + 2 * 32 + 4 * 4), scored * 66)
        # its popcounts at 16 per clock and SM
        k1["design"] = {"pixels_scored": scored, "popcounts": 16 * scored,
                        "ceiling_ms": ceiling_ms(16 * scored, 16)}
    results.append(k1)

    k1["planted"] = check_track_scores_planted(device, h, wp, n)

    # --- K2: stereo profiles ---------------------------------------------
    desc_k = descriptors.brief_at(field_l, inp["uv_near"])
    prof, u_r, x0 = stereo_kernel.stereo_profiles(
        field_r, inp["uv"], desc_k, max_disparity=max_disparity)
    torch.cuda.synchronize()
    De = prof.shape[1]
    _, v_r, x0p = stereo_kernel.span_origin(inp["uv"], h, wp, De)
    want2 = stereo_kernel.row_span_profiles(field_r, v_r, x0p, desc_k, De)
    err2 = max_abs_err(prof, want2)
    require(De == min(max_disparity, wp) and torch.equal(x0, x0p),
            "De == min(max_disparity, wp) and torch.equal(x0, x0p)")
    require(torch.equal(prof, want2),
            "stereo_profiles disagrees with the row-span profile")
    k2 = dict(name="stereo_profiles", max_abs_err=err2)
    if timed:
        cols = x0p[:, None] + torch.arange(De, device=device)[None, :]
        touched = unique_pixels(h, wp, v_r[:, None].expand(-1, De), cols)
        k2["ms"] = time_ms(lambda: stereo_kernel.stereo_profiles(
            field_r, inp["uv"], desc_k, max_disparity=max_disparity), 50)
        launch2 = lambda: stereo_kernel.launch_stereo_profiles(  # noqa: E731
            cuda_build.load_library(), field_r, v_r, x0p, desc_k, De)
        k2["launch_only_ms"] = time_ms(launch2, 50)
        k2["device_ms"] = traced_device_ms(launch2, ("stereo_profiles_kernel",))
        k2["plain_ms"] = time_ms(lambda: stereo_kernel.row_span_profiles(
            field_r, v_r, x0p, desc_k, De), 5, 1)
        # span pixels touched, keypoint + descriptor in, profile out;
        # 8 xor + 8 popcount + 7 add per candidate
        k2["bound_ms"], k2["bound_by"] = bound(
            touched * 32 + n * (2 * 4 + 32) + n * De * 4, n * De * 23)
    results.append(k2)
    return results


def check_track_scores_planted(device, h: int, w: int, n: int) -> dict:
    """K1 on a RANDOM field (no two descriptors alike), with one candidate
    planted per landmark anywhere in its window and the band laid exactly
    on, just inside or just outside that candidate, the reach exactly at or
    one short of it, and the candidate's two Hamming distances at or one
    over the cutoffs: every ``<=`` of the acceptance rule decides some
    landmark's outcome. Every eighth prediction lies on an exact half (the
    rounding decides the reach). The last two landmarks accept nothing, one
    with the band through window position 0, one with position 0 off every
    region: both must return position 0, as the plain version does."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.ops import track_kernel as tk

    rng = np.random.default_rng(29)
    gen = torch.Generator(device=device).manual_seed(29)
    field = torch.randint(-2 ** 31, 2 ** 31, (h, w, 8), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    uv = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    uv[::8] = np.floor(uv[::8]) + 0.5
    uv[-2:] = [[w / 2, h / 2], [w / 2 + 0.5, h / 2 + 0.5]]   # inside, away from the edges
    uv = uv.astype(np.float32)
    u_r = np.clip(np.round(uv[:, 0]), 0, w - 1).astype(np.int64)
    v_r = np.clip(np.round(uv[:, 1]), 0, h - 1).astype(np.int64)
    tx = np.clip(u_r + rng.integers(-tk.REACH_X, tk.REACH_X + 1, n), 0, w - 1)
    ty = np.clip(v_r + rng.integers(-tk.REACH_Y, tk.REACH_Y + 1, n), 0, h - 1)
    dx, dy = tx - u_r, ty - v_r
    theta = rng.uniform(0, 2 * np.pi, n)
    nxq = np.round(np.cos(theta) * 256).astype(np.int64)
    nyq = np.round(np.sin(theta) * 256).astype(np.int64)
    # band value at the planted pixel: on the line, on either edge (accept),
    # one step outside either edge (reject)
    target = np.array([0, 640, -640, 641, -641])[np.arange(n) % 5]
    c0q = target - (nxq * dx + nyq * dy)
    # reach exactly at the candidate, or one short of it on one axis
    short = (np.arange(n) // 5) % 3
    ru = np.abs(dx) - (short == 1)
    rv = np.abs(dy) - (short == 2)
    # the last two: full reach; the band through position 0 (dx = -28,
    # dy = -20 from the prediction) or far from the window
    ru[-2:], rv[-2:] = tk.REACH_X, tk.REACH_Y
    c0q[-2] = nxq[-2] * tk.REACH_X + nyq[-2] * tk.REACH_Y
    c0q[-1] = 90000
    to = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(device)  # noqa: E731
    desc = field[to(ty, np.int64), to(tx, np.int64)]
    # Hamming distances of the candidate to the last / anchor descriptor, at
    # and just over the cutoffs (25 for stage 1, 50 for stages 2-3 and the
    # anchor gate)
    d_last = np.array([3, 25, 26, 50, 51])[(np.arange(n) // 15) % 5]
    d_ref = np.array([0, 50, 51])[(np.arange(n) // 75) % 3]
    d_ref[-2:] = 128             # the anchor matches no pixel of the window

    def low_bits(counts):
        """[n, 8] int32 words with the lowest ``counts[i]`` bits set."""
        bit = np.arange(256)[None, :] < counts[:, None]
        w32 = (bit.reshape(n, 8, 32) * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
        return to(w32.astype(np.uint32).view(np.int32), np.int32)

    band = to(np.stack([nxq, nyq, c0q, ru, rv]), np.int32)
    args = (field, to(uv, np.float32), desc ^ low_bits(d_last), desc ^ low_bits(d_ref), band)
    cuts = dict(cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)
    got = tk.track_scores(*args, **cuts)
    torch.cuda.synchronize()
    want = tk.window_scores(*args, **cuts)
    require(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
            "track_scores disagrees with window_scores on planted candidates")
    accepted = (want[0] < tk.BIG).cpu().numpy()
    # what the planting says must happen
    cell = (np.abs(dx) <= 1) & (np.abs(dy) <= 1)
    near = (np.abs(dx) <= 8) & (np.abs(dy) <= 8)
    on_band = np.abs(target) <= 640
    in_reach = (np.abs(dx) <= ru) & (np.abs(dy) <= rv)
    expect = (d_ref <= 50) & ((cell & (d_last <= 25))
                              | ((near | (on_band & in_reach)) & (d_last <= 50)))
    require(bool((accepted == expect).all()),
            "planted candidates were not accepted as their bands and reaches say")
    origin = tk.window_origin(args[1], h, w)
    listed = tk.listed_mask(*tk.tier_row_intervals(*origin, band))
    require(bool(listed[-2, 0, 0]) and not bool(listed[-1, 0, 0])
            and not accepted[-2:].any()
            and all(int(v[-1]) == int(o[-1]) and int(v[-2]) == int(o[-2])
                    for v, o in zip(want[1:3], origin[2:4])),
            "the landmarks that accept nothing do not return window position 0")
    far = ~near
    return {"landmarks": n, "accepted": int(accepted.sum()),
            "decided_by_stage3": int((accepted & far).sum()),
            "rejected_at_band_edge": int((far & in_reach & ~on_band).sum()),
            "rejected_at_reach": int((far & on_band & ~in_reach).sum()),
            "rejected_at_cutoff": int(((d_ref > 50) | (d_last > 50)).sum()),
            "on_exact_halves": int((uv[:, 0] % 1 == 0.5).sum())}


class TrackInputs:
    """While in use, notes what the tracker hands K1 on a main path: the
    field's shape, the predictions and the bands of every call (references
    only: no copy, no host read), and a copy of all the inputs of call
    number ``sample``, for timing after the path."""

    def __init__(self, sample: int):
        self.sample, self.calls, self.sampled = sample, [], None

    def __enter__(self):
        from svi_mapper_tpu_torch.frontend import tracking

        self.wrapped = tracking.track_scores

        def recording(dense_left, uv_pred, desc_last, desc_ref, band, **cuts):
            if len(self.calls) == self.sample:
                self.sampled = ([t.clone() for t in (dense_left, uv_pred, desc_last,
                                                     desc_ref, band)], cuts)
            self.calls.append((dense_left.shape[:2], uv_pred, band))
            return self.wrapped(dense_left, uv_pred, desc_last, desc_ref, band, **cuts)

        tracking.track_scores = recording
        return self

    def __exit__(self, *exc):
        from svi_mapper_tpu_torch.frontend import tracking

        tracking.track_scores = self.wrapped

    def report(self) -> dict:
        """Pixels K1 listed per landmark over every call (from
        ``tier_row_intervals``, as the kernel lists them), and K1 on the
        sampled call's inputs: held against its plain version and timed.
        Launches K1 (after the path's counts were read)."""
        import torch

        from svi_mapper_tpu_torch.ops import cuda_build
        from svi_mapper_tpu_torch.ops import track_kernel as tk

        listed = torch.cat([
            tk.listed_mask(*tk.tier_row_intervals(*tk.window_origin(uv, h, w), band))
            .sum((1, 2)) for (h, w), uv, band in self.calls])
        out = {"calls": len(self.calls),
               "pixels_scored_per_landmark": {
                   "mean": float(listed.float().mean()), "max": int(listed.max()),
                   "window": tk.WIN_H * tk.WIN_W}}
        if self.sampled is not None:
            (field, uv, d_last, d_ref, band), cuts = self.sampled
            args = (field, uv, d_last, d_ref, band)
            got = tk.track_scores(*args, **cuts)
            want = tk.window_scores(*args, **cuts)
            require(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
                    "track_scores disagrees with window_scores on a main path's inputs")
            launch = lambda: tk.launch_track_scores(  # noqa: E731
                cuda_build.load_library(), field, uv, band, d_last, d_ref,
                cuts["cutoff_s1"], cuts["cutoff_s2"], cuts["cutoff_ref"])
            sampled = tk.listed_mask(*tk.tier_row_intervals(
                *tk.window_origin(uv, *field.shape[:2]), band)).sum((1, 2))
            out["sampled_call"] = {
                "call": self.sample, "equal_to_plain": True,
                "pixels_scored_mean": float(sampled.float().mean()),
                "device_ms": traced_device_ms(launch, ("track_scores_kernel",))}
        return out


FRONTEND_KERNELS = ("track_scores", "stereo_profiles", "brief_dense_fused")
BACKEND_KERNELS = ("schur_assemble", "schur_assemble_tiled")
CLOSURE_KERNEL = "hamming_matrix"

KERNEL_FACTS = {
    "track_scores": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/track_scores.cu",
        replaces="svi_mapper_tpu/ops/track_kernel.py:213"),
    "stereo_profiles": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/stereo_profiles.cu",
        replaces="svi_mapper_tpu/ops/stereo_kernel.py:111"),
    "brief_dense_fused": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/brief_dense.cu",
        replaces="svi_mapper_tpu/ops/descriptors.py:208"),
    "schur_assemble": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/schur_assemble.cu",
        replaces="svi_mapper_tpu/ops/ba_kernel.py:251"),
    "schur_assemble_tiled": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/schur_assemble.cu",
        replaces="svi_mapper_tpu/ops/ba_kernel.py:445"),
    "hamming_matrix": dict(
        route="cuda", source="svi_mapper_tpu_torch/csrc/hamming_matrix.cu",
        replaces="svi_mapper_tpu/ops/hamming.py:85"),
}


def launch_counts() -> dict:
    from svi_mapper_tpu_torch.ops import paths

    return paths.launch_counts()


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import paths

    paths.reset_launch_counts()


# ---------------------------------------------------------------------------
# trajectory error
# ---------------------------------------------------------------------------

def ate_rmse(est, gt) -> float:
    """RMSE of camera centres, both trajectories expressed in the frame of
    their own first pose (no further alignment)."""
    import numpy as np

    def centres(poses):
        poses = np.asarray(poses, np.float64)
        out = []
        for T in poses:
            Trel = T @ np.linalg.inv(poses[0])
            out.append(-Trel[:3, :3].T @ Trel[:3, 3])
        return np.stack(out)

    d = centres(est) - centres(gt)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def ate_rmse_aligned(est, gt) -> float:
    """RMSE of camera centres after the rigid (no scale) alignment that
    minimises it — the JAX package's ``eval.trajectory.ate_rmse``."""
    import numpy as np

    def centres(poses):
        poses = np.asarray(poses, np.float64)
        return -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])

    p, g = centres(est), centres(gt)
    pc, gc = p - p.mean(0), g - g.mean(0)
    U, _, Vt = np.linalg.svd(gc.T @ pc)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    d = pc @ R.T - gc
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU on a small sequence
# ---------------------------------------------------------------------------

def check_against_cpu(device) -> dict:
    import numpy as np

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.tracker import StereoTracker

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512, max_detections=512)
    n = 6
    seq = synthetic.SyntheticSequence(n_frames=n, width=512, height=256, step=0.5,
                                      device="cpu")
    frames = [(l.numpy(), r.numpy(), T) for l, r, T in seq]
    cam_gpu = synthetic.default_camera(512, 256, device=device)
    report = {}
    for mode in ("sv", "gt"):
        gt = mode == "gt"
        a = StereoTracker(cam_gpu, params, use_gt_pose=gt, device=device)
        b = StereoTracker(seq.cam, params, use_gt_pose=gt, device="cpu")
        worst_count, worst_pos = 0, 0.0
        for l, r, T in frames:
            oa = a.process(l, r, T if gt else None)
            ob = b.process(l, r, T if gt else None)
            require(bool(oa.posit_ok) == bool(ob.posit_ok),
                    "bool(oa.posit_ok) == bool(ob.posit_ok)")
            require(bool(oa.is_keyframe) == bool(ob.is_keyframe),
                    "bool(oa.is_keyframe) == bool(ob.is_keyframe)")
            for name in ("n_tracked", "n_new", "n_active", "n_optimal"):
                worst_count = max(worst_count,
                                  abs(int(getattr(oa, name)) - int(getattr(ob, name))))
            ca = -oa.T_wc[:3, :3].T @ oa.T_wc[:3, 3]
            cb = -ob.T_wc[:3, :3].T @ ob.T_wc[:3, 3]
            worst_pos = max(worst_pos, float(np.linalg.norm(ca - cb)))
        # float-order flips of borderline matches: at most 1 % of capacity;
        # poses within the free-running bound of the CPU parity tests
        require(worst_count <= 5, f"{mode}: counts differ by {worst_count}")
        require(worst_pos < 5e-2, f"{mode}: poses differ by {worst_pos} m")
        require(int(oa.n_tracked) > 100, "int(oa.n_tracked) > 100")
        report[mode] = {"max_count_diff": worst_count, "max_pose_diff_m": worst_pos}
    return report


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def run_main_path(device, profile: bool = False) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, load_stereo_camera
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.tracker import StereoTracker

    n_single, n_chunked, chunk, warm_from = 16, 8, 8, 4
    n = n_single + n_chunked
    cam = load_stereo_camera("kitti_00_camera_left.txt",
                             "kitti_00_camera_right.txt", device=device)
    require((cam.height, cam.width) == (H, W_RAW),
            "(cam.height, cam.width) == (H, W_RAW)")
    poses = synthetic.corridor_trajectory(n, step=0.5)
    rendered = [synthetic.render_stereo(cam, T) for T in poses]
    imgs_l = torch.stack([l for l, _ in rendered])
    imgs_r = torch.stack([r for _, r in rendered])
    del rendered
    torch.cuda.synchronize()

    tracker = StereoTracker(cam, DEFAULT_PARAMS, device=device)
    require(DEFAULT_PARAMS.max_landmarks == N_LANDMARKS,
            "DEFAULT_PARAMS.max_landmarks == N_LANDMARKS")
    reset_launch_counts()
    frame_s = []
    outs = []
    with TrackInputs(sample=n_single // 2) as k1_inputs:
        for i in range(n_single):
            t0 = time.perf_counter()
            outs.append(tracker.process(imgs_l[i], imgs_r[i]))
            frame_s.append(time.perf_counter() - t0)      # process() reads the outputs
        t0 = time.perf_counter()
        outs += tracker.process_many(imgs_l[n_single:], imgs_r[n_single:], chunk=chunk)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
    counts = launch_counts()

    require(len(outs) == n == tracker.frame_count,
            "len(outs) == n == tracker.frame_count")
    bad = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]
    require(not bad, f"pose solve rejected on frames {bad}")
    low = [(i, int(o.n_tracked)) for i, o in enumerate(outs[1:], 1)
           if int(o.n_tracked) <= 100]
    require(not low, f"too few landmarks tracked: {low}")
    traj = tracker.trajectory_array
    require(traj.shape == (n, 4, 4) and np.isfinite(traj).all(),
            "traj.shape == (n, 4, 4) and np.isfinite(traj).all()")
    ate = ate_rmse(traj, poses)
    require(ate < 0.10, f"ATE {ate} m against the exact ground truth")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS),
            f"kernel not launched: {counts}")
    st = tracker.state
    tensors = [st.T_wc, st.T_wc_prev, st.T_last_keyframe, st.next_uid,
               st.frame_idx, st.instability]
    tensors += [getattr(st.table, f.name) for f in dataclasses.fields(st.table)]
    require(all(t.is_cuda for t in tensors), "state left the card")

    # host synchronisations per frame: four more frames with PyTorch's sync
    # debug mode on, which warns at every call that waits for the card
    # (made after the launch counts were read)
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(4):
            tracker.process(imgs_l[i], imgs_r[i])
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(c.message).lower() for c in caught) / 4

    warm = frame_s[warm_from:]
    report = {
        "phase": "main_path", "frames": n, "image": [H, W_RAW],
        "landmarks": DEFAULT_PARAMS.max_landmarks,
        "ate_rmse_m": ate,
        "n_tracked_min": min(int(o.n_tracked) for o in outs[1:]),
        "n_tracked_mean": float(np.mean([int(o.n_tracked) for o in outs[1:]])),
        "keyframes": len(tracker.keyframes),
        "process_ms_per_frame": 1e3 * float(np.mean(warm)),
        "process_frames_per_s": len(warm) / float(np.sum(warm)),
        "process_many_ms_per_frame": 1e3 * chunked_s / n_chunked,
        "process_many_frames_per_s": n_chunked / chunked_s,
        "launches_per_frame": {k: counts[k] / n for k in FRONTEND_KERNELS},
        "host_syncs_per_frame": syncs,
        # K1 on the bands this path built
        "track_scores_on_path": k1_inputs.report(),
    }
    if profile:
        report["profile"] = profile_frames(tracker, imgs_l, imgs_r,
                                           report["process_ms_per_frame"])
    return report, counts


def profile_frames(tracker, imgs_l, imgs_r, unprofiled_ms_per_frame: float,
                   n: int = 4) -> dict:
    """``torch.profiler`` over ``n`` warm frames: the time the card was
    busy, its idle share of an UNPROFILED frame (tracing slows the host
    many times over, so the traced wall time only says what tracing costs),
    and the kernels that took most of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            tracker.process(imgs_l[i], imgs_r[i])
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "frames": n, "traced_wall_ms_per_frame": wall_ms / n,
        "device_busy_ms_per_frame": busy_ms / n,
        "device_idle_share": 1.0 - (busy_ms / n) / unprofiled_ms_per_frame,
        "device_kernels_per_frame": sum(r[2] for r in rows) / n,
        # device time of the port's own kernels, per launch, as traced
        "port_kernels_device_ms": {
            name: next((r[1] / r[2] for r in rows if name in r[0]), None)
            for name in ("track_scores_kernel", "stereo_profiles_kernel",
                         "brief_dense_kernel")},
        "top_kernels": [{"name": r[0][:80], "ms_per_frame": r[1] / n,
                         "calls_per_frame": r[2] / n} for r in rows[:12]],
    }


# ---------------------------------------------------------------------------
# the Schur-assembly kernels (K4, K5) against their plain versions
# ---------------------------------------------------------------------------

BA_WIDTH, BA_HEIGHT = 1241, 376
BA_LANDMARKS = 4096
# the tolerances of the CPU tests: relative to the largest entry of the
# plain version's output; rhs cancels, so it is held against 100 x max|b_l|.
# The largest entries of Hll_inv are the unobserved landmarks' 1 / damping,
# a thousand times an observed landmark's, so Hll_inv is held per landmark
# as well, each 3x3 block against its own largest entry: 5e-3, because the
# cofactors cancel (float32 alone is up to 8e-4 from float64 on a weakly
# observed landmark); a wrong block is off by its own size
SCHUR_NAMES = ("S", "rhs", "Hll_inv", "b_l", "W")
SCHUR_TOL = dict(S=2e-4, rhs=5e-3, Hll_inv=2e-4, b_l=2e-4, W=2e-4,
                 Hll_inv_block=5e-3)
# float operations per (keyframe, landmark) of the shared body, counted from
# csrc/schur_assemble.cu: point 18, projection and residuals 31, weight 8,
# Jacobian rows 24 + 36 + 60, H_ll/b_l 63, W rows 126, H_pp/b_p 189
FLOPS_PER_OBSERVATION = 555


def ba_problem(K: int, L: int, seed: int, noise: float = 0.5,
               point_noise: float = 0.2, hard: bool = False):
    """A forward-moving window over a box of landmarks (numpy): keyframes
    ``32 / K`` m apart, so that every keyframe of every window size sees the
    box; stereo observations with ``noise`` px, masked to the image; the
    landmark estimates perturbed by ``point_noise`` m. With ``hard``: 20 %
    of the observations dropped, seven landmarks never observed, five
    unmasked observations of points behind or almost in the plane of the
    camera (z below 0.05 and below 1e-6), so that every branch of the
    assembly runs."""
    import numpy as np

    from svi_mapper_tpu_torch.io.synthetic import default_camera

    cam = default_camera(BA_WIDTH, BA_HEIGHT, device="cpu")
    fx, fy, cx, cy, bq = (cam.left.fx, cam.left.fy, cam.left.cx, cam.left.cy,
                          cam.right.p03)
    rng = np.random.default_rng(seed)
    step = np.float32(min(1.0, 32.0 / K))
    X = rng.uniform([-20, -2, 5], [20, 2, 60], (L, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -np.arange(K, dtype=np.float32) * step
    p_c = np.einsum("kij,lj->kli", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p_c[..., 2]
    zs = np.where(np.abs(z) < 1e-3, 1e-3, z)
    u_l = fx * p_c[..., 0] / zs + cx
    v_l = fy * p_c[..., 1] / zs + cy
    u_r = (fx * p_c[..., 0] + bq) / zs + cx
    obs = np.stack([u_l, v_l, u_r, v_l], -1) + rng.normal(0, noise, (K, L, 4))
    mask = ((z > 1.0) & (u_l > 0) & (u_l < BA_WIDTH) & (v_l > 0)
            & (v_l < BA_HEIGHT))
    X0 = X + rng.normal(0, point_noise, X.shape).astype(np.float32)
    if hard:
        mask &= rng.random((K, L)) > 0.2
        mask[:, :7] = False
        k_near = max(K - 2, 0)
        X0[7:12, 2] = step * k_near + np.array([-0.3, 0.0, 0.03, 0.06, 1e-7],
                                               np.float32)
        mask[:, 7:12] = True
    fix = np.zeros(K, bool)
    fix[0] = True
    return dict(T=T, X_true=X, X0=X0.astype(np.float32),
                obs=np.clip(obs, -1e4, 1e4).astype(np.float32), mask=mask,
                fix=fix, intr=(fx, fy, cx, cy, bq))


def schur_errors(got, want) -> dict:
    """Per output: max |got - want| over the scale its tolerance names."""
    import torch

    scale_rhs = float(torch.max(torch.abs(want[3]))) * 100
    out = {}
    for nm, a, b in zip(SCHUR_NAMES, got, want):
        scale = scale_rhs if nm == "rhs" else max(float(torch.max(torch.abs(b))), 1e-9)
        out[nm] = float(torch.max(torch.abs(a.double() - b.double()))) / scale
    block_scale = want[2].double().abs().amax((1, 2)).clamp(min=1e-30)
    out["Hll_inv_block"] = float(torch.max(
        (got[2].double() - want[2].double()).abs().amax((1, 2)) / block_scale))
    return out


def ptxas_report(source: str, marker: str) -> list[dict]:
    """Registers, shared memory and spills of the kernels of one source, as
    ``ptxas -v`` printed them during this run's build ([] when the library
    was already built)."""
    import re

    from svi_mapper_tpu_torch.ops import cuda_build

    rows, name = [], None
    for line in cuda_build.build_log.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the plain name out of the mangled one, with its template value
            plain = re.search(r"\d+([a-z_]+kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (plain.group(1) + (f"<{plain.group(2)}>" if plain.group(2) else "")
                    if plain else m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append(dict(kernel=name, stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3))))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(s.group(1)) if s else 0
    return [r for r in rows if marker in r["kernel"]]


def sass_count(kernel: str, opcode: str) -> int | None:
    """Instructions of one opcode (``LDS``: shared loads) in a kernel of
    the built library, as ``cuobjdump -sass`` shows them (None without
    ``cuobjdump``)."""
    import re
    import shutil
    from pathlib import Path

    from svi_mapper_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", cuda_build.load_library()._name],
                          capture_output=True, text=True).stdout
    count, inside = 0, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(rf"\b{opcode}(\.|\s)", line):
            count += 1
    return count


def padded_ba_problem(K0: int, K: int, L0: int, L: int, seed: int):
    """``ba_problem(K0, L0, hard=True)`` padded as ``models.slam`` pads a BA
    window: keyframes past K0 with identity poses and no observations (the
    bucket to a power of two), landmarks past L0 at the origin and never
    observed (the bucket to a power of two of at least 64)."""
    import numpy as np

    p = ba_problem(K0, L0, seed=seed, noise=1.5, point_noise=0.1, hard=True)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:K0] = p["T"]
    X0 = np.zeros((L, 3), np.float32)
    X0[:L0] = p["X0"]
    obs = np.zeros((K, L, 4), np.float32)
    obs[:K0, :L0] = p["obs"]
    mask = np.zeros((K, L), bool)
    mask[:K0, :L0] = p["mask"]
    return dict(p, T=T, X0=X0, obs=obs, mask=mask)


# the design's three kernels, as the trace names them
SCHUR_KERNELS = ("schur_assembly_kernel", "schur_product_kernel", "schur_reduce_kernel")


def schur_counts(mask, K: int, L: int) -> dict:
    """Bytes and operations the function needs on this window's data: each
    input read once and each output written once; the assembly's
    operations per observation, and C = W Hll^-1 (90 operations per
    observed keyframe-landmark pair), the rhs column (36) and the product
    (216 per 6x6 block and landmark) only where an observation is, the
    product over the upper block triangle: n (n + 1) / 2 blocks for a
    landmark that n keyframes observe."""
    import numpy as np

    n_l = mask.sum(0).astype(np.int64)
    n_obs = int(n_l.sum())
    pairs = int((n_l * (n_l + 1) // 2).sum())
    moved_in = 4 * (16 * K + 3 * L + 5 * K * L)
    moved_out = 4 * (36 * K * K + 6 * K + 12 * L + 18 * K * L)
    return dict(bytes=moved_in + moved_out,
                flops=n_obs * (FLOPS_PER_OBSERVATION + 90 + 36) + 216 * pairs,
                product_flops_upper=216 * pairs,
                product_flops_dense_upper=216 * (K * (K + 1) // 2) * L,
                observations=n_obs)


def check_schur_kernel(device, name: str, K: int, L: int, timed: bool,
                       padded: bool = False) -> dict:
    import torch

    from svi_mapper_tpu_torch.ops import ba_kernel

    fn, plain = {
        "schur_assemble": (ba_kernel.schur_assemble, ba_kernel.schur_assemble_plain),
        "schur_assemble_tiled": (ba_kernel.schur_assemble_tiled,
                                 ba_kernel.schur_assemble_tiled_plain),
    }[name]
    if padded:
        p = padded_ba_problem(K // 2 + 3, K, L * 3 // 4 - 5, L, seed=29 + K)
    else:
        p = ba_problem(K, L, seed=23 + K, noise=1.5, point_noise=0.1, hard=True)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (to(p["T"]), to(p["X0"]), to(p["obs"]), to(p["mask"].astype("float32")))
    kw = dict(zip(("fx", "fy", "cx", "cy", "bq"), p["intr"]))
    # with one keyframe every landmark is observed once, and S is H_pp
    # cancelled by its own landmarks' terms down to the damping: at 1e-3 the
    # plain float32 version keeps no digit of it (7.8 x its size from
    # float64); at 10 it keeps five
    lam = 10.0 if K == 1 else 1e-3
    got = fn(*args, lam, **kw)
    torch.cuda.synchronize()
    again = fn(*args, lam, **kw)
    want32 = plain(*args, lam, **kw)
    want64 = plain(*[a.double() for a in args], lam, **kw)
    torch.cuda.synchronize()
    require(all(torch.isfinite(g).all() for g in got), f"{name}: non-finite output")
    require(got[0].shape == (K, 6, K, 6) and got[4].shape == (3, 6 * K, L),
            f"{name}: output shapes")
    err = schur_errors(got, want32)
    bad = {nm: float(f"{e:.3e}") for nm, e in err.items() if not e < SCHUR_TOL[nm]}
    require(not bad, f"{name} K={K} L={L} padded={padded}: off by {bad}")
    # the inputs reach every branch
    pc_z = (torch.einsum("kij,lj->kli", args[0][:, :3, :3], args[1])
            + args[0][:, None, :3, 3])[..., 2]
    seen = args[3] > 0
    require(bool(((pc_z < 0.05) & seen).any()) and bool(((pc_z.abs() < 1e-6) & seen).any()),
            "no observation behind / in the plane of the camera")
    require(bool((~seen.any(0)).any()), "no unobserved landmark")
    require(float(got[4][:, :, :7].abs().max()) == 0.0, "W of an unobserved landmark")
    # an unobserved landmark: 1 / (lam + point_damping) on the diagonal
    unseen_inv = got[2][~seen.any(0)].double() * (lam + 1e-6)
    require(float((unseen_inv - torch.eye(3, device=device, dtype=torch.float64))
                  .abs().max()) < 1e-5, "Hll_inv of an unobserved landmark")
    if padded:
        # the padded keyframes' rows and columns, the padded landmarks'
        # columns: exact zeros
        k0 = int(seen.any(1).nonzero().max()) + 1
        l0 = int(seen.any(0).nonzero().max()) + 1
        require(torch.count_nonzero(got[0][k0:]) == 0
                and torch.count_nonzero(got[0][:, :, k0:]) == 0
                and torch.count_nonzero(got[4][:, 6 * k0:]) == 0
                and torch.count_nonzero(got[4][:, :, l0:]) == 0,
                f"{name}: padded rows or columns of S / W not zero")
    out = dict(
        name=name, K=K, L=L, padded=padded, rel_err_vs_plain=err,
        max_abs_err=float(torch.max(torch.abs(got[0] - want32[0]))),
        rel_err_vs_float64=dict(kernel=schur_errors(got, want64),
                                plain=schur_errors(want32, want64)),
        # partials are added in a fixed order: no run-to-run change
        same_bits_twice=all(torch.equal(a, b) for a, b in zip(got, again)))
    require(out["same_bits_twice"], f"{name}: two runs differ")
    # the kernel is no further from float64 than the plain float32 version:
    # S, rhs and W within twice the plain version's error, or within 1e-5
    # (a twentieth of SCHUR_TOL) where both are at float32's rounding level
    # and the order of the sums decides
    worse = {nm: (out["rel_err_vs_float64"]["kernel"][nm],
                  out["rel_err_vs_float64"]["plain"][nm]) for nm in ("S", "rhs", "W")
             if out["rel_err_vs_float64"]["kernel"][nm]
             > max(2 * out["rel_err_vs_float64"]["plain"][nm], 1e-5)}
    out["no_worse_than_plain_vs_float64"] = not worse
    require(not worse, f"{name} K={K} L={L}: further from float64 than the plain "
            f"version (kernel, plain): {worse}")
    if timed:
        # the whole function through the wrapper; the launch alone
        # (allocations + the three kernels); the device time of each kernel
        # and their sum from a trace
        out["ms"] = time_ms(lambda: fn(*args, lam, **kw), 50)
        launch = lambda: ba_kernel.launch_schur_system(  # noqa: E731
            *args, lam, (*p["intr"], 10.0), 1e-6, tiled=name == "schur_assemble_tiled")
        out["launch_only_ms"] = time_ms(launch, 50)
        by_kernel = traced_device_ms_by_kernel(launch, SCHUR_KERNELS)
        out["device_ms_by_kernel"] = by_kernel
        out["device_ms"] = (None if None in by_kernel.values()
                            else sum(by_kernel.values()))
        out["plain_ms"] = time_ms(lambda: plain(*args, lam, **kw), 3, 1)
        # torch.matmul of the same planes: the dense [6K, 3L] x [3L, 6K]
        # product the plain version forms, its operands laid out beforehand
        A = ba_kernel._c_planes(got[4], got[2]).permute(1, 0, 2).reshape(6 * K, -1)
        B = got[4].permute(1, 0, 2).reshape(6 * K, -1)
        out["product_matmul_ms"] = time_ms(lambda: torch.matmul(A, B.T), 20)
        out["product_matmul_flops"] = 2 * (6 * K) ** 2 * 3 * L
        counts = schur_counts(p["mask"], K, L)
        out.update(counts)
        out["bound_ms"], out["bound_by"] = bound(counts["bytes"], counts["flops"])
    return out


# the windows SLAMSystem assembles on the 208-frame loop: the 8-keyframe local
# BA (K4) and the incremental BA after a closure, bucketed to 64 keyframes
# (K5), both over the loop's 1024 landmarks
LOOP_BA_SHAPES = [("schur_assemble", 8, N_LANDMARKS),
                  ("schur_assemble_tiled", 64, N_LANDMARKS)]


def check_backend_kernels(device, timed: bool = True) -> list[dict]:
    """K4 and K5 at ragged shapes (one keyframe, 31 keyframes, 4097
    landmarks), at the widest windows of the map-optimisation path, at the
    windows of the whole system's loop and at a 64 x 1024 window padded as
    the loop pads its windows (``timed=False``: every shape checked, none
    timed)."""
    shapes = [("schur_assemble", 8, 640, False), ("schur_assemble", 5, 1000, False),
              ("schur_assemble", 1, 640, False), ("schur_assemble", 31, 4097, False),
              ("schur_assemble_tiled", 32, 4097, False),
              ("schur_assemble", 32, BA_LANDMARKS, True),
              ("schur_assemble_tiled", 64, BA_LANDMARKS, True),
              ("schur_assemble_tiled", 128, BA_LANDMARKS, True),
              *[(*shape, True) for shape in LOOP_BA_SHAPES]]
    rows = [check_schur_kernel(device, *s[:3], s[3] and timed) for s in shapes]
    rows.append(check_schur_kernel(device, "schur_assemble_tiled", 64, N_LANDMARKS,
                                   timed, padded=True))
    return rows


# ---------------------------------------------------------------------------
# the map-optimisation path
# ---------------------------------------------------------------------------

def ba_window_on_card(device, K: int):
    """The window of ``ba_problem(K, 4096, seed=3)`` on the card: ``(p, t,
    cam, run)``, where ``run(n)`` takes it through ``prepare_ba_window`` and
    ``n`` LM iterations of ``bundle_adjust``."""
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.solvers import ba, ba_prep

    cam = default_camera(BA_WIDTH, BA_HEIGHT, device=device)
    p = ba_problem(K, BA_LANDMARKS, seed=3)
    t = convert.ba_problem_from_numpy(
        dict(T_wc=p["T"], points_w=p["X0"], obs_uv=p["obs"], obs_mask=p["mask"],
             fix_mask=p["fix"]), device=device)

    def run(n_it):
        prep = ba_prep.prepare_ba_window(t["T_wc"], t["obs_uv"], t["obs_mask"],
                                         t["points_w"], cam, device=device)
        res = ba.bundle_adjust(
            t["T_wc"], prep.X0, t["obs_uv"], prep.mask, cam, t["fix_mask"],
            obs_w=prep.obs_w, max_iterations=n_it, min_rel_improvement=0.0,
            device=device)
        return prep, res

    return p, t, cam, run


def run_bundle_adjust(device, K: int, iterations: int) -> dict:
    """``prepare_ba_window`` -> ``bundle_adjust`` -> ``reprojection_stats``
    on the window of ``ba_problem(K, 4096, seed=3)``."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.solvers import ba

    name = "schur_assemble" if K <= ba.SCHUR_KERNEL_MAX_K else "schur_assemble_tiled"
    require(ba.schur_kernel_auto(K, torch.float32, device), f"K={K} takes no kernel")
    p, t, cam, run = ba_window_on_card(device, K)
    run(2)                                             # warm-up
    torch.cuda.synchronize()
    before = launch_counts()[name]
    t0 = time.perf_counter()
    prep, res = run(iterations)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()[name] - before
    its = int(res.iterations)
    err2, depth = ba.reprojection_stats(res.T_wc, res.points_w, t["obs_uv"],
                                        prep.mask, cam, device=device)

    chi0, chi1 = float(res.chi2_initial), float(res.chi2_final)
    require(its == iterations, f"K={K}: {its} LM iterations of {iterations}")
    require(launches == its, f"K={K}: {launches} launches of {name} in {its} iterations")
    require(np.isfinite(chi1) and chi1 < 0.2 * chi0, f"K={K}: chi2 {chi0} -> {chi1}")
    T_est = res.T_wc.cpu().numpy()
    pose_err = float(np.abs(T_est[:, :3, 3] - p["T"][:, :3, 3]).max())
    rot_err = float(np.abs(T_est[:, :3, :3] - p["T"][:, :3, :3]).max())
    seen = prep.mask.any(0).cpu().numpy()
    X_err = np.linalg.norm(res.points_w.cpu().numpy() - p["X_true"], axis=1)[seen]
    X0_err = np.linalg.norm(p["X0"] - p["X_true"], axis=1)[seen]
    require(pose_err < 0.05 and rot_err < 5e-3,
            f"K={K}: pose error {pose_err} m / {rot_err}")
    require(float(np.median(X_err)) < 0.5 * float(np.median(X0_err)),
            f"K={K}: median point error {np.median(X_err)} m")
    require(np.array_equal(T_est[0], p["T"][0]) or
            float(np.abs(T_est[0] - p["T"][0]).max()) < 1e-6, "gauge pose moved")
    require(bool(torch.isfinite(err2).all()), "reprojection_stats not finite")
    return dict(
        K=K, L=BA_LANDMARKS, kernel=name, iterations=its, launches=launches,
        launches_per_iteration=launches / its, seconds=seconds,
        lm_iterations_per_s=its / seconds, ms_per_iteration=1e3 * seconds / its,
        chi2_initial=chi0, chi2_final=chi1, n_obs=int(prep.n_obs),
        n_gated=int(prep.n_gated), n_reinit=int(prep.n_reinit),
        pose_err_m=pose_err, rot_err=rot_err,
        median_point_err_m=float(np.median(X_err)),
        median_point_err_before_m=float(np.median(X0_err)),
        median_reproj_err_px2=float(err2[torch.from_numpy(seen).to(device)].median()),
        min_depth_m=float(depth[torch.isfinite(depth)].min()))


def exp_se3_np(xi):
    """float64 SE(3) exponential of a twist ``[rho, phi]`` (numpy)."""
    import torch

    from svi_mapper_tpu_torch.geometry import se3

    return se3.exp_se3(torch.as_tensor(xi, dtype=torch.float64)).numpy()


def ring_graph(n: int, seed: int, noise: float = 0.004, overlap: int = 60):
    """A ring driven a little more than once, so that the last ``overlap``
    keyframes revisit the first: true poses, an odometry estimate that
    drifts, sequential edges measured on the estimate and one exact closure
    edge for every fifth revisiting keyframe (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    turn = 2 * np.pi / (n - overlap)
    d = exp_se3_np([0, 0, 0.8, 0, turn, 0])
    T_true = [np.eye(4)]
    for _ in range(1, n):
        T_true.append(d @ T_true[-1])
    T_true = np.stack(T_true)
    T_est = [T_true[0]]
    for k in range(1, n):
        M = T_true[k] @ np.linalg.inv(T_true[k - 1])
        T_est.append(exp_se3_np(rng.normal(0, noise, 6)) @ M @ T_est[-1])
    T_est = np.stack(T_est)
    ei, ej = list(range(n - 1)), list(range(1, n))
    Ms = [T_est[k] @ np.linalg.inv(T_est[k - 1]) for k in range(1, n)]
    for i in range(0, overlap, 5):
        j = n - overlap + i
        ei.append(i)
        ej.append(j)
        Ms.append(T_true[j] @ np.linalg.inv(T_true[i]))
    E = len(ei)
    edges = dict(i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
                 T_ij=np.stack(Ms).astype(np.float32),
                 weight=np.ones(E, np.float32), valid=np.ones(E, bool))
    fix = np.zeros(n, bool)
    fix[0] = True
    return T_true.astype(np.float32), T_est.astype(np.float32), edges, fix


def end_point_error(T_est, T_true) -> float:
    import numpy as np

    c = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    return float(np.linalg.norm(c(np.asarray(T_est[-1], np.float64))
                                - c(np.asarray(T_true[-1], np.float64))))


def run_pose_graph(device, n: int = 680) -> dict:
    import numpy as np
    import torch

    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.solvers import pose_graph

    T_true, T_est, edges_np, fix = ring_graph(n, seed=7)
    edges = convert.pose_graph_edges_from_numpy(edges_np, device=device)
    T0 = torch.from_numpy(T_est).to(device)
    fixm = torch.from_numpy(fix).to(device)
    pose_graph.optimize_pose_graph(T0, edges, fixm, max_iterations=2, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pose_graph.optimize_pose_graph(T0, edges, fixm, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    T_opt = res.T_wc.cpu().numpy()
    e0, e1 = end_point_error(T_est, T_true), end_point_error(T_opt, T_true)
    chi0, chi1 = float(res.chi2_initial), float(res.chi2_final)
    require(np.isfinite(T_opt).all() and T_opt.shape == (n, 4, 4), "pose graph output")
    require(chi1 < 0.01 * chi0, f"pose graph chi2 {chi0} -> {chi1}")
    # the closures tie the end of the ring to its first keyframes, whose own
    # heading drift stays (only keyframe 0 is fixed): the end point comes
    # back by about half, not to zero
    require(e1 < 0.7 * e0, f"pose graph end point {e0} -> {e1} m")
    require(float(np.abs(T_opt[0] - T_est[0]).max()) < 1e-6, "gauge pose moved")
    its = int(res.iterations)
    return dict(n=n, edges=int(edges.i.shape[0]), iterations=its, ms=1e3 * seconds,
                ms_per_iteration=1e3 * seconds / max(its, 1),
                chi2_initial=chi0, chi2_final=chi1,
                end_point_err_before_m=e0, end_point_err_after_m=e1,
                ate_rmse_before_m=ate_rmse(T_est, T_true),
                ate_rmse_after_m=ate_rmse(T_opt, T_true))


def run_icp(device, batch: int = 4, points: int = 256) -> dict:
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.solvers import icp

    rng = np.random.default_rng(11)
    p_ref = np.stack([rng.uniform(-15, 15, (batch, points)),
                      rng.uniform(-3, 3, (batch, points)),
                      rng.uniform(5, 60, (batch, points))], -1)
    T_true = np.stack([exp_se3_np(rng.normal(0, [0.5, 0.3, 0.8, 0.03, 0.06, 0.02]))
                       for _ in range(batch)])
    p_q = np.einsum("bij,bnj->bni", T_true[:, :3, :3], p_ref) + T_true[:, None, :3, 3]
    p_q += rng.normal(0, 0.02, p_q.shape)
    p_q[:, :40] += 30.0                                  # gross outliers
    valid = np.ones((batch, points), bool)
    valid[:, -16:] = False
    valid[3, 20:] = False                                # 20 points: under the gate
    to = lambda a, dt: torch.from_numpy(a.astype(dt)).to(device)  # noqa: E731
    args = (to(p_q, np.float32), to(p_ref, np.float32), to(valid, bool))
    icp.align_clouds_batch(*args, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp.align_clouds_batch(*args, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ok = res.ok.cpu().numpy()
    T = res.T_qr.cpu().numpy()
    err = float(np.abs(T[:3] - T_true[:3]).max())
    require(ok[:3].all() and not ok[3], f"ICP gates: {ok}")
    require(err < 0.05, f"ICP transform error {err}")
    # each candidate alone gives what it gives in the batch
    for b in range(batch):
        one = icp.align_clouds(args[0][b], args[1][b], args[2][b], device=device)
        require(int(one.iterations) == int(res.iterations[b]),
                f"ICP candidate {b}: iterations {int(one.iterations)} alone, "
                f"{int(res.iterations[b])} in the batch")
        require(float((one.T_qr - res.T_qr[b]).abs().max()) < 1e-4,
                f"ICP candidate {b}: batch and single differ")
    return dict(batch=batch, points=points, ms=1e3 * seconds,
                iterations=res.iterations.cpu().tolist(),
                inliers=res.inliers.cpu().tolist(), ok=ok.tolist(),
                max_transform_err=err)


def profile_bundle_adjust(device, K: int, unprofiled_ms_per_iteration: float,
                          iterations: int) -> dict:
    """``torch.profiler`` over the run that ``run_bundle_adjust`` timed (the
    same window, ``prepare_ba_window`` and ``iterations`` LM iterations): the
    time the card was busy per iteration, its idle share of an UNPROFILED
    iteration, the device time of the port's own kernels per launch, and
    the kernels that took most of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, _, _, run = ba_window_on_card(device, K)
    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, res = run(iterations)
        torch.cuda.synchronize()
    n = int(res.iterations)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "K": K, "iterations": n,
        "device_busy_ms_per_iteration": busy_ms / n,
        "device_idle_share": 1.0 - (busy_ms / n) / unprofiled_ms_per_iteration,
        "device_kernels_per_iteration": sum(r[2] for r in rows) / n,
        "port_kernels_device_ms": {
            name: next((r[1] / r[2] for r in rows if name in r[0]), None)
            for name in SCHUR_KERNELS},
        "top_kernels": [{"name": r[0][:80], "ms_per_iteration": r[1] / n,
                         "calls_per_iteration": r[2] / n} for r in rows[:12]],
    }


def run_map_optimisation(device, profile: bool = False) -> tuple[dict, dict]:
    reset_launch_counts()
    windows = [run_bundle_adjust(device, 32, 30), run_bundle_adjust(device, 64, 10),
               run_bundle_adjust(device, 128, 10)]
    graph = run_pose_graph(device)
    clouds = run_icp(device)
    counts = launch_counts()
    require(all(counts[k] > 0 for k in BACKEND_KERNELS), f"kernel not launched: {counts}")
    report = {"phase": "map_optimisation", "bundle_adjust": windows,
              "pose_graph": graph, "icp": clouds,
              "launches": {k: counts[k] for k in BACKEND_KERNELS}}
    if profile:                      # after the launch counts were read
        report["profile"] = [
            profile_bundle_adjust(device, w["K"], w["ms_per_iteration"], w["iterations"])
            for w in (windows[0], windows[2])]
    return report, counts


def check_backend_against_cpu(device) -> dict:
    """A small BA window (kernel K4 on the card, its plain version on the
    CPU, the same fixed number of LM iterations) and a small pose graph:
    the card against the port on the CPU."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.solvers import ba, pose_graph

    p = ba_problem(8, 256, seed=5)
    out = {}
    results = {}
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        cam = default_camera(BA_WIDTH, BA_HEIGHT, device=dev)
        t = convert.ba_problem_from_numpy(
            dict(T_wc=p["T"], points_w=p["X0"], obs_uv=p["obs"], obs_mask=p["mask"],
                 fix_mask=p["fix"]), device=dev)
        results[(str(dev), dtype)] = ba.bundle_adjust(
            t["T_wc"].to(dtype), t["points_w"].to(dtype), t["obs_uv"].to(dtype),
            t["obs_mask"], cam, t["fix_mask"], max_iterations=6,
            min_rel_improvement=0.0, use_schur_kernel=True, device=dev)
    a, b = results[(str(device), torch.float32)], results[("cpu", torch.float32)]
    ref = results[("cpu", torch.float64)]
    chi_rel = abs(float(a.chi2_final) - float(b.chi2_final)) / float(b.chi2_final)
    dT = float((a.T_wc.cpu() - b.T_wc).abs().max())
    dX = float((a.points_w.cpu() - b.points_w).abs().max())
    # a landmark 52 m deep is fixed to millimetres in depth: there float32
    # rounding alone moves it by more than 1e-3 m (the CPU's float32 run is
    # 5.6 mm from the float64 one), so the card's points are held within
    # 1e-3 m of the CPU's float32 run or of its float64 run
    dX64 = {"card": float((a.points_w.cpu().double() - ref.points_w).abs().max()),
            "cpu": float((b.points_w.double() - ref.points_w).abs().max())}
    require(chi_rel < 1e-3 and dT < 1e-4 and (dX < 1e-3 or dX64["card"] < 1e-3),
            f"BA card vs CPU: chi2 {chi_rel}, poses {dT}, points {dX}; points "
            f"against float64 {dX64}")
    out["bundle_adjust"] = {"chi2_final_rel_diff": chi_rel, "max_pose_diff": dT,
                            "max_point_diff_m": dX, "max_point_diff_vs_float64_m": dX64}

    T_true, T_est, edges_np, fix = ring_graph(60, seed=9, overlap=10)
    poses = {}
    for dev in (device, "cpu"):
        edges = convert.pose_graph_edges_from_numpy(edges_np, device=dev)
        poses[str(dev)] = pose_graph.optimize_pose_graph(
            torch.from_numpy(T_est).to(dev), edges, torch.from_numpy(fix).to(dev),
            device=dev)
    a, b = poses[str(device)], poses["cpu"]
    dT = float((a.T_wc.cpu() - b.T_wc).abs().max())
    require(int(a.iterations) == int(b.iterations) and dT < 1e-4,
            f"pose graph card vs CPU: poses {dT}, iterations "
            f"{int(a.iterations)} / {int(b.iterations)}")
    out["pose_graph"] = {"max_pose_diff": dT, "iterations": int(a.iterations),
                         "end_point_err_m": end_point_error(a.T_wc.cpu().numpy(), T_true)}
    return out


# ---------------------------------------------------------------------------
# the Hamming-matrix kernel (K6) against its plain version
# ---------------------------------------------------------------------------

def hamming_inputs(seed: int, N: int, M: int, device,
                   batch: int | tuple | None = None):
    """Packed descriptors made from a seed (int32 views of uint32 words),
    with planted rows in every batch entry: an equal pair (distance 0), a
    complement (256), all-zero against all-one words (256), and words with
    only the sign bit set against zeros (8)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lead = () if batch is None else batch if isinstance(batch, tuple) else (batch,)
    a = rng.integers(0, 2 ** 32, lead + (N, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, lead + (M, 8), dtype=np.uint64).astype(np.uint32)
    planted = min(N, M) >= 4
    if planted:
        b[..., 0, :] = a[..., 0, :]
        b[..., 1, :] = ~a[..., 1, :]
        a[..., 2, :] = 0
        b[..., 2, :] = 0xFFFFFFFF
        a[..., 3, :] = 0x80000000
        b[..., 3, :] = 0
    to = lambda x: torch.from_numpy(x.view(np.int32)).to(device)  # noqa: E731
    return to(a), to(b), planted


HAMMING_SHAPES = [(256, 4096, None), (37, 203, None), (1, 1, None), (300, 129, None),
                  (256, 4096, 8), (37, 203, 3), (37, 203, (2, 3))]


def traced_device_ms(fn, kernels: tuple, n: int = 50) -> float | None:
    """Device time per call of ``fn``, summed over the kernels whose names
    contain one of ``kernels``, from a ``torch.profiler`` trace of ``n``
    calls (None when the trace shows no device time for one of them)."""
    per_kernel = traced_device_ms_by_kernel(fn, kernels, n)
    return None if None in per_kernel.values() else sum(per_kernel.values())


def traced_device_ms_by_kernel(fn, kernels: tuple, n: int = 50) -> dict:
    """Device time per call of ``fn`` of each kernel whose name contains one
    of ``kernels``, from a ``torch.profiler`` trace of ``n`` calls (None
    for a kernel the trace does not show)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for k in kernels:
        hit = [e.device_time_total for e in rows if k in e.key]
        out[k] = sum(hit) / 1e3 / n if hit else None
    return out


def check_closure_kernel(device) -> list[dict]:
    """K6 at the shape ``_pool_nn_counts`` gives it (256 x 4096), ragged
    shapes and the batched form: exactly the plain version's matrix, written
    into a buffer pre-filled with -1 so that an entry the kernel skips shows."""
    import torch

    from svi_mapper_tpu_torch.ops import cuda_build, hamming

    lib = cuda_build.load_library()
    rows = []
    for N, M, B in HAMMING_SHAPES:
        a, b, planted = hamming_inputs(41 + N, N, M, device, B)
        shape = a.shape[:-2] + (N, M)
        out = torch.full(shape, -1, dtype=torch.int32, device=device)
        # the launch takes one batch axis; the wrapper flattens more to it
        hamming.launch_hamming_matrix(lib, a.reshape((-1,) + a.shape[-2:])
                                      if a.dim() > 3 else a,
                                      b.reshape((-1,) + b.shape[-2:])
                                      if b.dim() > 3 else b,
                                      out=out.view((-1, N, M)) if a.dim() > 3 else out)
        got = hamming.hamming_distance_matrix(a, b)
        torch.cuda.synchronize()
        want = hamming.hamming_packed(a, b)
        err = max(max_abs_err(out, want), max_abs_err(got, want))
        require(got.shape == shape and got.dtype == torch.int32, f"hamming_matrix {shape}")
        require(torch.equal(out, want) and torch.equal(got, want),
                f"hamming_matrix disagrees with hamming_packed at {shape}: off by {err}")
        if planted:
            diag = [int(want[..., i, i].reshape(-1)[0]) for i in range(4)]
            require(diag == [0, 256, 256, 8], f"planted rows give {diag}")
        row = dict(name="hamming_matrix", N=N, M=M, B=B, max_abs_err=err)
        if (N, M, B) == HAMMING_SHAPES[0]:
            row["ms"] = time_ms(lambda: hamming.hamming_distance_matrix(a, b), 200)
            row["launch_only_ms"] = time_ms(
                lambda: hamming.launch_hamming_matrix(lib, a, b, out=out), 200)
            row["plain_ms"] = time_ms(lambda: hamming.hamming_packed(a, b), 5, 1)
            # not a library call of the same function (PyTorch has no
            # popcount): the bit-matmul identity, unpack + one float32 matmul
            row["matmul_identity_ms"] = time_ms(lambda: hamming.hamming_mxu(a, b), 10, 2)
            # each descriptor read once, the matrix written once; xor +
            # popcount + add per word pair
            row["bytes"], row["operations"] = (N + M) * 32 + N * M * 4, N * M * 8 * 3
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["operations"])
        elif B == 8:
            row["ms"] = time_ms(lambda: hamming.hamming_distance_matrix(a, b), 50)
        if "ms" in row:
            row["device_ms"] = traced_device_ms(
                lambda: hamming.launch_hamming_matrix(lib, a, b, out=out),
                ("hamming_matrix_kernel",))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the closure query
# ---------------------------------------------------------------------------

CLOSURE_KEYFRAMES, CLOSURE_POOL, CLOSURE_TABLE = 680, 256, 1024
CLOSURE_QUERIES = list(range(672, 680))
# query keyframe -> the earlier keyframe it revisits / whose descriptors it
# repeats with scrambled points
CLOSURE_REVISITS = {672: 40, 673: 90, 675: 140, 677: 200, 679: 260}
CLOSURE_DECOYS = {674: 60, 678: 300}
T_QR_TOL = 0.05          # |T_qr - planted| per entry: 2 cm point noise, <= 20 iterations


def closure_keyframes(seed: int):
    """The keyframes of the closure database (numpy): 2 m apart along a
    straight drive, pools of 200..256 random descriptors, bit probabilities
    near the bits. A revisit repeats an earlier pool in another order with 8
    bits of every descriptor flipped and its points moved by a known
    transform plus 2 cm of noise, and sits that transform away from the
    earlier keyframe; a decoy repeats the descriptors with points scrambled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out, T_true = [], {}
    for k in range(CLOSURE_KEYFRAMES):
        n = int(rng.integers(200, CLOSURE_POOL + 1))
        desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
        p = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                      rng.uniform(5, 60, n)], -1)
        T = np.eye(4)
        T[0, 3] = -2.0 * k
        src = CLOSURE_REVISITS.get(k, CLOSURE_DECOYS.get(k))
        if src is not None:
            ref = out[src]
            desc, p, T = ref["desc"].copy(), ref["p_cam"].astype(np.float64), ref["T_wc"].copy()
            flips = rng.integers(0, 256, (len(desc), 8))
            for j in range(8):
                desc[np.arange(len(desc)), flips[:, j] // 32] ^= (
                    np.uint32(1) << (flips[:, j] % 32).astype(np.uint32))
        if k in CLOSURE_REVISITS:
            order = rng.permutation(len(desc))
            T_qr = exp_se3_np(rng.normal(0, [0.5, 0.2, 0.5, 0.01, 0.04, 0.01]))
            desc = desc[order]
            p = p[order] @ T_qr[:3, :3].T + T_qr[:3, 3] + rng.normal(0, 0.02, p.shape)
            T = T_qr @ T
            T_true[k] = T_qr
        elif k in CLOSURE_DECOYS:
            p = p[rng.permutation(len(p))] + rng.normal(0, 3.0, p.shape)
        bits = np.unpackbits(desc.view(np.uint8), axis=1, bitorder="little")
        jitter = rng.integers(0, 40, bits.shape)
        prob = np.where(bits == 1, 255 - jitter, jitter).astype(np.uint8)
        sel = np.sort(rng.choice(CLOSURE_TABLE, len(desc), replace=False))
        out.append(dict(desc=desc, p_cam=p.astype(np.float32),
                        T_wc=T.astype(np.float32), prob=prob, sel=sel))
    return out, T_true


def fill_closure_database(keyframes, device, chunk: int = 8):
    """The keyframes through ``KeyframeDatabase.add_many``, ``chunk`` at a
    time, each chunk with its ``[B, L, 256]`` probability plane on the
    device, as ``SLAMSystem`` adds a chunk's keyframes."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.mapping.closure import KeyframeDatabase

    db = KeyframeDatabase.create(512, CLOSURE_POOL, store_prob=True, device=device)
    for s in range(0, len(keyframes), chunk):
        part = keyframes[s:s + chunk]
        plane = np.zeros((len(part), CLOSURE_TABLE, 256), np.uint8)
        for b, kf in enumerate(part):
            plane[b, kf["sel"]] = kf["prob"]
        db.add_many([(kf["desc"], kf["p_cam"], kf["T_wc"], kf["sel"]) for kf in part],
                    torch.from_numpy(plane).to(device))
    return db


def count_host_syncs(fn) -> int:
    """Calls that wait for the card while ``fn`` runs (PyTorch's sync debug
    mode warns at each)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message).lower() for c in caught)


def run_closure_query(device) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.mapping import closure
    from svi_mapper_tpu_torch.models.slam import closure_kwargs

    keyframes, T_true = closure_keyframes(seed=13)
    kw = closure_kwargs(DEFAULT_PARAMS)      # as SLAMSystem queries
    t0 = time.perf_counter()
    db = fill_closure_database(keyframes, device)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    require(db.n == CLOSURE_KEYFRAMES and db.bow is not None and db.bow.n == db.n,
            "closure database: keyframes or vocabulary missing")
    require(db.prob.is_cuda and db.desc.is_cuda and db.bow.vectors.is_cuda,
            "closure database left the card")

    closure.find_closures_batch(db, CLOSURE_QUERIES, **kw)            # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    found = closure.find_closures_batch(db, CLOSURE_QUERIES, **kw)    # ends in a read
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    syncs = count_host_syncs(
        lambda: closure.find_closures_batch(db, CLOSURE_QUERIES, **kw))

    worst = 0.0
    for q, cands in zip(CLOSURE_QUERIES, found):
        refs = [c.ref_kf for c in cands]
        if q in CLOSURE_REVISITS:
            require(refs == [CLOSURE_REVISITS[q]], f"query {q}: found {refs}")
            err = float(np.abs(cands[0].T_qr - T_true[q]).max())
            worst = max(worst, err)
            require(err < T_QR_TOL, f"query {q}: T_qr off by {err}")
            require(cands[0].inliers >= 150, f"query {q}: {cands[0].inliers} inliers")
        else:
            require(refs == [], f"query {q} (decoy or plain): accepted {refs}")
    require(counts[CLOSURE_KERNEL] > 0, f"kernel not launched: {counts}")

    # the same database through the port on the CPU (plain versions)
    t0 = time.perf_counter()
    db_cpu = fill_closure_database(keyframes, "cpu")
    found_cpu = closure.find_closures_batch(db_cpu, CLOSURE_QUERIES, **kw)
    cpu_s = time.perf_counter() - t0
    worst_T = 0.0
    for q, a, b in zip(CLOSURE_QUERIES, found, found_cpu):
        require([(c.ref_kf, c.matches, c.inliers) for c in a]
                == [(c.ref_kf, c.matches, c.inliers) for c in b],
                f"query {q}: card and CPU disagree")
        for x, y in zip(a, b):
            require(np.array_equal(x.pairs, y.pairs), f"query {q}: pairs differ")
            worst_T = max(worst_T, float(np.abs(x.T_qr - y.T_qr).max()))
    require(worst_T < 1e-3, f"T_qr card vs CPU: {worst_T}")
    same_words = bool(torch.equal(db.desc.cpu(), db_cpu.desc)
                      and torch.equal(db.prob.cpu(), db_cpu.prob))
    require(same_words, "card and CPU databases differ")
    vec_diff = float((db.bow.vectors.cpu() - db_cpu.bow.vectors).abs().max())
    require(vec_diff < 1e-6, f"BoW vectors card vs CPU: {vec_diff}")

    report = {
        "phase": "closure_query", "keyframes": db.n, "pool": CLOSURE_POOL,
        "capacity": db.capacity, "queries": len(CLOSURE_QUERIES),
        "planted_revisits": len(CLOSURE_REVISITS), "decoys": len(CLOSURE_DECOYS),
        "found": {str(q): [c.ref_kf for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
        "matches": {str(q): [c.matches for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
        "inliers": {str(q): [c.inliers for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
        "max_T_qr_err": worst, "T_qr_tolerance": T_QR_TOL,
        "fill_seconds": fill_s, "ms_per_batch": 1e3 * seconds,
        "host_syncs_per_batch": syncs,
        "hamming_matrix_launches_per_batch": counts[CLOSURE_KERNEL],
        "gpu_vs_cpu": {"discrete_outputs_equal": True, "max_T_qr_diff": worst_T,
                       "max_bow_vector_diff": vec_diff, "cpu_seconds": cpu_s},
    }
    return report, counts


# ---------------------------------------------------------------------------
# the whole system on a loop
# ---------------------------------------------------------------------------

LOOP_FRAMES, LOOP_RADIUS, LOOP_CHUNK = 208, 26.0, 32
# bounds on the closed loop (188 m driven), against the exact ground truth.
# ATE is the JAX package's own measure (eval.trajectory: RMSE of the camera
# centres after rigid alignment): the optimised trajectory no worse than the
# trajectory the same run recorded frame by frame, and under 0.5 m. Each
# accepted closure's measured transform lies within 0.5 m of the true one.
LOOP_ATE_BOUND_M = 0.5
LOOP_CLOSURE_ERR_M = 0.5
# what the JAX package's record of the same loop shows (BENCH_r05.json):
# behaviour to compare, no time taken from that file
LOOP_JAX_RECORD = {"keyframes": 49, "closures_accepted": 2, "closures_deduped": 15,
                   "ba_runs": 5}
LOOP_SYNC_CHUNKS = 2         # chunks of the run whose host reads are counted


def run_slam_loop(device, schur_kernels: bool = True) -> tuple[dict, dict]:
    """The whole system on the loop, once. The report's ``ba_windows`` names
    the kernel, K and L of every BA window the run assembled. With
    ``schur_kernels=False`` every BA window takes the materialised route
    (``solvers.ba``, ``use_schur_kernel=False``) instead of K4 / K5: a
    second witness of the loop's accuracy (``mutation_check.py
    --loop-routes``), not part of the smoke run."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.solvers import ba

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=N_LANDMARKS, max_detections=N_LANDMARKS,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5)
    seq = synthetic.SyntheticSequence(
        n_frames=LOOP_FRAMES, width=W_RAW, height=H, trajectory="loop",
        loop_radius=LOOP_RADIUS, device=device)
    t0 = time.perf_counter()
    imgs_l = torch.empty((LOOP_FRAMES, H, W_RAW), dtype=torch.float32, device=device)
    imgs_r = torch.empty_like(imgs_l)
    for i in range(LOOP_FRAMES):
        imgs_l[i], imgs_r[i], _ = seq.frame(i)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0

    windows = []

    class Recording(SLAMSystem):
        """Notes the kernel, K and L of every BA window the run assembles,
        and the launch counts at that moment."""

        def _assemble_ba_window(self, kfs, K=None):
            asm = super()._assemble_ba_window(kfs, K)
            if asm is not None:
                K_w, L_w = int(asm[1].shape[0]), int(asm[1].shape[1])
                name = ("schur_assemble" if K_w <= ba.SCHUR_KERNEL_MAX_K
                        else "schur_assemble_tiled")
                windows.append((name, K_w, L_w, launch_counts()[name]))
            return asm

    slam = Recording(seq.cam, params, device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    # one run; PyTorch's sync debug mode is on during its first chunks, which
    # counts the host reads there (a warning each, recorded, not printed)
    n_sync = LOOP_SYNC_CHUNKS * LOOP_CHUNK
    outs = []
    route = (contextlib.nullcontext() if schur_kernels else
             mock.patch.object(ba, "schur_kernel_auto", lambda *a, **k: False))
    with route, TrackInputs(sample=LOOP_FRAMES // 2) as k1_inputs:
        syncs = count_host_syncs(lambda: outs.extend(slam.process_many(
            imgs_l[:n_sync], imgs_r[:n_sync], chunk=LOOP_CHUNK)))
        outs.extend(slam.process_many(imgs_l[n_sync:], imgs_r[n_sync:], chunk=LOOP_CHUNK))
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    opt = slam.optimized_trajectory()
    raw = slam.trajectory_array

    # launches per window shape: the count at the next window (or at the end)
    # less the count at this one
    by_shape = {}
    for i, (name, K_w, L_w, at) in enumerate(windows):
        later = [w[3] for w in windows[i + 1:] if w[0] == name]
        row = by_shape.setdefault((name, K_w, L_w), {"windows": 0, "launches": 0})
        row["windows"] += 1
        row["launches"] += (later[0] if later else counts[name]) - at

    # the loop is driven in the corridor world, as the JAX package's bench
    # drives it, and passes through the plane of the wall at x = 9 m three
    # times: there the view changes within one frame and the pose solve
    # refuses the frame before the crossing and the one at it (the tracker
    # carries on by its motion model). The JAX package refuses the same
    # frames (tests/test_torch_loop_refusals.py). Everywhere else the solve
    # must accept.
    centres = -np.einsum("nji,nj->ni", seq.poses_wc[:, :3, :3], seq.poses_wc[:, :3, 3])
    side = centres[:, 0] > 9.0
    crossings = [i for i in range(1, LOOP_FRAMES) if side[i] != side[i - 1]]
    at_wall = {i + d for i in crossings for d in (-1, 0, 1)}
    rejected = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]
    n_kf = len(slam.slam_keyframes)
    st = slam.stats
    ate_rec, ate_opt = ate_rmse_aligned(raw, seq.poses_wc), ate_rmse_aligned(opt, seq.poses_wc)
    # anchored at the first pose, no alignment: printed with its verdict, not
    # required (the loop's drift is largest on its far side and the closure
    # acts where the loop ends, so this figure barely moves)
    anchored_rec, anchored_opt = ate_rmse(raw, seq.poses_wc), ate_rmse(opt, seq.poses_wc)
    on_path = (FRONTEND_KERNELS + (("schur_assemble",) if schur_kernels else ())
               + (CLOSURE_KERNEL,))
    k5_ran = counts["schur_assemble_tiled"] > 0

    # are the closed loops true loops: the measured transform of each
    # accepted closure against the ground truth between its two keyframes
    closure_err = []
    for c in slam.accepted_closures:
        f_r = slam.slam_keyframes[c.ref_kf].frame_idx
        f_q = slam.slam_keyframes[c.query_kf].frame_idx
        T_true = (seq.poses_wc[f_q].astype(np.float64)
                  @ np.linalg.inv(seq.poses_wc[f_r].astype(np.float64)))
        D = np.asarray(c.T_qr, np.float64) @ np.linalg.inv(T_true)
        closure_err.append(float(np.linalg.norm(D[:3, 3])))

    tm = slam.timings
    report = {
        "phase": "slam_loop", "frames": LOOP_FRAMES, "image": [H, W_RAW],
        "landmarks": N_LANDMARKS, "chunk": LOOP_CHUNK, "radius_m": LOOP_RADIUS,
        "render_seconds": render_s, "seconds": seconds,
        "frames_per_s": LOOP_FRAMES / seconds,
        "keyframes": n_kf,
        "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
        "jax_package_record": LOOP_JAX_RECORD,
        "ba_windows": [{"kernel": name, "K": K_w, "L": L_w, **row}
                       for (name, K_w, L_w), row in sorted(by_shape.items())],
        "schur_kernels": schur_kernels, "k5_on_this_path": k5_ran,
        "ate_recorded_m": ate_rec, "ate_optimised_m": ate_opt,
        "ate_bound_m": LOOP_ATE_BOUND_M,
        "ate_anchored_recorded_m": anchored_rec, "ate_anchored_optimised_m": anchored_opt,
        "anchored_optimised_no_worse_than_recorded":
            "passed" if anchored_opt <= anchored_rec else "failed",
        "closure_transform_err_m": closure_err,
        "n_tracked_min": min(int(o.n_tracked) for o in outs[1:]),
        "wall_crossings_at_frames": crossings, "posit_rejected_at_frames": rejected,
        "timings_s": {k: float(v) for k, v in tm.items()},
        "tail_ms_per_keyframe": {
            k: 1e3 * tm.get(k, 0.0) / n_kf
            for k in ("kf_db_add", "kf_closure", "kf_backend", "kf_ba", "kf_pose_graph",
                      "kf_total")},
        "launches": counts,
        "host_syncs_counted_over_chunks": LOOP_SYNC_CHUNKS,
        "host_syncs_per_chunk": syncs / LOOP_SYNC_CHUNKS,
        "host_syncs_per_frame_in_chunks": syncs / n_sync,
        # K1 on the bands this run built
        "track_scores_on_path": k1_inputs.report(),
    }
    emit(report)             # before the checks: a failing run shows its numbers

    bad = [i for i in rejected if i not in at_wall]
    require(len(outs) == LOOP_FRAMES and not bad,
            f"pose solve rejected on frames {bad} (wall crossings at {crossings})")
    require(n_kf >= 20, f"{n_kf} keyframes")
    require(st["closures_accepted"] >= 1 and st["pose_graph_runs"] >= 1
            and st["ba_runs"] >= 1, f"the loop was not closed: {st}")
    require(all(np.isfinite(kf.T_wc).all() for kf in slam.slam_keyframes),
            "NaN in a keyframe pose")
    for c in slam.accepted_closures:
        require(c.ref_kf < c.query_kf - params.closure_exclude_recent,
                f"closure {c.ref_kf} -> {c.query_kf} inside the exclusion")
    require(np.isfinite(opt).all() and ate_opt <= ate_rec and ate_opt < LOOP_ATE_BOUND_M,
            f"ATE: recorded {ate_rec} m, optimised {ate_opt} m")
    require(max(closure_err) < LOOP_CLOSURE_ERR_M,
            f"accepted closures off by {closure_err} m from the ground truth")
    require(all(counts[k] > 0 for k in on_path), f"kernel not launched: {counts}")
    require(k5_ran == (schur_kernels and any(name == "schur_assemble_tiled"
                                             for name, _, _ in by_shape)),
            f"K5 launches {counts['schur_assemble_tiled']} against windows {windows}")
    require(slam.db.n == n_kf and slam.db.desc.is_cuda and slam.db.prob.is_cuda,
            "closure database left the card")
    return report, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    import svi_mapper_tpu_torch  # noqa: F401  (fails outside the repository)
    from svi_mapper_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    cuda_build.load_library()
    emit({"phase": "build", "seconds": cuda_build.build_seconds,
          "sources": [p.name for p in cuda_build.sources()]})

    # 3. kernels against their plain versions: a ragged small shape, then
    #    the main path's shapes with timings
    small = check_kernels(device, h=75, w_raw=203, n=37, max_disparity=48, timed=False)
    emit({"phase": "kernels_small", "shape": [75, 203],
          "max_abs_err": {k["name"]: k["max_abs_err"] for k in small},
          "track_scores_planted": small[1]["planted"]})
    narrow = check_kernels(device, h=64, w_raw=96, n=16, max_disparity=128, timed=False)
    emit({"phase": "kernels_narrow", "shape": [64, 96],
          "max_abs_err": {k["name"]: k["max_abs_err"] for k in narrow}})
    full = check_kernels(device, h=H, w_raw=W_RAW, n=N_LANDMARKS,
                         max_disparity=MAX_DISPARITY, timed=True)
    emit({"phase": "kernels_full", "shape": [H, W_RAW],
          "max_abs_err": {k["name"]: k["max_abs_err"] for k in full},
          "track_scores_planted": full[1]["planted"],
          "build": {"brief_dense.cu": ptxas_report("brief_dense.cu", "kernel"),
                    "track_scores.cu": ptxas_report("track_scores.cu", "kernel")},
          "sass_shared_loads": {"brief_dense_kernel": sass_count("brief_dense_kernel", "LDS")},
          # modelled, not measured: the loads or popcounts the design issues
          # and the time they take at one issue rate per SM and clock
          "design": {k["name"]: k["design"] for k in full if "design" in k}})

    backend = check_backend_kernels(device)
    schur_build = ptxas_report("schur_assemble.cu", "kernel")
    emit({"phase": "kernels_backend", "tolerance": SCHUR_TOL, "shapes": backend,
          "build": schur_build})
    require(not schur_build or all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                   for r in schur_build),
            f"a kernel of schur_assemble.cu spills: {schur_build}")

    closure_rows = check_closure_kernel(device)
    emit({"phase": "kernels_closure", "shapes": closure_rows,
          "build": ptxas_report("hamming_matrix.cu", "kernel")})

    # 4. the card against the CPU on a small sequence, a small BA window and
    #    a small pose graph (the closure query holds its own comparison)
    emit({"phase": "gpu_vs_cpu", **check_against_cpu(device),
          **check_backend_against_cpu(device)})

    # 5. the main paths, each with the launch counts set to 0 just before it
    #    and read just after
    profile = "--profile" in sys.argv[1:]
    report, counts = run_main_path(device, profile=profile)
    emit(report)
    report, backend_counts = run_map_optimisation(device, profile=profile)
    emit(report)
    report, query_counts = run_closure_query(device)
    emit(report)
    loop, loop_counts = run_slam_loop(device)     # emits its own line
    # every BA window of the loop has a shape at which K4 / K5 were held
    # against their plain versions: the two expected ones in the kernel
    # phase above, any other one now
    at_shape = {(k["name"], k["K"], k["L"]): k for k in backend
                if "ms" in k and not k["padded"]}
    late = [(w["kernel"], w["K"], w["L"]) for w in loop["ba_windows"]
            if (w["kernel"], w["K"], w["L"]) not in at_shape]
    for shape in late:
        at_shape[shape] = check_schur_kernel(device, *shape, timed=True)
    emit({"phase": "kernels_backend_loop_shapes",
          "checked_in_kernel_phase": [list(s) for s in LOOP_BA_SHAPES],
          "checked_after_the_loop": [at_shape[shape] for shape in late]})
    # launches of each kernel on the path that is its own: the front-end, the
    # map optimisation on generated windows, and the whole system's loop (the
    # closure kernel's; the loop's counts of all six go along)
    counts = {**{k: counts[k] for k in FRONTEND_KERNELS},
              **{k: backend_counts[k] for k in BACKEND_KERNELS},
              CLOSURE_KERNEL: loop_counts[CLOSURE_KERNEL]}

    # the kernels line: each kernel at the largest shape its main path gives
    # it; K4 and K5 also at each window shape of the loop (the front-end
    # kernels and K6 have the same shapes there)
    at_width = {"schur_assemble": at_shape[("schur_assemble", 32, BA_LANDMARKS)],
                "schur_assemble_tiled": at_shape[("schur_assemble_tiled", 128, BA_LANDMARKS)],
                CLOSURE_KERNEL: closure_rows[0]}
    timed_keys = ("ms", "launch_only_ms", "device_ms", "device_ms_by_kernel", "plain_ms",
                  "bound_ms", "bound_by", "max_abs_err", "rel_err_vs_plain", "bytes",
                  "flops", "product_flops_upper", "product_matmul_ms")
    kernels = []
    for k in full + [at_width[n] for n in BACKEND_KERNELS + (CLOSURE_KERNEL,)]:
        row = {
            "name": k["name"], **KERNEL_FACTS[k["name"]],
            "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes any of the six functions
            "library_ms": None,
            "launches_slam_loop": loop_counts[k["name"]],
            "launches_closure_query": query_counts[k["name"]],
        }
        for extra in ("launch_only_ms", "rel_err_vs_plain", "K", "L", "flops",
                      "product_flops_upper",
                      "device_ms_by_kernel", "product_matmul_ms", "N", "M",
                      "matmul_identity_ms", "bytes", "operations", "device_ms",
                      "pixels_scored_per_landmark"):
            if extra in k:
                row[extra] = k[extra]
        if k["name"] == "track_scores":
            # the same count on the bands the whole system's loop built
            row["pixels_scored_per_landmark_slam_loop"] = \
                loop["track_scores_on_path"]["pixels_scored_per_landmark"]
        if k["name"] in BACKEND_KERNELS:
            row["at_slam_loop"] = [
                {"K": w["K"], "L": w["L"], "windows": w["windows"],
                 "launches": w["launches"],
                 **{key: at_shape[(w["kernel"], w["K"], w["L"])][key]
                    for key in timed_keys
                    if key in at_shape[(w["kernel"], w["K"], w["L"])]}}
                for w in loop["ba_windows"] if w["kernel"] == k["name"]]
        kernels.append(row)
    print(smi, flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
