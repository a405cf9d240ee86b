#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a ``torch.profiler`` breakdown of four warm frames to the
main-path line and of ten LM iterations to the map-optimisation line.) Needs one CUDA card, ``nvcc`` and nothing from the network. It

1. names the card (``nvidia-smi`` name and power limit);
2. builds the hand-written CUDA kernels from ``svi_mapper_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card and
   times kernel and plain version with CUDA events: the front-end kernels
   at the shapes of the main path (376x1248 field, 1024 landmarks /
   keypoints, 128 disparities) and at two ragged small shapes, exact
   equality; the two Schur-assembly kernels at (K, L) = (8, 640),
   (32, 4096), (5, 1000) and (64, 4096), (128, 4096), within the stated
   relative tolerances, and both against the plain version in float64;
4. compares the port on the card with the port on the CPU (plain versions)
   on a short small sequence, SV and GT mode, and on a small BA window and
   pose graph;
5. drives the main paths. The front-end: the KITTI-00 calibration at
   376x1241 with ``DEFAULT_PARAMS``, 24 frames through
   ``StereoTracker.process`` and 16 through ``process_many(chunk=8)``,
   frames rendered on the card by the port's corridor renderer; checks pose
   acceptance, track counts, the trajectory error against the exact ground
   truth. The map optimisation: ``prepare_ba_window`` -> ``bundle_adjust``
   at 32 / 64 / 128 keyframes x 4096 landmarks, ``optimize_pose_graph`` at
   680 keyframes, ``align_clouds_batch`` at 4 x 256; checks that chi^2
   falls and the errors against the generating truth. Each path must have
   launched its kernels.

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


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(seed: int, h: int, w_raw: int, n: int, device):
    """Images and per-landmark inputs made from a seed, at a given shape:
    a rendered stereo pair, predictions (some on the border, some
    non-finite), descriptors sampled near the predictions so that matches
    exist, and random oriented bands."""
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
    theta = rng.uniform(0, 2 * np.pi, n)
    band = (np.round(np.cos(theta) * 256), np.round(np.sin(theta) * 256),
            rng.integers(-800, 800, n), rng.integers(1, tk.REACH_X + 1, n),
            rng.integers(1, tk.REACH_Y + 1, n))
    offs = rng.integers(-6, 7, (n, 2)).astype(np.float32)
    to = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(device)  # noqa: E731
    return dict(
        img_l=img_l, img_r=img_r, uv=to(uv, np.float32),
        uv_near=to(np.nan_to_num(uv, nan=0.0, posinf=0.0, neginf=0.0) + offs, np.float32),
        band=tuple(to(b, np.int32) for b in band),
        flip=to(rng.integers(0, 2 ** 31, (n, 8)) * (rng.random((n, 8)) < 0.05), np.int32),
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
        k3["plain_ms"] = time_ms(lambda: descriptors.smooth_brief_dense_plain(img_l), 3, 1)
        k3["bound_ms"], k3["bound_by"] = bound(px * 4 + px * 32 + 256 * 16,
                                               px * (256 + 20))
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
    k1 = dict(name="track_scores", max_abs_err=err1, accepted=n_accept)
    if timed:
        _, _, x0, y0 = track_kernel.window_origin(inp["uv"], h, wp)
        rows = torch.arange(track_kernel.WIN_H, device=device)
        cols = torch.arange(track_kernel.WIN_W, device=device)
        ys = (y0[:, None, None] + rows[None, :, None]).expand(-1, -1, track_kernel.WIN_W)
        xs = (x0[:, None, None] + cols[None, None, :]).expand(-1, track_kernel.WIN_H, -1)
        touched = unique_pixels(h, wp, ys, xs)
        win = track_kernel.WIN_H * track_kernel.WIN_W
        k1["ms"] = time_ms(lambda: track_kernel.track_scores(*args, **cuts), 50)
        # the launch alone, without the wrapper's small PyTorch launches
        origin = [t.contiguous() for t in track_kernel.window_origin(inp["uv"], h, wp)]
        k1["launch_only_ms"] = time_ms(lambda: track_kernel.launch_track_scores(
            cuda_build.load_library(), field_l, origin, inp["band"], desc_last,
            desc_ref, 25, 50, 50), 50)
        k1["plain_ms"] = time_ms(lambda: track_kernel.window_scores(*args, **cuts), 3, 1)
        # field pixels touched, 9 ints + 2 floats + 2 descriptors in and
        # 4 ints out per landmark; 16 xor + 16 popcount + 14 add + ~20 for
        # the tiers and the key per window pixel
        k1["bound_ms"], k1["bound_by"] = bound(
            touched * 32 + n * (5 * 4 + 2 * 4 + 2 * 32 + 4 * 4), n * win * 66)
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
        k2["launch_only_ms"] = time_ms(lambda: stereo_kernel.launch_stereo_profiles(
            cuda_build.load_library(), field_r, v_r, x0p, desc_k, De), 50)
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
    landmark's outcome."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.ops import track_kernel as tk

    rng = np.random.default_rng(29)
    gen = torch.Generator(device=device).manual_seed(29)
    field = torch.randint(-2 ** 31, 2 ** 31, (h, w, 8), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    uv = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
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
    to = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt)).to(device)  # noqa: E731
    desc = field[to(ty, np.int64), to(tx, np.int64)]
    # Hamming distances of the candidate to the last / anchor descriptor, at
    # and just over the cutoffs (25 for stage 1, 50 for stages 2-3 and the
    # anchor gate)
    d_last = np.array([3, 25, 26, 50, 51])[(np.arange(n) // 15) % 5]
    d_ref = np.array([0, 50, 51])[(np.arange(n) // 75) % 3]

    def low_bits(counts):
        """[n, 8] int32 words with the lowest ``counts[i]`` bits set."""
        bit = np.arange(256)[None, :] < counts[:, None]
        w32 = (bit.reshape(n, 8, 32) * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
        return to(w32.astype(np.uint32).view(np.int32), np.int32)

    args = (field, to(uv, np.float32), desc ^ low_bits(d_last),
            desc ^ low_bits(d_ref),
            tuple(to(b, np.int32) for b in (nxq, nyq, c0q, ru, rv)))
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
    far = ~near
    return {"landmarks": n, "accepted": int(accepted.sum()),
            "decided_by_stage3": int((accepted & far).sum()),
            "rejected_at_band_edge": int((far & in_reach & ~on_band).sum()),
            "rejected_at_reach": int((far & on_band & ~in_reach).sum()),
            "rejected_at_cutoff": int(((d_ref > 50) | (d_last > 50)).sum())}


FRONTEND_KERNELS = ("track_scores", "stereo_profiles", "brief_dense_fused")
BACKEND_KERNELS = ("schur_assemble", "schur_assemble_tiled")

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
}


def launch_counts() -> dict:
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        stereo_kernel,
        track_kernel,
    )

    return {"track_scores": track_kernel.track_scores_launches,
            "stereo_profiles": stereo_kernel.stereo_profiles_launches,
            "brief_dense_fused": descriptors.brief_dense_fused_launches,
            "schur_assemble": ba_kernel.schur_assemble_launches,
            "schur_assemble_tiled": ba_kernel.schur_assemble_tiled_launches}


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        stereo_kernel,
        track_kernel,
    )

    track_kernel.track_scores_launches = 0
    stereo_kernel.stereo_profiles_launches = 0
    descriptors.brief_dense_fused_launches = 0
    ba_kernel.schur_assemble_launches = 0
    ba_kernel.schur_assemble_tiled_launches = 0


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

    n_single, n_chunked, chunk, warm_from = 24, 16, 8, 4
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


def check_schur_kernel(device, name: str, K: int, L: int, timed: bool) -> dict:
    import torch

    from svi_mapper_tpu_torch.ops import ba_kernel

    fn, plain = {
        "schur_assemble": (ba_kernel.schur_assemble, ba_kernel.schur_assemble_plain),
        "schur_assemble_tiled": (ba_kernel.schur_assemble_tiled,
                                 ba_kernel.schur_assemble_tiled_plain),
    }[name]
    p = ba_problem(K, L, seed=23 + K, noise=1.5, point_noise=0.1, hard=True)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (to(p["T"]), to(p["X0"]), to(p["obs"]), to(p["mask"].astype("float32")))
    kw = dict(zip(("fx", "fy", "cx", "cy", "bq"), p["intr"]))
    lam = 1e-3
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
    require(not bad, f"{name} K={K} L={L}: off by {bad}")
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
    out = dict(
        name=name, K=K, L=L, rel_err_vs_plain=err,
        max_abs_err=float(torch.max(torch.abs(got[0] - want32[0]))),
        rel_err_vs_float64=dict(kernel=schur_errors(got, want64),
                                plain=schur_errors(want32, want64)),
        # per-block partials are added in a fixed order: no run-to-run change
        same_bits_twice=all(torch.equal(a, b) for a, b in zip(got, again)))
    require(out["same_bits_twice"], f"{name}: two runs differ")
    if timed:
        out["ms"] = time_ms(lambda: fn(*args, lam, **kw), 50)
        # the launch alone (allocations + the kernel), without the PyTorch
        # work the wrapper does behind it
        cam_scalars = (*p["intr"], 10.0)
        if name == "schur_assemble":
            out["launch_only_ms"] = time_ms(lambda: ba_kernel.launch_schur_assemble(
                *args, lam, cam_scalars, 1e-6), 50)
        else:
            out["launch_only_ms"] = time_ms(
                lambda: ba_kernel.launch_schur_assemble_tiled(*args, cam_scalars), 50)
        out["plain_ms"] = time_ms(lambda: plain(*args, lam, **kw), 3, 1)
        obs_flops = K * L * FLOPS_PER_OBSERVATION
        moved_in = 4 * (16 * K + 3 * L + 5 * K * L)
        w_planes = 4 * 18 * K * L
        if name == "schur_assemble":
            # out: S, rhs, Hll_inv, b_l, W; the C planes and the product run
            # in the kernel. W Hll^-1 W^T is symmetric: what the function
            # needs is its upper triangle of 6x6 blocks, K (K + 1) / 2 of
            # them. The kernel forms all K^2 (flops_executed).
            moved = moved_in + 4 * (36 * K * K + 6 * K + 12 * L) + w_planes
            c_planes = 15 * 6 * K * L
            flops = obs_flops + c_planes + 2 * 36 * (K * (K + 1) // 2) * 3 * L
            out["flops_executed"] = obs_flops + c_planes + 2 * (6 * K) ** 2 * 3 * L
        else:
            # the kernel's own outputs: per-tile partial H_ll/b_l, H_pp, b_p, W
            moved = moved_in + 4 * (9 * L * (K // 32) + 42 * K) + w_planes
            flops = obs_flops
            C = ba_kernel._c_planes(got[4], got[2])
            H_pp = torch.zeros((K, 6, 6), device=device)
            out["product_matmul_ms"] = time_ms(
                lambda: ba_kernel._schur_from_planes(H_pp, C, got[4]), 20)
            out["product_flops"] = 2 * (6 * K) ** 2 * 3 * L
        out["bytes"], out["flops"] = moved, flops
        out["bound_ms"], out["bound_by"] = bound(moved, flops)
    return out


def check_backend_kernels(device) -> list[dict]:
    shapes = [("schur_assemble", 8, 640, False), ("schur_assemble", 5, 1000, False),
              ("schur_assemble", 32, BA_LANDMARKS, True),
              ("schur_assemble_tiled", 64, BA_LANDMARKS, True),
              ("schur_assemble_tiled", 128, BA_LANDMARKS, True)]
    return [check_schur_kernel(device, *s) for s in shapes]


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
            for name in ("schur_assemble_kernel", "schur_reduce_kernel",
                         "schur_tile_kernel", "tile_reduce_kernel")},
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
    for dev in (device, "cpu"):
        cam = default_camera(BA_WIDTH, BA_HEIGHT, device=dev)
        t = convert.ba_problem_from_numpy(
            dict(T_wc=p["T"], points_w=p["X0"], obs_uv=p["obs"], obs_mask=p["mask"],
                 fix_mask=p["fix"]), device=dev)
        results[str(dev)] = ba.bundle_adjust(
            t["T_wc"], t["points_w"], t["obs_uv"], t["obs_mask"], cam, t["fix_mask"],
            max_iterations=6, min_rel_improvement=0.0, use_schur_kernel=True,
            device=dev)
    a, b = results[str(device)], results["cpu"]
    chi_rel = abs(float(a.chi2_final) - float(b.chi2_final)) / float(b.chi2_final)
    dT = float((a.T_wc.cpu() - b.T_wc).abs().max())
    dX = float((a.points_w.cpu() - b.points_w).abs().max())
    require(chi_rel < 1e-3 and dT < 1e-4 and dX < 1e-3,
            f"BA card vs CPU: chi2 {chi_rel}, poses {dT}, points {dX}")
    out["bundle_adjust"] = {"chi2_final_rel_diff": chi_rel, "max_pose_diff": dT,
                            "max_point_diff_m": dX}

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
          "track_scores_planted": full[1]["planted"]})

    backend = check_backend_kernels(device)
    emit({"phase": "kernels_backend", "tolerance": SCHUR_TOL, "shapes": backend,
          "build": ptxas_report("schur_assemble.cu", "kernel")})

    # 4. the card against the CPU on a small sequence, a small BA window and
    #    a small pose graph
    emit({"phase": "gpu_vs_cpu", **check_against_cpu(device),
          **check_backend_against_cpu(device)})

    # 5. the main paths, each with the launch counts set to 0 just before it
    #    and read just after
    profile = "--profile" in sys.argv[1:]
    report, counts = run_main_path(device, profile=profile)
    emit(report)
    report, backend_counts = run_map_optimisation(device, profile=profile)
    emit(report)
    counts = {**{k: counts[k] for k in FRONTEND_KERNELS},
              **{k: backend_counts[k] for k in BACKEND_KERNELS}}

    # the kernels line: each kernel at the largest shape its main path gives it
    at_width = {"schur_assemble": backend[2], "schur_assemble_tiled": backend[4]}
    kernels = []
    for k in full + [at_width[n] for n in BACKEND_KERNELS]:
        row = {
            "name": k["name"], **KERNEL_FACTS[k["name"]],
            "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes any of the five functions
            "library_ms": None,
        }
        for extra in ("launch_only_ms", "rel_err_vs_plain", "K", "L", "flops",
                      "flops_executed", "product_matmul_ms"):
            if extra in k:
                row[extra] = k[extra]
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
