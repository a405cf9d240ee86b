#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

(``--profile`` adds a ``torch.profiler`` breakdown of four warm frames to the
main-path line.) Needs one CUDA card, ``nvcc`` and nothing from the network. It

1. names the card (``nvidia-smi`` name and power limit);
2. builds the hand-written CUDA kernels from ``svi_mapper_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (376x1248 field, 1024 landmarks / keypoints,
   128 disparities) and at one ragged small shape — exact equality — and
   times kernel and plain version with CUDA events;
4. compares the port on the card with the port on the CPU (plain versions)
   on a short small sequence, SV and GT mode;
5. drives the main path: the KITTI-00 calibration at 376x1241 with
   ``DEFAULT_PARAMS``, 24 frames through ``StereoTracker.process`` and 16
   through ``process_many(chunk=8)``, frames rendered on the card by the
   port's corridor renderer, and checks pose acceptance, track counts, the
   trajectory error against the exact ground truth, and that every kernel
   was launched by that run.

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
}


def launch_counts() -> dict:
    from svi_mapper_tpu_torch.ops import descriptors, stereo_kernel, track_kernel

    return {"track_scores": track_kernel.track_scores_launches,
            "stereo_profiles": stereo_kernel.stereo_profiles_launches,
            "brief_dense_fused": descriptors.brief_dense_fused_launches}


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import descriptors, stereo_kernel, track_kernel

    track_kernel.track_scores_launches = 0
    stereo_kernel.stereo_profiles_launches = 0
    descriptors.brief_dense_fused_launches = 0


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
    require(all(c > 0 for c in counts.values()), f"kernel not launched: {counts}")
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
        "launches_per_frame": {k: v / n for k, v in counts.items()},
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

    # 4. the card against the CPU on a small sequence
    emit({"phase": "gpu_vs_cpu", **check_against_cpu(device)})

    # 5. the main path
    report, counts = run_main_path(device, profile="--profile" in sys.argv[1:])
    emit(report)

    kernels = []
    for k in full:
        kernels.append({
            "name": k["name"], **KERNEL_FACTS[k["name"]],
            "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "launch_only_ms": k["launch_only_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes any of the three functions
            "library_ms": None,
        })
    print(smi, flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
