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
   equality (K2 through both entries, the fused match in five cases of
   ``match_stereo`` and with planted ties); the Schur assembly through both
   entry points (K4, K5; three kernels) at (K, L) = (8, 640), (5, 1000),
   (1, 640), (31, 4097), (32, 4097), (32, 4096), (64, 4096), (128, 4096),
   at the windows of the whole system's loop, (8, 1024) and (64, 1024), and
   at a 64 x 1024 window padded as the loop pads its windows, within the
   stated relative tolerances, no further from float64 than the plain
   version, the same bits twice, each kernel's registers and spills (none
   allowed); K6 through both entries, the Hamming matrix at 256 x 4096,
   ragged and batched shapes and the pool count at ``[8, 256, 16 x 256]``
   and ragged shapes with planted cutoff distances and invalid entries,
   exact equality, no spills in K2 or K6; every kernel's device time from a
   ``torch.profiler`` trace;
4. compares the port on the card with the port on the CPU (plain versions)
   on a short small sequence, SV and GT mode, on a small BA window and pose
   graph, and on the closure query below;
5. drives the main paths. The front-end: the KITTI-00 calibration at
   376x1241 with ``DEFAULT_PARAMS``, 16 frames through
   ``StereoTracker.process`` and 8 through ``process_many(chunk=8)``,
   frames rendered on the card by the port's corridor renderer; checks pose
   acceptance, track counts, the trajectory error against the exact ground
   truth. The map optimisation: ``prepare_ba_window`` -> ``bundle_adjust``
   at 32 / 64 / 128 keyframes x 4096 landmarks, ``optimize_pose_graph`` at
   680 keyframes (twice: the same bits), ``align_clouds_batch`` at 4 x 256;
   checks that chi^2 falls and the errors against the generating truth. The
   closure query: a database of 680 keyframes x 256 pool entries with
   planted revisits and decoys, ``find_closures_batch`` of 8 queries. The
   whole system: a 208-frame loop of 26 m radius at 376x1241 through
   ``SLAMSystem.process_many(chunk=32)`` -> ``finalize_backend`` ->
   ``optimized_trajectory``, which must close the loop, and every BA window
   it assembles must have a shape at which the kernels were held against
   their plain versions. Each path must have launched its kernels: K2's
   fused match on every ``match_stereo`` call, K6's pool count on every
   pool scoring;
6. drives the stereo-inertial path: the port on the card against the port
   on the CPU in lock step on 8 frames at 512x256 with 10 IMU samples a
   frame (``svi_gpu_vs_cpu``); the real-data front at the VI sensor's
   480x752 from the shipped vi_sensor calibration, equalization and remap
   card against CPU bit for bit, then 16 frames of ``process_imu_samples``
   (``svi_rectified``); and the configuration of ``bench.py:bench_svi`` —
   the same 208-frame loop with 10 IMU samples a frame through
   ``StereoInertialTracker.process_many_imu(chunk=32)`` ->
   ``finalize_backend`` (``svi_loop``), which must close the loop, pass
   gravity unaries to every pose graph and BA window, and launch every
   kernel of its path;
7. checkpoints and resumes both loops: each saves ``io.checkpoint`` after
   frame 95, and ``load_checkpoint`` onto the card must give the saved
   state bit for bit (frame state and table, database pools and host
   mirrors, keyframe records, closure edges, stats; for the
   stereo-inertial tracker its velocity, gravity observations, rig and
   calibration); frames 96-127 resumed must record the uninterrupted run's
   poses bit for bit, and the resumed SV loop must finish with the loop's
   accuracy checks (``checkpoint_resume``, ``checkpoint_svi``); drives the
   SV loop rendered with the moderate photometric stress
   (``io.stress.StressedSequence``) with the JAX package's accuracy gates
   of ``tests/test_stress.py`` (``stress_loop``) and the aliased corridor,
   which must accept no closure (``stress_alias``); and prints the stage
   budget of ``eval.stage_bench`` at 1241 x 376 (``stage_budget``);
8. drives the worker threads and the native runtime: the bench loop with
   the closure search on its worker (``async_closure``: the revisits
   ``slam_loop`` accepted, within 0.5 m, ATE < 0.5 m, K6's pool count on the
   worker) and with the whole keyframe tail on the back-end worker
   (``overlap_backend``, ``"force"``: closures, pose graph and BA ran, every
   future drained, ATE within the JAX tests' band of ``slam_loop``'s, K4 and
   K6 on the worker; ``True`` on the one card warns and runs synchronously),
   each with frames/s and the card's idle share (``nvidia-smi``'s
   utilization, sampled) beside ``slam_loop``'s; the C++ runtime built from
   ``native/src`` (``native_runtime``: the closure database with the native
   tree and no vocabulary, card == CPU, no decoy accepted, exact matching
   launching K6's matrix; the loop's first 32 frames through
   ``tools/make_dump`` and ``DumpReader(prefetch=4)``, tracked to the same
   bits as from memory; a ``.svic`` round trip of the clouds of that
   replay's state); and
   ``tools/create_cloud`` -> ``match_clouds`` -> ``bench_matching`` on the
   card (``cloud_tools``: card == CPU, K6's matrix held against
   ``hamming_packed``); and
9. drives the entry points a user calls: the loop rendered at twice the
   frame rate (416 frames: the tools' default parameters veto every BA at
   the 208-frame spacing) written as a KITTI tree (8-bit PNGs, times, the
   rendering camera's calib.txt, camera->world poses) through ``tools/acceptance`` with its default accuracy and
   closure gates (``ACCEPTANCE PASSED``, its frames/s beside the 20.8 fps
   default gate), ``tools/run_kitti`` (``--gt --frames 32``; ``--slam
   --chunk 32``) and ``run_demo`` (defaults; ``--slam --trajectory loop``)
   (``cli_entry_points``); ``compute_descriptors`` -> ``create_vocabulary``,
   ``triangulation_sampling``, the three trajectory CLIs on acceptance's
   trajectory and ``view_map`` on ``slam_loop``'s checkpoint
   (``offline_tools``); ``tools/validate_kernels`` (``kernel_validation``:
   exit 0, every kernel launched); ``bundle_adjust_sharded`` through a
   one-rank NCCL group at 16 x 8192 (K4) and 64 x 4096 (K5), equal to
   ``bundle_adjust`` bit for bit, and ``tools/bench_scaling``
   (``sharded_ba``); ``eval.utilization.utilization_report()`` at
   1241 x 376, every share in (0, 1.05] (``utilization``). Each phase
   requires the kernels of its path to have launched.

After the checkpoint phases (7), ``sharded_frame`` drives the
landmark-sharded frame step (``parallel.mesh.shard_state``): one NCCL rank
in this process over main_path's 24 frames, which must give main_path's
bits; then two gloo ranks spawned on the one card (gloo's CUDA support
probed first), 512 table rows each, over the same frames (integer outputs
and table fields equal to main_path's, poses within 1e-4), over the whole
system's loop (``slam_loop``'s gates on each rank, the two ranks'
trajectories the same bits, K4 and K6 launched on each), with the back-end
worker, and over the stereo-inertial loop (``svi_loop``'s figures and
gates, its launches on each rank); both loops save a checkpoint sharded at
frame 96 (every row, equal to the one-card phases' files) and resume from
it on each rank, and the host reads of the sharded SV loop (cloud, g2o,
viewer, logger dumps) must equal the one-card system's.

Every phase prints one line of JSON. Any failure raises, so the exit code
is non-zero and the final line is not printed. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# bytes/s and simple operations/s of one H100 SXM (data sheet): device
# memory rate, and the float32 rate outside the tensor cores taken as the
# rate of 32-bit ALU operations (generous for integer work, so the bound
# stays a lower bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the dense int8 rate of the tensor cores (data sheet); the data sheet
# gives no rate for the binary MMA K6 runs: binary_mma_ops_per_s measures it
PEAK_INT8_OPS_PER_S = 1979e12

H, W_RAW = 376, 1241
N_LANDMARKS = 1024
MAX_DISPARITY = 128
# main_path's frames: this many through process(), then process_many(chunk)
SHARD_SINGLE, SHARD_CHUNKED, SHARD_CHUNK = 16, 8, 8


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


def bound(bytes_moved: float, operations: float,
          ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# A probe of the binary MMA's rate: every warp issues CHAINS independent
# m16n8k256 b1 AND-popc MMAs per turn of its loop, on operands that are all
# ones, so each accumulator ends at iters * 256 and the sum a thread writes
# is known exactly.
B1_PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int CHAINS = 8;

__global__ void __launch_bounds__(256) b1_mma_rate_kernel(int* out, uint32_t x, int iters) {
    int acc[CHAINS][4] = {};
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < CHAINS; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
                : "r"(x), "r"(x), "r"(x), "r"(x), "r"(x), "r"(x));
    }
    int sum = 0;
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int svi_b1_mma_rate(void* out, int blocks, int iters, void* stream) {
    b1_mma_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((int*)out, 0xffffffffu, iters);
    return (int)cudaGetLastError();
}
"""
B1_PROBE_CHAINS, B1_PROBE_WARPS = 8, 8


@functools.cache
def binary_mma_ops_per_s() -> float:
    """The rate of ``mma.sync m16n8k256 b1 AND-popc`` on this card, in
    operations per second counted as an int8 product counts them (an AND
    and an add per bit pair: ``2 * 16 * 8 * 256`` per MMA), measured by
    ``B1_PROBE_SOURCE`` over four blocks of eight warps per SM, built
    apart from the package's library into its build directory."""
    import ctypes
    import os

    import torch

    from svi_mapper_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"b1_mma_rate.{os.getpid()}.cu"
    lib_path = src.with_suffix(".so")
    src.write_text(B1_PROBE_SOURCE)
    built = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", str(src),
                            "-o", str(lib_path)], capture_output=True, text=True)
    require(built.returncode == 0, f"the binary MMA probe did not build:\n{built.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.svi_b1_mma_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.zeros(blocks * 32 * B1_PROBE_WARPS, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        cuda_build.check_launch(fn(ctypes.c_void_p(out.data_ptr()), blocks, iters, stream),
                                "b1_mma_rate_kernel")

    ms = time_ms(launch, 3, 1)
    # each thread: CHAINS accumulators of 4 entries, each iters * 256
    require(bool((out == B1_PROBE_CHAINS * 4 * iters * 256).all()),
            "the binary MMA probe summed wrongly")
    mmas = blocks * B1_PROBE_WARPS * B1_PROBE_CHAINS * iters
    return mmas * 2 * 16 * 8 * 256 / (ms * 1e-3)


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

    from svi_mapper_tpu_torch.frontend.stereo import match_stereo
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.ops import (
        cuda_build,
        descriptors,
        paths,
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
        k3["bound_ms"], k3["bound_by"] = bound(*paths.brief_dense_work(h, wp))
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
        # the field pixels the tiers can accept: all the function needs
        touched, scored = track_kernel.scored_pixels(h, wp, inp["uv"], inp["band"])
        k1["ms"] = time_ms(lambda: track_kernel.track_scores(*args, **cuts), 50)
        # the launch alone, without the wrapper's checks
        launch1 = lambda: track_kernel.launch_track_scores(  # noqa: E731
            cuda_build.load_library(), field_l, inp["uv"], inp["band"], desc_last,
            desc_ref, 25, 50, 50)
        k1["launch_only_ms"] = time_ms(launch1, 50)
        k1["device_ms"] = traced_device_ms(launch1, ("track_scores_kernel",))
        k1["plain_ms"] = time_ms(lambda: track_kernel.window_scores(*args, **cuts), 3, 1)
        k1["bound_ms"], k1["bound_by"] = bound(*paths.track_scores_work(n, touched, scored))
        # its popcounts at 16 per clock and SM
        k1["design"] = {"pixels_scored": scored, "popcounts": 16 * scored,
                        "ceiling_ms": ceiling_ms(16 * scored, 16)}
    results.append(k1)

    k1["planted"] = check_track_scores_planted(device, h, wp, n)

    # --- K2: stereo profiles, and the fused match ---------------------------
    desc_k = descriptors.brief_at(field_l, inp["uv_near"])
    prof, u_r, x0 = stereo_kernel.stereo_profiles(
        field_r, inp["uv"], desc_k, max_disparity=max_disparity)
    torch.cuda.synchronize()
    De = prof.shape[1]
    u_rp, v_r, x0p = stereo_kernel.span_origin(inp["uv"], h, wp, De)
    want2 = stereo_kernel.row_span_profiles(field_r, v_r, x0p, desc_k, De)
    err2 = max(max_abs_err(prof, want2), max_abs_err(u_r, u_rp), max_abs_err(x0, x0p))
    require(De == min(max_disparity, wp), "De == min(max_disparity, wp)")
    require(torch.equal(prof, want2) and torch.equal(u_r, u_rp) and torch.equal(x0, x0p),
            "stereo_profiles disagrees with span_origin and the row-span profile")
    k2 = dict(name="stereo_profiles", max_abs_err=err2)
    k2m = dict(name="stereo_match", max_abs_err=0,
               cases=check_stereo_match_cases(field_r, inp["uv"], desc_k, max_disparity))
    k2m["planted"] = check_stereo_match_planted(device, h, wp, n, max_disparity)
    if timed:
        touched = stereo_kernel.span_pixels(inp["uv"], h, wp, De)
        lib = cuda_build.load_library()
        uv32 = inp["uv"].contiguous()
        k2["ms"] = time_ms(lambda: stereo_kernel.stereo_profiles(
            field_r, inp["uv"], desc_k, max_disparity=max_disparity), 50)
        launch2 = lambda: stereo_kernel.launch_stereo_profiles(  # noqa: E731
            lib, field_r, uv32, desc_k, De)
        k2["launch_only_ms"] = time_ms(launch2, 50)
        k2["device_ms"] = traced_device_ms(launch2, ("stereo_profiles_kernel",))
        k2["plain_ms"] = time_ms(lambda: stereo_kernel.row_span_profiles(
            field_r, *stereo_kernel.span_origin(inp["uv"], h, wp, De)[1:], desc_k, De), 5, 1)
        k2["bytes"], k2["operations"] = paths.stereo_profiles_work(n, De, touched)
        k2["bound_ms"], k2["bound_by"] = bound(k2["bytes"], k2["operations"])
        # its popcounts at 16 per clock and SM
        k2["design"] = {"popcounts": 8 * n * De, "ceiling_ms": ceiling_ms(8 * n * De, 16)}
        # the match as the tracker's re-match calls it: centre and range
        center, rng_ = stereo_match_ranges(n, De, device)
        mkw = dict(max_disparity=max_disparity, disparity_center=center, search_range=rng_)
        k2m["ms"] = time_ms(lambda: stereo_kernel.stereo_match(
            field_r, inp["uv"], desc_k, **mkw), 50)
        launch2m = lambda: stereo_kernel.launch_stereo_match(  # noqa: E731
            lib, field_r, uv32, desc_k, center, rng_, De, 0.5)
        k2m["launch_only_ms"] = time_ms(launch2m, 50)
        k2m["device_ms"] = traced_device_ms(launch2m, ("stereo_match_kernel",))
        k2m["plain_ms"] = time_ms(lambda: stereo_kernel.stereo_match_plain(
            field_r, inp["uv"], desc_k, **mkw), 5, 1)
        # the whole of match_stereo around it (the float tail in PyTorch)
        cam = synthetic.default_camera(w_raw, h, device=device)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        k2m["match_stereo_ms"] = time_ms(lambda: match_stereo(
            field_r, inp["uv"], desc_k, valid, cam, **mkw), 50)
        k2m["bytes"], k2m["operations"] = paths.stereo_match_work(n, De, touched)
        k2m["bound_ms"], k2m["bound_by"] = bound(k2m["bytes"], k2m["operations"])
        k2m["design"] = {"popcounts": 8 * n * De, "ceiling_ms": ceiling_ms(8 * n * De, 16)}
    results += [k2, k2m]
    return results


def stereo_match_ranges(n: int, De: int, device, seed: int = 5):
    """A previous disparity and a search range per keypoint, as the
    tracker's re-match gives them: centres across the span (some NaN, some
    outside it), ranges of 0 to 40 px."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    center = rng.uniform(-10, De + 10, n).astype(np.float32)
    center[::13] = np.nan
    search = rng.uniform(0, 40, n).astype(np.float32)
    search[::7] = np.round(search[::7])                 # ranges on whole pixels
    to = lambda a: torch.from_numpy(a).to(device)       # noqa: E731
    return to(center), to(search)


def check_stereo_match_cases(field, uv, desc, max_disparity: int) -> dict:
    """K2's fused match against its plain version, exactly (all six rows),
    in the cases ``match_stereo`` meets: no range, a centre and range per
    keypoint, a centre with the default range, a range that masks every
    candidate, another disparity floor. Returns the keypoints that found an
    unmasked minimum per case."""
    import torch

    from svi_mapper_tpu_torch.ops import stereo_kernel

    n = uv.shape[0]
    De = min(max_disparity, field.shape[1])
    center, search = stereo_match_ranges(n, De, uv.device)
    far = torch.full_like(center, -1000.0)
    cases = {"no_range": {}, "centre_and_range": dict(disparity_center=center,
                                                        search_range=search),
             "centre_default_range": dict(disparity_center=center),
             "everything_masked": dict(disparity_center=far, search_range=search),
             "floor_3_7": dict(min_disparity=3.7)}
    found = {}
    for label, kw in cases.items():
        got = stereo_kernel.stereo_match(field, uv, desc, max_disparity=max_disparity, **kw)
        torch.cuda.synchronize()
        want = stereo_kernel.stereo_match_plain(field, uv, desc,
                                                max_disparity=max_disparity, **kw)
        require(got.shape == want.shape == (6, n) and got.dtype == torch.int32,
                f"stereo_match {label}: shape {tuple(got.shape)}")
        rows = [r for r, a, b in zip(stereo_kernel.MATCH_ROWS, got, want)
                if not torch.equal(a, b)]
        require(not rows, f"stereo_match disagrees with stereo_match_plain ({label}) "
                          f"in rows {rows}")
        found[label] = int((want[1] < (1 << 20)).sum())
    require(found["everything_masked"] == 0, "a range far from every candidate matched")
    return found


def check_stereo_match_planted(device, h: int, w: int, n: int, max_disparity: int) -> dict:
    """K2's fused match on a RANDOM right field with ties planted: for each
    keypoint the same pixel is written at two candidates of its span, and
    its descriptor lies a few bits from that pixel, so two candidates share
    the least distance: the lower index must win, as ``torch.min`` says."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.ops import stereo_kernel

    De = min(max_disparity, w)
    rng = np.random.default_rng(31)
    gen = torch.Generator(device=device).manual_seed(31)
    field = torch.randint(-2 ** 31, 2 ** 31, (h, w, 8), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32)
    # keypoints whose span starts De - 1 left of them (the disparity is the
    # index), on exact halves every fourth
    uv = np.stack([rng.uniform(De - 1, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    uv[::4] = np.floor(uv[::4]) + 0.5
    uv = uv.astype(np.float32)
    u = np.clip(np.round(uv[:, 0]), 0, w - 1).astype(np.int64)
    v = np.clip(np.round(uv[:, 1]), 0, h - 1).astype(np.int64)
    x0 = np.clip(u - (De - 1), 0, w - De)
    i1 = rng.integers(1, De - 2, n)
    i2 = np.minimum(i1 + rng.integers(1, 20, n), De - 1)
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    px = field[to(v), to(x0 + (De - 1) - i1)]
    field[to(v), to(x0 + (De - 1) - i2)] = px
    flips = rng.integers(0, 20, n)
    bit = np.arange(256)[None, :] < flips[:, None]
    low = (bit.reshape(n, 8, 32) * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    desc = px ^ to(low.astype(np.uint32).view(np.int32))
    uv_t = to(uv)
    got = stereo_kernel.stereo_match(field, uv_t, desc, max_disparity=max_disparity)
    torch.cuda.synchronize()
    want = stereo_kernel.stereo_match_plain(field, uv_t, desc, max_disparity=max_disparity)
    require(torch.equal(got, want), "stereo_match disagrees with its plain version on planted ties")
    # spans of keypoints on one row may overwrite each other's plants
    lower = (want[0].cpu().numpy() == i1) & (want[1].cpu().numpy() == flips)
    require(lower.mean() > 0.8, f"planted ties resolved to the lower index at {lower.mean()}")
    return {"keypoints": n, "tie_to_lower_index": int(lower.sum())}


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


# the kernel entries each path launches; K2's profile entry and K6's
# matrix entry (the TPU kernels' functions) have no caller on these paths
FRONTEND_KERNELS = ("track_scores", "stereo_match", "brief_dense_fused")
BACKEND_KERNELS = ("schur_assemble", "schur_assemble_tiled")
CLOSURE_KERNEL = "pool_nn_counts"
OFF_PATH_ENTRIES = ("stereo_profiles", "hamming_matrix")

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
# the second entry of K2 and of K6: the same source, the same TPU kernel
KERNEL_FACTS["stereo_match"] = KERNEL_FACTS["stereo_profiles"]
KERNEL_FACTS["pool_nn_counts"] = KERNEL_FACTS["hamming_matrix"]
# the kernel ptxas names for an entry at the main path's shape
PTXAS_KERNEL = {"track_scores": "track_scores_kernel",
                "stereo_profiles": "stereo_profiles_kernel<128>",
                "stereo_match": "stereo_match_kernel<128>",
                "brief_dense_fused": "brief_dense_kernel",
                "hamming_matrix": "hamming_matrix_kernel",
                "pool_nn_counts": "pool_nn_counts_kernel"}


class CallCounter:
    """While in use, counts the calls of ``module.name`` that give the
    wrapped kernel entry work to launch (``work(*args)`` true): a path
    launched the entry on every such call when the entry's launch count
    equals this count."""

    def __init__(self, module, name: str, work):
        self.module, self.name, self.work, self.calls = module, name, work, 0

    def __enter__(self):
        self.wrapped = getattr(self.module, self.name)

        def counting(*args, **kw):
            self.calls += bool(self.work(*args))
            return self.wrapped(*args, **kw)

        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapped)


def stereo_match_calls():
    """Counts ``match_stereo``'s calls of the K2 match entry."""
    from svi_mapper_tpu_torch.frontend import stereo

    return CallCounter(stereo, "stereo_match", lambda field, uv, desc: uv.shape[0] > 0)


def pool_count_calls():
    """Counts the pool scorings that reach K6's pool entry."""
    from svi_mapper_tpu_torch.mapping import closure

    return CallCounter(closure, "pool_nn_counts",
                       lambda q, vq, r, vr, cut: r.numel() > 0)


def launch_counts() -> dict:
    from svi_mapper_tpu_torch.ops import paths

    return paths.launch_counts()


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import paths

    paths.reset_launch_counts()


# ---------------------------------------------------------------------------
# trajectory error
# ---------------------------------------------------------------------------

def ate_anchored(est, gt) -> float:
    """RMSE of camera centres, both trajectories expressed in the frame of
    their own first pose and not aligned further (``eval.trajectory.ate_rmse``
    with ``align=False`` on the anchored poses)."""
    import numpy as np

    from svi_mapper_tpu_torch.eval import trajectory as ev

    est, gt = (np.asarray(p, np.float64) for p in (est, gt))
    return ev.ate_rmse(est @ np.linalg.inv(est[0]), gt @ np.linalg.inv(gt[0]), align=False)


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
    # the third mode turns the landmark refinement's IDWA fallback on
    # (TrackingParams.landmark_idwa_fallback)
    for mode in ("sv", "gt", "sv_idwa"):
        gt = mode == "gt"
        p = dataclasses.replace(params, landmark_idwa_fallback=mode == "sv_idwa")
        a = StereoTracker(cam_gpu, p, use_gt_pose=gt, device=device)
        b = StereoTracker(seq.cam, p, use_gt_pose=gt, device="cpu")
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
        report[mode] = {"max_count_diff": worst_count, "max_pose_diff_m": worst_pos,
                        "n_optimal": [int(o.n_optimal) for o in a.outputs]}
    return report


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def run_main_path(device, profile: bool = False,
                  keep: dict | None = None) -> tuple[dict, dict]:
    """The front-end at configuration (a): SHARD_SINGLE frames through
    ``StereoTracker.process``, SHARD_CHUNKED through ``process_many``. With
    ``keep`` (a dict), fills it with what ``run_sharded_frame`` holds the
    sharded runs against: the host outputs, the table after the last
    frame, the frames, the camera, the launches and the frames/s."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, load_stereo_camera
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.tracker import StereoTracker

    n_single, n_chunked, chunk, warm_from = SHARD_SINGLE, SHARD_CHUNKED, SHARD_CHUNK, 4
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
    with TrackInputs(sample=n_single // 2) as k1_inputs, stereo_match_calls() as k2_calls:
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
    ate = ate_anchored(traj, poses)
    require(ate < 0.10, f"ATE {ate} m against the exact ground truth")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS),
            f"kernel not launched: {counts}")
    require(counts["stereo_match"] == k2_calls.calls and counts["stereo_profiles"] == 0,
            f"{k2_calls.calls} scanline matches, {counts['stereo_match']} launches of "
            f"the fused match, {counts['stereo_profiles']} of the profile entry")
    st = tracker.state
    tensors = [st.T_wc, st.T_wc_prev, st.T_last_keyframe, st.next_uid,
               st.frame_idx, st.instability]
    tensors += [getattr(st.table, f.name) for f in dataclasses.fields(st.table)]
    require(all(t.is_cuda for t in tensors), "state left the card")
    if keep is not None:
        keep.update(outs=outs, table=table_numpy(st.table), imgs=(imgs_l, imgs_r), cam=cam,
                    counts=counts, frames_per_s=n / (sum(frame_s) + chunked_s))

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
        "match_stereo_calls": k2_calls.calls,
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
            for name in ("track_scores_kernel", "stereo_match_kernel",
                         "brief_dense_kernel")},
        "top_kernels": [{"name": r[0][:80], "ms_per_frame": r[1] / n,
                         "calls_per_frame": r[2] / n} for r in rows[:12]],
    }


# ---------------------------------------------------------------------------
# the Schur-assembly kernels (K4, K5) against their plain versions
# ---------------------------------------------------------------------------

BA_WIDTH, BA_HEIGHT = 1241, 376
BA_LANDMARKS = 4096


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
            plain = re.search(r"\d+([a-z_][a-z0-9_]*kernel)(?:ILi(\d+)E)?", m.group(1))
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


def segment_ba_problem(K: int, L: int, seed: int):
    """``ba_problem(K, L, hard=True)`` as a map segment observes it: each
    landmark seen by a run of 3 to 15 consecutive keyframes (the five
    landmarks near the plane of the camera by the last four), in random
    order, so that once ordered by first observing keyframe most (keyframe
    group pair, slab) products of K5 are not live, some tiles of groups
    have none, and a tile's live slabs have gaps."""
    import numpy as np

    p = ba_problem(K, L, seed=seed, noise=1.5, point_noise=0.1, hard=True)
    rng = np.random.default_rng(seed + 1)
    first = rng.integers(0, K, L)
    span = rng.integers(3, 16, L)
    first[7:12], span[7:12] = max(K - 4, 0), 4
    k = np.arange(K)[:, None]
    return dict(p, mask=p["mask"] & (k >= first) & (k < first + span))


# the design's three kernels, as the trace names them
SCHUR_KERNELS = ("schur_assembly_kernel", "schur_product_kernel", "schur_reduce_kernel")


def check_schur_kernel(device, name: str, K: int, L: int, timed: bool,
                       padded: bool = False, segment: bool = False,
                       ordered: bool = False) -> dict:
    """K4 or K5 at ``[K, L]`` against the plain version (``SCHUR_TOL``) and
    no further from float64 than it, the same bits twice, on
    ``ba_problem``'s box of landmarks (``padded``: as ``models.slam`` pads
    a window; ``segment``: ``segment_ba_problem``'s visibility). With
    ``ordered`` the landmarks are put in ``landmark_order``'s order first,
    as ``solvers.ba`` loads a solve on the card. The wrapper makes its own
    schedule for the first call; the second call and the timed ones take a
    schedule made once, as the solver's buffer set holds one a solve."""
    import torch

    from svi_mapper_tpu_torch.ops import ba_kernel, paths

    fn, plain = {
        "schur_assemble": (ba_kernel.schur_assemble, ba_kernel.schur_assemble_plain),
        "schur_assemble_tiled": (ba_kernel.schur_assemble_tiled,
                                 ba_kernel.schur_assemble_tiled_plain),
    }[name]
    if padded:
        p = padded_ba_problem(K // 2 + 3, K, L * 3 // 4 - 5, L, seed=29 + K)
    elif segment:
        p = segment_ba_problem(K, L, seed=37 + K)
    else:
        p = ba_problem(K, L, seed=23 + K, noise=1.5, point_noise=0.1, hard=True)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (to(p["T"]), to(p["X0"]), to(p["obs"]), to(p["mask"].astype("float32")))
    if ordered:
        perm, _ = ba_kernel.landmark_order(args[3])
        args = (args[0], args[1][perm], args[2][:, perm], args[3][:, perm])
    kw = dict(zip(("fx", "fy", "cx", "cy", "bq"), p["intr"]))
    schedule = ba_kernel.schur_schedule(args[3])
    # with one keyframe every landmark is observed once, and S is H_pp
    # cancelled by its own landmarks' terms down to the damping: at 1e-3 the
    # plain float32 version keeps no digit of it (7.8 x its size from
    # float64); at 10 it keeps five
    lam = 10.0 if K == 1 else 1e-3
    got = fn(*args, lam, **kw)
    torch.cuda.synchronize()
    again = fn(*args, lam, **kw, schedule=schedule)
    want32 = plain(*args, lam, **kw)
    want64 = plain(*[a.double() for a in args], lam, **kw)
    torch.cuda.synchronize()
    require(all(torch.isfinite(g).all() for g in got), f"{name}: non-finite output")
    require(got[0].shape == (K, 6, K, 6) and got[4].shape == (3, 6 * K, L),
            f"{name}: output shapes")
    err = ba_kernel.schur_errors(got, want32)
    bad = {nm: float(f"{e:.3e}") for nm, e in err.items()
           if not e < ba_kernel.SCHUR_TOL[nm]}
    require(not bad, f"{name} K={K} L={L} padded={padded} segment={segment} "
            f"ordered={ordered}: off by {bad}")
    # the inputs reach every branch
    pc_z = (torch.einsum("kij,lj->kli", args[0][:, :3, :3], args[1])
            + args[0][:, None, :3, 3])[..., 2]
    seen = args[3] > 0
    require(bool(((pc_z < 0.05) & seen).any()) and bool(((pc_z.abs() < 1e-6) & seen).any()),
            "no observation behind / in the plane of the camera")
    require(bool((~seen.any(0)).any()), "no unobserved landmark")
    require(float(got[4][:, :, ~seen.any(0)].abs().max()) == 0.0,
            "W of an unobserved landmark")
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
        name=name, K=K, L=L, padded=padded, segment=segment, ordered=ordered,
        live_products=int(schedule.live),
        products=schedule.tiling.n_tiles * schedule.tiling.n_slabs, rel_err_vs_plain=err,
        max_abs_err=float(torch.max(torch.abs(got[0] - want32[0]))),
        rel_err_vs_float64=dict(kernel=ba_kernel.schur_errors(got, want64),
                                plain=ba_kernel.schur_errors(want32, want64)),
        # partials are added in a fixed order: no run-to-run change, whether
        # the wrapper or the caller made the schedule
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
        # and their sum from a trace; all with the schedule made once
        out["ms"] = time_ms(lambda: fn(*args, lam, **kw, schedule=schedule), 50)
        launch = lambda: ba_kernel.launch_schur_system(  # noqa: E731
            *args, lam, (*p["intr"], 10.0), 1e-6, tiled=name == "schur_assemble_tiled",
            schedule=schedule)
        out["launch_only_ms"] = time_ms(launch, 50)
        by_kernel = traced_device_ms_by_kernel(launch, SCHUR_KERNELS)
        out["device_ms_by_kernel"] = by_kernel
        out["device_ms"] = (None if None in by_kernel.values()
                            else sum(by_kernel.values()))
        if ordered:
            # what solvers.ba adds once a solve on the card and no schur_*
            # kernel counts: the order, the mask and the inputs gathered by
            # it, the schedule; every device operation of it
            def order_stage():
                perm, _ = ba_kernel.landmark_order(args[3])
                ba_kernel.schur_schedule(args[3].index_select(1, perm))
                args[2].index_select(1, perm)
                args[1].index_select(0, perm)
            out["order_stage_device_ms"] = traced_device_ms_by_kernel(
                order_stage, ("",), 20)[""]
        out["plain_ms"] = time_ms(lambda: plain(*args, lam, **kw), 3, 1)
        # torch.matmul of the same planes: the dense [6K, 3L] x [3L, 6K]
        # product the plain version forms, its operands laid out beforehand
        A = ba_kernel._c_planes(got[4], got[2]).permute(1, 0, 2).reshape(6 * K, -1)
        B = got[4].permute(1, 0, 2).reshape(6 * K, -1)
        out["product_matmul_ms"] = time_ms(lambda: torch.matmul(A, B.T), 20)
        out["product_matmul_flops"] = 2 * (6 * K) ** 2 * 3 * L
        counts = paths.schur_work(p["mask"], K, L)
        out.update(counts)
        out["bound_ms"], out["bound_by"] = bound(counts["bytes"], counts["flops"])
    return out


# the windows SLAMSystem and StereoInertialTracker assemble on the 208-frame
# loop (slam_loop and svi_loop alike): the 8-keyframe local BA (K4) and the
# incremental BA after a closure, bucketed to 64 keyframes (K5), both over
# the loop's 1024 landmarks
LOOP_BA_SHAPES = [("schur_assemble", 8, N_LANDMARKS),
                  ("schur_assemble_tiled", 64, N_LANDMARKS)]


# K5 over a map segment's visibility: 128 keyframes x L landmarks, in the
# order the solver loads a solve in on the card and, at the segment cells'
# size, in the generator's order
SEGMENT_SHAPES = [(BA_LANDMARKS, True), (65536, True), (65536, False)]


def check_backend_kernels(device, timed: bool = True) -> list[dict]:
    """K4 and K5 at ragged shapes (one keyframe, 31 keyframes, 4097
    landmarks), at the widest windows of the map-optimisation path, at the
    windows of the whole system's loop, at a 64 x 1024 window padded as
    the loop pads its windows and on map segments (``SEGMENT_SHAPES``)
    (``timed=False``: every shape checked, none timed)."""
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
    rows += [check_schur_kernel(device, "schur_assemble_tiled", 128, L, timed,
                                segment=True, ordered=ordered)
             for L, ordered in SEGMENT_SHAPES]
    return rows


# the observed walk's kernels, as the trace names them
WALK_KERNELS = ("observed_chi2_kernel", "observed_chi2_sum_kernel", "observed_update_kernel")
# how far a walk entry may be from its plain version: the chi^2 relative
# (both sum float32 terms in float64; the terms differ by the FMAs the
# compiler forms), the landmarks' step relative to its largest entry (W^T dp
# summed in float32 in another order)
WALK_TOL = dict(chi2=1e-5, update=1e-4)


def check_observed_walk_at(device, K: int, L: int, timed: bool, segment: bool = False,
                           ordered: bool = False, padded: bool = False) -> dict:
    """The observed walk's two entries at ``[K, L]`` against their plain
    versions (``WALK_TOL``), no further from float64 than the plain
    float32 versions (twice their error, or 1e-6 for the chi^2 and 1e-5 for
    the step), the same bits twice, on the windows ``check_schur_kernel``
    takes (``segment``: a map segment's visibility; ``ordered``: in
    ``landmark_order``'s order, as the solver holds a solve on the card;
    ``padded``: as ``models.slam`` pads a window). The back-substitution's
    operands are K4 / K5's on the window, and a pose step with the fixed
    pose's row zero. With ``timed``: each kernel's traced device time, the
    bound, the plain versions' time and the parent's dense passes' time."""
    import torch

    from svi_mapper_tpu_torch.ops import ba_kernel, observed_walk, paths
    from svi_mapper_tpu_torch.solvers import ba

    if padded:
        p = padded_ba_problem(K // 2 + 3, K, L * 3 // 4 - 5, L, seed=41 + K)
    elif segment:
        p = segment_ba_problem(K, L, seed=43 + K)
    else:
        p = ba_problem(K, L, seed=47 + K, noise=1.5, point_noise=0.1, hard=True)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    T, X, obs, ow = to(p["T"]), to(p["X0"]), to(p["obs"]), to(p["mask"].astype("float32"))
    if ordered:
        perm, _ = ba_kernel.landmark_order(ow)
        X, obs, ow = X[perm].contiguous(), obs[:, perm].contiguous(), ow[:, perm].contiguous()
    fx, fy, cx, cy, bq = p["intr"]
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, bq=bq, kernel_px2=10.0)
    assemble = ba_kernel.schur_assemble if K <= 32 else ba_kernel.schur_assemble_tiled
    _, _, Hll_inv, b_l, W = [t.clone() for t in assemble(
        T, X, obs, ow, 1e-3, **cam, point_damping=1e-6)]
    g = torch.Generator().manual_seed(K * 7 + L)
    dp = (torch.randn(K, 6, generator=g) * torch.tensor([1e-2] * 3 + [1e-3] * 3)).to(device)
    dp[0] = 0.0
    update_args = (W, dp, Hll_inv, b_l, X, ow)

    chi2 = observed_walk.observed_chi2(T, X, obs, ow, **cam).clone()
    chi2_again = observed_walk.observed_chi2(T, X, obs, ow, **cam)
    X_new = observed_walk.observed_update(*update_args).clone()
    X_new_again = observed_walk.observed_update(*update_args)
    chi2_32 = observed_walk.observed_chi2_plain(T, X, obs, ow, **cam)
    chi2_64 = observed_walk.observed_chi2_plain(T.double(), X.double(), obs.double(),
                                                ow.double(), **cam)
    X_new_32 = observed_walk.observed_update_plain(*update_args)
    X_new_64 = observed_walk.observed_update_plain(*(t.double() for t in update_args))

    # the parent's dense passes: _project -> robust_w -> _chi2 over every
    # slot, and the einsum over the whole W planes
    def dense_chi2():
        r = ba._residuals(T, X, obs, fx, fy, cx, cy, bq)[0]
        err2 = torch.sum(r * r, dim=-1)
        w = torch.where(err2 > 10.0, 10.0 / torch.clamp(err2, min=1e-12), torch.ones_like(err2))
        return ba._chi2(r, w * ow)

    def dense_update():
        Wt_dp = torch.einsum("bql,q->lb", W, dp.reshape(6 * K))
        return X + -(Hll_inv @ (b_l + Wt_dp)[..., None])[..., 0]

    chi2_dense, X_new_dense = dense_chi2(), dense_update()
    torch.cuda.synchronize()

    step64 = float((X_new_64 - X.double()).abs().max())
    chi2_err = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    step_err = lambda a, b: float((a.double() - b.double()).abs().max()) / step64  # noqa: E731
    seen = ow > 0
    out = dict(
        K=K, L=L, segment=segment, ordered=ordered, padded=padded,
        observed_slots=int(seen.sum()), total_slots=K * L,
        chi2=float(chi2), same_bits_twice=bool(torch.equal(chi2, chi2_again)
                                               and torch.equal(X_new, X_new_again)),
        rel_err_vs_plain=dict(chi2=chi2_err(chi2, chi2_32), update=step_err(X_new, X_new_32)),
        rel_err_vs_float64=dict(
            kernel=dict(chi2=chi2_err(chi2, chi2_64), update=step_err(X_new, X_new_64)),
            plain=dict(chi2=chi2_err(chi2_32, chi2_64), update=step_err(X_new_32, X_new_64)),
            dense=dict(chi2=chi2_err(chi2_dense, chi2_64),
                       update=step_err(X_new_dense, X_new_64))))
    where = f"observed walk K={K} L={L} segment={segment} ordered={ordered} padded={padded}"
    require(bool((~seen.any(0)).any()) and bool((~seen.any(1)).any() or not padded),
            f"{where}: no unobserved landmark (or, padded, keyframe)")
    require(torch.isfinite(chi2) and bool(torch.isfinite(X_new).all()), f"{where}: non-finite")
    require(out["same_bits_twice"], f"{where}: two runs differ")
    bad = {nm: e for nm, e in out["rel_err_vs_plain"].items() if not e < WALK_TOL[nm]}
    require(not bad, f"{where}: off the plain version by {bad}")
    floor = dict(chi2=1e-6, update=1e-5)
    worse = {nm: (out["rel_err_vs_float64"]["kernel"][nm], out["rel_err_vs_float64"]["plain"][nm])
             for nm in floor if out["rel_err_vs_float64"]["kernel"][nm]
             > max(2 * out["rel_err_vs_float64"]["plain"][nm], floor[nm])}
    require(not worse, f"{where}: further from float64 than the plain version: {worse}")
    # an unobserved landmark's step: -Hll_inv b_l, with b_l 0: it stays
    unseen = ~seen.any(0)
    require(torch.equal(X_new[unseen], X[unseen]), f"{where}: an unobserved landmark moved")
    if timed:
        by_kernel = traced_device_ms_by_kernel(
            lambda: (observed_walk.observed_chi2(T, X, obs, ow, **cam),
                     observed_walk.observed_update(*update_args)), WALK_KERNELS)
        out["device_ms_by_kernel"] = by_kernel
        out["chi2_device_ms"] = (None if None in list(by_kernel.values())[:2]
                                 else by_kernel[WALK_KERNELS[0]] + by_kernel[WALK_KERNELS[1]])
        out["update_device_ms"] = by_kernel[WALK_KERNELS[2]]
        for name, work in (("chi2", paths.observed_chi2_work(ow, K, L)),
                           ("update", paths.observed_update_work(ow, K, L))):
            out[f"{name}_bytes"], out[f"{name}_flops"] = work
            out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound(*work)
        out["chi2_plain_ms"] = time_ms(
            lambda: observed_walk.observed_chi2_plain(T, X, obs, ow, **cam), 5, 1)
        out["update_plain_ms"] = time_ms(
            lambda: observed_walk.observed_update_plain(*update_args), 5, 1)
        out["chi2_dense_device_ms"] = traced_device_ms(dense_chi2, ("",), 20)
        out["update_dense_device_ms"] = traced_device_ms(dense_update, ("",), 20)
    return out


# the observed walk's windows: the segment cells' (ordered, as the solver
# holds them, and in the generator's order), a segment at the card tests'
# size, the back-end's window BA (8 x 1024 and 32 x 4096 on K4, 64 x 1024 on
# K5, padded as the loop pads it) and ragged shapes
WALK_SHAPES = [(128, 65536, dict(segment=True, ordered=True)),
               (128, 65536, dict(segment=True)),
               (128, BA_LANDMARKS, dict(segment=True, ordered=True)),
               (32, BA_LANDMARKS, dict(ordered=True)),
               (8, 1024, dict(ordered=True)),
               (64, 1024, dict(padded=True, ordered=True)),
               (1, 640, {}), (31, 4097, {})]


def check_observed_walk(device, timed: bool = True) -> list[dict]:
    """The observed walk at ``WALK_SHAPES`` (``timed=False``: none timed)."""
    return [check_observed_walk_at(device, K, L, timed and K in (128, 32) and L >= BA_LANDMARKS,
                                   **kw)
            for K, L, kw in WALK_SHAPES]


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
    graphs_before = ba.graph_counts()
    ba.reset_schur_schedule_counts()
    ba.reset_observed_walk_counts()
    t0 = time.perf_counter()
    prep, res = run(iterations)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()[name] - before
    graphs = {k: v - graphs_before[k] for k, v in ba.graph_counts().items()}
    schedule = ba.schur_schedule_counts()
    walk = ba.observed_walk_counts()
    its = int(res.iterations)
    err2, depth = ba.reprojection_stats(res.T_wc, res.points_w, t["obs_uv"],
                                        prep.mask, cam, device=device)

    chi0, chi1 = float(res.chi2_initial), float(res.chi2_final)
    require(its == iterations, f"K={K}: {its} LM iterations of {iterations}")
    require(launches == its, f"K={K}: {launches} launches of {name} in {its} iterations")
    # the warm-up captured this window's stages: the update and chi^2 replay
    # (the window has no pose chain or gravity term, so no priors stage),
    # and the landmark order once a solve
    require(graphs == {"graph_capture": 0, "graph_replay": 2 * its + 2},
            f"K={K}: LM graphs {graphs} in {its} iterations")
    # the solve ordered its landmarks and made the product's schedule once
    require(schedule["solves_ordered"] == 1
            and 0 < schedule["live_products"] <= schedule["total_products"],
            f"K={K}: schedule counts {schedule}")
    # chi^2 and update walked the observed slots: the start's chi^2 and each
    # iteration's
    require(walk["chi2_passes"] == its + 1 and walk["update_passes"] == its
            and 0 < walk["observed_slots"] <= walk["total_slots"] == K * BA_LANDMARKS,
            f"K={K}: observed walk counts {walk}")
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
        graph_replays=graphs["graph_replay"], schur_schedule=schedule, observed_walk=walk,
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
    # the sums run in one order (solvers/pose_graph.py): the same graph gives
    # the same bits on a second run
    again = pose_graph.optimize_pose_graph(T0, edges, fixm, device=device)
    same_bits = all(torch.equal(x, y) for x, y in zip(
        (res.T_wc, res.chi2_initial, res.chi2_final, res.iterations),
        (again.T_wc, again.chi2_initial, again.chi2_final, again.iterations)))
    require(same_bits, "optimize_pose_graph gave other bits on a second run of one graph")
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
                same_bits_twice=same_bits,
                ms_per_iteration=1e3 * seconds / max(its, 1),
                chi2_initial=chi0, chi2_final=chi1,
                end_point_err_before_m=e0, end_point_err_after_m=e1,
                ate_rmse_before_m=ate_anchored(T_est, T_true),
                ate_rmse_after_m=ate_anchored(T_opt, T_true))


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
    """K6's two entries. The matrix at the shape of the closure's exact
    matching (256 x 4096), ragged shapes and the batched form: exactly the
    plain version's matrix, written into a buffer pre-filled with -1 so that
    an entry the kernel skips shows. The pool count at the shape of the
    closure batch's pool scoring (``[8, 256, 16 x 256]``) and at each shape
    of ``HAMMING_SHAPES`` (the M references cut into pools of up to 256),
    with planted distances at the cutoff and one over it, invalid queries,
    invalid references and a wholly invalid pool: exactly the plain
    version's counts, into a buffer pre-filled with -1."""
    import torch

    from svi_mapper_tpu_torch.ops import cuda_build, hamming, paths

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
            # the identity's operations on the tensor cores
            row["bytes"], row["operations"] = paths.hamming_matrix_work(1, N, M)
            row["bound_ms"], row["bound_by"], row["design"] = tensor_core_bound(
                row["bytes"], row["operations"], 8 * N * M)
        elif B == 8:
            row["ms"] = time_ms(lambda: hamming.hamming_distance_matrix(a, b), 50)
        if "ms" in row:
            row["device_ms"] = traced_device_ms(
                lambda: hamming.launch_hamming_matrix(lib, a, b, out=out),
                ("hamming_matrix_kernel",))
        rows.append(row)

    # the closure batch's shape first, timed
    for i, (N, M, B) in enumerate([(256, 4096, 8)] + HAMMING_SHAPES):
        C = -(-M // 256)
        rows.append(check_pool_counts(device, lib, B, N, C, M // C, timed=i == 0))
    return rows


POOL_CUTOFF = 25            # the closure's Hamming cutoff (DEFAULT_PARAMS)


def planted_hits(P: int, Pr: int) -> int:
    """How many planted queries of ``pool_inputs`` count in pool 0."""
    return len(range(0, min(P, Pr), 8))


def pool_inputs(seed: int, lead: tuple, P: int, C: int, Pr: int, device):
    """Query and reference pools made from a seed: random descriptors, 10 %
    of the queries and references invalid, the second pool wholly invalid
    (C > 1), and for every other query k a reference of pool 0 planted near
    it, from the end of the pool backwards (so the last, ragged tile and
    references of both parities hold planted ones): ``POOL_CUTOFF`` bits
    away with both valid (k % 8 == 0: it counts), ``POOL_CUTOFF + 1`` bits
    away (k % 8 == 2), ``POOL_CUTOFF`` bits away with the query invalid
    (k % 8 == 4) or the reference invalid (k % 8 == 6). Random descriptors
    lie ~128 bits apart, so exactly ``planted_hits`` queries count."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2 ** 32, lead + (P, 8), dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 2 ** 32, lead + (C, Pr, 8), dtype=np.uint64).astype(np.uint32)
    vq = rng.random(lead + (P,)) > 0.1
    vr = rng.random(lead + (C, Pr)) > 0.1
    if C > 1:
        vr[..., 1, :] = False
    for k in range(0, min(P, Pr), 2):
        kind = k % 8
        bit = np.zeros(256, bool)
        bit[rng.choice(256, POOL_CUTOFF + (kind == 2), replace=False)] = True
        word = (bit.reshape(8, 32) * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
        r[..., 0, Pr - 1 - k, :] = q[..., k, :] ^ word.astype(np.uint32)
        if kind != 2:
            vq[..., k] = kind != 4
            vr[..., 0, Pr - 1 - k] = kind != 6
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return to(q.view(np.int32)), to(vq), to(r.view(np.int32)), to(vr)


def check_pool_counts(device, lib, B, P: int, C: int, Pr: int, timed: bool) -> dict:
    import torch

    from svi_mapper_tpu_torch.ops import hamming, paths

    lead = () if B is None else B if isinstance(B, tuple) else (B,)
    q, vq, r, vr = pool_inputs(43 + P + Pr, lead, P, C, Pr, device)
    nb = 1
    for x in lead:
        nb *= x
    out = torch.full((nb, C), -1, dtype=torch.int32, device=device)
    flat = lambda t: t.reshape((nb,) + t.shape[len(lead):])  # noqa: E731
    hamming.launch_pool_nn_counts(lib, flat(q), flat(vq), flat(r), flat(vr),
                                  POOL_CUTOFF, out=out)
    got = hamming.pool_nn_counts(q, vq, r, vr, POOL_CUTOFF)
    torch.cuda.synchronize()
    want = hamming.pool_nn_counts_plain(q, vq, r, vr, POOL_CUTOFF)
    err = max(max_abs_err(out.reshape(want.shape), want), max_abs_err(got, want))
    require(got.shape == lead + (C,) and got.dtype == torch.int32,
            f"pool_nn_counts shape {tuple(got.shape)}")
    require(torch.equal(out.reshape(want.shape), want) and torch.equal(got, want),
            f"pool_nn_counts disagrees with its plain version at {lead} x {P} x {C} x {Pr}: "
            f"off by {err}")
    if C > 1:
        require(int(want[..., 1].abs().sum()) == 0, "a wholly invalid pool counted matches")
    row = dict(name="pool_nn_counts", B=B, P=P, C=C, Pr=Pr, max_abs_err=err,
               matches_in_pool_0=int(want[..., 0].sum()))
    require(bool((want[..., 0] == planted_hits(P, Pr)).all()),
            "the planted matches were not counted as planted")
    if timed:
        args = (q, vq, r, vr, POOL_CUTOFF)
        row["ms"] = time_ms(lambda: hamming.pool_nn_counts(*args), 200)
        launch = lambda: hamming.launch_pool_nn_counts(  # noqa: E731
            lib, flat(q), flat(vq), flat(r), flat(vr), POOL_CUTOFF, out=out)
        row["launch_only_ms"] = time_ms(launch, 200)
        row["device_ms"] = traced_device_ms(launch, ("pool_nn_counts_kernel",))
        row["plain_ms"] = time_ms(lambda: hamming.pool_nn_counts_plain(*args), 5, 1)
        # the identity's operations on the tensor cores
        pairs = nb * P * C * Pr
        row["bytes"], row["operations"] = paths.pool_nn_counts_work(nb, P, C, Pr)
        row["bound_ms"], row["bound_by"], row["design"] = tensor_core_bound(
            row["bytes"], row["operations"], 8 * pairs)
    return row


def tensor_core_bound(bytes_moved: float, operations: float, popcounts: float):
    """K6's bound: its operations at the faster of the two tensor-core
    rates the identity can run at, the binary MMA's as measured on this card
    and the int8 one of the data sheet; beside it the time of the same
    operations at each rate and of the old design's popcounts at 16 per
    clock and SM (modelled, not measured)."""
    b1 = binary_mma_ops_per_s()
    t, by = bound(bytes_moved, operations, max(b1, PEAK_INT8_OPS_PER_S))
    design = {"binary_mma_ops_per_s_measured": b1,
              "binary_mma_ceiling_ms": operations / b1 * 1e3,
              "int8_ceiling_ms": operations / PEAK_INT8_OPS_PER_S * 1e3,
              "popcount_ceiling_ms": ceiling_ms(popcounts, 16)}
    return t, by, design


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


def fill_closure_database(keyframes, device, chunk: int = 8, **create_kw):
    """The keyframes through ``KeyframeDatabase.add_many``, ``chunk`` at a
    time, each chunk with its ``[B, L, 256]`` probability plane on the
    device, as ``SLAMSystem`` adds a chunk's keyframes (``create_kw`` go to
    ``KeyframeDatabase.create``)."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.mapping.closure import KeyframeDatabase

    db = KeyframeDatabase.create(512, CLOSURE_POOL, store_prob=True, device=device,
                                 **create_kw)
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
    with pool_count_calls() as scorings:
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
    require(counts[CLOSURE_KERNEL] == scorings.calls > 0,
            f"{scorings.calls} pool scorings, {counts[CLOSURE_KERNEL]} launches: {counts}")

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
        "pool_nn_counts_launches_per_batch": counts["pool_nn_counts"],
        "hamming_matrix_launches_per_batch": counts["hamming_matrix"],
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
# the checkpoint phases: the loops save at the chunk boundary after frame
# 95, and the resumed systems run frames 96-127 (the next chunk)
CKPT_FRAME, CKPT_END = 96, 128


def system_snapshot(sys_) -> dict:
    """Every piece of a ``SLAMSystem``'s (or ``StereoInertialTracker``'s)
    state that a checkpoint carries, as host arrays: the frame state and
    table, the closure database's pools and host mirrors, the keyframe
    records, both closure edge lists, the recorded trajectory, the back-end
    queue and ``stats``; for a stereo-inertial tracker also the velocity,
    the gravity observations, ``T_cam_imu`` and the calibration."""
    import numpy as np

    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.ops.descriptors import words_to_numpy

    st = convert.state_to_numpy(sys_.state)
    out = {f"table__{k}": v for k, v in st.pop("table").items()}
    out.update({f"state__{k}": np.asarray(v) for k, v in st.items()})
    db = sys_.db
    out["db__desc"] = words_to_numpy(db.desc)
    for f in ("p_cam", "valid", "count", "T_wc", "prob"):
        out[f"db__{f}"] = getattr(db, f).cpu().numpy()
    out["db__count_host"] = np.asarray(db.count_host, np.int64)
    out["db__T_wc_host"] = np.asarray(db.poses_host()).copy()
    out["trajectory"] = np.stack([np.asarray(T, np.float64) for T in sys_.trajectory])
    out["world_offset"] = np.asarray(sys_.world_offset, np.float64)
    for i, kf in enumerate(sys_.slam_keyframes):
        out[f"kf{i}__index_frame"] = np.asarray([kf.index, kf.frame_idx])
        for f in ("T_wc", "obs_uv4", "obs_pos"):
            out[f"kf{i}__{f}"] = np.asarray(getattr(kf, f))
        # landmark ids: int32 where the run made them, int64 in the file
        for f in ("obs_uids", "pool_uids"):
            out[f"kf{i}__{f}"] = np.asarray(getattr(kf, f), np.int64)
    for name in ("closure_candidates", "accepted_closures"):
        for i, e in enumerate(getattr(sys_, name)):
            out[f"{name}{i}__ij"] = np.asarray([e.ref_kf, e.query_kf, e.accepted, e.suppressed])
            out[f"{name}{i}__T_qr"] = np.asarray(e.T_qr)
            out[f"{name}{i}__uid_pairs"] = np.asarray(e.uid_pairs)
    scalars = {
        "stats": {k: int(v) for k, v in sys_.stats.items()},
        "frame_count": sys_.frame_count, "db_n": db.n, "db_capacity": db.capacity,
        "world_shifts": sys_.world_shifts, "last_opt_kf": sys_._last_opt_kf,
        "uid_parent": sorted(sys_._uid_parent.items()),
        "excised_uids": sorted(sys_._excised_uids),
        "closure_queue": [sys_._last_closure_opt_kf, sys_._closure_kfs_in_queue,
                          sys_._closure_opt_lo, sys_._kf_since_local_ba]}
    out["scalars"] = np.frombuffer(json.dumps(scalars, sort_keys=True).encode(), np.uint8)
    if hasattr(sys_, "velocity"):
        out["svi__velocity"] = sys_.velocity.cpu().numpy()
        out["svi__gravity_obs"] = np.asarray(sys_.gravity_obs, np.float32).reshape(-1, 3)
        out["svi__T_cam_imu"] = np.asarray(sys_.T_cam_imu)
        for f in ("R_imu_to_world", "bias_gyro", "bias_accel", "noise_gyro", "noise_accel"):
            out[f"svi__calib__{f}"] = np.asarray(getattr(sys_.calib, f))
        out["svi__calib__n_samples"] = np.asarray(sys_.calib.n_samples)
    # copies: the system goes on writing its arrays in place
    return {k: np.array(v, copy=True) for k, v in out.items()}


def snapshot_differences(a: dict, b: dict) -> list[str]:
    """The entries of two snapshots that are not the same bits (dtype,
    shape and bytes), and the keys only one of them has."""
    diff = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            diff.append(k)
    return diff


def loop_with_checkpoint(system, keep: dict | None, start: int, outs: list, run) -> float:
    """Runs a loop's frames from ``start`` on through ``run(a, b)``; with
    ``keep`` (a dict with ``"path"``) in three calls that end at chunk
    boundaries (the same chunks as one call): up to ``CKPT_FRAME``, where it
    saves a checkpoint to ``keep["path"]`` and notes the system's snapshot
    (``keep["at_save"]``), up to ``CKPT_END`` (snapshot ``keep["at_end"]``),
    and the rest. Returns the seconds spent saving and snapshotting."""
    from svi_mapper_tpu_torch.io.checkpoint import save_checkpoint

    if keep is None:
        outs.extend(run(start, LOOP_FRAMES))
        return 0.0
    outs.extend(run(start, CKPT_FRAME))
    t0 = time.perf_counter()
    save_checkpoint(keep["path"], system)
    keep["at_save"] = system_snapshot(system)
    spent = time.perf_counter() - t0
    outs.extend(run(CKPT_FRAME, CKPT_END))
    t0 = time.perf_counter()
    keep["at_end"] = system_snapshot(system)
    spent += time.perf_counter() - t0
    outs.extend(run(CKPT_END, LOOP_FRAMES))
    return spent


def record_ba_windows(system, windows: list) -> None:
    """Notes the kernel, K and L of every BA window ``system`` assembles
    (and the launch count then) in ``windows``, as the loops' recording
    subclasses do."""
    from svi_mapper_tpu_torch.solvers import ba

    assemble = system._assemble_ba_window

    def recording(kfs, K=None):
        asm = assemble(kfs, K)
        if asm is not None:
            K_w, L_w = int(asm[1].shape[0]), int(asm[1].shape[1])
            name = ("schur_assemble" if K_w <= ba.SCHUR_KERNEL_MAX_K
                    else "schur_assemble_tiled")
            windows.append((name, K_w, L_w, launch_counts()[name]))
        return asm

    system._assemble_ba_window = recording


@contextlib.contextmanager
def recording_schur_shapes():
    """Inside: the set of ``(entry, K, L)`` of every K4 / K5 launch made in
    this process (``ops.ba_kernel.launch_schur_system`` wrapped), for the
    entry points whose systems build their own BA windows."""
    from svi_mapper_tpu_torch.ops import ba_kernel

    shapes = set()
    launch = ba_kernel.launch_schur_system

    def recording(T, X, obs, ow, *args, tiled: bool, **kwargs):
        shapes.add(("schur_assemble_tiled" if tiled else "schur_assemble",
                    int(ow.shape[0]), int(ow.shape[1])))
        return launch(T, X, obs, ow, *args, tiled=tiled, **kwargs)

    ba_kernel.launch_schur_system = recording
    try:
        yield shapes
    finally:
        ba_kernel.launch_schur_system = launch


def windows_by_shape(windows: list, counts: dict) -> list[dict]:
    """Per BA window shape: how many windows and the launches they made (the
    count at the next window of the kernel, or at the end, less the count at
    this one)."""
    by_shape = {}
    for i, (name, K_w, L_w, at) in enumerate(windows):
        later = [w[3] for w in windows[i + 1:] if w[0] == name]
        row = by_shape.setdefault((name, K_w, L_w), {"windows": 0, "launches": 0})
        row["windows"] += 1
        row["launches"] += (later[0] if later else counts[name]) - at
    return [{"kernel": name, "K": K_w, "L": L_w, **row}
            for (name, K_w, L_w), row in sorted(by_shape.items())]


def closure_errors(system, poses) -> list[float]:
    """Translation error (m) of each accepted closure's measured transform
    against the ground truth between its two keyframes."""
    import numpy as np

    errs = []
    for c in system.accepted_closures:
        f_r = system.slam_keyframes[c.ref_kf].frame_idx
        f_q = system.slam_keyframes[c.query_kf].frame_idx
        T_true = (poses[f_q].astype(np.float64)
                  @ np.linalg.inv(poses[f_r].astype(np.float64)))
        D = np.asarray(c.T_qr, np.float64) @ np.linalg.inv(T_true)
        errs.append(float(np.linalg.norm(D[:3, 3])))
    return errs


def loop_params():
    """The bench loop's tracking parameters (``bench.py:bench_full_slam``)."""
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS

    return dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=N_LANDMARKS, max_detections=N_LANDMARKS,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5)


def render_loop(device, n_frames: int = LOOP_FRAMES):
    """The bench loop's sequence and its frames rendered on the card:
    ``(seq, imgs_l, imgs_r, seconds)``; ``n_frames`` samples the same loop
    more or less densely."""
    import torch

    from svi_mapper_tpu_torch.io import synthetic

    seq = synthetic.SyntheticSequence(
        n_frames=n_frames, width=W_RAW, height=H, trajectory="loop",
        loop_radius=LOOP_RADIUS, device=device)
    t0 = time.perf_counter()
    imgs_l = torch.empty((n_frames, H, W_RAW), dtype=torch.float32, device=device)
    imgs_r = torch.empty_like(imgs_l)
    for i in range(n_frames):
        imgs_l[i], imgs_r[i], _ = seq.frame(i)
    torch.cuda.synchronize()
    return seq, imgs_l, imgs_r, time.perf_counter() - t0


class UtilSampler:
    """While in use, samples the card's ``utilization.gpu`` (the share of
    each sample period in which a kernel ran, as ``nvidia-smi`` reports it)
    every 100 ms in a child ``nvidia-smi`` process, stopped on exit.
    ``idle_share()`` is one less the mean sample (None if none came)."""

    def __enter__(self):
        import threading

        self.samples: list[float] = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return self
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append(float(line.strip()))
            except ValueError:
                pass

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=5)

    def idle_share(self):
        if not self.samples:
            return None
        return 1.0 - sum(self.samples) / len(self.samples) / 100.0


def run_slam_loop(device, schur_kernels: bool = True,
                  keep: dict | None = None) -> tuple[dict, dict]:
    """The whole system on the loop, once. The report's ``ba_windows`` names
    the kernel, K and L of every BA window the run assembled. With
    ``schur_kernels=False`` every BA window takes the materialised route
    (``solvers.ba``, ``use_schur_kernel=False``) instead of K4 / K5: a
    second witness of the loop's accuracy (``mutation_check.py
    --loop-routes``), not part of the smoke run. With ``keep`` (a dict with
    ``"path"``), the run saves a checkpoint there at frame ``CKPT_FRAME``
    and fills ``keep`` with what ``run_checkpoint_resume`` compares against
    (see :func:`loop_with_checkpoint`)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.solvers import ba

    params = loop_params()
    seq, imgs_l, imgs_r, render_s = render_loop(device)

    windows = []
    slam = SLAMSystem(seq.cam, params, device=device)
    record_ba_windows(slam, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    # one run; PyTorch's sync debug mode is on during its first chunks, which
    # counts the host reads there (a warning each, recorded, not printed)
    n_sync = LOOP_SYNC_CHUNKS * LOOP_CHUNK
    outs = []
    route = (contextlib.nullcontext() if schur_kernels else
             mock.patch.object(ba, "schur_kernel_auto", lambda *a, **k: False))
    with route, TrackInputs(sample=LOOP_FRAMES // 2) as k1_inputs, \
            stereo_match_calls() as k2_calls, pool_count_calls() as scorings, \
            UtilSampler() as util:
        syncs = count_host_syncs(lambda: outs.extend(slam.process_many(
            imgs_l[:n_sync], imgs_r[:n_sync], chunk=LOOP_CHUNK)))
        checkpoint_s = loop_with_checkpoint(
            slam, keep, n_sync, outs,
            lambda a, b: slam.process_many(imgs_l[a:b], imgs_r[a:b], chunk=LOOP_CHUNK))
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - checkpoint_s
    if keep is not None:
        keep.update(system=slam, seq=seq, params=params, imgs=(imgs_l, imgs_r))
    counts = launch_counts()
    opt = slam.optimized_trajectory()
    raw = slam.trajectory_array

    ba_windows = windows_by_shape(windows, counts)

    # the loop is driven in the corridor world, as the JAX package's bench
    # drives it, and passes through the plane of the wall at x = 9 m three
    # times: there the view changes within one frame and the pose solve
    # refuses the frame before the crossing and the one at it (the tracker
    # carries on by its motion model). The JAX package refuses the same
    # frames (tests/test_torch_loop_refusals.py). Everywhere else the solve
    # must accept.
    crossings, at_wall = wall_crossings(seq.poses_wc, 1)
    rejected = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]
    n_kf = len(slam.slam_keyframes)
    st = slam.stats
    ate_rec, ate_opt = ev.ate_rmse(raw, seq.poses_wc), ev.ate_rmse(opt, seq.poses_wc)
    # anchored at the first pose, no alignment: printed with its verdict, not
    # required (the loop's drift is largest on its far side and the closure
    # acts where the loop ends, so this figure barely moves)
    anchored_rec, anchored_opt = (ate_anchored(raw, seq.poses_wc),
                                  ate_anchored(opt, seq.poses_wc))
    on_path = (FRONTEND_KERNELS + (("schur_assemble",) if schur_kernels else ())
               + (CLOSURE_KERNEL,))
    k5_ran = counts["schur_assemble_tiled"] > 0

    # are the closed loops true loops
    closure_err = closure_errors(slam, seq.poses_wc)

    tm = slam.timings
    report = {
        "phase": "slam_loop", "frames": LOOP_FRAMES, "image": [H, W_RAW],
        # nvidia-smi's utilization.gpu, sampled every 100 ms over the run
        # (checkpoint saving included)
        "card_idle_share": util.idle_share(), "util_samples": len(util.samples),
        "landmarks": N_LANDMARKS, "chunk": LOOP_CHUNK, "radius_m": LOOP_RADIUS,
        "render_seconds": render_s, "seconds": seconds,
        "frames_per_s": LOOP_FRAMES / seconds,
        "checkpoint_seconds_left_out": checkpoint_s,
        "keyframes": n_kf,
        "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
        "jax_package_record": LOOP_JAX_RECORD,
        "ba_windows": ba_windows,
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
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
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
    require(counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"{k2_calls.calls} scanline matches and {scorings.calls} pool scorings "
            f"against launches {counts}")
    require(k5_ran == (schur_kernels and any(w["kernel"] == "schur_assemble_tiled"
                                             for w in ba_windows)),
            f"K5 launches {counts['schur_assemble_tiled']} against windows {windows}")
    require(slam.db.n == n_kf and slam.db.desc.is_cuda and slam.db.prob.is_cuda,
            "closure database left the card")
    return report, counts


# ---------------------------------------------------------------------------
# the stereo-inertial path
# ---------------------------------------------------------------------------

SVI_SUB, SVI_DT = 10, 0.05       # 200 Hz IMU : 20 fps frames (bench.py:bench_svi)
# the JAX package's StereoInertialTracker on the same loop, on a CPU
# (compare_svi_loop.py, measurement noise seeds 0 / 1 / 2): behaviour to
# compare, no time taken from it
SVI_LOOP_JAX_CPU = {"keyframes": [49, 51, 50], "closures_accepted": [2, 2, 2],
                    "closures_deduped": [13, 13, 12], "ba_runs": [8, 10, 10],
                    "pose_graph_runs": [2, 2, 2],
                    "ate_recorded_m": [1.1854, 1.4413, 1.5350],
                    "ate_optimised_m": [1.0749, 1.3221, 1.6815]}
# Where the pose solve refuses a frame (the three wall crossings), the
# stereo-inertial fallback is dead reckoning by rotation only (the reference's
# CTrackerSVI.cpp:548-551, mirrored): the frame's 0.91 m step is lost, and
# with it the map placed from that pose. So on this loop the aligned ATE is
# above 1 m in both packages, and the optimised one is above the recorded in
# two of six JAX runs and in every port run (whose back-end converges where
# the JAX package's stalls on its float32 log). The bounds: the recorded
# trajectory before the first refusal (the IMU-primed front-end alone; 0.018 m
# in both packages on a CPU), and the optimised one above the worst of both
# packages' CPU runs (1.68 m JAX, 1.85 m port) with a margin.
SVI_ATE_BEFORE_FIRST_REFUSAL_M = 0.05
SVI_ATE_BOUND_M = 2.0


def svi_blocks(n: int, omega, accel) -> tuple[list, list, list]:
    """bench.py:bench_svi's per-frame sample blocks: frame 0 gets one static
    sample, frame i the (i-1)-th measurement repeated over 10 steps of 5 ms."""
    import numpy as np

    from svi_mapper_tpu_torch.imu import interpolator as imu

    up = np.array([0.0, -1.0, 0.0])
    dts = [np.full(1 if i == 0 else SVI_SUB, SVI_DT if i == 0 else SVI_DT / SVI_SUB,
                   np.float32) for i in range(n)]
    oms = [np.zeros((1, 3), np.float32) if i == 0
           else np.tile(omega[i - 1], (SVI_SUB, 1)).astype(np.float32) for i in range(n)]
    acs = [(up * imu.GRAVITY)[None].astype(np.float32) if i == 0
           else np.tile(accel[i - 1], (SVI_SUB, 1)).astype(np.float32) for i in range(n)]
    return dts, oms, acs


def count_ops(fn) -> int:
    """PyTorch operations that ``fn`` dispatches, views, aliases and CPU
    scalars left out: on CUDA tensors each of them is a kernel launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    free = {"view", "_unsafe_view", "slice", "select", "expand", "t", "transpose",
            "unsqueeze", "squeeze", "alias", "as_strided", "detach", "permute",
            "lift_fresh", "scalar_tensor"}

    class Counting(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in free:
                Counting.n += 1
            return func(*args, **(kwargs or {}))

    with Counting():
        fn()
    return Counting.n


def zero_calibration():
    import numpy as np

    from svi_mapper_tpu_torch.imu import interpolator as imu

    return imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)


def svi_loop_inputs(device):
    """``bench.py:bench_svi``'s loop on the card: ``(params, seq, imgs_l,
    imgs_r, calibration, (dts, oms, acs), seconds)``, the frames rendered
    and the 10 IMU samples a frame synthesized from the ground truth."""
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io import synthetic

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
    calib0 = zero_calibration()
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, SVI_DT, calib=calib0, noise_gyro=0.001, noise_accel=0.02,
        device=device)
    blocks = svi_blocks(LOOP_FRAMES, omega, accel)
    torch.cuda.synchronize()
    return params, seq, imgs_l, imgs_r, calib0, blocks, time.perf_counter() - t0


def svi_loop_tracker(seq, calib0, params, device):
    """The SVI loop's tracker, noting the BA windows it assembles and
    whether each pose graph and BA window received gravity unaries:
    ``(tracker, windows, gravity_to_pose_graphs, gravity_to_ba_windows)``."""
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    windows, grav_pg, grav_ba = [], [], []

    class Recording(StereoInertialTracker):
        def _gravity_priors(self, N0, N):
            g = super()._gravity_priors(N0, N)
            grav_pg.append(g is not None and bool(g.valid[:N0].all()))
            return g

        def _gravity_ba_terms(self, kfs, K):
            g = super()._gravity_ba_terms(kfs, K)
            grav_ba.append(g is not None and bool((g[1][:len(kfs)] > 0).all()))
            return g

    tr = Recording(seq.cam, calib0, params, equalize=False, device=device)
    record_ba_windows(tr, windows)
    return tr, windows, grav_pg, grav_ba


def svi_loop_outcome(tr, outs, seq, windows, grav_pg, grav_ba, counts) -> dict:
    """What the SVI loop's gates read: its keyframes, closures, ATEs,
    refusals and gravity unaries, with both trajectories, the velocity and
    the gravity observations."""
    import numpy as np

    from svi_mapper_tpu_torch.eval import trajectory as ev

    opt = tr.optimized_trajectory()
    raw = tr.trajectory_array
    crossings, at_wall = wall_crossings(seq.poses_wc, 2)
    rejected = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]
    first = rejected[0] if rejected else LOOP_FRAMES
    return {
        "frames": len(outs), "keyframes": len(tr.slam_keyframes),
        "gravity_obs": len(tr.gravity_obs),
        "stats": {k: int(v) for k, v in tr.stats.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in tr.accepted_closures],
        "ba_windows": windows_by_shape(windows, counts),
        "gravity_to_pose_graphs": grav_pg, "gravity_to_ba_windows": grav_ba,
        "ate_recorded_m": ev.ate_rmse(raw, seq.poses_wc),
        "ate_optimised_m": ev.ate_rmse(opt, seq.poses_wc),
        "ate_recorded_before_first_refusal_m": ev.ate_rmse(raw[:first], seq.poses_wc[:first]),
        "frames_before_first_refusal": first,
        "closure_transform_err_m": closure_errors(tr, seq.poses_wc),
        "wall_crossings_at_frames": crossings, "near_wall": sorted(at_wall),
        "posit_rejected_at_frames": rejected,
        "poses_finite": all(np.isfinite(np.asarray(o.T_wc)).all() for o in outs),
        "raw": raw, "optimised": opt, "velocity": tr.velocity.cpu().numpy(),
        "gravity_obs_rows": np.asarray(tr.gravity_obs, np.float32).reshape(-1, 3),
    }


def require_svi_loop(r: dict, counts: dict, where: str) -> None:
    """The SVI loop's gates on :func:`svi_loop_outcome`'s ``r``: every pose
    finite, refusals only near a wall crossing, the loop closed, the ATE
    before the first refusal and the optimised ATE within their bounds,
    closures near the truth, one gravity observation per keyframe, gravity
    unaries to every pose graph and BA window, every kernel launched."""
    import numpy as np

    st, first = r["stats"], r["frames_before_first_refusal"]
    require(r["frames"] == LOOP_FRAMES and r["poses_finite"]
            and np.isfinite(r["optimised"]).all(), f"{where}: a pose is not finite")
    bad = [i for i in r["posit_rejected_at_frames"] if i not in r["near_wall"]]
    require(not bad, f"{where}: pose solve rejected on frames {bad} "
            f"(wall crossings at {r['wall_crossings_at_frames']})")
    require(st["closures_accepted"] >= 1 and st["pose_graph_runs"] >= 1
            and st["ba_runs"] >= 1, f"{where}: the SVI loop was not closed: {st}")
    require(first >= 20 and r["ate_recorded_before_first_refusal_m"]
            < SVI_ATE_BEFORE_FIRST_REFUSAL_M,
            f"{where}: ATE over the {first} frames before the first refusal: "
            f"{r['ate_recorded_before_first_refusal_m']} m")
    require(r["ate_optimised_m"] < SVI_ATE_BOUND_M,
            f"{where}: ATE: recorded {r['ate_recorded_m']} m, optimised "
            f"{r['ate_optimised_m']} m")
    require(max(r["closure_transform_err_m"]) < LOOP_CLOSURE_ERR_M,
            f"{where}: accepted closures off by {r['closure_transform_err_m']} m")
    require(r["gravity_obs"] == r["keyframes"],
            f"{where}: {r['gravity_obs']} gravity observations for {r['keyframes']} keyframes")
    require(len(r["gravity_to_pose_graphs"]) == st["pose_graph_runs"]
            and all(r["gravity_to_pose_graphs"]),
            f"{where}: gravity priors to the pose graphs: {r['gravity_to_pose_graphs']}")
    n_windows = sum(w["windows"] for w in r["ba_windows"])
    require(len(r["gravity_to_ba_windows"]) == n_windows and all(r["gravity_to_ba_windows"]),
            f"{where}: gravity unaries to the BA windows: {r['gravity_to_ba_windows']}")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + (CLOSURE_KERNEL,))
            and counts["schur_assemble"] + counts["schur_assemble_tiled"] > 0,
            f"{where}: kernel not launched on the SVI loop: {counts}")


def run_svi_loop(device, keep: dict | None = None) -> tuple[dict, dict]:
    """``bench.py:bench_svi`` through the port's ``StereoInertialTracker``,
    once: the 208-frame loop at 376 x 1241, 10 IMU samples a frame,
    ``process_many_imu(chunk=32)`` -> ``finalize_backend()``, loop closure
    and local BA on. The report's ``ba_windows`` names the kernel, K and L
    of every BA window the run assembled. ``keep`` as for
    :func:`run_slam_loop`."""
    import torch

    params, seq, imgs_l, imgs_r, calib0, (dts, oms, acs), stage_s = svi_loop_inputs(device)
    tr, windows, grav_pg, grav_ba = svi_loop_tracker(seq, calib0, params, device)
    n_sync = LOOP_SYNC_CHUNKS * LOOP_CHUNK
    outs = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        syncs = count_host_syncs(lambda: outs.extend(tr.process_many_imu(
            imgs_l[:n_sync], imgs_r[:n_sync], dts[:n_sync], oms[:n_sync], acs[:n_sync],
            chunk=LOOP_CHUNK)))
        checkpoint_s = loop_with_checkpoint(
            tr, keep, n_sync, outs,
            lambda a, b: tr.process_many_imu(imgs_l[a:b], imgs_r[a:b], dts[a:b], oms[a:b],
                                             acs[a:b], chunk=LOOP_CHUNK))
        tr.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - checkpoint_s
    if keep is not None:
        keep.update(system=tr, seq=seq, params=params, imgs=(imgs_l, imgs_r),
                    blocks=(dts, oms, acs))
    counts = launch_counts()
    r = svi_loop_outcome(tr, outs, seq, windows, grav_pg, grav_ba, counts)
    n_kf = r["keyframes"]
    tm = tr.timings
    report = {
        "phase": "svi_loop", "frames": LOOP_FRAMES, "image": [H, W_RAW],
        "landmarks": N_LANDMARKS, "chunk": LOOP_CHUNK, "radius_m": LOOP_RADIUS,
        "imu_samples_per_frame": SVI_SUB, "imu_sample_cap": tr._imu_sample_cap,
        "stage_seconds": stage_s, "seconds": seconds,
        "frames_per_s": LOOP_FRAMES / seconds,
        "checkpoint_seconds_left_out": checkpoint_s,
        **{k: r[k] for k in ("keyframes", "gravity_obs", "stats", "accepted_closures")},
        "jax_package_cpu": SVI_LOOP_JAX_CPU,
        **{k: r[k] for k in ("ba_windows", "gravity_to_pose_graphs", "gravity_to_ba_windows",
                             "ate_recorded_m", "ate_optimised_m")},
        "ate_bound_m": SVI_ATE_BOUND_M,
        **{k: r[k] for k in ("ate_recorded_before_first_refusal_m",
                             "frames_before_first_refusal")},
        "ate_before_first_refusal_bound_m": SVI_ATE_BEFORE_FIRST_REFUSAL_M,
        "closure_transform_err_m": r["closure_transform_err_m"],
        "n_tracked_min": min(int(o.n_tracked) for o in outs[1:]),
        **{k: r[k] for k in ("wall_crossings_at_frames", "posit_rejected_at_frames")},
        "timings_s": {k: float(v) for k, v in tm.items()},
        "tail_ms_per_keyframe": {
            k: 1e3 * tm.get(k, 0.0) / max(n_kf, 1)
            for k in ("kf_db_add", "kf_closure", "kf_backend", "kf_ba", "kf_pose_graph",
                      "kf_total")},
        "launches": counts,
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
        "host_syncs_counted_over_chunks": LOOP_SYNC_CHUNKS,
        "host_syncs_per_chunk": syncs / LOOP_SYNC_CHUNKS,
        "host_syncs_per_frame_in_chunks": syncs / n_sync,
    }
    # the IMU step of one frame alone (after the counts were read): the
    # prior, its fallback and the velocity update, on frame 100's inputs
    from svi_mapper_tpu_torch.models import frame as frame_mod

    blk = [torch.from_numpy(a).to(device) for a in tr._pad_samples(dts[100], oms[100],
                                                                    acs[100])]

    def imu_step():
        T_p, _, _ = frame_mod.svi_prior(tr.state.T_wc, *blk, tr.velocity, tr._R_ci,
                                        tr._bias_gyro, tr._bias_accel)
        return frame_mod.svi_velocity(T_p, tr.state.T_wc, torch.sum(blk[0] * blk[3]),
                                      tr.velocity)

    report["imu_step"] = {"ops": count_ops(imu_step), "host_syncs": count_host_syncs(imu_step),
                          "ms": time_ms(imu_step, repeats=20),
                          "frame_ms": 1e3 * tm["frame_total"] / LOOP_FRAMES}
    emit(report)             # before the checks: a failing run shows its numbers

    require_svi_loop(r, counts, "svi_loop")
    require(counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"{k2_calls.calls} scanline matches and {scorings.calls} pool scorings "
            f"against launches {counts}")
    if keep is not None:
        keep["outcome"] = r
    return report, counts


def fine_trajectory(n_frames: int, sub: int, dt_fine: float):
    """Analytic world->camera poses at the IMU rate: forward motion with a
    weave and a yaw wiggle (the JAX package's tests/test_imu.py fixture)."""
    import numpy as np

    poses = []
    for k in range(n_frames * sub + 1):
        t = k * dt_fine
        yaw = 0.06 * np.sin(2 * np.pi * 0.8 * t)
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([0.15 * np.sin(2 * np.pi * 0.5 * t), 0.0, 1.4 * t])
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ pos
        poses.append(T.astype(np.float32))
    return np.stack(poses)


def check_svi_against_cpu(device) -> dict:
    """The port on the card against the port on the CPU on a short
    stereo-inertial sequence (8 frames at 512 x 256, 10 IMU samples a
    frame, from a seed), in lock step: before every frame the card's
    tracker is given the CPU tracker's state. The IMU prior on the same
    inputs within 1e-6; flags, ``n_tracked`` and ``inliers`` equal; pose
    within 1e-4 m and 1e-5 rad; velocity within 1e-4 m/s."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models import frame as frame_mod
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    n, sub, h = 8, 10, 0.005
    fine = fine_trajectory(n, sub, h)
    cam_cpu = synthetic.default_camera(512, 256, device="cpu")
    cam_gpu = synthetic.default_camera(512, 256, device=device)
    bias_g, bias_a = np.array([0.008, -0.003, 0.002]), np.array([0.04, -0.02, 0.08])
    calib = imu.ImuCalibration(R_imu_to_world=np.eye(3), bias_gyro=bias_g,
                               bias_accel=bias_a, noise_gyro=np.zeros(3),
                               noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(fine, h, calib=calib, noise_gyro=0.002,
                                               noise_accel=0.04, seed=3, device="cpu")
    frames = [tuple(x.numpy() for x in synthetic.render_stereo(cam_cpu, T))
              for T in fine[::sub][:n]]
    up = np.array([0.0, -1.0, 0.0])
    blocks = [(np.full(1, h, np.float32), np.zeros((1, 3), np.float32),
               (up * imu.GRAVITY)[None].astype(np.float32))]
    blocks += [(np.full(sub, h, np.float32), omega[(i - 1) * sub:i * sub],
                accel[(i - 1) * sub:i * sub]) for i in range(1, n)]
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512, max_detections=512,
                                 keyframe_translation_m2=0.04)
    kw = dict(equalize=False, enable_loop_closure=False, enable_local_ba=False)
    cpu = StereoInertialTracker(cam_cpu, calib, params, device="cpu", **kw)
    gpu = StereoInertialTracker(cam_gpu, calib, params, device=device, **kw)
    worst = {"prior": 0.0, "rot_total": 0.0, "pos_m": 0.0, "rot_rad": 0.0, "vel": 0.0}
    for (L, R), block in zip(frames, blocks):
        carried = convert.svi_state_to_numpy(cpu)
        convert.svi_state_from_numpy(gpu, carried)
        # the IMU prior of this frame on both devices, from the same inputs
        args = [torch.from_numpy(np.asarray(a)) for a in cpu._pad_samples(*block)]
        priors = []
        for tr in (cpu, gpu):
            d, om, ac, va = (a.to(tr.device) for a in args)
            T_p, _, rot = frame_mod.svi_prior(tr.state.T_wc, d, om, ac, va, tr.velocity,
                                              tr._R_ci, tr._bias_gyro, tr._bias_accel)
            priors.append((T_p.cpu().numpy(), rot.cpu().numpy()))
        worst["prior"] = max(worst["prior"], float(np.abs(priors[0][0] - priors[1][0]).max()))
        worst["rot_total"] = max(worst["rot_total"],
                                 float(np.abs(priors[0][1] - priors[1][1]).max()))
        a = cpu.process_imu_samples(L, R, *block)
        b = gpu.process_imu_samples(L, R, *block)
        for name in ("posit_ok", "is_keyframe", "n_tracked", "inliers"):
            require(int(getattr(a, name)) == int(getattr(b, name)),
                    f"svi_gpu_vs_cpu: {name} {getattr(a, name)} on the CPU, "
                    f"{getattr(b, name)} on the card")
        A, B = np.asarray(a.T_wc, np.float64), np.asarray(b.T_wc, np.float64)
        D = A[:3, :3] @ B[:3, :3].T
        worst["pos_m"] = max(worst["pos_m"], float(np.linalg.norm(
            -A[:3, :3].T @ A[:3, 3] + B[:3, :3].T @ B[:3, 3])))
        worst["rot_rad"] = max(worst["rot_rad"], float(np.linalg.norm(
            0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]))))
        worst["vel"] = max(worst["vel"], float(np.abs(
            cpu.velocity.numpy() - gpu.velocity.cpu().numpy()).max()))
    report = {"frames": n, "image": [256, 512], "imu_samples_per_frame": sub,
              "max_diff": worst, "keyframes": len(gpu.slam_keyframes),
              "posit_ok_from_frame_1": all(bool(o.posit_ok) for o in gpu.outputs[1:])}
    require(worst["prior"] <= 1e-6 and worst["rot_total"] <= 1e-6,
            f"svi_gpu_vs_cpu: IMU prior differs: {worst}")
    require(worst["pos_m"] < 1e-4 and worst["rot_rad"] < 1e-5 and worst["vel"] < 1e-4,
            f"svi_gpu_vs_cpu: poses or velocities differ: {worst}")
    require(gpu.velocity.is_cuda and gpu.state.T_wc.is_cuda, "SVI state left the card")
    return report


def raw_from_rectified(img, K, dist, R_rect, P):
    """A raw (distorted, unrectified) image made from a rectified one: for
    every raw pixel, undistort (fixed-point iteration), rotate into the
    rectified frame and project with ``P``; sample bilinearly there. The
    inverse of what ``undistort_rectify_maps`` + ``remap_bilinear`` undo."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.ops.image import remap_bilinear

    h, w = img.shape
    k1, k2, p1, p2 = [float(c) for c in dist]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xd, yd = (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(20):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        x = (xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial
        y = (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial
    rays = np.stack([x, y, np.ones_like(x)], -1) @ R_rect.T
    mx = P[0, 0] * rays[..., 0] / rays[..., 2] + P[0, 2]
    my = P[1, 1] * rays[..., 1] / rays[..., 2] + P[1, 2]
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(img.device)  # noqa: E731
    return remap_bilinear(img, t(mx), t(my))


def run_svi_rectified(device) -> dict:
    """The front of the real-data path at the VI sensor's size, 480 x 752:
    ``stereo_rectify`` -> ``undistort_rectify_maps`` from the shipped
    vi_sensor calibration, raw frames made from rendered rectified ones,
    ``equalize_hist`` and ``remap_bilinear`` on the card against the CPU
    (the same bits), then 16 frames of ``process_imu_samples`` with
    ``equalize=True``, those maps and the rig's ``T_cam_imu``."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch import config
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker
    from svi_mapper_tpu_torch.ops import image

    cl = config.load_camera_calibration("vi_sensor_camera_left.txt")
    cr = config.load_camera_calibration("vi_sensor_camera_right.txt")
    w, h = cl.width, cl.height
    T_10 = cr.T_cam_imu @ np.linalg.inv(cl.T_cam_imu)
    R0, R1, P0, P1 = image.stereo_rectify(cl.K, cl.dist, cr.K, cr.dist, T_10, w, h)
    maps = (*image.undistort_rectify_maps(cl.K, cl.dist, R0, P0, w, h),
            *image.undistort_rectify_maps(cr.K, cr.dist, R1, P1, w, h))
    cam = StereoCamera(
        left=pinhole_from_projection(P0, w, h, K=cl.K, dist=cl.dist, R_rect=R0,
                                     device=device),
        right=pinhole_from_projection(P1, w, h, K=cr.K, dist=cr.dist, R_rect=R1,
                                      device=device))
    n, sub, dt = 16, 10, 0.005
    fine = fine_trajectory(n, sub, dt)
    raw = []
    for T in fine[::sub][:n]:
        L, R = synthetic.render_stereo(cam, T)
        raw.append((raw_from_rectified(L, cl.K, cl.dist, R0, P0),
                    raw_from_rectified(R, cr.K, cr.dist, R1, P1)))
    # equalize + remap of every raw frame, card against CPU
    err_eq = err_rm = 0.0
    for pair in raw:
        for k, img in enumerate(pair):
            mx, my = maps[2 * k], maps[2 * k + 1]
            outs = []
            for dev in (device, torch.device("cpu")):
                eq = image.equalize_hist(image.to_u8(img.to(dev)))
                rm = image.remap_bilinear(eq, torch.from_numpy(mx).to(dev),
                                          torch.from_numpy(my).to(dev))
                outs.append((eq.cpu(), rm.cpu()))
            err_eq = max(err_eq, float((outs[0][0] - outs[1][0]).abs().max()))
            err_rm = max(err_rm, float((outs[0][1] - outs[1][1]).abs().max()))
    # the rig's IMU measures in its own frame: camera-frame rates and forces
    # rotate back through T_cam_imu before they are fed
    omega_c, accel_c = imu.synthesize_measurements(fine, dt, noise_gyro=0.002,
                                                   noise_accel=0.04, seed=5, device="cpu")
    R_ci = cl.T_cam_imu[:3, :3]
    omega_i, accel_i = omega_c @ R_ci, accel_c @ R_ci
    up = np.array([0.0, -1.0, 0.0])
    calib = zero_calibration()
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=N_LANDMARKS,
                                 max_detections=N_LANDMARKS)
    tr = StereoInertialTracker(cam, calib, params, rectify_maps=maps, equalize=True,
                               T_cam_imu=cl.T_cam_imu, enable_loop_closure=False,
                               device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    for i, (L, R) in enumerate(raw):
        if i == 0:
            tr.process_imu_samples(L, R, np.full(1, dt, np.float32), np.zeros((1, 3)),
                                   ((up * imu.GRAVITY) @ R_ci)[None])
        else:
            sl = slice((i - 1) * sub, i * sub)
            tr.process_imu_samples(L, R, np.full(sub, dt, np.float32), omega_i[sl],
                                   accel_i[sl])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    traj = tr.trajectory_array
    report = {
        "phase": "svi_rectified", "frames": n, "image": [h, w],
        "baseline_m": cam.baseline, "equalize_hist_card_vs_cpu_max_abs_err": err_eq,
        "remap_bilinear_card_vs_cpu_max_abs_err": err_rm,
        "ms_per_frame": 1e3 * seconds / n,
        "posit_ok": [bool(o.posit_ok) for o in tr.outputs],
        "n_tracked_min": min(int(o.n_tracked) for o in tr.outputs[1:]),
        "ate_m": ev.ate_rmse(traj, fine[::sub][:n]),
        "launches": counts,
    }
    emit(report)
    require(err_eq == 0.0 and err_rm == 0.0,
            f"equalize_hist / remap_bilinear differ between card and CPU: {err_eq}, {err_rm}")
    require(np.isfinite(traj).all(), "a pose of svi_rectified is not finite")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS),
            f"kernel not launched on svi_rectified: {counts}")
    return report


# ---------------------------------------------------------------------------
# checkpoint and resume; the photometric stress worlds; the stage budget
# ---------------------------------------------------------------------------

def run_checkpoint_resume(device, keep: dict) -> tuple[dict, dict]:
    """The SV loop resumed from the checkpoint ``run_slam_loop`` saved after
    frame 95: ``load_checkpoint`` onto the card must give the saved system's
    state bit for bit; the resumed system runs frames 96-127 and must record
    the uninterrupted run's poses bit for bit; then it finishes the loop and
    the back-end and must pass the loop's accuracy checks. The in-run BoW
    vocabulary is not in the file (ROADMAP F12): the resumed database trains
    a new one at its next keyframe over all stored pools, so later closure
    shortlists may differ from the uninterrupted run's; what differs at frame
    128 is reported."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    tr = load_checkpoint(keep["path"])          # device=None: onto the card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    roundtrip = snapshot_differences(keep["at_save"], system_snapshot(tr))
    on_card = tr.state.T_wc.is_cuda and tr.db.desc.is_cuda and tr.db.prob.is_cuda
    imgs_l, imgs_r = keep["imgs"]
    seq, ref = keep["seq"], keep["report"]
    windows = []
    record_ba_windows(tr, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        outs = tr.process_many(imgs_l[CKPT_FRAME:CKPT_END], imgs_r[CKPT_FRAME:CKPT_END],
                               chunk=LOOP_CHUNK)
        at_end = system_snapshot(tr)
        outs += tr.process_many(imgs_l[CKPT_END:], imgs_r[CKPT_END:], chunk=LOOP_CHUNK)
        tr.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    got = at_end["trajectory"][CKPT_FRAME:CKPT_END]
    want = keep["at_end"]["trajectory"][CKPT_FRAME:CKPT_END]
    differ = [CKPT_FRAME + i for i in range(len(got)) if got[i].tobytes() != want[i].tobytes()]
    opt = tr.optimized_trajectory()
    raw = tr.trajectory_array
    ate_rec, ate_opt = ev.ate_rmse(raw, seq.poses_wc), ev.ate_rmse(opt, seq.poses_wc)
    closure_err = closure_errors(tr, seq.poses_wc)
    st = tr.stats
    report = {
        "phase": "checkpoint_resume", "saved_after_frame": CKPT_FRAME - 1,
        "file_mib": keep["path"].stat().st_size / 2 ** 20, "load_seconds": load_s,
        "roundtrip_fields_compared": len(keep["at_save"]), "roundtrip_differs_in": roundtrip,
        "on_card": on_card,
        "resumed_frames": [CKPT_FRAME, CKPT_END - 1], "resumed_frames_differ_at": differ,
        "state_at_frame_128_differs_in": snapshot_differences(keep["at_end"], at_end),
        "seconds_resumed_to_end": seconds,
        "keyframes": len(tr.slam_keyframes), "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in tr.accepted_closures],
        "closure_transform_err_m": closure_err,
        "ate_recorded_m": ate_rec, "ate_optimised_m": ate_opt,
        "uninterrupted": {k: ref[k] for k in ("keyframes", "stats", "accepted_closures",
                                              "ate_recorded_m", "ate_optimised_m")},
        "ate_optimised_minus_uninterrupted_m": ate_opt - ref["ate_optimised_m"],
        "ba_windows": windows_by_shape(windows, counts),
        "launches": counts,
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
    }
    emit(report)
    require(not roundtrip, f"the checkpoint round trip changed {roundtrip}")
    require(on_card, "the loaded system is not on the card")
    require(not differ, f"resumed frames {differ} differ from the uninterrupted run")
    require(len(outs) == LOOP_FRAMES - CKPT_FRAME and np.isfinite(opt).all(),
            "the resumed loop did not finish")
    require(st["closures_accepted"] >= 1 and closure_err
            and max(closure_err) < LOOP_CLOSURE_ERR_M,
            f"resumed loop: closures {closure_err} m from the ground truth, {st}")
    require(ate_opt < LOOP_ATE_BOUND_M, f"resumed loop: optimised ATE {ate_opt} m")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + (CLOSURE_KERNEL,))
            and counts["schur_assemble"] + counts["schur_assemble_tiled"] > 0,
            f"kernel not launched on the resumed loop: {counts}")
    require(counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"{k2_calls.calls} scanline matches and {scorings.calls} pool scorings "
            f"against launches {counts}")
    return report, counts


def run_checkpoint_svi(device, keep: dict) -> tuple[dict, dict]:
    """The stereo-inertial loop resumed from the checkpoint ``run_svi_loop``
    saved after frame 95: the round trip onto the card bit for bit (the
    velocity, gravity observations, ``T_cam_imu`` and calibration among the
    fields), and frames 96-127 resumed bit for bit."""
    import torch

    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    tr = load_checkpoint(keep["path"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    roundtrip = snapshot_differences(keep["at_save"], system_snapshot(tr))
    svi_fields = sorted(k for k in keep["at_save"] if k.startswith("svi__"))
    imgs_l, imgs_r = keep["imgs"]
    dts, oms, acs = keep["blocks"]
    a, b = CKPT_FRAME, CKPT_END
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        tr.process_many_imu(imgs_l[a:b], imgs_r[a:b], dts[a:b], oms[a:b], acs[a:b],
                            chunk=LOOP_CHUNK)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    at_end = system_snapshot(tr)
    got, want = at_end["trajectory"][a:b], keep["at_end"]["trajectory"][a:b]
    differ = [a + i for i in range(len(got)) if got[i].tobytes() != want[i].tobytes()]
    report = {
        "phase": "checkpoint_svi", "saved_after_frame": a - 1,
        "file_mib": keep["path"].stat().st_size / 2 ** 20, "load_seconds": load_s,
        "roundtrip_fields_compared": len(keep["at_save"]), "svi_fields": svi_fields,
        "roundtrip_differs_in": roundtrip,
        "resumed_frames": [a, b - 1], "resumed_frames_differ_at": differ,
        "velocity_at_frame_128_equal": (at_end["svi__velocity"].tobytes()
                                        == keep["at_end"]["svi__velocity"].tobytes()),
        "state_at_frame_128_differs_in": snapshot_differences(keep["at_end"], at_end),
        "seconds": seconds, "launches": counts,
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
    }
    emit(report)
    require(len(svi_fields) == 9, f"stereo-inertial fields compared: {svi_fields}")
    require(not roundtrip, f"the checkpoint round trip changed {roundtrip}")
    require(tr.velocity.is_cuda and tr.state.T_wc.is_cuda, "the loaded tracker is not on the card")
    require(not differ, f"resumed frames {differ} differ from the uninterrupted run")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS)
            and counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"kernels on the resumed frames: {counts}, {k2_calls.calls} scanline matches, "
            f"{scorings.calls} pool scorings")
    return report, counts


# the JAX package's SLAMSystem on the same stressed loop on a CPU
# (compare_stress_loop.py jax): behaviour to compare and the ATE the port's
# run is bounded by (at most STRESS_ATE_FACTOR times), no time taken from it
STRESS_JAX_CPU = {"keyframes": 44, "closures_accepted": 2, "accepted_closures": [[1, 38], [5, 43]],
                  "ate_recorded_m": 0.190212555750364, "ate_optimised_m": 0.19231380532112904}
STRESS_ATE_FACTOR = 2.0
STRESS_MIN_TRACKED = 40        # tests/test_stress.py's bound, from frame 5 on
ALIAS_FRAMES, ALIAS_PERIOD_M = 160, 24.0


def wall_crossings(poses, reach: int):
    """Frames where the loop passes the plane of the corridor's wall at
    x = 9 m, and the frames within ``reach`` of one."""
    import numpy as np

    centres = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
    side = centres[:, 0] > 9.0
    crossings = [i for i in range(1, len(poses)) if side[i] != side[i - 1]]
    return crossings, {i + d for i in crossings for d in range(-reach, reach + 1)}


def run_stress_loop(device) -> tuple[dict, dict]:
    """The SV loop of ``slam_loop`` rendered with the moderate photometric
    stress (``io.stress.StressedSequence``: read noise, exposure and gamma
    drift, blur, vignetting, a blank-wall span, sheen, an occluder panel)
    on the card, through ``SLAMSystem.process_many(chunk=32)`` ->
    ``finalize_backend()``, as ``tests/test_stress.py`` holds the JAX
    package: at least 40 landmarks tracked from frame 5 on (but within two
    frames of a wall crossing, where the JAX package too drops below), at
    least one closure within 0.5 m of the truth, and the recorded and
    optimised ATE at most twice the JAX package's on the same loop."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.stress import StressedSequence
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=N_LANDMARKS, max_detections=N_LANDMARKS,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5)
    seq = StressedSequence(n_frames=LOOP_FRAMES, width=W_RAW, height=H, trajectory="loop",
                           loop_radius=LOOP_RADIUS, stress="moderate", device=device)
    t0 = time.perf_counter()
    imgs_l = torch.empty((LOOP_FRAMES, H, W_RAW), dtype=torch.float32, device=device)
    imgs_r = torch.empty_like(imgs_l)
    for i in range(LOOP_FRAMES):
        imgs_l[i], imgs_r[i], _ = seq.frame(i)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    slam = SLAMSystem(seq.cam, params, device=device)
    windows = []
    record_ba_windows(slam, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        outs = slam.process_many(imgs_l, imgs_r, chunk=LOOP_CHUNK)
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    opt = slam.optimized_trajectory()
    raw = slam.trajectory_array
    ate_rec, ate_opt = ev.ate_rmse(raw, seq.poses_wc), ev.ate_rmse(opt, seq.poses_wc)
    crossings, near_wall = wall_crossings(seq.poses_wc, 2)
    tracked = [int(o.n_tracked) for o in outs]
    low = {i: n for i, n in enumerate(tracked) if i >= 5 and n < STRESS_MIN_TRACKED}
    closure_err = closure_errors(slam, seq.poses_wc)
    st = slam.stats
    report = {
        "phase": "stress_loop", "stress": "moderate", "frames": LOOP_FRAMES,
        "image": [H, W_RAW], "chunk": LOOP_CHUNK, "render_seconds": render_s,
        "seconds": seconds, "frames_per_s": LOOP_FRAMES / seconds,
        "keyframes": len(slam.slam_keyframes), "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
        "closure_transform_err_m": closure_err,
        "ate_recorded_m": ate_rec, "ate_optimised_m": ate_opt,
        "jax_package_cpu": STRESS_JAX_CPU, "ate_factor_bound": STRESS_ATE_FACTOR,
        "n_tracked_min_from_frame_5": min(tracked[5:]),
        "frames_tracked_below_bound": low, "wall_crossings_at_frames": crossings,
        "posit_rejected_at_frames": [i for i, o in enumerate(outs[1:], 1)
                                     if not bool(o.posit_ok)],
        "ba_windows": windows_by_shape(windows, counts),
        "launches": counts,
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
    }
    emit(report)
    require(len(outs) == LOOP_FRAMES and np.isfinite(opt).all(), "stressed loop: poses")
    bad = {i: n for i, n in low.items() if i not in near_wall}
    require(not bad, f"stressed loop: fewer than {STRESS_MIN_TRACKED} landmarks tracked at "
            f"{bad} (wall crossings at {crossings})")
    require(st["closures_accepted"] >= 1 and closure_err
            and min(closure_err) < LOOP_CLOSURE_ERR_M,
            f"stressed loop: closures {closure_err} m from the ground truth, {st}")
    for key, got in (("ate_recorded_m", ate_rec), ("ate_optimised_m", ate_opt)):
        require(got <= STRESS_ATE_FACTOR * STRESS_JAX_CPU[key],
                f"stressed loop: {key} {got} m against the JAX package's "
                f"{STRESS_JAX_CPU[key]} m")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + (CLOSURE_KERNEL,))
            and counts["schur_assemble"] + counts["schur_assemble_tiled"] > 0,
            f"kernel not launched on the stressed loop: {counts}")
    require(counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"{k2_calls.calls} scanline matches and {scorings.calls} pool scorings "
            f"against launches {counts}")
    return report, counts


def run_stress_alias(device) -> tuple[dict, dict]:
    """The aliased corridor of ``tests/test_stress.py``: 160 frames at 512 x
    256 of a straight corridor whose texture repeats every 24 m, probabilistic
    closure matching, local BA and loop closure on. Every place has a
    pixel-identical twin 24 and 48 m away and no place is revisited, so any
    accepted closure is a false one: none may be accepted."""
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=512, max_detections=512,
        keyframe_translation_m2=9.0, closure_probabilistic=True)
    seq = synthetic.SyntheticSequence(n_frames=ALIAS_FRAMES, width=512, height=256,
                                      step=0.4, alias_period=ALIAS_PERIOD_M, device=device)
    imgs = [seq.frame(i) for i in range(ALIAS_FRAMES)]
    imgs_l = torch.stack([f[0] for f in imgs])
    imgs_r = torch.stack([f[1] for f in imgs])
    slam = SLAMSystem(seq.cam, params, enable_local_ba=True, enable_loop_closure=True,
                      device=device)
    windows = []
    record_ba_windows(slam, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        slam.process_many(imgs_l, imgs_r, chunk=16)
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    st = slam.stats
    report = {
        "phase": "stress_alias", "frames": ALIAS_FRAMES, "image": [256, 512],
        "alias_period_m": ALIAS_PERIOD_M, "closure_probabilistic": True,
        "seconds": seconds, "keyframes": len(slam.slam_keyframes),
        "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
        "ba_windows": windows_by_shape(windows, counts),
        "launches": counts,
        "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls,
    }
    emit(report)
    require(len(slam.slam_keyframes) >= 12, f"{len(slam.slam_keyframes)} keyframes")
    require(st["closures_accepted"] == 0,
            f"false closures accepted in the aliased corridor: {report['accepted_closures']}")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + (CLOSURE_KERNEL,))
            and counts["stereo_match"] == k2_calls.calls
            and counts[CLOSURE_KERNEL] == scorings.calls,
            f"kernels on the aliased corridor: {counts}, {k2_calls.calls} scanline "
            f"matches, {scorings.calls} pool scorings")
    return report, counts


STAGES = ("dense_brief_x2", "tracking_window", "stereo_rematch", "posit_gn",
          "regional_recovery", "landmark_gn", "detect_corners", "ba_window_10lm",
          "ba_window_prep", "pose_graph_64kf", "closure_match_icp", "closure_query_fused")


def run_stage_budget(device, smi: str) -> tuple[dict, dict]:
    """``eval.stage_bench.stage_budget()`` at 1241 x 376 on the card: each
    stage timed alone between two synchronisations, ten calls (five for BA
    and the pose graph)."""
    import math

    from svi_mapper_tpu_torch.eval import stage_bench

    reset_launch_counts()
    t0 = time.perf_counter()
    budget = stage_bench.stage_budget(width=W_RAW, height=H, reps=10, device=device)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    report = {"phase": "stage_budget", "card": smi, "image": [H, W_RAW],
              "ms": budget, "table": stage_bench.format_budget(budget).splitlines(),
              "seconds": seconds, "launches": counts}
    emit(report)
    require(tuple(budget) == STAGES and all(math.isfinite(v) and v > 0
                                            for v in budget.values()),
            f"stage budget: {budget}")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + ("schur_assemble", CLOSURE_KERNEL)),
            f"kernel not launched by the stage budget: {counts}")
    return report, counts


# ---------------------------------------------------------------------------
# the worker threads, the native runtime and its tools
# ---------------------------------------------------------------------------

def worker_launches(thread_prefix: str) -> dict:
    """Launches per kernel entry by the threads whose names start with
    ``thread_prefix`` since the counts were last set to 0."""
    from svi_mapper_tpu_torch.ops import paths

    out = dict.fromkeys(launch_counts(), 0)
    for name, tally in paths.launch_counts_by_thread().items():
        if name.startswith(thread_prefix):
            for k, v in tally.items():
                out[k] += v
    return out


def same_revisits(a: list, b: list, radius: int) -> bool:
    """Every accepted closure of one list has one of the other within
    ``radius`` keyframes at both ends (the dedup rule's notion of one
    revisit event), both ways."""
    near = lambda e, others: any(abs(e[0] - o[0]) <= radius and abs(e[1] - o[1]) <= radius  # noqa: E731
                                 for o in others)
    return all(near(e, b) for e in a) and all(near(e, a) for e in b)


def run_worker_loop(device, loop: dict, option: dict, phase: str,
                    thread_prefix: str) -> tuple[dict, dict, object]:
    """The bench loop through ``SLAMSystem(**option)``: ``process_many(chunk=32)``
    -> ``flush_closures(block=True)`` -> ``finalize_backend()``, timed as
    ``slam_loop`` times its run, with the card's idle share. Returns the
    report's common part, the launch counts, the system (not closed) and
    the common checks as ``(passed, message)`` pairs, for the caller to
    require after it printed its report."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    params = loop_params()
    seq, imgs_l, imgs_r, render_s = render_loop(device)
    windows = []
    slam = SLAMSystem(seq.cam, params, device=device, **option)
    record_ba_windows(slam, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    with UtilSampler() as util:
        outs = slam.process_many(imgs_l, imgs_r, chunk=LOOP_CHUNK)
        slam.flush_closures(block=True)
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    on_worker = worker_launches(thread_prefix)
    opt = slam.optimized_trajectory()
    raw = slam.trajectory_array
    st = slam.stats
    n_kf = len(slam.slam_keyframes)
    accepted = [[c.ref_kf, c.query_kf] for c in slam.accepted_closures]
    crossings, at_wall = wall_crossings(seq.poses_wc, 1)
    rejected = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]
    report = {
        "phase": phase, "option": {k: v for k, v in option.items()},
        "frames": LOOP_FRAMES, "image": [H, W_RAW], "chunk": LOOP_CHUNK,
        "render_seconds": render_s, "seconds": seconds,
        "frames_per_s": LOOP_FRAMES / seconds,
        "slam_loop_frames_per_s": loop["frames_per_s"],
        "card_idle_share": util.idle_share(), "util_samples": len(util.samples),
        "slam_loop_card_idle_share": loop.get("card_idle_share"),
        "keyframes": n_kf, "slam_loop_keyframes": loop["keyframes"],
        "stats": {k: int(v) for k, v in st.items()},
        "accepted_closures": accepted,
        "slam_loop_accepted_closures": loop["accepted_closures"],
        "closures_found": int(st["closures_found"]),
        "slam_loop_closures_found": loop["stats"]["closures_found"],
        "same_closures_as_slam_loop": (
            int(st["closures_found"]) == loop["stats"]["closures_found"]
            and accepted == loop["accepted_closures"]),
        "same_revisits_as_slam_loop": same_revisits(
            accepted, loop["accepted_closures"], params.closure_dedup_radius_kf),
        "closure_transform_err_m": closure_errors(slam, seq.poses_wc),
        "ate_recorded_m": ev.ate_rmse(raw, seq.poses_wc),
        "ate_optimised_m": ev.ate_rmse(opt, seq.poses_wc),
        "slam_loop_ate_optimised_m": loop["ate_optimised_m"],
        "ba_windows": windows_by_shape(windows, counts),
        "posit_rejected_at_frames": rejected, "wall_crossings_at_frames": crossings,
        "timings_s": {k: float(v) for k, v in slam.timings.items()},
        "launches": counts, "launches_on_worker": on_worker,
    }
    bad = [i for i in rejected if i not in at_wall]
    checks = [(len(outs) == LOOP_FRAMES and not bad,
               f"{phase}: pose solve rejected on frames {bad}"),
              (all(np.isfinite(kf.T_wc).all() for kf in slam.slam_keyframes),
               f"{phase}: NaN in a keyframe pose"),
              (np.isfinite(opt).all(), f"{phase}: NaN in the optimised trajectory"),
              (slam.db.n == n_kf and slam.db.desc.device == imgs_l.device,
               f"{phase}: database")]
    return report, counts, slam, checks


def run_async_closure(device, loop: dict) -> tuple[dict, dict]:
    """The bench loop with the closure search on its worker thread
    (``async_closure=True``). Gates: the accepted closures are the revisit
    events ``slam_loop`` accepted (within the dedup radius; whether found
    and accepted closures are the same exactly is reported), each within
    0.5 m of the truth; no search pending; optimised ATE < 0.5 m; K6's pool
    count launched on the closure worker. The revisit events and not the
    exact edges: on this chunked path the JAX package's own async run folds
    a closure a keyframe later than its synchronous run, which changes the
    keyframes and closures found after it but not the revisit events
    accepted (``tests/test_torch_async_closure_chunked.py``, where the
    port's chunked async run equals the JAX package's exactly)."""
    report, counts, slam, checks = run_worker_loop(
        device, loop, {"async_closure": True}, "async_closure", "loop-closure")
    report["pending_after_flush"] = len(slam._pending_closures)
    emit(report)
    for passed, message in checks:
        require(passed, message)
    st = slam.stats
    require(st["closures_accepted"] >= 1, f"async_closure: no closure accepted: {st}")
    require(report["same_revisits_as_slam_loop"],
            f"async_closure: closures {report['accepted_closures']} against "
            f"slam_loop's {loop['accepted_closures']}")
    require(max(report["closure_transform_err_m"]) < LOOP_CLOSURE_ERR_M,
            f"async_closure: closures off by {report['closure_transform_err_m']} m")
    require(not slam._pending_closures, "async_closure: a search is still pending")
    require(report["ate_optimised_m"] < LOOP_ATE_BOUND_M,
            f"async_closure: ATE {report['ate_optimised_m']} m")
    require(report["launches_on_worker"][CLOSURE_KERNEL] > 0,
            f"async_closure: K6 not launched on the worker: {report['launches_on_worker']}")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS + ("schur_assemble",)),
            f"async_closure: kernel not launched: {counts}")
    slam.close()
    return report, counts


def run_overlap_backend(device, loop: dict) -> tuple[dict, dict]:
    """The bench loop with the whole keyframe tail on the back-end worker
    (``overlap_backend="force"``). Gates: the worker ran; closures, pose
    graph and BA each ran; every future drained and every fold applied;
    optimised ATE < max(1.25 x slam_loop's, 0.25 m) and < 0.5 m; K4 launched
    on the worker. Then ``overlap_backend=True`` on the one card must warn
    and run synchronously."""
    import warnings

    import torch

    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    report, counts, slam, checks = run_worker_loop(
        device, loop, {"overlap_backend": "force"}, "overlap_backend", "backend")
    report.update(worker_set=slam._bk_pool is not None,
                  futures_left=len(slam._bk_futures),
                  folds_left=slam._bk_folds.qsize(),
                  folds_applied=slam._fold_version,
                  ate_bound_m=min(max(1.25 * loop["ate_optimised_m"], 0.25),
                                  LOOP_ATE_BOUND_M))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = SLAMSystem(slam.cam, loop_params(), device=device, overlap_backend=True)
    report["true_on_one_card"] = {
        "warned": any("single visible device" in str(w.message) for w in caught),
        "worker": one._bk_pool is not None, "cards": torch.cuda.device_count()}
    one.close()
    emit(report)
    for passed, message in checks:
        require(passed, message)
    st = slam.stats
    require(report["worker_set"], "overlap_backend: no back-end worker")
    require(st["closures_accepted"] >= 1 and st["pose_graph_runs"] >= 1
            and st["ba_runs"] >= 1, f"overlap_backend: the loop was not closed: {st}")
    require(report["futures_left"] == 0 and report["folds_left"] == 0,
            "overlap_backend: work left on the queue")
    require(report["ate_optimised_m"] < report["ate_bound_m"],
            f"overlap_backend: ATE {report['ate_optimised_m']} m, bound "
            f"{report['ate_bound_m']} m")
    require(report["launches_on_worker"]["schur_assemble"] > 0,
            f"overlap_backend: K4 not launched on the worker: {report['launches_on_worker']}")
    require(report["launches_on_worker"][CLOSURE_KERNEL] > 0,
            f"overlap_backend: K6 not launched on the worker: {report['launches_on_worker']}")
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS),
            f"overlap_backend: kernel not launched: {counts}")
    require(report["true_on_one_card"]["warned"] and not report["true_on_one_card"]["worker"],
            f"overlap_backend=True on one card: {report['true_on_one_card']}")
    slam.close()
    require(slam._bk_pool is None, "overlap_backend: close() left the worker")
    return report, counts


DUMP_FRAMES = 32


def run_native_runtime(device) -> tuple[dict, dict]:
    """The port's C++ host runtime, built from ``native/src`` with g++:
    (1) the closure database of ``closure_query`` with the native index and
    no vocabulary, so that the tree shortlists every query, as
    ``SLAMSystem`` queries (probabilistic matching) and with exact matching
    (K6's matrix); votes and results card == CPU; no decoy accepted;
    (2) the bench loop's first 32 frames through ``tools/make_dump``, read
    back by ``DumpReader(prefetch=4)``, ``validate_dump`` == 32, and tracked
    by ``StereoTracker`` to the same bits as the same 8-bit frames from
    memory; (3) a ``.svic`` round trip, bit for bit, of the clouds
    ``io.cloud.cloud_from_slam_state`` took of the dump replay's state after
    each frame. Returns the report and the launch counts of the closure
    queries (``queries``) and of the dump replay (``dump``), each set to 0
    just before its run and read just after."""
    import dataclasses as dc

    import numpy as np
    import torch

    from svi_mapper_tpu_torch import native
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io import cloud as cloud_mod
    from svi_mapper_tpu_torch.mapping import closure
    from svi_mapper_tpu_torch.models.slam import closure_kwargs
    from svi_mapper_tpu_torch.models.tracker import StereoTracker
    from svi_mapper_tpu_torch.native import build
    from svi_mapper_tpu_torch.ops import cuda_build
    from svi_mapper_tpu_torch.ops.descriptors import words_to_numpy
    from svi_mapper_tpu_torch.tools import make_dump

    t0 = time.perf_counter()
    require(native.available(), f"native library: {native.load_error()}")
    build_s = time.perf_counter() - t0
    lib_path = build.library_path()
    require(native._lib._name == str(lib_path) and lib_path.parent == cuda_build.BUILD_DIR,
            f"native library loaded from {native._lib._name}")

    # (1) the tree shortlist on the closure database
    keyframes, T_true = closure_keyframes(seed=13)
    kw = closure_kwargs(DEFAULT_PARAMS)
    kw_exact = dict(kw, probabilistic=False)
    t0 = time.perf_counter()
    db = fill_closure_database(keyframes, device, native_index=True, auto_vocab=False)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    require(db.n == CLOSURE_KEYFRAMES and db.bow is None and db.index is not None,
            "native database: keyframes, vocabulary or index")
    require(db.index.size == sum(len(kf["desc"]) for kf in keyframes),
            f"native index holds {db.index.size} descriptors")
    reset_launch_counts()
    t0 = time.perf_counter()
    found = closure.find_closures_batch(db, CLOSURE_QUERIES, **kw)
    query_s = time.perf_counter() - t0
    found_exact = closure.find_closures_batch(db, CLOSURE_QUERIES, **kw_exact)
    torch.cuda.synchronize()
    counts = launch_counts()
    desc_q = words_to_numpy(db.desc[CLOSURE_QUERIES[0]: CLOSURE_QUERIES[-1] + 1])
    valid_q = db.valid[CLOSURE_QUERIES[0]: CLOSURE_QUERIES[-1] + 1].cpu().numpy()
    exclude = kw["exclude_recent"]
    t0 = time.perf_counter()
    votes = [db.index.query(d[v], cutoff=kw["hamming_cutoff"], max_keyframe=q - exclude)
             for q, d, v in zip(CLOSURE_QUERIES, desc_q, valid_q)]
    tree_s = (time.perf_counter() - t0) / len(CLOSURE_QUERIES)

    t0 = time.perf_counter()
    db_cpu = fill_closure_database(keyframes, "cpu", native_index=True, auto_vocab=False)
    found_cpu = closure.find_closures_batch(db_cpu, CLOSURE_QUERIES, **kw)
    found_exact_cpu = closure.find_closures_batch(db_cpu, CLOSURE_QUERIES, **kw_exact)
    cpu_s = time.perf_counter() - t0
    votes_cpu = [db_cpu.index.query(
        words_to_numpy(db_cpu.desc[q])[db_cpu.valid[q].numpy()], cutoff=kw["hamming_cutoff"],
        max_keyframe=q - exclude) for q in CLOSURE_QUERIES]
    worst_T = 0.0
    for a_all, b_all in ((found, found_cpu), (found_exact, found_exact_cpu)):
        for q, a, b in zip(CLOSURE_QUERIES, a_all, b_all):
            require([(c.ref_kf, c.matches, c.inliers) for c in a]
                    == [(c.ref_kf, c.matches, c.inliers) for c in b],
                    f"native route, query {q}: card and CPU disagree")
            for x, y in zip(a, b):
                worst_T = max(worst_T, float(np.abs(x.T_qr - y.T_qr).max()))
    require(worst_T < 1e-3, f"native route T_qr card vs CPU: {worst_T}")
    require(all(np.array_equal(a, b) for a, b in zip(votes, votes_cpu)),
            "tree votes differ between the card's and the CPU's database")
    t_err = {}
    for q, cands in zip(CLOSURE_QUERIES, found):
        refs = [c.ref_kf for c in cands]
        require(q in CLOSURE_REVISITS or refs == [], f"native route: query {q} accepted {refs}")
        if q in CLOSURE_REVISITS and refs == [CLOSURE_REVISITS[q]]:
            t_err[str(q)] = float(np.abs(cands[0].T_qr - T_true[q]).max())
    require(all(e < T_QR_TOL for e in t_err.values()), f"native route T_qr: {t_err}")

    # (2) the loop's first frames through the dump
    params = loop_params()
    seq, imgs_l, imgs_r, _ = render_loop(device)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as d:
        path = Path(d) / "loop.svid"
        t0 = time.perf_counter()
        n_valid_write = make_dump.dump_sequence(seq, path, DUMP_FRAMES)
        dump_write_s = time.perf_counter() - t0
        dump_bytes = path.stat().st_size
        t0 = time.perf_counter()
        with native.DumpReader(path, prefetch=4) as r:
            dims = (r.n_frames, r.height, r.width)
            dumped = list(r)
        dump_read_s = time.perf_counter() - t0
        n_valid = native.validate_dump(path)
    memory = [(make_dump.to_u8(imgs_l[i]), make_dump.to_u8(imgs_r[i]))
              for i in range(DUMP_FRAMES)]
    same_images = all(np.array_equal(a[0], b[2]) and np.array_equal(a[1], b[3])
                      for a, b in zip(memory, dumped))
    runs, loop_clouds = {}, []
    for name, frames in (("memory", memory), ("dump", [(f[2], f[3]) for f in dumped])):
        tr = StereoTracker(seq.cam, params, device=device)
        if name == "dump":
            reset_launch_counts()
        t0, capture_s = time.perf_counter(), 0.0
        for i, (L, R) in enumerate(frames):
            tr.process(torch.from_numpy(L).to(device, torch.float32),
                       torch.from_numpy(R).to(device, torch.float32))
            if name == "dump":
                # the cloud the system writes, of this frame's state (its
                # host reads left out of the replay's time)
                t1 = time.perf_counter()
                loop_clouds.append(cloud_mod.cloud_from_slam_state(tr.state, i, i))
                capture_s += time.perf_counter() - t1
        torch.cuda.synchronize()
        runs[name] = (tr, time.perf_counter() - t0 - capture_s)
    dump_counts = launch_counts()

    # (3) .svic round trip of the dump replay's clouds
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as d:
        d = Path(d)
        t0 = time.perf_counter()
        for c in loop_clouds:
            cloud_mod.save_cloud(d / f"kf{c.keyframe_id:04d}.svic", c)
        write_s = time.perf_counter() - t0
        svic_bytes = sum(p.stat().st_size for p in d.glob("*.svic"))
        t0 = time.perf_counter()
        back = [cloud_mod.load_cloud(d / f"kf{c.keyframe_id:04d}.svic") for c in loop_clouds]
        read_s = time.perf_counter() - t0
        for c in loop_clouds[:4]:
            cloud_mod.save_cloud(d / f"kf{c.keyframe_id:04d}.npz", c)
        npz_bytes = sum(p.stat().st_size for p in d.glob("*.npz"))
    fields = ("T_wc", "uids", "points_w", "points_cam", "uv_left", "uv_right", "descriptors")
    cloud_diff = [(c.keyframe_id, f) for c, b in zip(loop_clouds, back) for f in fields
                  if not np.array_equal(np.asarray(getattr(c, f)), np.asarray(getattr(b, f)))]
    cloud_diff += [(c.keyframe_id, "ids") for c, b in zip(loop_clouds, back)
                   if (c.keyframe_id, c.frame_idx) != (b.keyframe_id, b.frame_idx)]

    tm, td = runs["memory"][0], runs["dump"][0]
    same_track = (np.array_equal(tm.trajectory_array, td.trajectory_array)
                  and [int(o.n_tracked) for o in tm.outputs] == [int(o.n_tracked) for o in td.outputs]
                  and [bool(o.is_keyframe) for o in tm.outputs]
                  == [bool(o.is_keyframe) for o in td.outputs])

    report = {
        "phase": "native_runtime", "library": str(lib_path.relative_to(cuda_build._PKG.parent)),
        "build_seconds": build_s,
        "closure_database": {
            "keyframes": db.n, "pool": CLOSURE_POOL, "index_descriptors": db.index.size,
            "fill_seconds": fill_s, "queries": len(CLOSURE_QUERIES),
            "ms_per_batch": 1e3 * query_s, "tree_ms_per_query": 1e3 * tree_s,
            "found": {str(q): [c.ref_kf for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
            "matches": {str(q): [c.matches for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
            "inliers": {str(q): [c.inliers for c in f] for q, f in zip(CLOSURE_QUERIES, found)},
            "found_exact": {str(q): [c.ref_kf for c in f]
                            for q, f in zip(CLOSURE_QUERIES, found_exact)},
            "revisits_found": sum(1 for q, f in zip(CLOSURE_QUERIES, found)
                                  if q in CLOSURE_REVISITS and [c.ref_kf for c in f]
                                  == [CLOSURE_REVISITS[q]]),
            "planted_revisits": len(CLOSURE_REVISITS), "decoys": len(CLOSURE_DECOYS),
            "max_T_qr_err": t_err,
            "top_votes": {str(q): int(v.max(initial=0)) for q, v in zip(CLOSURE_QUERIES, votes)},
            "voted_for_revisit": {str(q): int(np.argmax(v)) for q, v in zip(CLOSURE_QUERIES, votes)
                                  if q in CLOSURE_REVISITS},
            "card_vs_cpu": {"discrete_outputs_equal": True, "votes_equal": True,
                            "max_T_qr_diff": worst_T, "cpu_seconds": cpu_s},
        },
        "svic": {"clouds": len(loop_clouds), "source": "cloud_from_slam_state per dump frame",
                 "points": [len(c.uids) for c in loop_clouds], "bytes": svic_bytes,
                 "write_seconds": write_s, "read_seconds": read_s,
                 "write_MB_per_s": svic_bytes / 1e6 / max(write_s, 1e-9),
                 "read_MB_per_s": svic_bytes / 1e6 / max(read_s, 1e-9),
                 "npz_bytes_first_4": npz_bytes, "fields_differing": cloud_diff},
        "dump": {"frames": DUMP_FRAMES, "shape": list(dims), "bytes": dump_bytes,
                 "validated": n_valid, "validated_at_write": n_valid_write,
                 # make_dump renders each frame on the card, copies it to the
                 # host as 8 bits and appends it: the seconds include all three
                 "make_dump_seconds": dump_write_s,
                 "read_seconds": dump_read_s,
                 "read_MB_per_s": dump_bytes / 1e6 / dump_read_s,
                 "read_prefetch": 4, "images_equal": same_images,
                 "tracked_same_bits": same_track,
                 "track_seconds_memory": runs["memory"][1],
                 "track_seconds_dump": runs["dump"][1]},
        "launches_closure_queries": counts, "launches_dump_replay": dump_counts,
    }
    emit(report)
    require(not cloud_diff and len(back) == len(loop_clouds) == DUMP_FRAMES
            # no landmark is optimal in the first few frames: their clouds
            # are empty
            and sum(1 for c in loop_clouds if len(c.uids)) >= DUMP_FRAMES // 2,
            f".svic round trip: {cloud_diff}, points {[len(c.uids) for c in loop_clouds]}")
    require(n_valid == n_valid_write == DUMP_FRAMES and dims == (DUMP_FRAMES, H, W_RAW)
            and len(dumped) == DUMP_FRAMES, f"dump: {n_valid} frames, {dims}")
    require(same_images and same_track, "dump: frames or tracking differ from memory")
    require(counts["hamming_matrix"] > 0,
            f"native route: K6's matrix not launched by exact matching: {counts}")
    require(all(dump_counts[k] > 0 for k in FRONTEND_KERNELS),
            f"dump replay: front-end kernel not launched: {dump_counts}")
    return report, {"queries": counts, "dump": dump_counts}


def run_cloud_tools(device) -> tuple[dict, dict]:
    """``tools/create_cloud`` -> ``tools/match_clouds`` ->
    ``tools/bench_matching`` on the card: four clouds of 256 landmarks (the
    tools' defaults) matched all pairs, card == CPU; the benchmark of brute
    force, K6's matrix, the native tree and the probabilistic matcher on
    them and on 256 queries against 64 clouds of 256. K6's matrix is held
    against ``hamming_packed`` on the benchmark's inputs."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.io.cloud import load_cloud
    from svi_mapper_tpu_torch.ops import cuda_build
    from svi_mapper_tpu_torch.ops.descriptors import words_from_numpy, words_u32
    from svi_mapper_tpu_torch.ops.hamming import hamming_distance_matrix, hamming_packed
    from svi_mapper_tpu_torch.tools import bench_matching, create_cloud, match_clouds

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as d:
        d = Path(d)
        t0 = time.perf_counter()
        small = [load_cloud(p) for p in create_cloud.create_clouds(
            d / "small", clouds=4, points=256, svic=True, seed=0, log=lambda *a: None)]
        large = [load_cloud(p) for p in create_cloud.create_clouds(
            d / "large", clouds=65, points=256, svic=True, seed=1, log=lambda *a: None)]
        create_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = match_clouds.match_all(small, device=device)
    match_s = time.perf_counter() - t0
    benches = {"4x256": bench_matching.bench(small, device=device, reps=20),
               "65x256": bench_matching.bench(large, device=device, reps=20)}
    torch.cuda.synchronize()
    counts = launch_counts()
    rows_cpu = match_clouds.match_all(small, device="cpu")
    keys = ("query", "ref", "matches", "icp_ok", "inliers")
    require([{k: r.get(k) for k in keys} for r in rows]
            == [{k: r.get(k) for k in keys} for r in rows_cpu],
            "match_clouds: card and CPU disagree")
    worst_T = max(float(np.abs(a["T_qr"] - b["T_qr"]).max())
                  for a, b in zip(rows, rows_cpu) if "T_qr" in a)
    require(worst_T < 1e-4, f"match_clouds T_qr card vs CPU: {worst_T}")
    errs = {}
    for name, cl in (("4x256", small), ("65x256", large)):
        q = words_u32(cl[0].descriptors)
        train = np.concatenate([words_u32(c.descriptors) for c in cl[1:]])
        got = hamming_distance_matrix(words_from_numpy(q, device),
                                      words_from_numpy(train, device)).cpu()
        want = hamming_packed(words_from_numpy(q, "cpu"), words_from_numpy(train, "cpu"))
        errs[name] = int((got - want).abs().max())
    for b in benches.values():
        for k in ("matrix_s", "brute_force_s", "tree_s", "probabilistic_s"):
            b[k.replace("_s", "_ms")] = 1e3 * b.pop(k)
    report = {"phase": "cloud_tools", "create_seconds": create_s,
              "match_clouds": [{k: r.get(k) for k in keys} for r in rows],
              "match_seconds": match_s, "max_T_qr_diff_vs_cpu": worst_T,
              "bench_matching": benches, "hamming_matrix_max_abs_err": errs,
              "launches": counts}
    emit(report)
    require(all(e == 0 for e in errs.values()), f"K6's matrix against hamming_packed: {errs}")
    require(sum(1 for r in rows if r.get("icp_ok")) >= 3,
            f"match_clouds: consecutive clouds not matched: {rows}")
    require(counts["hamming_matrix"] > 0, f"cloud tools: K6's matrix not launched: {counts}")
    require(all(b["brute_force_votes"][0] > 0 for b in benches.values()),
            f"bench_matching: {benches}")
    return report, counts


# ---------------------------------------------------------------------------
# the entry points a user calls: the command-line tools on a KITTI tree, the
# offline tools, the kernel validator, the sharded BA and the utilization
# report
# ---------------------------------------------------------------------------

TOOL_TREE_FRAMES = 32          # run_kitti --gt --frames
# The tools run DEFAULT_PARAMS, whose max_motion_scaling_for_optimization
# (1.5) vetoes every BA at the loop's 0.9 m and 0.035 rad a frame (motion
# scaling ~1.8; the bench sets 2.5, and neither package's tools take the
# parameter): the tree is the same loop at twice the frame rate, which
# halves the motion per frame.
TOOL_LOOP_FRAMES = 2 * LOOP_FRAMES
KERNEL_ENTRIES = ("track_scores", "stereo_match", "brief_dense_fused", "schur_assemble",
                  "schur_assemble_tiled", "pool_nn_counts", "hamming_matrix",
                  "stereo_profiles")


def write_kitti_tree(root: Path, seq, imgs_l, imgs_r, rate_hz: float = 20.0) -> Path:
    """The loop as a KITTI odometry tree under ``root``: 8-bit grayscale
    PNGs in ``sequences/00/image_0`` / ``image_1`` (cv2, else PIL),
    ``times.txt`` at ``rate_hz``, ``calib.txt`` with the P0 / P1 of the camera
    the frames were rendered with (KITTI 00's focal length, 0.54 m
    baseline), and ``poses/00.txt`` (camera->world, 3x4 per line)."""
    import numpy as np
    import torch

    try:
        import cv2

        write = lambda path, a: cv2.imwrite(str(path), a)  # noqa: E731
    except ImportError:
        from PIL import Image

        write = lambda path, a: Image.fromarray(a).save(path)  # noqa: E731
    seq_dir = root / "sequences" / "00"
    for d in ("image_0", "image_1"):
        (seq_dir / d).mkdir(parents=True, exist_ok=True)
    to_u8 = lambda t: t.round().clamp(0, 255).to(torch.uint8)  # noqa: E731
    left, right = to_u8(imgs_l).cpu().numpy(), to_u8(imgs_r).cpu().numpy()
    for i in range(len(left)):
        write(seq_dir / "image_0" / f"{i:06d}.png", left[i])
        write(seq_dir / "image_1" / f"{i:06d}.png", right[i])
    (seq_dir / "times.txt").write_text(
        "".join(f"{i / rate_hz:.6e}\n" for i in range(len(left))))
    P = [c.P.cpu().numpy().astype(np.float64) for c in (seq.cam.left, seq.cam.right)]
    (seq_dir / "calib.txt").write_text("".join(
        f"P{k}: " + " ".join(f"{x:.12e}" for x in P[k].reshape(-1)) + "\n" for k in (0, 1)))
    (root / "poses").mkdir(exist_ok=True)
    (root / "poses" / "00.txt").write_text("".join(
        " ".join(f"{x:.12e}" for x in np.linalg.inv(np.asarray(T, np.float64))[:3].reshape(-1))
        + "\n" for T in seq.poses_wc))
    return root


def run_tool(main_fn, argv: list[str]) -> tuple[int, str, float]:
    """A tool's ``main(argv)`` in this process: (exit code, its standard
    output, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            code = main_fn(argv) or 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue(), time.perf_counter() - t0


def launched(counts: dict, names, where: str) -> None:
    missing = [n for n in names if counts[n] == 0]
    require(not missing, f"{where}: {missing} launched no time: {counts}")


def run_cli_entry_points(device, tree: Path) -> tuple[dict, dict]:
    """``tools/acceptance`` on the loop's KITTI tree with its default ATE,
    relative-error and closure gates (the throughput gate at 0, its default
    reported beside the measured frames/s), ``tools/run_kitti`` with
    ``--gt --frames 32`` and with ``--slam --chunk 32`` over the first 208
    frames, ``run_demo`` with
    its defaults and with ``--slam --trajectory loop`` round the bench loop;
    each on the card with
    the launch counts set to 0 just before it and read just after. K1-K3
    launch in every run, K4 and K6's pool count in every SLAM run."""
    import re

    from svi_mapper_tpu_torch import run_demo
    from svi_mapper_tpu_torch.tools import acceptance, run_kitti

    traj = tree / "acceptance_traj.txt"
    runs = {
        "acceptance": (acceptance.main, [str(tree), "--min-fps", "0", "--save", str(traj)]),
        "run_kitti_gt": (run_kitti.main, [str(tree), "--gt", "--frames", str(TOOL_TREE_FRAMES)]),
        # half the tree (its first 208 frames: 3 local BA windows and 10
        # closure queries on the CPU), which acceptance runs whole
        "run_kitti_slam": (run_kitti.main, [str(tree), "--slam", "--chunk", "32",
                                            "--frames", str(LOOP_FRAMES)]),
        "run_demo": (run_demo.main, []),
        # the demo's default loop (30 frames round 12 m: 2.9 m and 0.24 rad a
        # frame) loses track at once in both packages; the tree's loop
        "run_demo_slam": (run_demo.main, ["--slam", "--trajectory", "loop", "--frames",
                                          str(TOOL_LOOP_FRAMES), "--loop-radius",
                                          str(LOOP_RADIUS)]),
    }
    report, all_counts = {"phase": "cli_entry_points"}, {}
    for name, (fn, argv) in runs.items():
        reset_launch_counts()
        code, out, seconds = run_tool(fn, argv)
        counts = launch_counts()
        all_counts[name] = counts
        lines = out.strip().splitlines()
        report[name] = {"exit": code, "seconds": seconds, "launches": counts,
                        "tail": lines[-12:] if name.startswith(("acceptance", "run_kitti"))
                        else lines[-9:]}
        require(code == 0, f"{name} exited {code}:\n{out[-3000:]}")
        launched(counts, FRONTEND_KERNELS, name)
        if name in ("acceptance", "run_kitti_slam", "run_demo_slam"):
            launched(counts, ("schur_assemble", CLOSURE_KERNEL), name)
        if name == "acceptance":
            require("ACCEPTANCE PASSED" in out, f"acceptance failed:\n{out[-3000:]}")
            fps = float(re.search(r"\[PASS\] throughput\s+([0-9.]+) fps", out).group(1))
            closures = int(re.search(r"loop closures\s+(\d+) accepted", out).group(1))
            report[name].update(frames_per_s=fps, closures_accepted=closures,
                                default_fps_gate=acceptance.DEFAULT_MIN_FPS,
                                default_fps_gate_passes=fps >= acceptance.DEFAULT_MIN_FPS)
            require(closures >= 1, "acceptance accepted no closure")
    emit(report)
    return report, all_counts


def run_offline_tools(device, tree: Path, checkpoint: Path) -> tuple[dict, dict]:
    """``compute_descriptors`` -> ``create_vocabulary`` on four left frames
    of the tree, ``triangulation_sampling``, ``evaluate_trajectory`` /
    ``align_trajectory`` / ``interpolate_trajectory`` on acceptance's saved
    trajectory against the tree's poses, and ``view_map --html`` (and
    ``--png`` where matplotlib is installed) on ``slam_loop``'s checkpoint."""
    import importlib.util

    import numpy as np

    from svi_mapper_tpu_torch.tools import (
        align_trajectory,
        compute_descriptors,
        create_vocabulary,
        evaluate_trajectory,
        interpolate_trajectory,
        triangulation_sampling,
        view_map,
    )

    work = tree / "offline"
    imgs = work / "images"
    imgs.mkdir(parents=True)
    for i in (0, 100, 200, 300):
        shutil.copy(tree / "sequences" / "00" / "image_0" / f"{i:06d}.png", imgs)
    traj, gt = tree / "acceptance_traj.txt", tree / "poses" / "00.txt"
    times = tree / "sequences" / "00" / "times.txt"
    (work / "times_mid.txt").write_text(
        "".join(f"{t + 0.05:.6e}\n" for t in np.loadtxt(times)[:-1]))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    view = [str(checkpoint), "--html", str(work / "map.html")]
    if has_mpl:
        view += ["--png", str(work / "map.png")]
    runs = {
        "compute_descriptors": (compute_descriptors.main,
                                [str(imgs), "-o", str(work / "desc.npz")]),
        "create_vocabulary": (create_vocabulary.main,
                              [str(work / "desc.npz"), "-o", str(work / "vocab.npz"),
                               "--k", "8", "--levels", "3"]),
        "triangulation_sampling": (triangulation_sampling.main, []),
        "evaluate_trajectory": (evaluate_trajectory.main, [str(traj), str(gt)]),
        "align_trajectory": (align_trajectory.main,
                             [str(traj), str(gt), "-o", str(work / "aligned.txt")]),
        "interpolate_trajectory": (interpolate_trajectory.main,
                                   [str(traj), "--times-src", str(times), "--times-dst",
                                    str(work / "times_mid.txt"), "-o",
                                    str(work / "resampled.txt")]),
        "view_map": (view_map.main, view),
    }
    reset_launch_counts()
    report = {"phase": "offline_tools", "matplotlib": has_mpl}
    for name, (fn, argv) in runs.items():
        code, out, seconds = run_tool(fn, argv)
        report[name] = {"exit": code, "seconds": seconds, "tail": out.strip().splitlines()[-6:]}
        require(code == 0, f"{name} exited {code}:\n{out[-3000:]}")
    counts = launch_counts()
    report["launches"] = counts
    desc = np.load(work / "desc.npz")
    report["descriptors"] = int(len(desc["desc"]))
    require(len(desc["desc"]) > 100 and desc["desc"].dtype == np.uint32,
            f"compute_descriptors: {len(desc['desc'])} descriptors")
    require(np.loadtxt(work / "resampled.txt").shape == (len(np.loadtxt(times)) - 1, 12),
            "interpolate_trajectory: wrong number of poses")
    html = (work / "map.html").read_text()
    require("const DATA = " in html and "<script src=" not in html, "view_map: no viewer data")
    if has_mpl:
        require((work / "map.png").read_bytes()[:4] == b"\x89PNG", "view_map: no PNG")
    emit(report)
    return report, counts


def run_kernel_validation(device) -> tuple[dict, dict]:
    """``tools/validate_kernels`` on the card: every kernel against its
    plain version at the JAX tool's shapes; exit 0, and all six kernels
    (both entries of K2 and K6) launched."""
    from svi_mapper_tpu_torch.tools import validate_kernels

    reset_launch_counts()
    code, out, seconds = run_tool(validate_kernels.main, [])
    counts = launch_counts()
    report = {"phase": "kernel_validation", "exit": code, "seconds": seconds,
              "lines": out.strip().splitlines(), "launches": counts}
    emit(report)
    require(code == 0, f"validate_kernels exited {code}:\n{out}")
    launched(counts, KERNEL_ENTRIES, "validate_kernels")
    return report, counts


def run_sharded_ba(device) -> tuple[dict, dict]:
    """``parallel.sharded_ba.bundle_adjust_sharded`` through a one-rank
    NCCL group opened in this process, at 16 x 8192 (K4) and 64 x 4096
    (K5): ``bundle_adjust``'s bits; then the group is destroyed and
    ``tools/bench_scaling`` prints its world-size-1 line (its own spawned
    rank)."""
    import socket

    import torch
    import torch.distributed as dist

    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.parallel import distributed
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh
    from svi_mapper_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded
    from svi_mapper_tpu_torch.solvers import ba
    from svi_mapper_tpu_torch.tools import bench_scaling

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sk.getsockname()[1]}"
    t0 = time.perf_counter()
    distributed.initialize(address, 1, 0, device=device)
    report = {"phase": "sharded_ba", "backend": dist.get_backend(),
              "initialize_seconds": time.perf_counter() - t0, "cases": []}
    counts = {k: 0 for k in launch_counts()}
    try:
        mesh = make_map_mesh(device=device)
        cam = default_camera(width=1241, height=376, device=device)
        for K, L, kernel in ((16, 8192, "schur_assemble"), (64, 4096, "schur_assemble_tiled")):
            p = bench_scaling.make_problem(K, L)
            on = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            args = (on(p["T"]), on(p["X0"]), on(p["obs"]), on(p["mask"]), cam, on(p["fix"]))
            reset_launch_counts()
            t0 = time.perf_counter()
            res = bundle_adjust_sharded(mesh, *args, device=device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            case_counts = launch_counts()
            ref = ba.bundle_adjust(*args, device=device)
            same = {f: torch.equal(getattr(res, f), getattr(ref, f))
                    for f in ("T_wc", "points_w", "chi2_initial", "chi2_final", "iterations")}
            report["cases"].append({"K": K, "L": L, "kernel": kernel, "seconds": seconds,
                                    "chi2_final": float(res.chi2_final),
                                    "iterations": int(res.iterations),
                                    "same_bits_as_bundle_adjust": same,
                                    "launches": case_counts})
            require(all(same.values()), f"sharded BA {K} x {L} differs from bundle_adjust: {same}")
            launched(case_counts, (kernel,), f"sharded BA {K} x {L}")
            counts = {k: counts[k] + case_counts[k] for k in counts}
    finally:
        t0 = time.perf_counter()
        dist.destroy_process_group()
        report["destroy_seconds"] = time.perf_counter() - t0
    # bench_scaling spawns its rank, which imports this script again as
    # ``__mp_main__`` (cheap: the phases run only under ``__main__``)
    code, out, seconds = run_tool(bench_scaling.main, [])
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    report["bench_scaling"] = {"exit": code, "seconds": seconds, "lines": lines}
    report["launches"] = counts
    emit(report)
    require(code == 0 and len(lines) == torch.cuda.device_count() and lines[0]["devices"] == 1,
            f"bench_scaling: {out[-2000:]}")
    return report, counts


# ---------------------------------------------------------------------------
# the landmark-sharded frame step
# ---------------------------------------------------------------------------

SHARD_RANKS = 2
# a rank whose collective waits this long raises (the process group's timeout)
SHARD_COLLECTIVE_TIMEOUT_S = 120
SHARD_POSE_TOL = 1e-4
# the velocity is a pose difference over a 0.05 s frame interval: a pose
# within SHARD_POSE_TOL moves it by up to ~2e-3 m/s; the CPU tests hold the
# sharded tracker's to 1e-3 m/s
SHARD_VELOCITY_TOL = 1e-3
# what a checkpoint of the sharded loops is compared on, array by array,
# with the one-card phases' files
CKPT_STATE_KEYS = ("state__", "table__")
CKPT_SVI_KEYS = CKPT_STATE_KEYS + ("svi__velocity", "svi__gravity_obs", "svi__T_cam_imu",
                                   "svi__calib__")
INT_OUTPUT_FIELDS = ("posit_ok", "n_tracked", "n_active", "n_optimal", "n_new",
                     "is_keyframe", "inliers", "instability")


def table_numpy(table) -> dict:
    """Every field of a table as numpy, with every row (gathered over the
    mesh of a sharded table)."""
    from svi_mapper_tpu_torch.parallel.mesh import LandmarkShards

    names = [f.name for f in dataclasses.fields(table)]
    shards = LandmarkShards.of(table.active)
    fields = [getattr(table, k) for k in names]
    if shards is not None:
        fields = shards.gather(*[shards.local(t) for t in fields])
    return {k: t.cpu().numpy() for k, t in zip(names, fields)}


def int_table_fields(table: dict) -> list[str]:
    import numpy as np

    return [k for k, v in table.items() if not np.issubdtype(v.dtype, np.floating)]


class RowsRecorder:
    """While in use, notes the rows (landmarks or keypoints) of every call
    of K1's and K2's match entries, as the frame step calls them."""

    def __enter__(self):
        from svi_mapper_tpu_torch.frontend import stereo, tracking

        self.rows = {"track_scores": set(), "stereo_match": set()}
        self._k1 = CallCounter(tracking, "track_scores",
                               lambda field, uv, *a: self.rows["track_scores"].add(uv.shape[0]))
        self._k2 = CallCounter(stereo, "stereo_match",
                               lambda field, uv, desc: self.rows["stereo_match"].add(uv.shape[0]))
        self._k1.__enter__()
        self._k2.__enter__()
        return self

    def __exit__(self, *exc):
        self._k2.__exit__(*exc)
        self._k1.__exit__(*exc)

    def report(self) -> dict:
        return {k: sorted(v) for k, v in self.rows.items()}


def drive_main_path_frames(tracker, imgs_l, imgs_r) -> list:
    """main_path's frames: SHARD_SINGLE through ``process``, the rest
    through ``process_many(chunk=SHARD_CHUNK)``; the host outputs."""
    outs = [tracker.process(imgs_l[i], imgs_r[i]) for i in range(SHARD_SINGLE)]
    return outs + tracker.process_many(imgs_l[SHARD_SINGLE:], imgs_r[SHARD_SINGLE:],
                                       chunk=SHARD_CHUNK)


def outputs_numpy(outs) -> dict:
    import numpy as np

    return {f.name: np.stack([np.asarray(getattr(o, f.name)) for o in outs])
            for f in dataclasses.fields(outs[0])}


def first_difference(got: dict, want: dict, fields) -> dict | None:
    """The first frame (and the fields) at which two runs' outputs part."""
    import numpy as np

    for i in range(len(want[fields[0]])):
        bad = [f for f in fields if not np.array_equal(got[f][i], want[f][i])]
        if bad:
            return {"frame": i, "fields": bad}
    return None


def probe_gloo_cuda(device) -> dict:
    """What gloo's process group accepts on CUDA tensors, rank against
    rank: ``all_reduce`` with SUM / MIN / MAX on each dtype the sharded step
    reduces (the result checked), then ``broadcast``, ``all_gather``,
    ``scatter`` and ``reduce_scatter`` on float32 (DTensor's placement and
    gather use them). The second part runs in a group of its own with a
    20 s timeout, so an asymmetric refusal cannot hold the main group."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    out = {"all_reduce": {}}
    ops = {"SUM": dist.ReduceOp.SUM, "MIN": dist.ReduceOp.MIN, "MAX": dist.ReduceOp.MAX}
    expect = {"SUM": n * (n + 1) / 2, "MIN": 1, "MAX": n}
    for dtype in (torch.uint8, torch.int32, torch.int64, torch.float32, torch.float64,
                  torch.bool):
        for name, op in ops.items():
            key = f"{name}/{str(dtype).removeprefix('torch.')}"
            x = torch.full((5,), rank + 1, device=device).to(dtype)
            try:
                dist.all_reduce(x, op=op)
                want = torch.full((5,), expect[name], device=device).to(dtype)
                out["all_reduce"][key] = "ok" if torch.equal(x, want) else f"wrong: {x.tolist()}"
            except Exception as e:  # noqa: BLE001  (the probe records the refusal)
                out["all_reduce"][key] = f"{type(e).__name__}: {str(e)[:160]}"
    probe = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=20))
    tries = {
        "broadcast": lambda x: dist.broadcast(x, src=0, group=probe),
        "all_gather": lambda x: dist.all_gather([torch.empty_like(x) for _ in range(n)], x,
                                                group=probe),
        "scatter": lambda x: dist.scatter(
            x, [torch.ones_like(x) for _ in range(n)] if rank == 0 else None, src=0,
            group=probe),
        "reduce_scatter": lambda x: dist.reduce_scatter(
            x, [torch.ones_like(x) for _ in range(n)], group=probe),
    }
    for name, call in tries.items():
        try:
            call(torch.full((4,), float(rank), device=device))
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def sharded_frames_on_rank(device) -> dict:
    """Part 2 on one rank: main_path's 24 frames at configuration (a) on
    the state sharded over the world (512 rows a rank)."""
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, load_stereo_camera
    from svi_mapper_tpu_torch.io import synthetic
    from svi_mapper_tpu_torch.models.tracker import StereoTracker
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    cam = load_stereo_camera("kitti_00_camera_left.txt", "kitti_00_camera_right.txt",
                             device=device)
    poses = synthetic.corridor_trajectory(SHARD_SINGLE + SHARD_CHUNKED, step=0.5)
    rendered = [synthetic.render_stereo(cam, T) for T in poses]
    imgs_l = torch.stack([l for l, _ in rendered])
    imgs_r = torch.stack([r for _, r in rendered])
    tracker = StereoTracker(cam, DEFAULT_PARAMS, device=device)
    tracker.state = shard_state(tracker.state, make_map_mesh(device=device))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with RowsRecorder() as rows:
        outs = drive_main_path_frames(tracker, imgs_l, imgs_r)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"outputs": outputs_numpy(outs), "table": table_numpy(tracker.state.table),
            "local_rows": int(tracker.state.table.active.to_local().shape[0]),
            "placements": str(tracker.state.table.pos_w.placements),
            "launches": launch_counts(), "rows": rows.report(), "seconds": seconds,
            "frames_per_s": len(outs) / seconds}


def sharded_loop_on_rank(device, option: dict, keep: dict | None = None) -> dict:
    """Parts 3 and 4 on one rank: ``SLAMSystem(**option).process_many(
    chunk=32)`` + ``finalize_backend`` over loop (d) on the sharded state.
    With ``keep`` (part 3) the run saves its checkpoint at ``CKPT_FRAME``
    through :func:`loop_with_checkpoint` (every rank saves, rank 0 writes;
    the saving is left out of the time), and ``keep`` gets the system, the
    sequence and the frames."""
    import torch

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    params = loop_params()
    seq, imgs_l, imgs_r, _ = render_loop(device)
    slam = SLAMSystem(seq.cam, params, device=device, **option)
    slam.state = shard_state(slam.state, make_map_mesh(device=device))
    windows, outs = [], []
    record_ba_windows(slam, windows)
    reset_launch_counts()
    t0 = time.perf_counter()
    with recording_schur_shapes() as shapes:
        checkpoint_s = loop_with_checkpoint(
            slam, keep, 0, outs,
            lambda a, b: slam.process_many(imgs_l[a:b], imgs_r[a:b], chunk=LOOP_CHUNK))
        slam.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - checkpoint_s
    if keep is not None:
        keep.update(system=slam, seq=seq, imgs=(imgs_l, imgs_r))
    counts = launch_counts()
    raw, opt = slam.trajectory_array, slam.optimized_trajectory()
    crossings, at_wall = wall_crossings(seq.poses_wc, 1)
    worker = slam._bk_pool is not None
    left = (len(slam._bk_futures) + len(slam._bk_ready) + slam._bk_folds.qsize()
            if worker else None)
    slam.close()
    return {"frames": len(outs), "seconds": seconds, "frames_per_s": len(outs) / seconds,
            "checkpoint_seconds_left_out": checkpoint_s,
            "worker": worker, "folds_or_futures_left": left,
            "launches_on_worker": worker_launches("backend"),
            "keyframes": len(slam.slam_keyframes),
            "stats": {k: int(v) for k, v in slam.stats.items()},
            "accepted_closures": [[c.ref_kf, c.query_kf] for c in slam.accepted_closures],
            "closure_transform_err_m": closure_errors(slam, seq.poses_wc),
            "ate_recorded_m": ev.ate_rmse(raw, seq.poses_wc),
            "ate_optimised_m": ev.ate_rmse(opt, seq.poses_wc),
            "posit_rejected_at_frames": [i for i, o in enumerate(outs[1:], 1)
                                         if not bool(o.posit_ok)],
            "wall_crossings_at_frames": crossings, "near_wall": sorted(at_wall),
            "raw": raw, "optimised": opt,
            "placements": str(slam.state.table.pos_w.placements),
            "ba_windows": windows_by_shape(windows, counts),
            "schur_shapes": sorted(shapes), "launches": counts}


def trajectory_frames_differing(got: dict, want: dict, a: int, b: int) -> list[int]:
    """The frames ``a .. b - 1`` whose recorded poses two system snapshots
    (:func:`system_snapshot`) hold with other bits."""
    return [a + i for i, (x, y) in enumerate(zip(got["trajectory"][a:b],
                                                 want["trajectory"][a:b]))
            if x.tobytes() != y.tobytes()]


def sharded_resume_on_rank(device, keep: dict) -> dict:
    """Part 6 on one rank, loop (d): ``load_checkpoint`` of the file part 3
    saved at ``CKPT_FRAME`` (the state on one device) -> ``shard_state`` ->
    the rest of the loop (``process_many(chunk=32)``, ``finalize_backend``);
    against part 3's uninterrupted run."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    done, (imgs_l, imgs_r), seq = keep["system"], keep["imgs"], keep["seq"]
    t0 = time.perf_counter()
    tr = load_checkpoint(keep["path"], device=device)
    tr.state = shard_state(tr.state, make_map_mesh(device=device))
    load_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = tr.process_many(imgs_l[CKPT_FRAME:CKPT_END], imgs_r[CKPT_FRAME:CKPT_END],
                           chunk=LOOP_CHUNK)
    at_end = system_snapshot(tr)
    outs += tr.process_many(imgs_l[CKPT_END:], imgs_r[CKPT_END:], chunk=LOOP_CHUNK)
    tr.finalize_backend()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    opt = tr.optimized_trajectory()
    return {"load_seconds": load_s, "seconds": seconds, "frames": len(outs),
            "placements": str(tr.state.table.pos_w.placements),
            "resumed_frames_differ_at": trajectory_frames_differing(
                at_end, keep["at_end"], CKPT_FRAME, CKPT_END),
            "state_at_frame_128_differs_in": snapshot_differences(keep["at_end"], at_end),
            "keyframe_frames": [k.frame_idx for k in tr.slam_keyframes],
            "uninterrupted_keyframe_frames": [k.frame_idx for k in done.slam_keyframes],
            "whole_trajectory_equal": bool(np.array_equal(tr.trajectory_array,
                                                          done.trajectory_array)),
            "optimised_equal": bool(np.array_equal(opt, done.optimized_trajectory())),
            "stats": {k: int(v) for k, v in tr.stats.items()},
            "closure_transform_err_m": closure_errors(tr, seq.poses_wc),
            "ate_optimised_m": ev.ate_rmse(opt, seq.poses_wc),
            "launches": launch_counts(), "optimised": opt}


def sharded_svi_on_rank(device, keep: dict) -> dict:
    """Part 5 on one rank: configuration (e), ``bench.py:bench_svi``'s loop,
    as ``run_svi_loop`` drives it (``process_many_imu(chunk=32)`` ->
    ``finalize_backend``, loop closure and local BA on) on the sharded state,
    saving its checkpoint at ``CKPT_FRAME`` as the one-card phase does (every
    rank saves, rank 0 writes; left out of the time)."""
    import torch

    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    params, seq, imgs_l, imgs_r, calib0, (dts, oms, acs), _ = svi_loop_inputs(device)
    tr, windows, grav_pg, grav_ba = svi_loop_tracker(seq, calib0, params, device)
    tr.state = shard_state(tr.state, make_map_mesh(device=device))
    outs = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with stereo_match_calls() as k2_calls, pool_count_calls() as scorings:
        checkpoint_s = loop_with_checkpoint(
            tr, keep, 0, outs,
            lambda a, b: tr.process_many_imu(imgs_l[a:b], imgs_r[a:b], dts[a:b], oms[a:b],
                                             acs[a:b], chunk=LOOP_CHUNK))
        tr.finalize_backend()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - checkpoint_s
    counts = launch_counts()
    keep.update(imgs=(imgs_l, imgs_r), blocks=(dts, oms, acs))
    tr.close()
    return {**svi_loop_outcome(tr, outs, seq, windows, grav_pg, grav_ba, counts),
            "seconds": seconds, "frames_per_s": len(outs) / seconds,
            "checkpoint_seconds_left_out": checkpoint_s,
            "placements": str(tr.state.table.pos_w.placements), "launches": counts,
            "match_stereo_calls": k2_calls.calls, "pool_scorings": scorings.calls}


def sharded_svi_resume_on_rank(device, keep: dict) -> dict:
    """Part 6 on one rank, loop (e): ``load_checkpoint`` of the file part 5
    saved -> ``shard_state`` -> frames 96-127, against part 5's
    uninterrupted run at frame 128 (``checkpoint_svi``'s depth)."""
    import torch

    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    (imgs_l, imgs_r), (dts, oms, acs) = keep["imgs"], keep["blocks"]
    a, b = CKPT_FRAME, CKPT_END
    tr = load_checkpoint(keep["path"], device=device)
    tr.state = shard_state(tr.state, make_map_mesh(device=device))
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.process_many_imu(imgs_l[a:b], imgs_r[a:b], dts[a:b], oms[a:b], acs[a:b],
                        chunk=LOOP_CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    at_end = system_snapshot(tr)
    return {"seconds": seconds, "placements": str(tr.state.table.pos_w.placements),
            "resumed_frames_differ_at": trajectory_frames_differing(at_end, keep["at_end"],
                                                                    a, b),
            "velocity_at_frame_128_equal": (at_end["svi__velocity"].tobytes()
                                            == keep["at_end"]["svi__velocity"].tobytes()),
            "state_at_frame_128_differs_in": snapshot_differences(keep["at_end"], at_end),
            "launches": launch_counts()}


def gathered_copy(system, device):
    """A shallow copy of ``system`` whose state is its (sharded) state
    gathered onto one device (the host records shared)."""
    import copy

    from svi_mapper_tpu_torch import convert

    clone = copy.copy(system)
    clone.state = convert.state_from_numpy(convert.state_to_numpy(system.state), device)
    return clone


def host_reads(system, where: Path) -> dict:
    """What each host read of a SLAM system gives: its last keyframe's
    ``cloud_from_slam_state``, the ``snapshot_slam`` g2o bytes (with
    landmarks), ``snapshot_tracker``'s arrays and the bytes of the
    logger's ``finalize`` dumps; the files go under ``where`` (on a sharded
    system every rank calls this and rank 0 writes them)."""
    import numpy as np

    from svi_mapper_tpu_torch.eval.viewer import snapshot_tracker
    from svi_mapper_tpu_torch.io.cloud import cloud_from_slam_state
    from svi_mapper_tpu_torch.io.g2o_export import snapshot_slam
    from svi_mapper_tpu_torch.utils import loggers

    cloud = cloud_from_slam_state(system.state, len(system.slam_keyframes) - 1,
                                  system.frame_count - 1)
    out = {f"cloud/{f.name}": np.asarray(getattr(cloud, f.name))
           for f in dataclasses.fields(cloud)}
    where.mkdir(parents=True, exist_ok=True)
    snapshot_slam(system, where / "map.g2o")      # writes nothing without a keyframe
    out["g2o"] = (where / "map.g2o").read_bytes() if system.slam_keyframes else b""
    view = snapshot_tracker(system)
    hud = view.pop("hud", {})
    out.update({f"viewer/{k}": np.asarray(v) for k, v in view.items()})
    out.update({f"viewer/hud/{k}": np.asarray(v) for k, v in hud.items()})
    loggers.finalize(system, loggers.RunLogger(where / "logs"))
    for name in ("landmarks_final", "landmarks_final_optimized", "trajectory_kitti"):
        out[f"logs/{name}"] = (where / "logs" / f"{name}.txt").read_bytes()
    return out


def host_read_differences(got: dict, want: dict) -> list[str]:
    """The reads of :func:`host_reads` that differ (bytes, or arrays with
    NaNs equal), and those only one side has."""
    import numpy as np

    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        a, b = got[k], want[k]
        same = (a == b if isinstance(a, bytes)
                else a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
        if not same:
            bad.append(k)
    return bad


def _sharded_rank(rank: int, n: int, address: str, results, work_dir: str) -> None:
    """One gloo rank on the card: the probe and parts 2-7; its report (or
    its traceback) goes into ``results``. The checkpoints and the host
    reads' files go under ``work_dir`` (rank 0 writes the shared ones)."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    try:
        from svi_mapper_tpu_torch.ops import cuda_build

        cuda_build.load_library()
        dist.init_process_group(
            "gloo", init_method=f"tcp://{address}", world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
        try:
            report = {"rank": rank, "backend": dist.get_backend(),
                      "gloo_cuda": probe_gloo_cuda(device)}
            work = Path(work_dir)
            report["frames"] = sharded_frames_on_rank(device)
            torch.cuda.empty_cache()
            loop_keep = {"path": work / "sharded_slam_loop.npz"}
            report["loop"] = sharded_loop_on_rank(device, {}, loop_keep)
            torch.cuda.empty_cache()
            report["overlap"] = sharded_loop_on_rank(device, {"overlap_backend": "force"})
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            svi_keep = {"path": work / "sharded_svi_loop.npz"}
            report["svi"] = sharded_svi_on_rank(device, svi_keep)
            report["svi"]["part_seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            report["resume"] = sharded_resume_on_rank(device, loop_keep)
            report["svi_resume"] = sharded_svi_resume_on_rank(device, svi_keep)
            report["resume"]["part_seconds"] = time.perf_counter() - t0
            del svi_keep
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            system = loop_keep["system"]
            report["host_reads"] = {
                "sharded": host_reads(system, work / "host_reads_sharded"),
                "gathered": host_reads(gathered_copy(system, device),
                                       work / f"host_reads_gathered_rank{rank}"),
                "seconds": time.perf_counter() - t0}
        finally:
            dist.destroy_process_group()
        results.put(report)
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()[-4000:]})
        raise


def run_sharded_world(n: int, timeout: float, work_dir: Path) -> list[dict]:
    """Spawn ``n`` gloo ranks on the one card, as ``tools/bench_scaling``
    spawns its ranks; their reports in rank order. Raises if a rank fails
    or the world outlasts ``timeout``; no rank is left running."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with __import__("socket").socket() as sk:
        sk.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sk.getsockname()[1]}"
    procs = [ctx.Process(target=_sharded_rank, args=(r, n, address, results, str(work_dir)),
                         daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    reports = {}
    try:
        while len(reports) < n:
            try:
                rep = results.get(timeout=1.0)
            except queue.Empty:
                require(time.monotonic() < deadline and
                        not any(p.exitcode not in (None, 0) for p in procs),
                        f"sharded world of {n}: a rank failed or hung (exit codes "
                        f"{[p.exitcode for p in procs]})")
                continue
            require("error" not in rep, f"rank {rep['rank']} failed:\n{rep.get('error')}")
            reports[rep["rank"]] = rep
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        require(all(p.exitcode == 0 for p in procs),
                f"exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [reports[r] for r in range(n)]


def checkpoint_comparison(path: Path, ref: Path, prefixes: tuple) -> dict:
    """The arrays of two checkpoint files whose names start with
    ``prefixes``, array by array: those that differ in bits, those where an
    integer differs or a float by more than ``SHARD_POSE_TOL``, and the
    rows of each ``table__*`` array of ``path``."""
    import numpy as np

    with np.load(path) as z, np.load(ref) as w:
        keys = sorted(k for k in set(z.files) | set(w.files) if k.startswith(prefixes))
        differ, beyond, rows = [], [], set()
        for k in keys:
            if k not in z.files or k not in w.files:
                differ.append(k)
                beyond.append(k)
                continue
            a, b = z[k], w[k]
            if k.startswith("table__"):
                rows.add(int(a.shape[0]))
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                differ.append(k)
                if (a.dtype != b.dtype or a.shape != b.shape or a.dtype.kind != "f"
                        or not np.allclose(a, b, rtol=0, atol=SHARD_POSE_TOL, equal_nan=True)):
                    beyond.append(k)
    return {"arrays_compared": len(keys), "table_rows": sorted(rows), "differ_in": differ,
            "beyond_tolerance": beyond}


def run_sharded_frame(device, main_keep: dict, loop: dict, smi: str, loop_keep: dict,
                      svi: dict, svi_keep: dict, svi_counts: dict,
                      work_dir: Path) -> tuple[dict, dict]:
    """The landmark-sharded frame step (``parallel.mesh.shard_state``) on
    the card, in three parts. 1: one NCCL rank in this process runs
    main_path's 24 frames at configuration (a) on the sharded state and
    must give main_path's bits on every frame and in every table field.
    2: two gloo ranks on the one card (spawned) run the same frames with
    512 rows each: every frame's integer outputs and the gathered table's
    integer fields equal main_path's, poses within SHARD_POSE_TOL. 3: the
    same ranks run ``SLAMSystem.process_many(chunk=32)`` +
    ``finalize_backend`` over loop (d) and are held to ``slam_loop``'s
    gates; the two ranks' trajectories must be the same bits, and K4 and K6
    must launch on each. 4: the same loop with the back-end worker
    (``overlap_backend="force"``, ``__graft_entry__.dryrun_multichip``'s
    last part) on the two ranks, held to ``overlap_backend``'s gates, the
    ranks the same bits (they fold only what both have). 5: the same ranks
    run ``svi_loop`` (configuration (e)) on the sharded state: the ranks the
    same bits, the one-card run's keyframes, closures, BA runs, trajectories,
    velocity and gravity observations (the same bits, or equal integers and
    poses within SHARD_POSE_TOL), ``svi_loop``'s gates, its launches on
    each rank. 6: parts 3 and 5 saved their checkpoints at CKPT_FRAME (rank
    0 wrote): every table holds every row and equals the one-card phases'
    files array by array; each rank loads the file, shards the state again
    and resumes, and must record the uninterrupted sharded run's poses. 7:
    the host reads (cloud, g2o, viewer, the logger's dumps) of part 3's
    final system equal those of the same state gathered and, where part 3
    gave ``slam_loop``'s bits, those of the one-card system. Returns the
    report and each part's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.models.tracker import StereoTracker
    from svi_mapper_tpu_torch.parallel import distributed
    from svi_mapper_tpu_torch.parallel.mesh import make_map_mesh, shard_state

    t_phase = time.perf_counter()
    want_out, want_table = outputs_numpy(main_keep["outs"]), main_keep["table"]
    imgs_l, imgs_r = main_keep["imgs"]
    report = {"phase": "sharded_frame", "nvidia_smi": smi}

    # 1. one NCCL rank
    with __import__("socket").socket() as sk:
        sk.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sk.getsockname()[1]}"
    distributed.initialize(address, 1, 0, device=device)
    try:
        tracker = StereoTracker(main_keep["cam"], DEFAULT_PARAMS, device=device)
        tracker.state = shard_state(tracker.state, make_map_mesh(device=device))
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = drive_main_path_frames(tracker, imgs_l, imgs_r)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        one_counts = launch_counts()
        got_out, got_table = outputs_numpy(outs), table_numpy(tracker.state.table)
        one = {"backend": dist.get_backend(), "seconds": seconds,
               "frames_per_s": len(outs) / seconds,
               "main_path_frames_per_s": main_keep["frames_per_s"],
               "placements": str(tracker.state.table.pos_w.placements),
               "first_output_difference": first_difference(
                   got_out, want_out, list(want_out)),
               "table_fields_differing": [k for k in want_table
                                          if not np.array_equal(got_table[k], want_table[k],
                                                                equal_nan=True)],
               "launches": one_counts, "main_path_launches": main_keep["counts"]}
    finally:
        dist.destroy_process_group()
    report["one_nccl_rank"] = one

    # 2 and 3. two gloo ranks on the one card
    t0 = time.perf_counter()
    ranks = run_sharded_world(SHARD_RANKS, timeout=900.0, work_dir=work_dir)
    report["gloo_world_seconds"] = time.perf_counter() - t0
    report["gloo_cuda_probe"] = ranks[0]["gloo_cuda"]
    frames = [r["frames"] for r in ranks]
    tol_fields = [f for f in INT_OUTPUT_FIELDS if f in want_out]
    two = {"local_rows": [f["local_rows"] for f in frames],
           "placements": frames[0]["placements"],
           "seconds": [f["seconds"] for f in frames],
           "frames_per_s": [f["frames_per_s"] for f in frames],
           "rows_k1_k2_ran_on": [f["rows"] for f in frames],
           "main_path_rows": N_LANDMARKS,
           "launches": [f["launches"] for f in frames],
           "first_integer_output_difference": [
               first_difference(f["outputs"], want_out, tol_fields) for f in frames],
           "integer_table_fields_differing": [
               [k for k in int_table_fields(want_table)
                if not np.array_equal(f["table"][k], want_table[k])] for f in frames],
           "pose_max_abs_diff": [float(np.abs(f["outputs"]["T_wc"] - want_out["T_wc"]).max())
                                 for f in frames],
           "ranks_same_bits": all(
               np.array_equal(frames[0]["outputs"][k], frames[1]["outputs"][k])
               for k in want_out) and all(
               np.array_equal(frames[0]["table"][k], frames[1]["table"][k], equal_nan=True)
               for k in want_table)}
    report["two_gloo_ranks_frames"] = two
    loops = [r["loop"] for r in ranks]
    three = {k: [lp[k] for lp in loops] for k in (
        "frames", "seconds", "frames_per_s", "keyframes", "stats", "accepted_closures",
        "closure_transform_err_m", "ate_recorded_m", "ate_optimised_m",
        "posit_rejected_at_frames", "ba_windows", "launches")}
    three["placements"] = loops[0]["placements"]
    three["wall_crossings_at_frames"] = loops[0]["wall_crossings_at_frames"]
    three["ranks_same_trajectory_bits"] = (
        np.array_equal(loops[0]["raw"], loops[1]["raw"])
        and np.array_equal(loops[0]["optimised"], loops[1]["optimised"]))
    three["slam_loop"] = {k: loop[k] for k in ("keyframes", "frames_per_s", "ate_recorded_m",
                                               "ate_optimised_m", "accepted_closures")}
    loop_system = loop_keep["system"]
    # reported, not required: float32 sum order may part them
    three["same_trajectory_bits_as_slam_loop"] = (
        np.array_equal(loops[0]["raw"], loop_system.trajectory_array)
        and np.array_equal(loops[0]["optimised"], loop_system.optimized_trajectory()))
    report["two_gloo_ranks_loop"] = three
    overlaps = [r["overlap"] for r in ranks]
    four = {k: [lp[k] for lp in overlaps] for k in (
        "worker", "folds_or_futures_left", "frames", "seconds", "frames_per_s", "keyframes",
        "stats", "accepted_closures", "closure_transform_err_m", "ate_recorded_m",
        "ate_optimised_m", "posit_rejected_at_frames", "launches", "launches_on_worker")}
    four["ranks_same_trajectory_bits"] = (
        np.array_equal(overlaps[0]["raw"], overlaps[1]["raw"])
        and np.array_equal(overlaps[0]["optimised"], overlaps[1]["optimised"]))
    four["ate_bound_m"] = min(max(1.25 * loop["ate_optimised_m"], 0.25), LOOP_ATE_BOUND_M) \
        if loop.get("ate_optimised_m") is not None else LOOP_ATE_BOUND_M
    report["two_gloo_ranks_overlap_backend"] = four
    report["schur_shapes"] = sorted({tuple(s) for lp in loops + overlaps
                                     for s in lp["schur_shapes"]})
    # 5. the stereo-inertial loop on the two ranks
    svis, svi_ref = [r["svi"] for r in ranks], svi_keep["outcome"]
    vectors = ("raw", "optimised", "velocity", "gravity_obs_rows")
    integers = ("keyframes", "stats", "accepted_closures", "posit_rejected_at_frames")
    five = {k: [sv[k] for sv in svis] for k in (
        "frames", "part_seconds", "seconds", "frames_per_s", "keyframes", "stats",
        "accepted_closures", "closure_transform_err_m", "ate_recorded_m", "ate_optimised_m",
        "ate_recorded_before_first_refusal_m", "posit_rejected_at_frames", "ba_windows",
        "launches", "checkpoint_seconds_left_out")}
    five["placements"] = svis[0]["placements"]
    five["ranks_same_bits"] = all(np.array_equal(svis[0][k], svis[1][k]) for k in vectors)
    five["svi_loop_integers_equal"] = all(sv[k] == svi_ref[k] for sv in svis for k in integers)
    five["svi_loop_same_bits"] = five["svi_loop_integers_equal"] and all(
        np.array_equal(sv[k], svi_ref[k]) for sv in svis for k in vectors)
    five["pose_max_abs_diff_from_svi_loop"] = max(
        float(np.abs(sv[k] - svi_ref[k]).max()) for sv in svis for k in ("raw", "optimised"))
    five["velocity_max_abs_diff_from_svi_loop"] = max(
        float(np.abs(sv["velocity"] - svi_ref["velocity"]).max()) for sv in svis)
    five["gravity_max_abs_diff_from_svi_loop"] = max(
        float(np.abs(sv["gravity_obs_rows"] - svi_ref["gravity_obs_rows"]).max())
        if sv["gravity_obs_rows"].shape == svi_ref["gravity_obs_rows"].shape else float("inf")
        for sv in svis)
    five["svi_loop"] = {k: svi[k] for k in ("keyframes", "frames_per_s", "ate_recorded_m",
                                            "ate_optimised_m", "accepted_closures")}
    five["frames_per_s_over_svi_loop"] = [f / svi["frames_per_s"] for f in five["frames_per_s"]]
    five["svi_loop_launches"] = svi_counts
    report["two_gloo_ranks_svi_loop"] = five
    # 6. the checkpoints at CKPT_FRAME, and the resumed ranks
    six = {"slam_file": checkpoint_comparison(work_dir / "sharded_slam_loop.npz",
                                              loop_keep["path"], CKPT_STATE_KEYS),
           "svi_file": checkpoint_comparison(work_dir / "sharded_svi_loop.npz",
                                             svi_keep["path"], CKPT_SVI_KEYS),
           "resume": [{k: v for k, v in r["resume"].items() if k != "optimised"}
                      for r in ranks],
           "svi_resume": [r["svi_resume"] for r in ranks],
           "ranks_same_bits": np.array_equal(ranks[0]["resume"]["optimised"],
                                             ranks[1]["resume"]["optimised"])}
    report["two_gloo_ranks_checkpoint"] = six
    # 7. the host reads of part 3's final system
    t0 = time.perf_counter()
    one_card = host_reads(loop_system, work_dir / "host_reads_one_card")
    reads = [r["host_reads"] for r in ranks]
    seven = {"reads": sorted(one_card), "rank_seconds": [h["seconds"] for h in reads],
             "one_card_seconds": time.perf_counter() - t0,
             "cloud_points": int(one_card["cloud/uids"].shape[0]),
             "g2o_bytes": len(one_card["g2o"]),
             "ranks_differ_in": host_read_differences(reads[0]["sharded"], reads[1]["sharded"]),
             "differ_from_gathered": [host_read_differences(h["sharded"], h["gathered"])
                                      for h in reads],
             "differ_from_slam_loop": [host_read_differences(h["sharded"], one_card)
                                       for h in reads]}
    report["two_gloo_ranks_host_reads"] = seven
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)

    # part 1's gates
    require(one["first_output_difference"] is None and not one["table_fields_differing"],
            f"one NCCL rank differs from main_path: {one['first_output_difference']}, "
            f"table fields {one['table_fields_differing']}")
    require(all(one_counts[k] == main_keep["counts"][k] > 0 for k in FRONTEND_KERNELS),
            f"one NCCL rank launched {one_counts}, main_path {main_keep['counts']}")
    # part 2's
    require(two["local_rows"] == [N_LANDMARKS // SHARD_RANKS] * SHARD_RANKS,
            f"rows per rank {two['local_rows']}")
    require(all(d is None for d in two["first_integer_output_difference"]),
            f"an integer output parted from main_path's: {two['first_integer_output_difference']}")
    require(not any(two["integer_table_fields_differing"]),
            f"integer table fields differ: {two['integer_table_fields_differing']}")
    require(max(two["pose_max_abs_diff"]) <= SHARD_POSE_TOL,
            f"poses {two['pose_max_abs_diff']} from main_path's")
    require(two["ranks_same_bits"], "the two ranks' frame outputs or tables differ")
    for f in frames:
        launched(f["launches"], FRONTEND_KERNELS, "sharded frames, one rank")
        require(N_LANDMARKS // SHARD_RANKS in f["rows"]["track_scores"]
                and N_LANDMARKS // SHARD_RANKS in f["rows"]["stereo_match"],
                f"K1 / K2 did not run on the rank's rows: {f['rows']}")
    # part 3's: slam_loop's gates on each rank
    for lp in loops:
        st = lp["stats"]
        bad = [i for i in lp["posit_rejected_at_frames"] if i not in lp["near_wall"]]
        require(lp["frames"] == LOOP_FRAMES and not bad,
                f"sharded loop: pose solve rejected on frames {bad}")
        require(st["closures_accepted"] >= 1 and st["pose_graph_runs"] >= 1
                and st["ba_runs"] >= 1, f"sharded loop not closed: {st}")
        require(np.isfinite(lp["optimised"]).all()
                and lp["ate_optimised_m"] <= lp["ate_recorded_m"]
                and lp["ate_optimised_m"] < LOOP_ATE_BOUND_M,
                f"sharded loop ATE: recorded {lp['ate_recorded_m']} m, "
                f"optimised {lp['ate_optimised_m']} m")
        require(lp["closure_transform_err_m"]
                and max(lp["closure_transform_err_m"]) < LOOP_CLOSURE_ERR_M,
                f"sharded loop closures off by {lp['closure_transform_err_m']} m")
        launched(lp["launches"], FRONTEND_KERNELS + ("schur_assemble", CLOSURE_KERNEL),
                 "sharded loop, one rank")
    require(three["ranks_same_trajectory_bits"], "the two ranks' trajectories differ")
    # part 4's: overlap_backend's gates on each rank
    for lp in overlaps:
        st = lp["stats"]
        bad = [i for i in lp["posit_rejected_at_frames"] if i not in lp["near_wall"]]
        require(lp["worker"] and lp["folds_or_futures_left"] == 0,
                f"sharded overlap: worker {lp['worker']}, {lp['folds_or_futures_left']} left")
        require(lp["frames"] == LOOP_FRAMES and not bad,
                f"sharded overlap: pose solve rejected on frames {bad}")
        require(st["closures_accepted"] >= 1 and st["pose_graph_runs"] >= 1
                and st["ba_runs"] >= 1, f"sharded overlap: {st}")
        require(np.isfinite(lp["optimised"]).all()
                and lp["ate_optimised_m"] < four["ate_bound_m"],
                f"sharded overlap ATE {lp['ate_optimised_m']} m, bound {four['ate_bound_m']}")
        require(max(lp["closure_transform_err_m"]) < LOOP_CLOSURE_ERR_M,
                f"sharded overlap closures off by {lp['closure_transform_err_m']} m")
        launched(lp["launches_on_worker"], ("schur_assemble", CLOSURE_KERNEL),
                 "sharded overlap, the worker of one rank")
    require(four["ranks_same_trajectory_bits"],
            "the two ranks' trajectories differ with the back-end worker")
    # part 5's: the ranks alike, svi_loop's figures, its gates and launches
    require(five["ranks_same_bits"], "the two ranks' stereo-inertial runs differ")
    require(five["svi_loop_same_bits"] or (
        five["svi_loop_integers_equal"]
        and five["pose_max_abs_diff_from_svi_loop"] <= SHARD_POSE_TOL
        and five["gravity_max_abs_diff_from_svi_loop"] <= SHARD_POSE_TOL
        and five["velocity_max_abs_diff_from_svi_loop"] <= SHARD_VELOCITY_TOL),
        f"the sharded SVI loop parted from svi_loop: integers equal "
        f"{five['svi_loop_integers_equal']}, poses {five['pose_max_abs_diff_from_svi_loop']}, "
        f"gravity {five['gravity_max_abs_diff_from_svi_loop']}, velocity "
        f"{five['velocity_max_abs_diff_from_svi_loop']}")
    for r, sv in enumerate(svis):
        require_svi_loop(sv, sv["launches"], f"sharded svi_loop, rank {r}")
        on_path = FRONTEND_KERNELS + BACKEND_KERNELS + (CLOSURE_KERNEL,)
        require(all(sv["launches"][k] == svi_counts[k] for k in on_path)
                and sv["launches"]["stereo_match"] == sv["match_stereo_calls"]
                and sv["launches"][CLOSURE_KERNEL] == sv["pool_scorings"],
                f"sharded svi_loop, rank {r}: launches {sv['launches']}, svi_loop's "
                f"{svi_counts}")
    # part 6's: whole tables, the one-card files, the resumed ranks
    for name in ("slam_file", "svi_file"):
        f = six[name]
        require(f["table_rows"] == [N_LANDMARKS] and f["arrays_compared"] > 0,
                f"{name}: table rows {f['table_rows']}")
        require(not f["beyond_tolerance"],
                f"{name} differs from the one-card file in {f['beyond_tolerance']}")
    for r, (res, sres) in enumerate(zip(ranks, six["svi_resume"])):
        res = res["resume"]
        st = res["stats"]
        require(not res["resumed_frames_differ_at"]
                and res["keyframe_frames"] == res["uninterrupted_keyframe_frames"],
                f"rank {r}: resumed loop frames {res['resumed_frames_differ_at']} differ, or "
                f"its keyframes {len(res['keyframe_frames'])} from "
                f"{len(res['uninterrupted_keyframe_frames'])}")
        require(res["frames"] == LOOP_FRAMES - CKPT_FRAME and st["closures_accepted"] >= 1
                and res["closure_transform_err_m"]
                and max(res["closure_transform_err_m"]) < LOOP_CLOSURE_ERR_M
                and res["ate_optimised_m"] < LOOP_ATE_BOUND_M,
                f"rank {r}: resumed loop {st}, closures {res['closure_transform_err_m']} m, "
                f"ATE {res['ate_optimised_m']} m")
        require(not sres["resumed_frames_differ_at"] and sres["velocity_at_frame_128_equal"],
                f"rank {r}: resumed SVI frames {sres['resumed_frames_differ_at']} differ, "
                f"velocity equal {sres['velocity_at_frame_128_equal']}")
        launched(res["launches"], FRONTEND_KERNELS, f"resumed sharded loop, rank {r}")
        launched(sres["launches"], FRONTEND_KERNELS, f"resumed sharded SVI loop, rank {r}")
    require(six["ranks_same_bits"], "the resumed ranks' trajectories differ")
    # part 7's: the gathered state's reads; slam_loop's where part 3 gave its bits
    require(not seven["ranks_differ_in"], f"the ranks' host reads differ in "
            f"{seven['ranks_differ_in']}")
    require(not any(seven["differ_from_gathered"]),
            f"host reads differ from the gathered state's: {seven['differ_from_gathered']}")
    require(not three["same_trajectory_bits_as_slam_loop"]
            or not any(seven["differ_from_slam_loop"]),
            f"host reads differ from slam_loop's: {seven['differ_from_slam_loop']}")
    counts = {"nccl_1": one_counts, "gloo_frames": two["launches"],
              "gloo_loop": three["launches"], "gloo_overlap": four["launches"],
              "gloo_svi_loop": five["launches"],
              "gloo_resume": [r["resume"]["launches"] for r in ranks],
              "gloo_svi_resume": [r["svi_resume"]["launches"] for r in ranks]}
    return report, counts


def run_utilization(device) -> tuple[dict, dict]:
    """``eval.utilization.utilization_report()`` at 1241 x 376: every stage's
    MFU and device-memory share in (0, 1.05] (above raises in the module)."""
    from svi_mapper_tpu_torch.eval import utilization

    reset_launch_counts()
    t0 = time.perf_counter()
    rep = utilization.utilization_report()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    report = {"phase": "utilization", "seconds": seconds, **rep, "launches": counts}
    emit(report)
    print(utilization.format_report(rep), flush=True)
    for name, row in rep["stages"].items():
        require(0 < row["mfu"] <= 1.05 and 0 < row["hbm_frac"] <= 1.05,
                f"utilization {name}: mfu {row['mfu']}, hbm_frac {row['hbm_frac']}")
    launched(counts, FRONTEND_KERNELS + ("schur_assemble",), "utilization")
    return report, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    import svi_mapper_tpu_torch  # noqa: F401  (fails outside the repository)
    from svi_mapper_tpu_torch.ops import ba_kernel, cuda_build

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
          "track_scores_planted": small[1]["planted"],
          "stereo_match": {k: small[3][k] for k in ("cases", "planted")}})
    narrow = check_kernels(device, h=64, w_raw=96, n=16, max_disparity=128, timed=False)
    emit({"phase": "kernels_narrow", "shape": [64, 96],
          "max_abs_err": {k["name"]: k["max_abs_err"] for k in narrow},
          "stereo_match": {k: narrow[3][k] for k in ("cases", "planted")}})
    full = check_kernels(device, h=H, w_raw=W_RAW, n=N_LANDMARKS,
                         max_disparity=MAX_DISPARITY, timed=True)
    front_build = {src: ptxas_report(src, "kernel") for src in
                   ("brief_dense.cu", "track_scores.cu", "stereo_profiles.cu")}
    emit({"phase": "kernels_full", "shape": [H, W_RAW],
          "max_abs_err": {k["name"]: k["max_abs_err"] for k in full},
          "track_scores_planted": full[1]["planted"],
          "stereo_match": {k: full[3][k] for k in ("cases", "planted")},
          "build": front_build,
          "sass_shared_loads": {"brief_dense_kernel": sass_count("brief_dense_kernel", "LDS")},
          # modelled, not measured: the loads or popcounts the design issues
          # and the time they take at one issue rate per SM and clock
          "design": {k["name"]: k["design"] for k in full if "design" in k}})

    backend = check_backend_kernels(device)
    schur_build = ptxas_report("schur_assemble.cu", "kernel")
    emit({"phase": "kernels_backend", "tolerance": dict(ba_kernel.SCHUR_TOL), "shapes": backend,
          "build": schur_build})
    require(not schur_build or all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                   for r in schur_build),
            f"a kernel of schur_assemble.cu spills: {schur_build}")
    walk = check_observed_walk(device)
    walk_build = ptxas_report("observed_walk.cu", "kernel")
    emit({"phase": "kernels_observed_walk", "tolerance": WALK_TOL, "shapes": walk,
          "build": walk_build})
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in walk_build),
            f"a kernel of observed_walk.cu spills: {walk_build}")

    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                for r in front_build["stereo_profiles.cu"]),
            f"a kernel of stereo_profiles.cu spills: {front_build['stereo_profiles.cu']}")

    closure_rows = check_closure_kernel(device)
    hamming_build = ptxas_report("hamming_matrix.cu", "kernel")
    emit({"phase": "kernels_closure",
          "shapes": [{k: v for k, v in r.items() if k != "design"} for r in closure_rows],
          "build": hamming_build,
          # modelled, not measured: the time the timed rows' operations take
          # at each rate (the binary MMA's rate itself is measured)
          "design": {r["name"]: r["design"] for r in closure_rows if "design" in r}})
    require(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in hamming_build),
            f"a kernel of hamming_matrix.cu spills: {hamming_build}")

    # 4. the card against the CPU on a small sequence, a small BA window and
    #    a small pose graph (the closure query holds its own comparison)
    emit({"phase": "gpu_vs_cpu", **check_against_cpu(device),
          **check_backend_against_cpu(device)})

    # 5. the main paths, each with the launch counts set to 0 just before it
    #    and read just after
    profile = "--profile" in sys.argv[1:]
    main_keep = {}
    report, counts = run_main_path(device, profile=profile, keep=main_keep)
    emit(report)
    report, backend_counts = run_map_optimisation(device, profile=profile)
    emit(report)
    report, query_counts = run_closure_query(device)
    emit(report)
    ckdir = tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR)
    tools_dir = tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR)
    loop_keep = {"path": Path(ckdir.name) / "slam_loop.npz"}
    svi_keep = {"path": Path(ckdir.name) / "svi_loop.npz"}
    # the loops save a checkpoint after frame 95 (left out of their times)
    loop, loop_counts = run_slam_loop(device, keep=loop_keep)     # emits its own line
    # 6. the stereo-inertial path: card against CPU, the real-data front at
    #    the VI sensor's size, the bench loop (each with its counts set to 0
    #    just before it and read just after)
    emit({"phase": "svi_gpu_vs_cpu", **check_svi_against_cpu(device)})
    run_svi_rectified(device)                       # emits its own line
    svi, svi_counts = run_svi_loop(device, keep=svi_keep)        # emits its own line
    # 7. checkpoint and resume of both loops; the stress worlds; the stage
    #    budget (each with its counts set to 0 just before it, read after)
    loop_keep["report"] = loop
    resume, resume_counts = run_checkpoint_resume(device, loop_keep)
    svi_resume, svi_resume_counts = run_checkpoint_svi(device, svi_keep)
    # the landmark-sharded frame step: one NCCL rank, then two gloo ranks on
    # the one card (main_path's frames, the SV loop, the SVI loop, both
    # resumed from their checkpoints, the host reads), each part with the
    # counts set to 0 just before it and read just after
    torch.cuda.empty_cache()
    sharded, sharded_counts = run_sharded_frame(
        device, main_keep, loop, smi, loop_keep, svi, svi_keep, svi_counts,
        work_dir=Path(ckdir.name))
    del main_keep
    # view_map (offline_tools, below) draws slam_loop's checkpoint
    loop_checkpoint = Path(tools_dir.name) / "slam_loop.npz"
    shutil.copy(loop_keep["path"], loop_checkpoint)
    del loop_keep, svi_keep
    ckdir.cleanup()
    torch.cuda.empty_cache()
    stress, stress_counts = run_stress_loop(device)
    alias, alias_counts = run_stress_alias(device)
    stage, stage_counts = run_stage_budget(device, smi)
    # 8. the worker threads, the native runtime and its tools (each with its
    #    counts set to 0 just before it and read just after)
    torch.cuda.empty_cache()
    asyn, async_counts = run_async_closure(device, loop)          # emits its own line
    overlap, overlap_counts = run_overlap_backend(device, loop)   # emits its own line
    native_rt, native_counts = run_native_runtime(device)
    tools, tools_counts = run_cloud_tools(device)
    # 9. the entry points a user calls: the command-line tools on the loop
    #    written as a KITTI tree, the offline tools, the kernel validator,
    #    the sharded BA and the utilization report (each with its counts set
    #    to 0 just before it and read just after)
    torch.cuda.empty_cache()
    phase_seconds = {}
    t_phase = time.perf_counter()
    tree = Path(tools_dir.name)
    seq, imgs_l, imgs_r, _ = render_loop(device, TOOL_LOOP_FRAMES)
    write_kitti_tree(tree, seq, imgs_l, imgs_r)
    del seq, imgs_l, imgs_r
    # the K4 / K5 window shapes these phases launch (the CLIs' systems build
    # their own windows; bench_scaling's spawned rank solves the sharded
    # phase's 16 x 8192 problem), each held against its plain version below
    # (the sharded loop's ranks recorded theirs in their own processes)
    entry_shapes = {"sharded_frame": {tuple(x) for x in sharded["schur_shapes"]}}
    with recording_schur_shapes() as shapes:
        cli, cli_counts = run_cli_entry_points(device, tree)
    entry_shapes["cli_entry_points"] = shapes
    phase_seconds["cli_entry_points"] = time.perf_counter() - t_phase
    for name, fn, args in (("offline_tools", run_offline_tools, (tree, loop_checkpoint)),
                           ("kernel_validation", run_kernel_validation, ()),
                           ("sharded_ba", run_sharded_ba, ()),
                           ("utilization", run_utilization, ())):
        t_phase = time.perf_counter()
        with recording_schur_shapes() as shapes:
            _, cli_counts[name] = fn(device, *args)
        entry_shapes[name] = shapes
        phase_seconds[name] = time.perf_counter() - t_phase
    tools_dir.cleanup()
    emit({"phase": "entry_point_seconds", **phase_seconds,
          "total": sum(phase_seconds.values())})
    # every BA window of the loops has a shape at which K4 / K5 were held
    # against their plain versions: the expected ones in the kernel phase
    # above, any other one now
    at_shape = {(k["name"], k["K"], k["L"]): k for k in backend
                if "ms" in k and not k["padded"] and not k["segment"]}
    loop_windows = (loop["ba_windows"] + svi["ba_windows"] + resume["ba_windows"]
                    + stress["ba_windows"] + alias["ba_windows"] + asyn["ba_windows"]
                    + overlap["ba_windows"])
    late = sorted({(w["kernel"], w["K"], w["L"]) for w in loop_windows
                   if (w["kernel"], w["K"], w["L"]) not in at_shape})
    for shape in late:
        at_shape[shape] = check_schur_kernel(device, *shape, timed=True)
    emit({"phase": "kernels_backend_loop_shapes",
          "checked_in_kernel_phase": [list(s) for s in LOOP_BA_SHAPES],
          "checked_after_the_loops": [at_shape[shape] for shape in late]})
    # the same for every window shape the entry points launched (not timed)
    t_check = time.perf_counter()
    entry_late = sorted(set().union(*entry_shapes.values()) - set(at_shape))
    for shape in entry_late:
        at_shape[shape] = check_schur_kernel(device, *shape, timed=False)
    emit({"phase": "kernels_backend_entry_point_shapes",
          "launched": {name: sorted(map(list, shapes)) for name, shapes in entry_shapes.items()},
          "checked_after_the_entry_points": [at_shape[shape] for shape in entry_late],
          "seconds": time.perf_counter() - t_check})
    # launches of each kernel entry on the path that is its own: the
    # front-end, the map optimisation on generated windows, and the whole
    # system's loop (the closure entries'; the loop's counts of all eight go
    # along). The two entries no path calls count 0 there.
    counts = {**{k: counts[k] for k in FRONTEND_KERNELS + ("stereo_profiles",)},
              **{k: backend_counts[k] for k in BACKEND_KERNELS},
              **{k: loop_counts[k] for k in (CLOSURE_KERNEL, "hamming_matrix")}}

    # the kernels line: each kernel at the largest shape its main path gives
    # it; K4 and K5 also at each window shape of the loop (the front-end
    # kernels and K6 have the same shapes there)
    at_width = {"schur_assemble": at_shape[("schur_assemble", 32, BA_LANDMARKS)],
                "schur_assemble_tiled": at_shape[("schur_assemble_tiled", 128, BA_LANDMARKS)],
                "hamming_matrix": closure_rows[0],
                CLOSURE_KERNEL: next(r for r in closure_rows if r["name"] == CLOSURE_KERNEL)}
    # registers and spills of each entry's kernel at the path's shape, as
    # ptxas printed them during this run's build
    built = {r["kernel"]: r for rows in (*front_build.values(), hamming_build,
                                         schur_build) for r in rows}
    timed_keys = ("ms", "launch_only_ms", "device_ms", "device_ms_by_kernel", "plain_ms",
                  "bound_ms", "bound_by", "max_abs_err", "rel_err_vs_plain", "bytes",
                  "flops", "product_flops_upper", "product_matmul_ms")
    kernels = []
    for k in full + [at_width[n] for n in BACKEND_KERNELS + ("hamming_matrix",
                                                               CLOSURE_KERNEL)]:
        row = {
            "name": k["name"], **KERNEL_FACTS[k["name"]],
            "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes any of the eight functions
            "library_ms": None,
            "launches_slam_loop": loop_counts[k["name"]],
            "launches_svi_loop": svi_counts[k["name"]],
            "launches_closure_query": query_counts[k["name"]],
            "launches_checkpoint_resume": resume_counts[k["name"]],
            "launches_checkpoint_svi": svi_resume_counts[k["name"]],
            "launches_stress_loop": stress_counts[k["name"]],
            "launches_stress_alias": alias_counts[k["name"]],
            "launches_stage_budget": stage_counts[k["name"]],
            "launches_async_closure": async_counts[k["name"]],
            "launches_async_closure_on_worker": asyn["launches_on_worker"][k["name"]],
            "launches_overlap_backend": overlap_counts[k["name"]],
            "launches_overlap_backend_on_worker": overlap["launches_on_worker"][k["name"]],
            "launches_native_queries": native_counts["queries"][k["name"]],
            "launches_native_dump": native_counts["dump"][k["name"]],
            "launches_cloud_tools": tools_counts[k["name"]],
            **{f"launches_{phase}": c[k["name"]] for phase, c in cli_counts.items()},
            # per rank: one NCCL rank; two gloo ranks on main_path's frames
            # and on the loop
            "launches_sharded_frame": {
                "one_nccl_rank": sharded_counts["nccl_1"][k["name"]],
                "gloo_frames_per_rank": [c[k["name"]] for c in sharded_counts["gloo_frames"]],
                "gloo_loop_per_rank": [c[k["name"]] for c in sharded_counts["gloo_loop"]],
                "gloo_overlap_per_rank": [c[k["name"]]
                                          for c in sharded_counts["gloo_overlap"]],
                "gloo_svi_loop_per_rank": [c[k["name"]]
                                           for c in sharded_counts["gloo_svi_loop"]],
                "gloo_resume_per_rank": [c[k["name"]] for c in sharded_counts["gloo_resume"]],
                "gloo_svi_resume_per_rank": [c[k["name"]]
                                             for c in sharded_counts["gloo_svi_resume"]]},
            "on_path": k["name"] not in OFF_PATH_ENTRIES,
        }
        for extra in ("launch_only_ms", "rel_err_vs_plain", "K", "L", "flops",
                      "product_flops_upper",
                      "device_ms_by_kernel", "product_matmul_ms", "N", "M",
                      "matmul_identity_ms", "bytes", "operations", "device_ms",
                      "pixels_scored_per_landmark",
                      "match_stereo_ms", "B", "P", "C", "Pr"):
            if extra in k:
                row[extra] = k[extra]
        ptx = built.get(PTXAS_KERNEL.get(k["name"], ""))
        if ptx is not None:
            row["ptxas"] = {key: ptx.get(key) for key in ("registers", "spill_stores",
                                                          "spill_loads")}
        if k["name"] == "track_scores":
            # the same count on the bands the whole system's loop built
            row["pixels_scored_per_landmark_slam_loop"] = \
                loop["track_scores_on_path"]["pixels_scored_per_landmark"]
        if k["name"] in BACKEND_KERNELS:
            for key, path in (("at_slam_loop", loop), ("at_svi_loop", svi),
                              ("at_checkpoint_resume", resume), ("at_stress_loop", stress),
                              ("at_stress_alias", alias), ("at_async_closure", asyn),
                              ("at_overlap_backend", overlap)):
                row[key] = [
                    {"K": w["K"], "L": w["L"], "windows": w["windows"],
                     "launches": w["launches"],
                     **{t: at_shape[(w["kernel"], w["K"], w["L"])][t]
                        for t in timed_keys
                        if t in at_shape[(w["kernel"], w["K"], w["L"])]}}
                    for w in path["ba_windows"] if w["kernel"] == k["name"]]
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
