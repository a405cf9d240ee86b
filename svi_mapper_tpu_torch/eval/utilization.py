"""Hardware-utilization evidence: roofline share and MFU per hot pipeline
stage.

The reference's only performance instrumentation is wall-clock stage
accumulators (CTimer.h:14-29, printed at exit tracker_gt.cpp:285-308) — it
never relates stage cost to what the hardware could do. Here every hot
stage gets an absolute utilization row:

  * ``flops`` / ``bytes`` counted from what the stage launches, in one
    counting pass before the timed calls:
      - the floating-point operations of its aten ops
        (``torch.utils.flop_counter.FlopCounterMode``: matrix products and
        convolutions);
      - the bytes of its aten ops: each op's tensor inputs read and outputs
        written, on the stage's device, a broadcast dimension counted once,
        view ops and uninitialised allocations not at all;
      - for each hand-written kernel launch, the bytes and operations its
        wrapper reports beside its launch count (``ops.paths``: the
        formulas ``chip_smoke.py``'s bounds use, counted on the launch's
        own inputs);
    so the bytes are traffic the stage asks for, never a compiler's buffer
    accesses with on-chip reuse (which let the JAX package's report read
    166 % of the TPU's HBM rate);
  * ``wall_sync_ms`` — per-call wall time with a device sync per call (what
    a latency-bound caller pays, launches and host reads included);
  * ``wall_stream_ms`` — per-call wall time with many calls in flight and
    ONE final sync;
  * achieved GFLOP/s and GB/s from the stream time, and their fractions of
    the card's peak (``mfu`` = fraction of the dense bf16 tensor-core rate,
    the standard MFU definition, conservative for the float32 and integer
    work here; ``hbm_frac`` = fraction of the device-memory rate). A share
    above 1.05 is a fault of the count and raises;
  * a ``bound`` classification: ``dispatch`` when synced calls cost far
    more than streamed ones or the stream time is far above the roofline
    (launch and host overheads dominate), else ``hbm`` / ``compute`` by
    the larger roofline term; ``unknown`` without the card's peaks.

Peaks are public per-card specs keyed by the exact
``torch.cuda.get_device_name()`` (override with ``SVI_PEAK_TFLOPS_BF16`` /
``SVI_PEAK_HBM_GBPS`` for cards not listed).
"""

from __future__ import annotations

import math
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from svi_mapper_tpu_torch.ops import paths
from svi_mapper_tpu_torch.utils.device import resolve_device

# public peak specs per card: (dense bf16 tensor-core TFLOP/s, device-memory
# GB/s) — NVIDIA's H100 data sheet, SXM part, at its 700 W limit
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}

# aten ops that move no data but are not marked as views: allocations that
# leave the memory as it is, and reinterpretations of a buffer
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
               torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default}


def device_peaks(device=None) -> tuple[float, float] | None:
    """(peak TFLOP/s bf16, peak device-memory GB/s) of ``device``'s card,
    or None if unknown (always for the CPU, unless overridden)."""
    env_tf = os.environ.get("SVI_PEAK_TFLOPS_BF16")
    env_bw = os.environ.get("SVI_PEAK_HBM_GBPS")
    if env_tf and env_bw:
        return float(env_tf), float(env_bw)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAKS.get(torch.cuda.get_device_name(dev))


def _extent(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast dimension,
    stride 0, counted once)."""
    return t.element_size() * math.prod(
        n for n, s in zip(t.shape, t.stride()) if s != 0)


class _BytesMode(TorchDispatchMode):
    """Adds up each aten op's tensor inputs and outputs on one device type."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(
                _extent(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor) and t.device.type == self.device_type)
        return out


def count_work(fn, args: tuple, device=None) -> tuple[float, float, dict]:
    """``(flops, bytes, kernels)`` of one call ``fn(*args)`` on ``device``:
    aten flops and bytes plus the work the kernel wrappers report
    (``kernels``: entry -> [bytes, operations])."""
    dev = resolve_device(device)
    with paths.recording_work() as kernels, \
            FlopCounterMode(display=False) as flop_mode, _BytesMode(dev.type) as byte_mode:
        fn(*args)
    flops = float(flop_mode.get_total_flops()) + sum(op for _, op in kernels.values())
    moved = float(byte_mode.bytes) + sum(b for b, _ in kernels.values())
    return flops, moved, {k: list(v) for k, v in kernels.items()}


def analyze_stage(fn, args: tuple, *, reps_sync: int = 10, reps_stream: int = 32,
                  device=None) -> dict:
    """Utilization row for one stage called as ``fn(*args)`` on ``device``
    (``None`` means CUDA): wall times, flops/bytes, achieved rates, peak
    fractions and the bound classification."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    flops, bts, _ = count_work(fn, args, dev)

    fn(*args)                                  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps_sync):
        fn(*args)
        sync()
    wall_sync = (time.perf_counter() - t0) / reps_sync

    t0 = time.perf_counter()
    for _ in range(reps_stream):
        fn(*args)
    sync()
    wall_stream = (time.perf_counter() - t0) / reps_stream

    row = {
        "flops": flops,
        "bytes": bts,
        "wall_sync_ms": wall_sync * 1e3,
        "wall_stream_ms": wall_stream * 1e3,
        "gflops_s": flops / wall_stream / 1e9 if wall_stream > 0 else 0.0,
        "gbytes_s": bts / wall_stream / 1e9 if wall_stream > 0 else 0.0,
    }
    peaks = device_peaks(dev)
    if peaks is not None:
        tflops, gbps = peaks
        t_compute = flops / (tflops * 1e12)
        t_mem = bts / (gbps * 1e9)
        row["mfu"] = row["gflops_s"] / (tflops * 1e3)
        row["hbm_frac"] = row["gbytes_s"] / gbps
        if row["mfu"] > 1.05 or row["hbm_frac"] > 1.05:
            raise RuntimeError(
                f"utilization above the card's peak (mfu {row['mfu']:.3f}, "
                f"hbm_frac {row['hbm_frac']:.3f}): the stage's work is miscounted")
        row["roofline_ms"] = max(t_compute, t_mem) * 1e3
        # how much of what a latency-bound caller pays is streamed work
        row["busy_frac_of_sync"] = min(1.0, wall_stream / max(wall_sync, 1e-12))
        if wall_sync > 3.0 * wall_stream or max(t_compute, t_mem) < 0.3 * wall_stream:
            row["bound"] = "dispatch"
        elif t_mem >= t_compute:
            row["bound"] = "hbm"
        else:
            row["bound"] = "compute"
    else:
        row["bound"] = "unknown"
    return row


def utilization_report(width: int = 1241, height: int = 376, device=None) -> dict:
    """Utilization rows for the hot stages on ``device`` (``None`` means
    CUDA) at the stage budget's shapes: KITTI-resolution images, a
    1024-landmark table, a K = 8 BA window."""
    import dataclasses

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.frontend import epipolar as epi
    from svi_mapper_tpu_torch.frontend.tracking import track_landmarks
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence, default_camera
    from svi_mapper_tpu_torch.models import frame as frame_mod
    from svi_mapper_tpu_torch.ops.descriptors import smooth_brief_dense
    from svi_mapper_tpu_torch.ops.image import _pad
    from svi_mapper_tpu_torch.solvers import ba as ba_mod
    from svi_mapper_tpu_torch.tools.bench_scaling import make_problem

    dev = resolve_device(device)
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=1024,
                                 max_detections=1024)
    seq = SyntheticSequence(n_frames=8, width=width, height=height, step=0.8,
                            device=dev)
    frames = [seq.frame(i) for i in range(8)]
    cam = seq.cam
    state = frame_mod.init_state(params, device=dev)
    for (L, R, T) in frames[:6]:
        state, _ = frame_mod.process_frame(
            state, L, R, cam, params, T, use_external_prior=True, device=dev)
    img_l, img_r, Tf = frames[6]
    T_prior = torch.as_tensor(Tf, dtype=torch.float32).to(dev)
    wp = -(-width // 16) * 16
    img_l_ext = _pad(img_l, 0, 0, 0, wp - width, "edge")
    img_r_ext = _pad(img_r, 0, 0, 0, wp - width, "edge")
    dense_l = smooth_brief_dense(img_l_ext)
    dense_r = smooth_brief_dense(img_r_ext)
    ms = epi.motion_scaling(torch.eye(4, device=dev))

    rows: dict[str, dict] = {}
    rows["dense_brief"] = analyze_stage(smooth_brief_dense, (img_l_ext,), device=dev)
    rows["track_lattice"] = analyze_stage(
        lambda dl, dr, tb, Tp, m: track_landmarks(dl, dr, tb, Tp, cam, m),
        (dense_l, dense_r, state.table, T_prior, ms), device=dev)
    rows["frame_step_fused"] = analyze_stage(
        lambda s, l, r, Tp: frame_mod.process_frame(
            s, l, r, cam, params, Tp, use_external_prior=True, device=dev),
        (state, img_l, img_r, T_prior), device=dev)

    # BA window (per keyframe event): bench_scaling's problem at K = 8
    p = make_problem(8, 1024)
    bcam = default_camera(width=1241, height=376, device=dev)
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    rows["ba_schur_k8"] = analyze_stage(
        lambda Tj, Xj, oj, mj, fj: ba_mod.bundle_adjust(
            Tj, Xj, oj, mj, bcam, fj, max_iterations=10, min_rel_improvement=0.0,
            device=dev),
        (on(p["T"]), on(p["X0"]), on(p["obs"]), on(p["mask"]), on(p["fix"])), device=dev)

    peaks = device_peaks(dev)
    return {
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "peak_tflops_bf16": peaks[0] if peaks else None,
        "peak_hbm_gbps": peaks[1] if peaks else None,
        "stages": rows,
    }


def format_report(rep: dict) -> str:
    lines = [
        f"hardware utilization — {rep['device_kind']} "
        f"(peaks: {rep['peak_tflops_bf16']} TF/s bf16, "
        f"{rep['peak_hbm_gbps']} GB/s HBM)",
        "-" * 78,
        f"  {'stage':18s} {'sync ms':>8s} {'stream ms':>9s} {'GF/s':>8s} "
        f"{'GB/s':>7s} {'MFU':>6s} {'HBM%':>6s}  bound",
    ]
    for name, r in rep["stages"].items():
        mfu = f"{100 * r.get('mfu', 0):5.1f}%" if "mfu" in r else "    ?"
        hbm = f"{100 * r.get('hbm_frac', 0):5.1f}%" if "hbm_frac" in r else "    ?"
        lines.append(
            f"  {name:18s} {r['wall_sync_ms']:8.2f} {r['wall_stream_ms']:9.2f} "
            f"{r['gflops_s']:8.1f} {r['gbytes_s']:7.1f} {mfu:>6s} {hbm:>6s}  "
            f"{r['bound']}")
    lines.append("-" * 78)
    lines.append(
        "  sync = a device sync per call; stream = many calls, one sync;\n"
        "  MFU vs the bf16 tensor-core peak (conservative for float32 and\n"
        "  integer work). flops and bytes = what the stage launches: aten ops'\n"
        "  inputs and outputs, and each kernel's function as its wrapper reports it.")
    return "\n".join(lines)
