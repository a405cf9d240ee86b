"""Per-stage device timing — the tracker_gt exit report, measured.

The reference prints a stage budget at exit (regional L1/R1/L2/R2, epipolar,
posit, loop closing, g2o, keyframes, landmark opt; tracker_gt.cpp:285-308),
accumulated with wall-clock timers around each host stage. Here each stage
runs on its own on representative state — the same functions the frame
step and the keyframe tail call, timed in isolation between two
``torch.cuda.synchronize()`` calls (launch overhead and the stage's own host
reads included, so the sum exceeds the frame step's cost; the deltas are
what matter for tuning).

The stages reach the port's kernels: ``dense_brief_x2`` the dense BRIEF
field (K3), ``tracking_window`` the window scoring (K1) and the fused
scanline match (K2), ``stereo_rematch`` K2's match, ``ba_window_10lm`` the
Schur assembly (K4), ``closure_query_fused`` the pool count (K6).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from svi_mapper_tpu_torch.utils.device import resolve_device


def _timeit(fn, reps: int, dev: torch.device) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls after one warm
    call, the clock read between two device synchronisations."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def stage_budget(width: int = 1241, height: int = 376, reps: int = 10,
                 device=None) -> dict:
    """Time every pipeline stage on KITTI-scale inputs on ``device``
    (``None`` means CUDA).

    Returns a dict of stage -> milliseconds, in pipeline order (front-end
    stages are per frame; back-end stages per keyframe event).
    """
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.frontend import epipolar as epi
    from svi_mapper_tpu_torch.frontend.recovery import regional_recovery
    from svi_mapper_tpu_torch.frontend.stereo import match_stereo
    from svi_mapper_tpu_torch.frontend.tracking import track_landmarks
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
    from svi_mapper_tpu_torch.models import frame as frame_mod
    from svi_mapper_tpu_torch.ops.corners import detect_corners
    from svi_mapper_tpu_torch.ops.descriptors import smooth_brief_dense
    from svi_mapper_tpu_torch.ops.image import _pad
    from svi_mapper_tpu_torch.solvers import ba as ba_mod
    from svi_mapper_tpu_torch.solvers.landmark_opt import optimize_landmarks
    from svi_mapper_tpu_torch.solvers.posit import solve_stereo_posit

    dev = resolve_device(device)
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=1024,
                                 max_detections=1024)
    seq = SyntheticSequence(n_frames=8, width=width, height=height, step=0.8,
                            device=dev)
    frames = [seq.frame(i) for i in range(8)]
    cam = seq.cam

    # warm a representative state (live landmark table, velocity prior)
    state = frame_mod.init_state(params, device=dev)
    for (L, R, T) in frames[:6]:
        state, _ = frame_mod.process_frame(
            state, L, R, cam, params, T, use_external_prior=True, device=dev)
    img_l, img_r, Tf = frames[6]
    T_prior = torch.as_tensor(Tf, dtype=torch.float32).to(dev)

    wp = -(-width // 16) * 16
    img_l_ext = _pad(img_l, 0, 0, 0, wp - width, "edge")
    img_r_ext = _pad(img_r, 0, 0, 0, wp - width, "edge")

    budget: dict[str, float] = {}

    budget["dense_brief_x2"] = _timeit(
        lambda: (smooth_brief_dense(img_l_ext), smooth_brief_dense(img_r_ext)),
        reps, dev)
    dense_l = smooth_brief_dense(img_l_ext)
    dense_r = smooth_brief_dense(img_r_ext)

    ms = epi.motion_scaling(torch.eye(4, device=dev))
    tr = track_landmarks(dense_l, dense_r, state.table, T_prior, cam, ms)
    budget["tracking_window"] = _timeit(
        lambda: track_landmarks(dense_l, dense_r, state.table, T_prior, cam, ms),
        reps, dev)

    budget["stereo_rematch"] = _timeit(
        lambda: match_stereo(dense_r, tr.uv4[:, :2], tr.desc_left, tr.tracked,
                             cam, cutoff=100), reps, dev)

    budget["posit_gn"] = _timeit(
        lambda: solve_stereo_posit(T_prior, state.table.pos_w, tr.uv4,
                                   tr.tracked, cam, T_prior=T_prior), reps, dev)

    budget["regional_recovery"] = _timeit(
        lambda: regional_recovery(dense_l, dense_r, img_l, state.table,
                                  tr.tracked, T_prior, cam, ms), reps, dev)

    budget["landmark_gn"] = _timeit(
        lambda: optimize_landmarks(state.table, cam), reps, dev)

    budget["detect_corners"] = _timeit(
        lambda: detect_corners(img_l, k=params.max_detections,
                               cell=params.detect_cell, border=28), reps, dev)

    # back-end stages (per keyframe event) --------------------------------
    rng = np.random.default_rng(0)
    K, Lm = 8, 1024
    X = rng.uniform([-20, -2, 5], [20, 2, 60], (Lm, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -np.arange(K, dtype=np.float32)
    fx, cx, cy, bq = cam.left.fx, cam.left.cx, cam.left.cy, cam.right.p03
    p_c = np.einsum("kij,lj->kli", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p_c[..., 2]
    u_l = fx * p_c[..., 0] / z + cx
    v_l = fx * p_c[..., 1] / z + cy
    obs = np.stack([u_l, v_l, (fx * p_c[..., 0] + bq) / z + cx, v_l], -1)
    mask = (z > 1.0) & (u_l > 0) & (u_l < width) & (v_l > 0) & (v_l < height)
    fix = np.zeros(K, bool)
    fix[0] = True

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    args = (t(T), t(X + 0.1), t(obs, torch.float32), t(mask), cam, t(fix))
    budget["ba_window_10lm"] = _timeit(
        lambda: ba_mod.bundle_adjust(*args, max_iterations=10,
                                     min_rel_improvement=0.0, device=dev),
        max(2, reps // 2), dev)

    # BA window preparation (depth gate + self-consistency re-init + tier
    # weights)
    from svi_mapper_tpu_torch.solvers import ba_prep as prep_mod
    budget["ba_window_prep"] = _timeit(
        lambda: prep_mod.prepare_ba_window(
            t(T), t(obs, torch.float32), t(mask), t(X + 0.1), cam, device=dev),
        reps, dev)

    from svi_mapper_tpu_torch.solvers import pose_graph as pg_mod
    N = 64
    Tn = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    Tn[:, 2, 3] = -np.arange(N, dtype=np.float32)
    M_seq = np.matmul(Tn[1:], np.linalg.inv(Tn[:-1]))
    edges = pg_mod.PoseGraphEdges(
        i=torch.arange(N - 1, dtype=torch.int32, device=dev),
        j=torch.arange(1, N, dtype=torch.int32, device=dev),
        T_ij=t(M_seq.astype(np.float32)),
        weight=torch.ones(N - 1, dtype=torch.float32, device=dev),
        valid=torch.ones(N - 1, dtype=torch.bool, device=dev),
    )
    fixn = np.zeros(N, bool)
    fixn[0] = True
    budget["pose_graph_64kf"] = _timeit(
        lambda: pg_mod.optimize_pose_graph(t(Tn), edges, t(fixn), device=dev),
        max(2, reps // 2), dev)

    from svi_mapper_tpu_torch.mapping import closure as cm
    from svi_mapper_tpu_torch.mapping.vocabulary import BowDatabase, build_vocabulary

    db = cm.KeyframeDatabase.create(64, 256, auto_vocab=False, device=dev)
    pool_d = rng.integers(0, 2 ** 32, (40, 200, 8), dtype=np.uint64).astype(np.uint32)
    pool_p = rng.uniform(-10, 10, (40, 200, 3)).astype(np.float32)
    for k in range(40):
        db.add(pool_d[k], pool_p[k], np.eye(4, dtype=np.float32))
    vocab = build_vocabulary(pool_d.reshape(-1, 8)[:2000], k=8, levels=3, iters=2,
                             device=dev)
    db.bow = BowDatabase(vocab, capacity=64)
    for k in range(40):
        db.bow.add(pool_d[k])
    cand = torch.arange(4, dtype=torch.int32, device=dev)
    Ti = torch.eye(4, dtype=torch.float32, device=dev).expand(4, 4, 4)
    budget["closure_match_icp"] = _timeit(
        lambda: cm.match_pools_many(39, cand, db.desc, db.p_cam, db.valid, Ti),
        reps, dev)
    # the production path: the whole query in one call
    budget["closure_query_fused"] = _timeit(
        lambda: cm.closure_query_fused(
            vocab.centroids, vocab.child_valid, vocab.weights,
            db.bow.vectors, 39, db.desc, db.p_cam, db.valid,
            db.T_wc, 29, float("inf"), 25, vocab.k, 16, 4, 25), reps, dev)
    return budget


def format_budget(budget: dict) -> str:
    """tracker_gt.cpp:285-308-style stage table."""
    total_fe = sum(v for k, v in budget.items()
                   if not k.startswith(("ba_", "pose_graph", "closure_")))
    lines = ["per-stage timing (isolated stages; launches and host reads incl.)",
             "-" * 58]
    for k, v in budget.items():
        lines.append(f"  {k:24s} {v:8.2f} ms")
    lines.append("-" * 58)
    lines.append(f"  front-end stage sum      {total_fe:8.2f} ms "
                 "(the frame step shares work)")
    return "\n".join(lines)
