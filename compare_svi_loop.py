#!/usr/bin/env python3
"""The stereo-inertial bench loop through one package on the CPU.

    python3 compare_svi_loop.py jax|port|lockstep|backend [--frames N]
                                [--threads T] [--seed S]

Runs the configuration of ``bench.py:bench_svi`` — 208 frames of the 26 m
loop at 376 x 1241 in the corridor world, 10 IMU samples per frame from
``synthesize_measurements(noise_gyro=0.001, noise_accel=0.02)``, the bench's
parameters, ``equalize=False``, ``process_many_imu(chunk=32)`` then
``finalize_backend()``; ``--seed`` picks the measurement noise, 0 as the
bench — through the JAX package's ``StereoInertialTracker``
or the port's (``device="cpu"``), each package rendering its own frames and
synthesizing its own measurements as the bench does. Prints one JSON line:
keyframes, closures accepted and deduped, BA and pose-graph runs, the pose
solve's refusals, the aligned ATE of the recorded (VO) and of the optimised
trajectory (each package's ``eval.trajectory.ate_rmse``), the recorded
step at each refused frame against the true one, and the seconds taken. The
two packages' lines side by side are the CPU reference for
``chip_smoke.py``'s ``svi_loop`` phase (whose sample blocks this script
borrows).

``lockstep`` runs the JAX package's tracker frame by frame
(``process_imu_samples``, back-end on) on its frames and measurements, and
before every frame starts the port's ``process_frame_svi`` from the JAX
tracker's state and velocity: it prints, per frame where they differ and in
sum, the flags, counts, pose and velocity differences, so that a gap between
the two free-running lines can be told apart as drift or a fault.

``backend`` runs the JAX package's tracker on the loop as ``jax`` does, notes
every call of its bundle adjustment and pose graph (inputs and results), and
gives each call's inputs to the port's solver on the CPU: per call, chi^2
before and after in both packages, how far each moved the keyframes, and how
far apart the two results are.

This script imports the JAX package only when asked to run it; it is not
part of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from chip_smoke import svi_blocks

LOOP_RADIUS = 26.0
H, W = 376, 1241
DT = 0.05


def run_jax(n: int, seed: int = 0) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.eval import trajectory as ev
    from svi_mapper_tpu.imu import interpolator as imu
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.svi import StereoInertialTracker

    seq = SyntheticSequence(n_frames=n, width=W, height=H, trajectory="loop",
                            loop_radius=LOOP_RADIUS)
    L = jnp.stack([jnp.asarray(f[0]) for f in seq])
    R = jnp.stack([jnp.asarray(f[1]) for f in seq])
    calib0 = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, DT, calib=calib0, noise_gyro=0.001, noise_accel=0.02, seed=seed)
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=1024, max_detections=1024,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5)
    t0 = time.perf_counter()
    tr = StereoInertialTracker(seq.cam, calib0, params, equalize=False)
    outs = tr.process_many_imu(L, R, *svi_blocks(n, omega, accel), chunk=32)
    tr.finalize_backend()
    seconds = time.perf_counter() - t0
    return _report("jax", tr, outs, seq.poses_wc, ev, seconds)


def run_port(n: int, seed: int = 0) -> dict:
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    seq = SyntheticSequence(n_frames=n, width=W, height=H, trajectory="loop",
                            loop_radius=LOOP_RADIUS, device="cpu")
    L = torch.stack([f[0] for f in seq])
    R = torch.stack([f[1] for f in seq])
    calib0 = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, DT, calib=calib0, noise_gyro=0.001, noise_accel=0.02, seed=seed,
        device="cpu")
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=1024, max_detections=1024,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5)
    t0 = time.perf_counter()
    tr = StereoInertialTracker(seq.cam, calib0, params, equalize=False, device="cpu")
    outs = tr.process_many_imu(L, R, *svi_blocks(n, omega, accel), chunk=32)
    tr.finalize_backend()
    seconds = time.perf_counter() - t0
    return _report("port", tr, outs, seq.poses_wc, ev, seconds)


def run_lockstep(n: int) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
    from svi_mapper_tpu.imu import interpolator as jimu
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.svi import StereoInertialTracker
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.models import frame as frame_mod

    seq = SyntheticSequence(n_frames=208, width=W, height=H, trajectory="loop",
                            loop_radius=LOOP_RADIUS)
    calib0 = jimu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = jimu.synthesize_measurements(
        seq.poses_wc, DT, calib=calib0, noise_gyro=0.001, noise_accel=0.02)
    kw = dict(max_landmarks=1024, max_detections=1024, keyframe_translation_m2=4.0,
              keyframe_rotation_rad2=0.02, max_motion_scaling_for_optimization=2.5)
    jparams = dataclasses.replace(JPARAMS, **kw)
    params = dataclasses.replace(DEFAULT_PARAMS, **kw)
    jt = StereoInertialTracker(seq.cam, calib0, jparams, equalize=False)
    pcam = convert.camera_from_numpy({side: {
        "P": np.asarray(c.P), "K": np.asarray(c.K), "dist": np.asarray(c.dist),
        "R_rect": np.asarray(c.R_rect), "width": c.width, "height": c.height}
        for side, c in (("left", seq.cam.left), ("right", seq.cam.right))}, "cpu")
    dts, oms, acs = svi_blocks(n, omega, accel)
    zero3 = torch.zeros(3)
    rows, differ = [], []
    for i in range(n):
        L, R, _ = seq.frame(i)
        L, R = np.asarray(L), np.asarray(R)
        table = {f: np.asarray(getattr(jt.state.table, f))
                 for f in jt.state.table.__dataclass_fields__}
        st = convert.state_from_numpy(
            {**{k: np.asarray(getattr(jt.state, k)) for k in
                ("T_wc", "T_wc_prev", "T_last_keyframe", "next_uid", "frame_idx",
                 "instability")}, "table": table}, "cpu")
        vel0 = torch.from_numpy(np.array(jt.velocity, np.float32))
        cap = 32
        d = np.zeros(cap, np.float32)
        o = np.zeros((cap, 3), np.float32)
        a = np.zeros((cap, 3), np.float32)
        k = len(dts[i])
        d[:k], o[:k], a[:k] = dts[i], oms[i], acs[i]
        _, pout, pvel = frame_mod.process_frame_svi(
            st, L, R, pcam, params, torch.from_numpy(d), torch.from_numpy(o),
            torch.from_numpy(a), torch.arange(cap) < k, vel0, torch.eye(3), zero3,
            zero3, device="cpu")
        jout = jt.process_imu_samples(L, R, dts[i], oms[i], acs[i])
        pout = pout.to_host()
        A, B = np.asarray(jout.T_wc, np.float64), np.asarray(pout.T_wc, np.float64)
        dpos = float(np.linalg.norm(A[:3, :3].T @ A[:3, 3] - B[:3, :3].T @ B[:3, 3]))
        D = A[:3, :3] @ B[:3, :3].T
        drot = float(np.linalg.norm(0.5 * np.array(
            [D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])))
        dvel = float(np.abs(np.asarray(jt.velocity) - pvel.numpy()).max())
        flags = [int(getattr(jout, f)) - int(getattr(pout, f)) for f in
                 ("posit_ok", "is_keyframe", "n_tracked", "inliers", "instability")]
        rows.append((dpos, drot, dvel))
        if any(flags):
            differ.append([i] + flags)
    r = np.asarray(rows)
    return {"mode": "lockstep", "frames": n, "frames_differing_in_flags_or_counts": differ,
            "pose_m_max": float(r[:, 0].max()), "pose_m_max_at": int(r[:, 0].argmax()),
            "pose_m_median": float(np.median(r[:, 0])),
            "rot_rad_max": float(r[:, 1].max()),
            "velocity_max": float(r[:, 2].max()), "velocity_max_at": int(r[:, 2].argmax()),
            "velocity_median": float(np.median(r[:, 2])),
            "jax_keyframes": len(jt.slam_keyframes), "jax_stats": dict(jt.stats)}


def run_backend(n: int, seed: int = 0) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from svi_mapper_tpu.models import slam as jslam
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.solvers import ba, pose_graph as pg

    calls = []
    jax_ba, jax_pg = jslam.ba_mod.bundle_adjust, jslam.pg_mod.optimize_pose_graph

    def host(v):
        return np.asarray(v) if hasattr(v, "shape") else v

    def noting_ba(T, X, obs, mask, cam, fix, **kw):
        res = jax_ba(T, X, obs, mask, cam, fix, **kw)
        calls.append(("ba", cam, [host(a) for a in (T, X, obs, mask, fix)],
                      {k: host(v) for k, v in kw.items()}, res))
        return res

    def noting_pg(T, edges, fix, gravity=None, **kw):
        res = jax_pg(T, edges, fix, gravity=gravity, **kw)
        calls.append(("pg", None, [host(T), edges, host(fix), gravity], kw, res))
        return res

    jslam.ba_mod.bundle_adjust, jslam.pg_mod.optimize_pose_graph = noting_ba, noting_pg
    try:
        loop = run_jax(n, seed)
    finally:
        jslam.ba_mod.bundle_adjust, jslam.pg_mod.optimize_pose_graph = jax_ba, jax_pg

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))

    def centres(T):
        T = np.asarray(T, np.float64)
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])

    rows = []
    for kind, jcam, args, kw, jres in calls:
        if kind == "ba":
            T0, X, obs, mask, fix = args
            cam = convert.camera_from_numpy({side: {
                "P": np.asarray(c.P), "K": np.asarray(c.K), "dist": np.asarray(c.dist),
                "R_rect": np.asarray(c.R_rect), "width": c.width, "height": c.height}
                for side, c in (("left", jcam.left), ("right", jcam.right))}, "cpu")
            res = ba.bundle_adjust(t(T0), t(X), t(obs), t(mask), cam, t(fix), device="cpu",
                                   **{k: (t(v) if isinstance(v, np.ndarray) else v)
                                      for k, v in kw.items()})
            real = slice(0, int(T0.shape[0]))
        else:
            T0, edges, fix, grav = args
            e = {f: np.asarray(getattr(edges, f)) for f in
                 ("i", "j", "T_ij", "weight", "valid", "info6")}
            res = pg.optimize_pose_graph(
                t(T0), pg.PoseGraphEdges(**{f: t(v) for f, v in e.items()}), t(fix),
                gravity=None if grav is None else pg.GravityPriors(
                    t(grav.down_cam), t(grav.weight), t(grav.valid)),
                device="cpu", **kw)
            real = slice(0, int(np.asarray(grav.valid).sum()) if grav is not None
                         else int(T0.shape[0]))
        cj, cp, c0 = (centres(np.asarray(x)[real])
                      for x in (jres.T_wc, res.T_wc.numpy(), T0))
        rows.append({
            "call": kind, "K": int(np.asarray(T0).shape[0]),
            "L": int(args[1].shape[0]) if kind == "ba" else None,
            "gravity": (kw.get("grav_d") is not None) if kind == "ba" else args[3] is not None,
            "chi2_jax": [float(jres.chi2_initial), float(jres.chi2_final)],
            "chi2_port": [float(res.chi2_initial), float(res.chi2_final)],
            "moved_jax_m": float(np.linalg.norm(cj - c0, axis=1).max()),
            "moved_port_m": float(np.linalg.norm(cp - c0, axis=1).max()),
            "jax_to_port_m": float(np.linalg.norm(cj - cp, axis=1).max())})
    return {"mode": "backend", "seed": seed, "jax_run": {k: loop[k] for k in (
        "keyframes", "stats", "ate_recorded_m", "ate_optimised_m")}, "calls": rows}


def _report(package, tr, outs, poses, ev, seconds) -> dict:
    import numpy as np

    opt = tr.optimized_trajectory()
    raw = tr.trajectory_array
    refused = [i for i, o in enumerate(outs[1:], 1) if not bool(o.posit_ok)]

    def step(T, i):
        c = -np.einsum("nji,nj->ni", T[i - 1:i + 1, :3, :3], T[i - 1:i + 1, :3, 3])
        return float(np.linalg.norm(c[1] - c[0]))

    return {
        "package": package, "frames": len(outs), "image": [H, W], "chunk": 32,
        "seconds": seconds,
        "keyframes": len(tr.slam_keyframes),
        "gravity_obs": len(tr.gravity_obs),
        "stats": {k: int(v) for k, v in tr.stats.items()},
        "accepted_closures": [[c.ref_kf, c.query_kf] for c in tr.accepted_closures],
        "keyframe_frames": [kf.frame_idx for kf in tr.slam_keyframes],
        "posit_rejected_at_frames": refused,
        "recorded_step_at_refused_m": [step(raw, i) for i in refused],
        "true_step_at_refused_m": [step(np.asarray(poses, np.float64), i) for i in refused],
        "ate_recorded_m": ev.ate_rmse(raw, poses),
        "ate_optimised_m": ev.ate_rmse(opt, poses),
        "finite": bool(np.isfinite(opt).all()),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "port", "lockstep", "backend"))
    ap.add_argument("--frames", type=int, default=208)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0, help="measurement noise seed")
    args = ap.parse_args()
    os.environ.setdefault("OMP_NUM_THREADS", str(args.threads))
    if args.package == "port":
        import torch

        torch.set_num_threads(args.threads)
        print(json.dumps(run_port(args.frames, args.seed)), flush=True)
    elif args.package in ("lockstep", "backend"):
        import torch

        torch.set_num_threads(args.threads)
        run = run_lockstep(args.frames) if args.package == "lockstep" else run_backend(
            args.frames, args.seed)
        print(json.dumps(run), flush=True)
    else:
        print(json.dumps(run_jax(args.frames, args.seed)), flush=True)


if __name__ == "__main__":
    main()
