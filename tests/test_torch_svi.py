"""The stereo-inertial path as a whole: the port's ``StereoInertialTracker``
and ``process_chunk_svi`` against the JAX package's tracker on the same
frames and the same IMU measurement arrays (the JAX package's own, as
``tests/test_imu.py`` makes them), at 512 x 256 with 512 landmarks over 14
frames of a 200 Hz trajectory.

Lock step: before every frame the port is started from the JAX tracker's
state (``convert.svi_state_from_numpy``: frame state, carried velocity,
gravity observations). Then, per frame: ``T_prior`` and ``T_fb`` within
1e-6; ``posit_ok``, ``is_keyframe``, ``n_tracked`` and ``inliers`` equal;
the pose within 1e-4 m and 1e-5 rad; the velocity within 1e-4 m/s. The
velocity is the float32 log of the frame's pose step over its interval. Where
that step turns between 1e-4 and 1e-2 rad the two packages' ``log_se3`` take
different branches: the JAX package's closed form has no digits left there
(ROADMAP F6; found 3.4e-3 m/s off at 2.9e-3 rad) and the port's series is
right, so there the port is held against a float64 restatement (found:
3.3e-7 m/s). Elsewhere both take the same branch and the port is held against
the JAX package (found: 5.9e-5 m/s; both are up to 6.5e-4 m/s from float64
above 1e-2 rad, ROADMAP F10). The lock step runs through the port's
``process_imu`` (frames 0-1), ``process_imu_samples`` (frames 2-13) and
``process_chunk_svi`` (a one-frame chunk, frames 2-13).

The chunked and free-running checks are in ``test_torch_svi_system.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.geometry import se3 as j_se3
from svi_mapper_tpu.imu import interpolator as j_imu
from svi_mapper_tpu.io.synthetic import default_camera as j_default_camera
from svi_mapper_tpu.io.synthetic import render_stereo as j_render_stereo
from svi_mapper_tpu.models.svi import StereoInertialTracker as JTracker
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.models import frame as frame_mod
from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

from test_imu import _fine_trajectory
from test_torch_imu import log_se3_64
from torch_parity import state_dict, torch_camera

CPU = "cpu"
N_FRAMES, SUB, DT_FINE = 14, 10, 0.005
UP = np.array([0.0, -1.0, 0.0])
# where the JAX package's log_se3 takes its closed form and the port's its
# series (their branch points, theta^2 = 1e-8 and 1e-4)
BRANCHES_DIFFER = (1e-4, 1e-2)


def _params(base):
    # a 0.2 m keyframe baseline: the 1 m run spawns several keyframes
    return dataclasses.replace(base, max_landmarks=512, max_detections=512,
                               keyframe_translation_m2=0.04,
                               keyframe_rotation_rad2=0.01)


def _pose_diff(A, B):
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    ca = -A[:3, :3].T @ A[:3, 3]
    cb = -B[:3, :3].T @ B[:3, 3]
    D = A[:3, :3] @ B[:3, :3].T
    w = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.linalg.norm(ca - cb)), float(np.arcsin(min(1.0, np.linalg.norm(w))))


def make_data(n_frames: int = N_FRAMES) -> dict:
    """Frames rendered by the JAX package's renderer, its IMU measurement
    arrays and calibration, and the port's camera (the first ``n_frames``
    frames of the trajectory)."""
    poses_fine = _fine_trajectory(n_frames, SUB, DT_FINE)
    jcam = j_default_camera(512, 256)
    bias_g = np.array([0.008, -0.003, 0.002])
    bias_a = np.array([0.04, -0.02, 0.08])
    fake = j_imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = j_imu.synthesize_measurements(
        poses_fine, DT_FINE, calib=fake, noise_gyro=0.002, noise_accel=0.04, seed=3)
    rng = np.random.default_rng(0)
    calib = j_imu.calibrate(bias_g + rng.normal(0, 0.001, (200, 3)),
                            UP * j_imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3)))
    frame_poses = poses_fine[::SUB][:n_frames]
    frames = [tuple(np.asarray(x) for x in j_render_stereo(jcam, jnp.asarray(T)))
              for T in frame_poses]
    blocks = []           # (dts, omega, accel) per frame; frame 0 is static
    for i in range(n_frames):
        if i == 0:
            blocks.append((np.full(1, DT_FINE, np.float32), np.zeros((1, 3), np.float32),
                           (UP * j_imu.GRAVITY)[None].astype(np.float32)))
        else:
            lo, hi = (i - 1) * SUB, i * SUB
            blocks.append((np.full(SUB, DT_FINE, np.float32), omega[lo:hi], accel[lo:hi]))
    return dict(jcam=jcam, cam=torch_camera(jcam), calib=calib, frames=frames,
                blocks=blocks, poses=frame_poses)


@pytest.fixture(scope="module")
def data():
    return make_data()


def port_tracker(data, **kw):
    return StereoInertialTracker(
        data["cam"], convert.imu_calibration_from_numpy(data["calib"]),
        _params(DEFAULT_PARAMS), equalize=False, enable_loop_closure=False,
        enable_local_ba=False, device=CPU, **kw)


def _jax_svi_dict(jt):
    return {"state": state_dict(jt.state), "velocity": np.asarray(jt.velocity),
            "gravity_obs": np.array(jt.gravity_obs, np.float32).reshape(-1, 3),
            "T_cam_imu": np.asarray(jt.T_cam_imu)}


def _jax_prior(jt, block):
    """The JAX package's ``T_prior`` and dead-reckoning ``T_fb`` of
    ``process_imu_samples`` for the tracker's state, restated from its code."""
    cap = jt._imu_sample_cap
    dts, om, ac = block
    n = len(dts)
    pad = lambda a, shape: np.concatenate([a, np.zeros(shape, np.float32)])  # noqa: E731
    T = jnp.asarray(jt.state.T_wc)
    T_prior, rot = j_imu.integrate_prior_samples(
        T, jnp.asarray(pad(dts, (cap - n,))), jnp.asarray(pad(om, (cap - n, 3))),
        jnp.asarray(pad(ac, (cap - n, 3))), jnp.asarray(np.arange(cap) < n),
        jnp.asarray(jt.velocity), jt._R_ci,
        jnp.asarray(jt.calib.bias_gyro, jnp.float32),
        jnp.asarray(jt.calib.bias_accel, jnp.float32))
    rot_yz = np.asarray(rot).astype(np.float32)
    rot_yz[0] = 0.0
    T_fb = np.eye(4, dtype=np.float32)
    T_fb[:3, :3] = np.asarray(j_se3.exp_so3(jnp.asarray(rot_yz)))
    return np.asarray(T_prior), T_fb @ np.asarray(jt.state.T_wc)


def _pad(block, cap=32):
    dts, om, ac = block
    n = len(dts)
    d = torch.zeros(cap)
    o = torch.zeros(cap, 3)
    a = torch.zeros(cap, 3)
    d[:n], o[:n], a[:n] = torch.from_numpy(dts), torch.from_numpy(om), torch.from_numpy(ac)
    return d, o, a, torch.arange(cap) < n


@pytest.fixture(scope="module")
def lockstep(data):
    jt = JTracker(data["jcam"], data["calib"], _params(JPARAMS), equalize=False,
                  enable_loop_closure=False, enable_local_ba=False)
    pa = port_tracker(data)
    rows = []
    for i, ((L, R), block) in enumerate(zip(data["frames"], data["blocks"])):
        d = _jax_svi_dict(jt)
        T_before = np.asarray(jt.state.T_wc)
        row = {"i": i}
        if i >= 2:
            row["prior_jax"] = _jax_prior(jt, block)
        convert.svi_state_from_numpy(pa, d)
        if i == 0:
            a = jt.process_imu(L, R, np.zeros(3), UP * j_imu.GRAVITY, DT_FINE)
            b = pa.process_imu(L, R, np.zeros(3), UP * j_imu.GRAVITY, DT_FINE)
        elif i == 1:
            a = jt.process_imu(L, R, block[1][0], block[2][0], 0.05)
            b = pa.process_imu(L, R, block[1][0], block[2][0], 0.05)
        else:
            a = jt.process_imu_samples(L, R, *block)
            b = pa.process_imu_samples(L, R, *block)
            st = convert.state_from_numpy(d["state"], CPU)
            dts, om, ac, va = _pad(block)
            R_ci = torch.from_numpy(np.array(jt._R_ci))
            bg = torch.tensor(jt.calib.bias_gyro, dtype=torch.float32)
            ba = torch.tensor(jt.calib.bias_accel, dtype=torch.float32)
            T_prior, T_fb, _ = frame_mod.svi_prior(
                st.T_wc, dts, om, ac, va, torch.from_numpy(d["velocity"]), R_ci, bg, ba)
            row["prior_port"] = (T_prior.numpy(), T_fb.numpy())
            st2, vel2, outs, _ = frame_mod.process_chunk_svi(
                st, torch.tensor(L)[None], torch.tensor(R)[None], data["cam"],
                _params(DEFAULT_PARAMS), dts[None], om[None], ac[None], va[None],
                torch.from_numpy(d["velocity"]), R_ci, bg, ba, device=CPU)
            row["chunk"] = (outs.to_host(), vel2.numpy())
        row.update(jax=a, port=b, jax_vel=np.asarray(jt.velocity, np.float32),
                   port_vel=pa.velocity.numpy(), T_before=T_before,
                   dt=float(np.sum(block[0])) if i >= 2 else (DT_FINE if i == 0 else 0.05))
        rows.append(row)
    return dict(rows=rows, jt=jt, pa=pa)


def _step_angle(T_new, T_before):
    D = np.asarray(T_new, np.float64) @ np.linalg.inv(np.asarray(T_before, np.float64))
    return float(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))


def test_lockstep_priors(lockstep):
    rows = [r for r in lockstep["rows"] if "prior_port" in r]
    assert len(rows) == N_FRAMES - 2
    for r in rows:
        for got, want in zip(r["prior_port"], r["prior_jax"]):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=str(r["i"]))


@pytest.mark.parametrize("path", ["tracker", "chunk"])
def test_lockstep_flags_counts_pose_velocity(lockstep, path):
    checked = 0
    for r in lockstep["rows"]:
        if path == "chunk":
            if "chunk" not in r:
                continue
            stacked, vel = r["chunk"]
            b = frame_mod.FrameOutput(**{f.name: getattr(stacked, f.name)[0]
                                         for f in dataclasses.fields(stacked)})
        else:
            b, vel = r["port"], r["port_vel"]
        a = r["jax"]
        i = r["i"]
        assert bool(a.posit_ok) == bool(b.posit_ok), i
        assert bool(a.is_keyframe) == bool(b.is_keyframe), i
        assert int(a.n_tracked) == int(b.n_tracked), i
        assert int(a.inliers) == int(b.inliers), i
        dpos, drot = _pose_diff(a.T_wc, b.T_wc)
        assert dpos < 1e-4 and drot < 1e-5, (i, dpos, drot)
        theta = _step_angle(b.T_wc, r["T_before"])
        if BRANCHES_DIFFER[0] <= theta < BRANCHES_DIFFER[1]:
            xi = log_se3_64(np.asarray(b.T_wc, np.float64)
                            @ np.linalg.inv(np.asarray(r["T_before"], np.float64)))
            want = xi[:3] / np.float32(r["dt"])
        else:
            want = r["jax_vel"]
        np.testing.assert_allclose(vel, want, atol=1e-4, rtol=0, err_msg=str(i))
        checked += 1
    assert checked == (N_FRAMES if path == "tracker" else N_FRAMES - 2)


def test_lockstep_gravity_terms_match(lockstep):
    """``_gravity_priors`` / ``_gravity_ba_terms`` from the same gravity
    observations equal the JAX package's on the real rows."""
    jt, pa = lockstep["jt"], lockstep["pa"]
    convert.svi_state_from_numpy(pa, _jax_svi_dict(jt))
    n = len(jt.gravity_obs)
    assert n >= 2 and n == len(jt.slam_keyframes)
    for N in (n, 8):
        want = jt._gravity_priors(n, N)
        got = pa._gravity_priors(n, N)
        for f in ("down_cam", "weight", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert pa._gravity_priors(n + 1, n + 1) is None
    kfs = jt.slam_keyframes
    for K in (len(kfs), 8):
        want = jt._gravity_ba_terms(kfs, K)
        got = pa._gravity_ba_terms(kfs, K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_default_device_is_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    calib = convert.imu_calibration_from_numpy(data["calib"])
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoInertialTracker(data["cam"], calib)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoInertialTracker(data["cam"], calib, device="cuda")
