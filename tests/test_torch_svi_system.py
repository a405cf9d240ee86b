"""The port's stereo-inertial tracker on its own, at 512 x 256: the chunked
path against the per-frame one (the same bits), free running against the
ground truth, the full-graph BA's gravity unaries, and the velocity through
a world shift (mirrors ``tests/test_imu.py`` and
``tests/test_world_shift.py``). The frames and IMU arrays are those of
``test_torch_svi.py``'s lock step."""

import dataclasses

import numpy as np
import pytest
import torch

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.eval import trajectory as ev
from svi_mapper_tpu_torch.imu import interpolator as imu
from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

from test_torch_svi import N_FRAMES, make_data, port_tracker

CPU = "cpu"
UP = np.array([0.0, -1.0, 0.0])


@pytest.fixture(scope="module")
def data():
    return make_data()


def test_chunked_equals_per_frame_and_tracks(data):
    """``process_many_imu(chunk=7)`` (a ragged last chunk) against per-frame
    ``process_imu_samples``: the same frame step, so the same bits (the
    back-end is off: with it on, the chunked path runs the keyframe tail at
    the chunk boundary by design). Free running, the port tracks the
    sequence: ATE < 0.15 m and the pose solve accepted from frame 1."""
    Ls = np.stack([f[0] for f in data["frames"]])
    Rs = np.stack([f[1] for f in data["frames"]])
    dts, oms, acs = zip(*data["blocks"])
    chunked = port_tracker(data)
    outs = chunked.process_many_imu(Ls, Rs, list(dts), list(oms), list(acs), chunk=7)
    single = port_tracker(data)
    for (L, R), block in zip(data["frames"], data["blocks"]):
        single.process_imu_samples(L, R, *block)
    assert len(outs) == N_FRAMES
    np.testing.assert_array_equal(np.stack(chunked.trajectory), np.stack(single.trajectory))
    assert torch.equal(chunked.velocity, single.velocity)
    for f in dataclasses.fields(chunked.state.table):
        assert torch.equal(getattr(chunked.state.table, f.name),
                           getattr(single.state.table, f.name)), f.name
    assert [k.frame_idx for k in chunked.slam_keyframes] == \
        [k.frame_idx for k in single.slam_keyframes]
    assert len(chunked.slam_keyframes) >= 1
    assert len(chunked.gravity_obs) == len(chunked.slam_keyframes)
    np.testing.assert_array_equal(np.array(chunked.gravity_obs), np.array(single.gravity_obs))
    assert all(bool(o.posit_ok) for o in outs[1:])
    assert ev.ate_rmse(chunked.trajectory_array, data["poses"]) < 0.15
    assert chunked.velocity.device.type == "cpu"


def _corridor_imu(seq, dt, rng, calib_noise=True):
    """Measurements of ``seq`` from the port's generator, and a calibration
    from a static period (tests/test_imu.py's recipe)."""
    bias_g = np.array([0.01, -0.004, 0.002])
    bias_a = np.array([0.05, -0.02, 0.1])
    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, dt, calib=fake, noise_gyro=0.002, noise_accel=0.05, device=CPU)
    calib = imu.calibrate(bias_g + rng.normal(0, 0.001, (200, 3)),
                          UP * imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3)),
                          device=CPU)
    return omega, accel, calib


def test_incremental_ba_stays_gravity_consistent(rng):
    """With the full-graph BA on, the keyframe rotations stay aligned with
    the recorded gravity directions (tests/test_imu.py): the unaries reach
    every BA window and pose graph the run assembles."""
    seq = SyntheticSequence(n_frames=16, width=512, height=256, step=0.5, device=CPU)
    dt = 0.05
    omega, accel, calib = _corridor_imu(seq, dt, rng)
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=512, max_detections=512,
        keyframe_translation_m2=0.25, keyframe_rotation_rad2=0.01,
        optimize_every_keyframes=4)
    windows = []

    class Recording(StereoInertialTracker):
        def _gravity_ba_terms(self, kfs, K):
            terms = super()._gravity_ba_terms(kfs, K)
            windows.append(terms is not None)
            return terms

    tr = Recording(seq.cam, calib, params, equalize=False, enable_loop_closure=False,
                   enable_local_ba=True, local_ba_every=2, device=CPU)
    for i, (L, R, _) in enumerate(seq):
        if i == 0:
            tr.process_imu(L, R, np.zeros(3), UP * imu.GRAVITY, dt)
        else:
            tr.process_imu(L, R, omega[i - 1], accel[i - 1], dt)
    assert tr.stats["ba_runs"] >= 1 and windows and all(windows)
    assert len(tr.slam_keyframes) >= 4
    assert len(tr.gravity_obs) == len(tr.slam_keyframes)
    for k, kf in enumerate(tr.slam_keyframes):
        d = -np.asarray(kf.T_wc)[:3, 1]     # R_wc @ (0,-1,0)
        g = tr.gravity_obs[k]
        cosang = float(np.dot(d, g) / (np.linalg.norm(d) * np.linalg.norm(g)))
        assert cosang > 0.995, f"keyframe {k} tilted {np.degrees(np.arccos(min(cosang, 1))):.1f} deg"


def test_velocity_survives_world_shift():
    """The velocity is a difference of poses across the frame; taken across
    the robocentric rebase it would absorb the shift (shift/dt ~ 40 m/s).
    It must stay near the true 10 m/s through the rebase
    (tests/test_world_shift.py)."""
    rng = np.random.default_rng(7)
    seq = SyntheticSequence(n_frames=10, width=384, height=192, step=0.5, device=CPU)
    dt = 0.05
    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, dt, calib=fake, noise_gyro=0.001, noise_accel=0.02, device=CPU)
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512, max_detections=512)
    tr = StereoInertialTracker(seq.cam, fake, params, equalize=False,
                               enable_loop_closure=False, enable_local_ba=False,
                               device=CPU)
    tr.world_shift_threshold_m = 2.0            # rebase after ~4 frames
    speeds = []
    for i, (L, R, _) in enumerate(seq):
        if i == 0:
            tr.process_imu(L, R, np.zeros(3), UP * imu.GRAVITY, dt)
        else:
            tr.process_imu(L, R, omega[i - 1], accel[i - 1], dt)
        speeds.append(float(torch.linalg.norm(tr.velocity)))
    assert tr.world_shifts >= 1
    assert max(speeds) < 20.0 and min(speeds[2:]) > 5.0
    assert ev.evaluate(tr.trajectory_array, seq.poses_wc).ate_rmse_m < 0.15
    del rng
