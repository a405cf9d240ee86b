"""The port's dataset readers and its EuRoC runnable: ``io/euroc.py`` and
``io/kitti.py`` against the JAX package's on folders written by the test
(no dataset download), the port's ``StereoInertialTracker`` and
``tools/run_euroc.py`` on a mini ASL sequence (mirrors
``tests/test_euroc.py``).

Tolerances: every array the two loaders give is equal (the same float64
numpy arithmetic, the same float32 casts).
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from svi_mapper_tpu.eval import trajectory as j_ev
from svi_mapper_tpu.io import euroc as j_euroc
from svi_mapper_tpu.io import kitti as j_kitti
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.eval import trajectory as t_ev
from svi_mapper_tpu_torch.imu import interpolator as imu
from svi_mapper_tpu_torch.io import euroc as t_euroc
from svi_mapper_tpu_torch.io import kitti as t_kitti
from svi_mapper_tpu_torch.io.synthetic import default_camera, render_stereo
from svi_mapper_tpu_torch.models.svi import StereoInertialTracker
from svi_mapper_tpu_torch.tools import run_euroc

from test_imu import _fine_trajectory
from torch_parity import exp_se3_np

CPU = "cpu"
T0_NS = 1_000_000_000


def _quat_wxyz(R):
    w = np.sqrt(max(1e-12, 1 + np.trace(R))) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def _sensor_yaml(path, K, dist, T_BS, size, rate=20):
    y = {"sensor_type": "camera", "rate_hz": rate, "resolution": [int(v) for v in size],
         "camera_model": "pinhole", "intrinsics": [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])],
         "distortion_model": "radial-tangential",
         "distortion_coefficients": [float(d) for d in dist],
         "T_BS": {"rows": 4, "cols": 4, "data": [float(x) for x in T_BS.reshape(-1)]}}
    # an opencv-style directive line, which the loaders strip
    path.write_text("%YAML:1.0\n" + yaml.safe_dump(y))


def write_asl(root, frames, K, dist, T_BS, imu_rows, gt_T_wc=None, T_BS_imu=None):
    """An ASL folder: ``frames`` is a list of uint8 (left, right) pairs at
    20 Hz from ``T0_NS``, ``imu_rows`` [n, 7] (t in s, w, a)."""
    mav = root / "mav0"
    h, w = frames[0][0].shape
    for c, name in enumerate(("cam0", "cam1")):
        d = mav / name / "data"
        d.mkdir(parents=True)
        _sensor_yaml(mav / name / "sensor.yaml", K[c], dist[c], T_BS[c], (w, h))
        rows = ["#timestamp [ns],filename"]
        for i, pair in enumerate(frames):
            ts = T0_NS + i * 50_000_000 + (1000 if c else 0)   # 1 us pairing skew
            Image.fromarray(pair[c]).save(d / f"{ts}.png")
            rows.append(f"{ts},{ts}.png")
        (mav / name / "data.csv").write_text("\n".join(rows) + "\n")
    (mav / "imu0").mkdir(parents=True)
    if T_BS_imu is not None:
        (mav / "imu0" / "sensor.yaml").write_text(yaml.safe_dump(
            {"sensor_type": "imu", "T_BS": {"rows": 4, "cols": 4,
                                            "data": [float(x) for x in T_BS_imu.reshape(-1)]}}))
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    for r in imu_rows:
        rows.append(f"{int(round(r[0] * 1e9))}," + ",".join(f"{x:.9g}" for x in r[1:]))
    (mav / "imu0" / "data.csv").write_text("\n".join(rows) + "\n")
    if gt_T_wc is not None:
        g = mav / "state_groundtruth_estimate0"
        g.mkdir(parents=True)
        rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
        for i, T in enumerate(gt_T_wc):
            T_WB = np.linalg.inv(np.asarray(T, np.float64)) @ np.linalg.inv(T_BS[0])
            q = _quat_wxyz(T_WB[:3, :3])
            rows.append(f"{T0_NS + i * 50_000_000}," + ",".join(
                f"{x:.12g}" for x in list(T_WB[:3, 3]) + list(q)))
        (g / "data.csv").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def rig_dataset(tmp_path_factory):
    """Random images, a distorted pair with a rotated, 11 cm baseline and an
    IMU mounted at an angle: the loaders' arithmetic, not the tracker."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("asl_rig")
    K = [np.array([[458.0, 0, 36.5], [0, 457.0, 24.2], [0, 0, 1]]),
         np.array([[455.0, 0, 33.1], [0, 456.0, 25.3], [0, 0, 1]])]
    dist = [np.array([-0.28, 0.07, -9e-4, -9e-6]), np.array([-0.27, 0.06, 3e-4, 2e-5])]
    T_BS1 = exp_se3_np(np.array([0.11, 0.002, -0.001, 0.01, -0.02, 0.015]))
    T_BS_imu = exp_se3_np(np.array([0.02, -0.05, 0.01, 0.0, 0.0, np.pi / 2]))
    frames = [tuple(rng.integers(0, 256, (48, 72)).astype(np.uint8) for _ in range(2))
              for _ in range(4)]
    t = 0.9 + np.arange(100) * 0.005
    imu_rows = np.concatenate([t[:, None], rng.normal(0, 0.01, (100, 3)),
                               rng.normal([0.05, -9.8, 0.03], 0.02, (100, 3))], 1)
    gt = [np.linalg.inv(exp_se3_np(np.array([0.1 * i, 0, 0.05 * i, 0, 0.01 * i, 0])))
          for i in range(4)]
    write_asl(root, frames, K, dist, [np.eye(4), T_BS1], imu_rows, gt, T_BS_imu)
    return root


def test_euroc_loader_matches_jax(rig_dataset):
    want = j_euroc.EurocSequence(rig_dataset)
    got = t_euroc.EurocSequence(rig_dataset, device=CPU)
    for side in ("left", "right"):
        a, b = getattr(want.cam, side), getattr(got.cam, side)
        for f in ("P", "K", "dist", "R_rect"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                          err_msg=f"{side}.{f}")
        assert (b.width, b.height) == (a.width, a.height)
    assert got.cam.baseline == pytest.approx(float(want.cam.baseline), abs=1e-7)
    assert abs(got.cam.baseline - 0.11) < 1e-3
    for a, b in zip(want.rectify_maps, got.rectify_maps):
        np.testing.assert_array_equal(b, a)
    assert [(t, p0.name, p1.name) for t, p0, p1 in got.frames] == \
        [(t, p0.name, p1.name) for t, p0, p1 in want.frames]
    assert got.n_frames == 4
    for f in ("imu", "T_cam_imu", "gt_times", "gt_T_wc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in dataclasses.fields(want.cam0):
        np.testing.assert_array_equal(getattr(got.cam0, f.name), getattr(want.cam0, f.name))
    np.testing.assert_array_equal(got.static_imu_window(0.3), want.static_imu_window(0.3))
    np.testing.assert_array_equal(got.imu_between(1.0, 1.05), want.imu_between(1.0, 1.05))
    for (ta, La, Ra, ia), (tb, Lb, Rb, ib) in zip(want, got):
        assert ta == tb
        np.testing.assert_array_equal(Lb, La)
        np.testing.assert_array_equal(Rb, Ra)
        np.testing.assert_array_equal(ib, ia)
    # the static window feeds the calibration: gyro bias to 1e-6
    static = got.static_imu_window(0.3)
    calib = imu.calibrate(static[:, 1:4], static[:, 4:7], device=CPU)
    np.testing.assert_allclose(calib.bias_gyro, static[:, 1:4].mean(0), atol=1e-6)


@pytest.fixture(scope="module")
def svi_dataset(tmp_path_factory):
    """A rectified rig over 8 frames of the 200 Hz trajectory at 256 x 128:
    frames rendered by the port, the port's 200 Hz IMU rows, ground truth."""
    root = tmp_path_factory.mktemp("asl_svi")
    n, sub, h = 8, 10, 0.005
    fine = _fine_trajectory(n, sub, h)
    cam = default_camera(256, 128, device=CPU)
    frames = []
    for T in fine[::sub][:n]:
        L, R = render_stereo(cam, T)
        frames.append(tuple(np.clip(np.rint(x.numpy()), 0, 255).astype(np.uint8)
                            for x in (L, R)))
    omega, accel = imu.synthesize_measurements(fine, h, noise_gyro=0.002,
                                               noise_accel=0.04, seed=3, device=CPU)
    t = 1.0 + np.arange(1, len(omega) + 1) * h - h / 2
    pre = 0.5 + np.arange(80) * h       # a static period before the first frame
    static = np.tile(np.r_[0.0, 0.0, 0.0, 0.0, 0.0, -imu.GRAVITY, 0.0], (80, 1))
    static[:, 0] = pre
    rows = np.concatenate([static, np.concatenate([t[:, None], omega, accel], 1)])
    K = np.array([[cam.left.fx, 0, cam.left.cx], [0, cam.left.fy, cam.left.cy], [0, 0, 1]])
    T_BS1 = np.eye(4)
    T_BS1[0, 3] = cam.baseline
    write_asl(root, frames, [K, K], [np.zeros(4)] * 2, [np.eye(4), T_BS1], rows,
              fine[::sub][:n])
    return root, fine[::sub][:n]


def _drive(seq, tracker):
    prev_t = None
    for (t, L, R, rows) in seq:
        dt = (t - prev_t) if prev_t is not None else 0.05
        prev_t = t
        if len(rows):
            tracker.process_imu_samples(L, R, np.full(len(rows), 0.005, np.float32),
                                        rows[:, 1:4], rows[:, 4:7])
        else:
            tracker.process_imu(L, R, np.zeros(3), np.zeros(3), dt)


def test_port_tracker_runs_on_the_mini_sequence(svi_dataset):
    root, gt = svi_dataset
    seq = t_euroc.EurocSequence(root, device=CPU)
    assert seq.n_frames == 8
    # an aligned rig: the maps sample the raw image where it is
    u = np.arange(256, dtype=np.float32)
    np.testing.assert_allclose(seq.rectify_maps[0][5], u, atol=1e-3)
    static = seq.static_imu_window(0.3)
    calib = imu.calibrate(static[:, 1:4], static[:, 4:7], device=CPU)
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=256, max_detections=256)
    tracker = StereoInertialTracker(seq.cam, calib, params, rectify_maps=seq.rectify_maps,
                                    T_cam_imu=seq.T_cam_imu, enable_loop_closure=False,
                                    enable_local_ba=False, device=CPU)
    _drive(seq, tracker)
    assert tracker.frame_count == 8
    traj = tracker.trajectory_array
    assert np.isfinite(traj).all()
    assert all(bool(o.posit_ok) for o in tracker.outputs[1:])
    assert t_ev.ate_rmse(traj, gt) < 0.15


def test_run_euroc_writes_a_kitti_trajectory(svi_dataset, tmp_path, capsys):
    root, gt = svi_dataset
    out = tmp_path / "traj.txt"
    run_euroc.main([str(root), "--device", "cpu", "--out", str(out),
                    "--calib-seconds", "0.3", "--frames", "6"])
    printed = capsys.readouterr().out
    assert "ATE RMSE" in printed and "8 paired stereo frames" in printed
    T = t_ev.load_kitti_trajectory(out)
    assert T.shape == (6, 4, 4) and np.isfinite(T).all()
    np.testing.assert_array_equal(T, j_ev.load_kitti_trajectory(out))
    assert t_ev.ate_rmse(T, gt[:6]) < 0.15


def test_run_euroc_defaults_to_cuda(svi_dataset):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_euroc.main([str(svi_dataset[0])])


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------

def write_kitti(root, n, times=None, calib=True, poses=True, rename_right=None):
    rng = np.random.default_rng(5)
    seq = root / "sequences" / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
        for i in range(n):
            name = f"{i:06d}.png"
            if d == "image_1" and rename_right == i:
                name = f"{i + 100:06d}.png"
            Image.fromarray(rng.integers(0, 256, (40, 60)).astype(np.uint8)).save(seq / d / name)
    ts = np.arange(n) * 0.1 if times is None else np.asarray(times)
    (seq / "times.txt").write_text("\n".join(f"{t:.6e}" for t in ts) + "\n")
    if calib:
        P0 = np.array([[700.0, 0, 30.5, 0], [0, 700.0, 20.5, 0], [0, 0, 1, 0]])
        P1 = P0.copy()
        P1[0, 3] = -700.0 * 0.54
        (seq / "calib.txt").write_text(
            "".join(f"P{i}: " + " ".join(f"{x:.12e}" for x in P.reshape(-1)) + "\n"
                    for i, P in enumerate((P0, P1))) + "Tr: 1 0 0\n")
    if poses:
        (root / "poses").mkdir()
        lines = []
        for i in range(n):
            T = exp_se3_np(np.array([0.1 * i, 0.0, 0.8 * i, 0.0, 0.02 * i, 0.0]))
            lines.append(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)))
        (root / "poses" / "00.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("variant", ["complete", "no_calib_no_poses", "broken"])
def test_kitti_sequence_matches_jax(tmp_path, variant):
    kw = {"complete": {}, "no_calib_no_poses": dict(calib=False, poses=False),
          "broken": dict(times=[0.0, 0.1, 0.1, 0.3, 0.2], rename_right=3)}[variant]
    write_kitti(tmp_path, 5, **kw)
    want = j_kitti.KittiSequence(tmp_path, "00")
    got = t_kitti.KittiSequence(tmp_path, "00", device=CPU)
    for side in ("left", "right"):
        np.testing.assert_array_equal(getattr(got.cam, side).P.numpy(),
                                      np.asarray(getattr(want.cam, side).P))
        assert getattr(got.cam, side).width == 60
    np.testing.assert_array_equal(got.times, want.times)
    assert got.n_frames == want.n_frames == 5
    if want.poses_wc is None:
        assert got.poses_wc is None
    else:
        np.testing.assert_array_equal(got.poses_wc, want.poses_wc)
    for i in range(5):
        for a, b in zip(want.frame(i), got.frame(i)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, np.asarray(a))
    assert t_kitti.validate_sequence(got) == j_kitti.validate_sequence(want)
    assert (t_kitti.validate_sequence(got) == []) == (variant != "broken")
    want_P = j_kitti.load_calibration(tmp_path / "sequences" / "00")
    got_P = t_kitti.load_calibration(tmp_path / "sequences" / "00")
    if want_P is None:
        assert got_P is None and "calib" in kw
    else:
        for a, b in zip(want_P, got_P):
            np.testing.assert_array_equal(b, a)


def test_kitti_missing_sequence_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_kitti.KittiSequence(tmp_path, "07", device=CPU)
