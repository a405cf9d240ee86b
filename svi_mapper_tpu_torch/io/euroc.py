"""EuRoC / ASL dataset loader (the VI-sensor input path).

The reference supports the VI-sensor (EuRoC-style stereo+IMU rig) through
calibration text files (hardware_parameters/vi_sensor_camera_left.txt with
camera-to-IMU extrinsics, parsed by CParameterBase.h:169-392) and a txt_io
message dump. Here we read the ASL folder layout directly::

    <root>/mav0/
        cam0/{sensor.yaml, data.csv, data/<ts>.png}
        cam1/{...}
        imu0/{sensor.yaml, data.csv}
        state_groundtruth_estimate0/data.csv      (optional)

Calibration comes from the Kalibr-style ``sensor.yaml`` files; the stereo
pair is rectified with :func:`svi_mapper_tpu_torch.ops.image.stereo_rectify`
(the cv::stereoRectify role, CStereoCameraIMU.h:20-52) and per-camera
undistort/rectify maps are precomputed (host numpy) for on-device
remapping. PyYAML, and cv2 or PIL, are imported only where a file is read,
so the package imports without them.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import numpy as np

import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection
from svi_mapper_tpu_torch.ops.image import stereo_rectify, undistort_rectify_maps


@dataclasses.dataclass
class EurocCameraInfo:
    K: np.ndarray          # [3,3]
    dist: np.ndarray       # [4] radtan k1 k2 p1 p2
    T_BS: np.ndarray       # [4,4] sensor(cam)->body
    width: int
    height: int
    rate_hz: float


def _load_sensor_yaml(path: Path) -> dict:
    import yaml

    text = path.read_text()
    # some ASL files carry an opencv '%YAML:1.0' header — strip directives
    lines = [ln for ln in text.splitlines() if not ln.startswith("%")]
    return yaml.safe_load("\n".join(lines))


def load_camera_info(cam_dir: Path) -> EurocCameraInfo:
    y = _load_sensor_yaml(cam_dir / "sensor.yaml")
    fu, fv, cu, cv_ = y["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1.0]])
    dist = np.asarray(y.get("distortion_coefficients", [0, 0, 0, 0]),
                      np.float64)[:4]
    T_BS = np.asarray(y["T_BS"]["data"], np.float64).reshape(4, 4)
    w, h = y["resolution"]
    return EurocCameraInfo(K=K, dist=dist, T_BS=T_BS, width=int(w),
                           height=int(h), rate_hz=float(y.get("rate_hz", 20)))


def _read_data_csv(path: Path) -> list[list[str]]:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith("#"):
                continue
            rows.append([c.strip() for c in row])
    return rows


class EurocSequence:
    """Paired stereo+IMU playback of one EuRoC sequence.

    Iterating yields ``(t_sec, img_left, img_right, imu)`` where ``imu`` is
    a ``[k, 7]`` float64 array of the IMU rows (t, wx, wy, wz, ax, ay, az)
    since the previous frame (empty for the first). Images are the RAW
    (unrectified) uint8 frames; feed them through
    :attr:`rectify_maps` + ``ops.image.remap_bilinear`` or let
    :class:`svi_mapper_tpu_torch.models.svi.StereoInertialTracker` do it.
    The rectified camera lives on ``device`` (``None`` means CUDA).
    """

    def __init__(self, root: str | Path, pair_tolerance_s: float = 0.003,
                 device: torch.device | str | None = None):
        root = Path(root)
        if (root / "mav0").exists():
            root = root / "mav0"
        self.root = root
        self.cam0 = load_camera_info(root / "cam0")
        self.cam1 = load_camera_info(root / "cam1")

        # relative extrinsics: x1 = T_10 x0 with T_10 = inv(T_BS1) @ T_BS0
        T_10 = np.linalg.inv(self.cam1.T_BS) @ self.cam0.T_BS
        R0, R1, P0, P1 = stereo_rectify(
            self.cam0.K, self.cam0.dist, self.cam1.K, self.cam1.dist,
            T_10, self.cam0.width, self.cam0.height)
        self.cam = StereoCamera(
            left=pinhole_from_projection(
                P0, self.cam0.width, self.cam0.height, K=self.cam0.K,
                dist=self.cam0.dist, R_rect=R0, device=device),
            right=pinhole_from_projection(
                P1, self.cam1.width, self.cam1.height, K=self.cam1.K,
                dist=self.cam1.dist, R_rect=R1, device=device),
        )
        m0 = undistort_rectify_maps(self.cam0.K, self.cam0.dist, R0, P0,
                                    self.cam0.width, self.cam0.height)
        m1 = undistort_rectify_maps(self.cam1.K, self.cam1.dist, R1, P1,
                                    self.cam1.width, self.cam1.height)
        self.rectify_maps = (m0[0], m0[1], m1[0], m1[1])

        # image pairing by timestamp (ref message pairing tracker_gt.cpp:185-263)
        rows0 = _read_data_csv(root / "cam0" / "data.csv")
        rows1 = _read_data_csv(root / "cam1" / "data.csv")
        ts1 = np.asarray([int(r[0]) for r in rows1], np.int64)
        self.frames: list[tuple[float, Path, Path]] = []
        for r in rows0:
            t0 = int(r[0])
            j = int(np.argmin(np.abs(ts1 - t0)))
            if abs(ts1[j] - t0) <= pair_tolerance_s * 1e9:
                self.frames.append((
                    t0 * 1e-9,
                    root / "cam0" / "data" / r[1],
                    root / "cam1" / "data" / rows1[j][1],
                ))

        # camera<->IMU extrinsics: T_cam_imu = inv(T_BS_cam0) @ T_BS_imu
        # (ref vi_sensor IMU extrinsics, CPinholeCameraIMU.h:17-60)
        T_BS_imu = np.eye(4)
        imu_yaml = root / "imu0" / "sensor.yaml"
        if imu_yaml.exists():
            y = _load_sensor_yaml(imu_yaml)
            if isinstance(y, dict) and "T_BS" in y:
                T_BS_imu = np.asarray(y["T_BS"]["data"], np.float64).reshape(4, 4)
        self.T_cam_imu = np.linalg.inv(self.cam0.T_BS) @ T_BS_imu

        # IMU stream
        imu_rows = _read_data_csv(root / "imu0" / "data.csv")
        self.imu = np.asarray(
            [[int(r[0]) * 1e-9] + [float(x) for x in r[1:7]] for r in imu_rows],
            np.float64) if imu_rows else np.zeros((0, 7))

        # ground truth (T_WB body poses -> world->cam0 transforms)
        self.gt_times: np.ndarray | None = None
        self.gt_T_wc: np.ndarray | None = None
        gt_csv = root / "state_groundtruth_estimate0" / "data.csv"
        if gt_csv.exists():
            rows = _read_data_csv(gt_csv)
            times, Ts = [], []
            for r in rows:
                t = int(r[0]) * 1e-9
                p = np.asarray([float(x) for x in r[1:4]])
                qw, qx, qy, qz = [float(x) for x in r[4:8]]
                R = _quat_to_R(qw, qx, qy, qz)
                T_WB = np.eye(4)
                T_WB[:3, :3] = R
                T_WB[:3, 3] = p
                # world->cam0 = inv(T_WB @ T_BS_cam0)
                Ts.append(np.linalg.inv(T_WB @ self.cam0.T_BS))
                times.append(t)
            self.gt_times = np.asarray(times)
            self.gt_T_wc = np.stack(Ts).astype(np.float32)

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        sel = (self.imu[:, 0] > t0) & (self.imu[:, 0] <= t1)
        return self.imu[sel]

    def static_imu_window(self, seconds: float = 2.0) -> np.ndarray:
        """IMU rows from the sequence start (the pre-loop calibration feed,
        tracker_svi.cpp:145-177)."""
        if not len(self.imu):
            return self.imu
        t0 = self.imu[0, 0]
        return self.imu[self.imu[:, 0] <= t0 + seconds]

    def __iter__(self):
        prev_t = None
        for (t, p0, p1) in self.frames:
            img0 = _read_gray(p0)
            img1 = _read_gray(p1)
            imu = (self.imu_between(prev_t, t) if prev_t is not None
                   else np.zeros((0, 7)))
            prev_t = t
            yield t, img0, img1, imu


def _quat_to_R(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read_gray(path: Path) -> np.ndarray:
    from svi_mapper_tpu_torch.io.kitti import _read_image

    return _read_image(path)
