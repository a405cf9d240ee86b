"""KITTI odometry dataset loading (the port's copy; the camera is built on
an explicit device, ``None`` meaning CUDA).

Replaces the reference's txt_io message-dump pipeline: ``republisher_kitti``
(republisher_kitti.cpp:28-100: times.txt + image_0/ + image_1/ -> message
dump) and the L/R pairing loop of ``tracker_gt`` main
(tracker_gt.cpp:182-263). Instead of a dump intermediary, frames stream
straight from the sequence folder; ground-truth poses load from the
KITTI poses file (one 3x4 camera->world per line, the format of
CLogger's trajectory output CLogger.h:264-302).

Layout expected (standard KITTI odometry):
  <root>/sequences/<seq>/times.txt
  <root>/sequences/<seq>/image_0/*.png   (left, grayscale)
  <root>/sequences/<seq>/image_1/*.png   (right)
  <root>/poses/<seq>.txt                 (optional ground truth)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

import torch

from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

# KITTI 00 rectified calibration (hardware_parameters/kitti_00_camera_*.txt)
KITTI_00_P_LEFT = np.array(
    [[718.856, 0.0, 607.1928, 0.0],
     [0.0, 718.856, 185.2157, 0.0],
     [0.0, 0.0, 1.0, 0.0]]
)
KITTI_00_P_RIGHT = np.array(
    [[718.856, 0.0, 607.1928, -386.1448],
     [0.0, 718.856, 185.2157, 0.0],
     [0.0, 0.0, 1.0, 0.0]]
)


def _read_image(path: Path) -> np.ndarray:
    """Grayscale image -> float32 [H, W]. Uses cv2 if present, else PIL
    (both imported here, so the package imports without either)."""
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


def load_calibration(seq_dir: Path) -> tuple[np.ndarray, np.ndarray] | None:
    """Parse <seq>/calib.txt (P0/P1 lines) if present: ``(P0, P1)``."""
    calib = seq_dir / "calib.txt"
    if not calib.exists():
        return None
    P = {}
    for line in calib.read_text().splitlines():
        if ":" not in line:
            continue
        key, vals = line.split(":", 1)
        nums = [float(x) for x in vals.split()]
        if len(nums) == 12:
            P[key.strip()] = np.asarray(nums).reshape(3, 4)
    if "P0" not in P or "P1" not in P:
        return None
    # width/height read lazily from the first image by the sequence loader
    return P["P0"], P["P1"]


@dataclasses.dataclass
class KittiSequence:
    """Streaming KITTI stereo sequence with optional ground truth."""

    root: Path
    sequence: str
    cam: StereoCamera = None
    times: np.ndarray = None
    left_files: list = None
    right_files: list = None
    poses_wc: np.ndarray | None = None   # world->camera, [N,4,4]

    def __init__(self, root: str | Path, sequence: str = "00",
                 device: torch.device | str | None = None):
        self.root = Path(root)
        self.sequence = sequence
        seq_dir = self.root / "sequences" / sequence
        if not seq_dir.exists():
            raise FileNotFoundError(f"KITTI sequence dir not found: {seq_dir}")
        self.left_files = sorted((seq_dir / "image_0").glob("*.png"))
        self.right_files = sorted((seq_dir / "image_1").glob("*.png"))
        assert len(self.left_files) == len(self.right_files), (
            "left/right image counts differ — broken sequence"
        )
        times_file = seq_dir / "times.txt"
        self.times = (
            np.asarray([float(t) for t in times_file.read_text().split()])
            if times_file.exists()
            else np.arange(len(self.left_files)) * 0.05
        )

        first = _read_image(self.left_files[0])
        h, w = first.shape
        calib = load_calibration(seq_dir)
        P_l, P_r = calib if calib else (KITTI_00_P_LEFT, KITTI_00_P_RIGHT)
        self.cam = StereoCamera(
            left=pinhole_from_projection(P_l, w, h, device=device),
            right=pinhole_from_projection(P_r, w, h, device=device),
        )

        poses_file = self.root / "poses" / f"{sequence}.txt"
        self.poses_wc = None
        if poses_file.exists():
            rows = []
            for line in poses_file.read_text().splitlines():
                vals = [float(x) for x in line.split()]
                if len(vals) != 12:
                    continue
                T = np.eye(4)
                T[:3] = np.asarray(vals).reshape(3, 4)     # camera->world
                rows.append(np.linalg.inv(T))
            self.poses_wc = np.stack(rows).astype(np.float32)

    @property
    def n_frames(self) -> int:
        return len(self.left_files)

    def frame(self, i: int):
        L = _read_image(self.left_files[i])
        R = _read_image(self.right_files[i])
        T = self.poses_wc[i] if self.poses_wc is not None else None
        return L, R, T

    def __iter__(self):
        for i in range(self.n_frames):
            yield self.frame(i)


def validate_sequence(seq: KittiSequence) -> list[str]:
    """Dataset sanity checks (the ``validate_dataset`` runnable,
    validate_dataset.cpp:73-111): stream pairing, timestamp monotonicity,
    frame-count consistency. Returns a list of problems (empty = OK)."""
    problems = []
    if len(seq.left_files) != len(seq.right_files):
        problems.append(
            f"stream pairing: {len(seq.left_files)} left vs {len(seq.right_files)} right"
        )
    if len(seq.times) < seq.n_frames:
        problems.append(f"times.txt has {len(seq.times)} entries for {seq.n_frames} frames")
    dt = np.diff(seq.times[: seq.n_frames])
    if np.any(dt <= 0):
        problems.append(f"non-monotonic timestamps at indices {np.nonzero(dt <= 0)[0][:5]}")
    if seq.poses_wc is not None and len(seq.poses_wc) != seq.n_frames:
        problems.append(
            f"ground truth has {len(seq.poses_wc)} poses for {seq.n_frames} frames"
        )
    for i, (lf, rf) in enumerate(zip(seq.left_files, seq.right_files)):
        if lf.stem != rf.stem:
            problems.append(f"frame id mismatch at {i}: {lf.stem} vs {rf.stem}")
            break
    return problems
