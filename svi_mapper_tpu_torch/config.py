"""Configuration: calibration-file parsing + runtime parameter pack.

The port's own copy of the calibration parser (whitespace-token
``hardware_parameters/*.txt`` files, ref CParameterBase.h:15-392) and of the
frozen ``TrackingParams`` dataclass. Cameras are built as dataclasses of
torch tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry.camera import (
    PinholeCamera,
    StereoCamera,
    pinhole_from_projection,
)
from svi_mapper_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# calibration file parsing (ref CParameterBase.h:21-166)
# ---------------------------------------------------------------------------
def _tokenize(text: str) -> list[str]:
    return text.split()


def _get_scalar(tokens: list[str], key: str, default=None) -> float | None:
    try:
        i = tokens.index(key)
    except ValueError:
        return default
    return float(tokens[i + 1])


def _get_vector(tokens: list[str], key: str, n: int, default=None) -> np.ndarray | None:
    try:
        i = tokens.index(key)
    except ValueError:
        return default
    return np.array([float(t) for t in tokens[i + 1 : i + 1 + n]], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class CameraCalibration:
    """One parsed ``hardware_parameters`` camera file
    (format: kitti_00_camera_left.txt / vi_sensor_camera_left.txt)."""

    width: int
    height: int
    K: np.ndarray                 # (3,3) raw intrinsics (matIntrinsic)
    dist: np.ndarray              # (4,)  distortion (vecDistortionCoefficients)
    R_rect: np.ndarray            # (3,3) rectification (matRectification)
    P: np.ndarray                 # (3,4) rectified projection (matProjection)
    focal_length_m: float = 0.0
    # IMU extrinsics (vi_sensor files only; ref CPinholeCameraIMU.h:17-60)
    q_cam_to_imu: np.ndarray | None = None   # (4,) xyzw
    t_cam_to_imu: np.ndarray | None = None   # (3,)
    R_intrinsic_cam_to_imu: np.ndarray | None = None  # (3,3)

    @property
    def has_imu(self) -> bool:
        return self.q_cam_to_imu is not None

    @property
    def T_cam_imu(self) -> np.ndarray | None:
        """The IMU->camera transform [4,4] (float64) of a vi_sensor file, or
        None. The file gives the camera's pose in the IMU frame:
        ``x_imu = R_intr R_q x_cam + t`` with ``R_q`` from
        ``vecQuaternionToIMU`` (xyzw), ``t`` = ``vecTranslationToIMU`` and
        ``R_intr`` = ``matRotationIntrinsicCAMERAtoIMU`` (the two boards'
        axes, 180 degrees about z on the VI sensor). With it the two shipped
        cameras' relative pose puts the left one 0.110 m left of the right
        one, the baseline their rectified projections state."""
        if not self.has_imu:
            return None
        x, y, z, w = self.q_cam_to_imu / np.linalg.norm(self.q_cam_to_imu)
        R_q = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        R_intr = (np.eye(3) if self.R_intrinsic_cam_to_imu is None
                  else self.R_intrinsic_cam_to_imu)
        T_imu_cam = np.eye(4)
        T_imu_cam[:3, :3] = R_intr @ R_q
        T_imu_cam[:3, 3] = self.t_cam_to_imu
        return np.linalg.inv(T_imu_cam)


def load_camera_calibration(path: str | Path) -> CameraCalibration:
    """Parse one calibration text file (ref CParameterBase.h:169-392).

    Raises :class:`svi_mapper_tpu_torch.utils.errors.ParameterError` on missing or
    malformed required fields (the reference throws CExceptionParameter)."""
    from svi_mapper_tpu_torch.utils.errors import ParameterError

    p = Path(path)
    if not p.exists() and not p.is_absolute():
        # bare filenames resolve against the shipped calibration directory
        # (hardware_parameters/, the reference's layout)
        shipped = HARDWARE_PARAMETERS_DIR / p
        if shipped.exists():
            p = shipped
    try:
        tokens = _tokenize(p.read_text())
    except OSError as e:
        raise ParameterError(f"cannot read calibration file {path}: {e}") from e
    required = ("uWidthPixels", "uHeightPixels", "vecDistortionCoefficients",
                "matProjection")
    missing = [k for k in required if k not in tokens]
    if missing:
        raise ParameterError(
            f"calibration file {path} is missing required fields: {missing}")
    try:
        width = int(_get_scalar(tokens, "uWidthPixels"))
        height = int(_get_scalar(tokens, "uHeightPixels"))
        K = _get_vector(tokens, "matIntrinsic", 9,
                        default=np.zeros(9)).reshape(3, 3)
        dist = _get_vector(tokens, "vecDistortionCoefficients", 4)
        R_rect = _get_vector(tokens, "matRectification", 9,
                             default=np.zeros(9)).reshape(3, 3)
        P = _get_vector(tokens, "matProjection", 12).reshape(3, 4)
    except (ValueError, IndexError) as e:
        raise ParameterError(f"malformed calibration file {path}: {e}") from e
    if P.shape != (3, 4) or len(dist) != 4:
        raise ParameterError(f"malformed calibration file {path}")
    q = _get_vector(tokens, "vecQuaternionToIMU", 4)
    t = _get_vector(tokens, "vecTranslationToIMU", 3)
    R_i = _get_vector(tokens, "matRotationIntrinsicCAMERAtoIMU", 9)
    # KITTI files leave K/R_rect zeroed and carry everything in P
    if not np.any(K):
        K = P[:, :3].copy()
    if not np.any(R_rect):
        R_rect = np.eye(3)
    return CameraCalibration(
        width=width,
        height=height,
        K=K,
        dist=dist,
        R_rect=R_rect,
        P=P,
        focal_length_m=_get_scalar(tokens, "dFocalLengthMeters", 0.0),
        q_cam_to_imu=q,
        t_cam_to_imu=t,
        R_intrinsic_cam_to_imu=None if R_i is None else R_i.reshape(3, 3),
    )

def camera_from_calibration(
    calib: CameraCalibration, dtype=np.float32,
    device: torch.device | str | None = None,
) -> PinholeCamera:
    """``dtype`` (numpy or torch) is the camera matrices' dtype."""
    return pinhole_from_projection(
        calib.P, calib.width, calib.height, K=calib.K, dist=calib.dist,
        R_rect=calib.R_rect, dtype=dtype, device=device,
    )


def load_stereo_camera(
    left_path: str | Path, right_path: str | Path, dtype=np.float32,
    device: torch.device | str | None = None,
) -> StereoCamera:
    """Build a rectified stereo camera from two calibration files
    (ref CParameterBase constructCameraSTEREO, tracker_gt.cpp:121-123;
    the baseline lives in P_right[0,3] = -fx*b, e.g. -386.1448 for KITTI 00
    -> b = 0.537 m). ``dtype`` (numpy or torch) is the matrices' dtype,
    float32 by default. ``device=None`` means CUDA."""
    device = resolve_device(device)
    left = camera_from_calibration(load_camera_calibration(left_path), dtype, device)
    right = camera_from_calibration(load_camera_calibration(right_path), dtype, device)
    return StereoCamera(left=left, right=right)


# ---------------------------------------------------------------------------
# tracking parameter pack (ref constants scattered in class headers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrackingParams:
    """All front-end/solver thresholds, with reference provenance."""

    # --- capacities (static shapes; fixed-capacity tables) ---
    max_landmarks: int = 1024          # active landmark table rows
    max_detections: int = 1024         # GFTT cap (ref CFundamentalMatcher.cpp:18)
    max_measurements: int = 16         # per-landmark measurement ring buffer
    descriptor_bits: int = 256         # ref Types.h:6 DESCRIPTOR_SIZE_BITS

    # --- detection (ref GFTT 1000 pts / quality 0.01 / min-dist 7) ---
    detect_quality: float = 0.01
    detect_min_distance: int = 7
    detect_cell: int = 16              # grid-NMS cell for masked top-k

    # --- descriptor matching Hamming cutoffs (ref CFundamentalMatcher.cpp:23-26) ---
    matching_distance_tracking: int = 25
    matching_distance_tracking_stage2: int = 50
    matching_distance_epipolar: int = 50
    matching_distance_triangulation: int = 100   # ref CTriangulator.cpp:13

    # --- stereo / triangulation (ref CTriangulator.h:20-21, .cpp:326-356) ---
    min_search_range_px: float = 60.0
    min_disparity_px: float = 0.01
    min_depth_m: float = 0.05
    max_depth_m: float = 1000.0

    # --- temporal tracking (ref CFundamentalMatcher.h:83, .cpp:203-242) ---
    max_failed_trackings: int = 5
    keyframe_presences_for_graph: int = 2
    stale_landmark_age_frames: int = 100
    epipolar_base_window_px: float = 10.0

    # --- pose solver gates (ref CSolverStereoPosit.h:89-98) ---
    posit_min_points: int = 25
    posit_min_inliers: int = 15
    posit_kernel_px2: float = 10.0
    posit_max_error_px2: float = 9.0
    posit_max_risk_m2: float = 2.0
    # GN converges in <10 iterations; the reference's 1000-iteration cap
    # (CSolverStereoPosit.h) is a safety net; keep the cap tight.
    posit_max_iterations: int = 25
    posit_convergence: float = 1e-5

    # --- landmark refinement gates (ref CLandmark.h:90-98) ---
    landmark_min_measurements: int = 5
    landmark_kernel_px2: float = 10.0
    landmark_max_error_px2: float = 9.0
    landmark_min_inlier_ratio: float = 0.5
    landmark_max_iterations: int = 10
    landmark_convergence: float = 1e-5

    # --- keyframing (ref CTrackerGT.h:47-49,68,70) ---
    keyframe_translation_m2: float = 25.0
    keyframe_rotation_rad2: float = 0.025
    keyframe_min_landmarks: int = 50
    optimize_every_keyframes: int = 20

    # --- loop closure (ref CTrackerGT.cpp:422,479,506-631; Cg2oOptimizer.h:125) ---
    closure_min_matches: int = 25
    # the reference gates at 0.5 of the full keyframe cloud
    # (CTrackerGT.cpp:479); our pools are the currently-OPTIMAL landmark
    # subset, so the same fraction is stricter — 0.25 matches the intent
    closure_min_relative_matches: float = 0.25
    # metric candidate gate (ref m_dLoopClosingRadiusSquaredMetersL2 = 25,
    # CTrackerSV.h:89): closure candidates must lie within 5 m of the
    # query's current pose estimate — the precision defense against
    # perceptual aliasing (distinct places with identical appearance)
    closure_search_radius_m2: float = 25.0
    closure_icp_inlier_m: float = 1.0
    closure_icp_min_inliers: int = 25
    closure_icp_max_error: float = 0.9
    closure_icp_max_iterations: int = 100
    closure_consensus_chi2: float = 0.25
    closure_hamming_cutoff: int = 25    # ref CKeyFrame.h:12 MAXIMUM_DISTANCE_HAMMING
    # probabilistic (bit-statistics) candidate matching: expected Hamming
    # against the pooled per-bit probabilities under the probability cutoff
    # (ref CBPTree.h:41-50 matching; MAXIMUM_DISTANCE_HAMMING_PROBABILITY=50,
    # CKeyFrame.h:13). Keeps closure recall when photometric noise pushes
    # per-snapshot descriptors past the exact cutoff between revisits.
    closure_probabilistic: bool = True
    closure_prob_cutoff: float = 50.0
    # DBoW2 direct-index restriction on closure correspondence matching
    # (DBOW2_ID_LEVELS = 2, CTrackerGT.cpp:38-39; consumed via the
    # database's per-node feature lists at :248-250): >0 requires matched
    # descriptor pairs to share their vocabulary node at that tree level,
    # implemented as a node-equality mask on the dense Hamming matrix
    # (mapping.vocabulary.node_ids). Default OFF: the exact all-pairs
    # match is already one dense op, so the index is a
    # precision knob (prunes cross-node coincidental Hamming hits) rather
    # than the CPU reference's lookup accelerator; enabling it trades
    # closure recall for precision.
    closure_direct_index_levels: int = 0
    # temporal exclusion: a query may only close against keyframes at least
    # this many keyframes older (ref m_uMinimumLoopClosingKeyFrameDistance
    # = 20, CTrackerSV.h:84)
    closure_exclude_recent: int = 20
    # near-duplicate edge suppression: an accepted closure whose
    # (ref_kf, query_kf) both lie within this many keyframes of an
    # already-accepted edge is redundant — the same revisit event seen one
    # keyframe later. Each redundant edge adds pose-graph rows and identity
    # -merge work with no new information (the reference's wider
    # 20-keyframe exclusion + per-keyframe single search naturally thins
    # this; our batched multi-candidate search needs the explicit gate).
    # One edge per revisit event; <0 disables.
    closure_dedup_radius_kf: int = 4
    # loop-closure pose-graph edges damp their translation-z information
    # x100 (ref _getInformationNoZ, Cg2oOptimizer.cpp:1542-1550): the ICP
    # transform's depth component along the optical axis is its noisy
    # direction and must not pull as hard as x/y
    closure_z_info_damping: float = 0.01

    # --- depth-dependent measurement information (ref depth-tiered edges,
    #     Cg2oOptimizer.cpp:1383-1466: every tier carries the common factor
    #     dInformationFactor = 1/z, and far landmarks need > 1 px of
    #     disparity to contribute, :1444-1447). UNIT ANALYSIS + MEASUREMENT
    #     drive the defaults here: the reference's 1/z factor scales
    #     METER-unit residuals, and since pixel errors map to meters as
    #     ~z/f, a 1/z meter-space information is ≈CONSTANT information in
    #     pixel space — our residuals are already pixel-space, so stacking
    #     another 1/z double-counts depth. Measured on the 120-frame clean
    #     loop (r4): 1/z weighting costs 0.05 m ATE and the far-disparity
    #     drop costs 0.03 m (far points still carry bearing information in
    #     a pixel residual; the reference drops the whole edge). Both stay
    #     available for depth-dependent-noise regimes — where 1/z weighting
    #     measurably wins (tests/test_backend.py::
    #     test_ba_depth_weighting_beats_uniform) — but default OFF.
    #     Weights are mean-normalized over the window so the robust
    #     kernel's px^2 scale stays calibrated. ---
    ba_depth_weighting: bool = False
    ba_far_depth2_m2: float = 50.0        # far tier: beyond this squared range
    ba_min_far_disparity_px: float = 0.0  # ref 1.0 drops far sub-px-disparity
                                          # edges entirely (see above)

    # --- IDWA landmark-refinement fallback (ref dormant alternates
    #     CLandmark.cpp:347-445,583-646): rescue landmarks whose pixel-GN
    #     landscape is degenerate from the inverse-depth-weighted average
    #     of their measurement back-projections. Measured on the clean
    #     loop: rescued marginal landmarks re-seed from (drifted)
    #     back-projections and cost 0.09 m raw ATE — opt-in, mirroring the
    #     reference where both alternates are disabled in optimize()
    #     (CLandmark.cpp:289-291). ---
    landmark_idwa_fallback: bool = False

    # --- motion scaling (ref CTrackerGT.cpp:157 / CTrackerSVI.cpp:494) ---
    motion_scaling_cap: float = 5.0
    # back-end trigger veto: optimization only fires while the platform
    # moves smoothly — (ms_current + ms_last)/2 must stay BELOW this bound
    # (ref m_dMaximumMotionScalingForOptimization = 1.5, CTrackerSV.h:72,
    # checked alongside the instability==0 veto at CTrackerSV.cpp:431)
    max_motion_scaling_for_optimization: float = 1.5

    # --- regional recovery (stage-2 second chance, ref
    #     CFundamentalMatcher.cpp:495-727) ---
    enable_recovery: bool = True
    recovery_max_detections: int = 1024
    recovery_cell: int = 4

    # --- descriptor history ring (ref CLandmark.h:46-55 keeps the full
    #     per-landmark descriptor history, vecDescriptorsLEFT — feeding
    #     cloud matching and bit statistics; the tracking gate itself uses
    #     the FIXED creation descriptor: callers pass
    #     matDescriptorReferenceLEFT as p_matDescriptorOriginal,
    #     CFundamentalMatcher.cpp:986,991). The ring is kept for bit
    #     statistics/closure pools; ``use_desc_history=True`` additionally
    #     anchors the tracking gate on the ring entry nearest the current
    #     appearance — a DELIBERATE relaxation of the reference's fixed
    #     anchor that gains ~4% tracked measurements under photometric
    #     drift but lets appearance drift accumulate unboundedly (the
    #     anchor follows the track): measured raw-VO loop ATE regresses
    #     0.146 -> 0.334 m (r4 bisect). Default OFF = reference gate. ---
    use_desc_history: bool = False
    desc_history_slots: int = 4
    desc_history_every: int = 8


DEFAULT_PARAMS = TrackingParams()

HARDWARE_PARAMETERS_DIR = Path(__file__).resolve().parent.parent / "hardware_parameters"
