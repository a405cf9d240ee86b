"""IMU calibration, filtering, and pose-prior integration.

Equivalent of ``CIMUInterpolator`` (CIMUInterpolator.h:7, .cpp:29-105):
startup calibration alternates gravity-direction alignment
(``calibrateRotation``) and bias estimation (``calibrateOffsets``) over a
static measurement buffer until convergence 1e-3; runtime threshold filters
zero sub-noise components (angular-velocity imprecision 0.01 rad/s,
acceleration imprecision 0.5 m/s^2, CIMUInterpolator.h:36-41), and the IMU
pose prior of the SVI tracker takes its rotation from the integrated gyro and
its translation from 1/2 a dt^2 (CTrackerSVI.cpp:356-364), damped when
dt > 0.11 s (:377-398).

The threshold filters are hard cuts, so a one-ulp difference in a product
ahead of them can zero a component on one side and not on the other. The
small matrix products here are therefore written out
(:func:`matmul_ordered`): every entry is ``a0*b0 + a1*b1 + ...`` summed left
to right, each product and sum rounded in float32, which is the same
arithmetic on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.utils.device import resolve_device

# reference constants (CIMUInterpolator.h:36-41)
GRAVITY = 9.80665
IMPRECISION_OMEGA = 0.01      # rad/s — zero smaller angular rates
IMPRECISION_ACCEL = 0.5       # m/s^2 — zero smaller linear accelerations
MAX_DT_SECONDS = 0.11         # damped fallback beyond this gap (CTrackerSVI.cpp:377)
CALIBRATION_CONVERGENCE = 1e-3  # (CIMUInterpolator.cpp:29-45)


@dataclasses.dataclass(frozen=True)
class ImuCalibration:
    """Result of the static startup calibration (numpy fields)."""

    R_imu_to_world: np.ndarray   # [3,3] gravity-aligned orientation
    bias_gyro: np.ndarray        # [3] rad/s
    bias_accel: np.ndarray       # [3] m/s^2 (gravity removed)
    noise_gyro: np.ndarray       # [3] std dev
    noise_accel: np.ndarray      # [3] std dev
    n_samples: int


def matmul_ordered(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` over the last two axes with each entry summed left to right
    from the first product, each step rounded on its own (no fused
    multiply-add, no blocked sum)."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return acc


def matvec_ordered(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` (``v`` with a leading batch axis allowed), summed as
    :func:`matmul_ordered` sums."""
    return matmul_ordered(M, v[..., :, None])[..., 0]


def _up(device) -> torch.Tensor:
    return torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32, device=device)


def calibrate(
    omega,                       # [N,3] angular velocities (static period)
    accel,                       # [N,3] specific-force measurements
    max_iterations: int = 20,
    convergence: float = CALIBRATION_CONVERGENCE,
    device: torch.device | str | None = None,
) -> ImuCalibration:
    """Alternate gravity alignment and bias estimation until convergence
    (the calibrateRotation/calibrateOffsets loop, CIMUInterpolator.cpp:29-105),
    on ``device`` (``None`` means CUDA). One host read per iteration decides
    convergence.

    During the static period the mean specific force equals -g in IMU
    coordinates; R_imu_to_world rotates it onto the world 'up' axis
    (0, -1, 0) — the y-down camera/world convention of the pipeline.
    """
    dev = resolve_device(device)
    omega = torch.as_tensor(np.asarray(omega, np.float32)).to(dev)
    accel = torch.as_tensor(np.asarray(accel, np.float32)).to(dev)
    up = _up(dev)

    R = torch.eye(3, dtype=torch.float32, device=dev)
    bias_a = torch.zeros(3, dtype=torch.float32, device=dev)
    # the means are summed in float64 and rounded once: the float32 value
    # nearest the mean, on any device (a float32 sum's error depends on its
    # order, a few ulps of 9.8 m/s^2 over a few hundred samples)
    mean_acc = torch.mean(accel.double(), dim=0).float()
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        # gravity direction estimate from bias-corrected mean
        mean_a = mean_acc - bias_a
        g_dir = mean_a / torch.clamp(torch.linalg.norm(mean_a), min=1e-9)
        # rotation bringing measured gravity onto world up (axis-angle)
        axis = torch.linalg.cross(g_dir, up)
        s = torch.linalg.norm(axis)
        c = torch.dot(g_dir, up)
        angle = torch.atan2(s, c)
        axis = torch.where(s > 1e-9, axis / torch.clamp(s, min=1e-9), x_axis)
        R_new = se3.exp_so3(axis * angle)
        # bias = residual after removing rotated gravity
        g_world = up * GRAVITY
        bias_new = mean_acc - matvec_ordered(R_new.T, g_world)
        delta = torch.maximum(torch.max(torch.abs(R_new - R)),
                              torch.max(torch.abs(bias_new - bias_a)))
        R, bias_a = R_new, bias_new
        if float(delta) < convergence:
            break

    return ImuCalibration(
        R_imu_to_world=R.cpu().numpy(),
        bias_gyro=torch.mean(omega.double(), dim=0).float().cpu().numpy(),
        bias_accel=bias_a.cpu().numpy(),
        noise_gyro=torch.std(omega, dim=0, correction=0).cpu().numpy(),
        noise_accel=torch.std(accel, dim=0, correction=0).cpu().numpy(),
        n_samples=int(omega.shape[0]),
    )


def threshold_filter(v: torch.Tensor, imprecision: float) -> torch.Tensor:
    """Zero components below the sensor imprecision
    (ref CIMUInterpolator.h:36-41 static filters)."""
    return torch.where(torch.abs(v) > imprecision, v, 0.0)


def gravity_filtered_accel(
    accel_imu: torch.Tensor,     # [3] raw specific force in IMU frame
    R_wc: torch.Tensor,          # [3,3] world->camera rotation (camera==IMU here)
    bias_accel: torch.Tensor,
) -> torch.Tensor:
    """Linear acceleration in the camera frame with gravity removed
    (ref CTrackerSVI.cpp:586-596)."""
    g_cam = matvec_ordered(R_wc, _up(accel_imu.device) * GRAVITY)
    a = accel_imu - bias_accel - g_cam
    return threshold_filter(a, IMPRECISION_ACCEL)


def integrate_prior(
    T_wc: torch.Tensor,          # [4,4] current world->camera
    omega: torch.Tensor,         # [3] bias-corrected angular velocity (camera frame)
    accel: torch.Tensor,         # [3] gravity-filtered linear acceleration
    velocity: torch.Tensor,      # [3] current linear velocity (camera frame)
    dt,                          # scalar seconds (tensor or float)
) -> torch.Tensor:
    """IMU-primed pose prior: rotation from integrated gyro, translation
    from v dt + 1/2 a dt^2 (ref CTrackerSVI.cpp:356-364), with the damped
    fallback when the measurement gap exceeds MAX_DT_SECONDS (:377-398)."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=T_wc.device)
    one = torch.ones((), dtype=torch.float32, device=T_wc.device)
    scale = torch.where(dt <= MAX_DT_SECONDS, one, 0.5 * one)
    w = threshold_filter(omega, IMPRECISION_OMEGA) * scale
    t_delta = (velocity * dt + 0.5 * accel * dt * dt) * scale
    # camera-frame motion increment: new_T = delta @ T
    delta = se3.exp_se3(torch.cat([t_delta, w * dt]))
    return matmul_ordered(delta, T_wc)


def integrate_prior_samples(
    T_wc: torch.Tensor,          # [4,4] current world->camera
    dts: torch.Tensor,           # [K] per-sample time steps (s), 0-padded
    omega: torch.Tensor,         # [K,3] raw IMU-frame angular velocities
    accel: torch.Tensor,         # [K,3] raw IMU-frame specific forces
    valid: torch.Tensor,         # [K] bool — real samples (padding False)
    velocity: torch.Tensor,      # [3] camera-frame linear velocity at frame start
    R_cam_imu: torch.Tensor,     # [3,3] IMU->camera rotation (rig extrinsics)
    bias_gyro: torch.Tensor,     # [3] IMU-frame gyro bias
    bias_accel: torch.Tensor,    # [3] IMU-frame accelerometer bias
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample IMU integration of one frame interval.

    The reference extrapolates a SINGLE filtered sample over the whole
    interval (CTrackerSVI.cpp:356-364); here every 200 Hz row integrates
    individually — rotation composes ``prod exp(w_i dt_i)``, gravity is
    removed per sample with the *evolving* orientation, and translation
    accumulates ``v dt + 1/2 a dt^2`` with the velocity carried through the
    interval.

    The loop runs over all K rows on the tensors' device with no host read.
    A padded row has ``dt = 0``: its rotation ``exp(w * 0)`` is exactly the
    identity and it moves neither the translation nor the velocity, so the
    result depends on the real rows only.

    The damped fallback applies when the total interval exceeds
    ``MAX_DT_SECONDS`` (ref :377-398): rotation capped to the first
    sample's rate over MAX_DT, translation zeroed.

    Returns ``(T_prior, rot_total)`` — the primed pose and the integrated
    camera-frame rotation vector (consumed by the dead-reckoning final
    fallback that zeroes its x component, ref :548-551).
    """
    dev = T_wc.device
    R_wc0 = T_wc[:3, :3]
    # w_cam[k] = R_cam_imu @ (omega[k] - bias), for all rows at once
    w_cam = threshold_filter(
        matvec_ordered(R_cam_imu, omega - bias_gyro[None, :]), IMPRECISION_OMEGA)
    a_cam_raw = matvec_ordered(R_cam_imu, accel - bias_accel[None, :])
    dts = torch.where(valid, dts, torch.zeros_like(dts))
    # the per-row rotation increments do not depend on the carry
    steps = se3.exp_so3(w_cam * dts[:, None])
    # world gravity is (0, -g, 0): of (R_d R_wc0) (0, -g, 0) only the middle
    # column's products are not zero, so the gravity in the camera frame is
    # that column times -g, the same float32 value as the whole product
    up_col = R_wc0[:, 1]

    R_d = torch.eye(3, dtype=torch.float32, device=dev)
    t_d = torch.zeros(3, dtype=torch.float32, device=dev)
    v = velocity
    for k in range(dts.shape[0]):
        h = dts[k]
        # gravity removal with the orientation AT this sample
        g_cam = matvec_ordered(R_d, up_col) * -GRAVITY
        a_lin = threshold_filter(a_cam_raw[k] - g_cam, IMPRECISION_ACCEL)
        t_d = t_d + v * h + 0.5 * a_lin * h * h
        v = v + a_lin * h
        R_d = matmul_ordered(steps[k], R_d)

    dt_total = torch.sum(dts)
    rot_total = se3.log_so3(R_d)

    # damped fallback (ref CTrackerSVI.cpp:377-398)
    damped = dt_total > MAX_DT_SECONDS
    rot_damped = w_cam[0] * MAX_DT_SECONDS
    rot_used = torch.where(damped, rot_damped, rot_total)
    t_used = torch.where(damped, torch.zeros_like(t_d), t_d)
    R_used = torch.where(damped, se3.exp_so3(rot_damped), R_d)
    T_prior = matmul_ordered(se3.make_T(R_used, t_used), T_wc)
    return T_prior, rot_used


def synthesize_measurements(
    poses_wc: np.ndarray,        # [N,4,4] ground-truth world->camera poses
    dt: float,
    calib: ImuCalibration | None = None,
    noise_gyro: float = 0.0,
    noise_accel: float = 0.0,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate (omega [N-1,3], accel [N-1,3]) IMU streams consistent with a
    pose sequence — the test-fixture generator (no analog in the reference,
    which replays recorded sensor dumps). Each step's twist is the port's
    float32 ``log_se3`` on ``device`` (``None`` means CUDA); the noise is
    numpy's ``default_rng(seed)``, drawn in the JAX package's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    poses_wc = np.asarray(poses_wc)
    N = len(poses_wc)
    deltas = np.stack([poses_wc[k + 1] @ np.linalg.inv(poses_wc[k])
                       for k in range(N - 1)])
    xis = se3.log_se3(
        torch.from_numpy(deltas.astype(np.float32)).to(dev)).cpu().numpy()
    omegas, accels = [], []
    up = np.array([0.0, -1.0, 0.0])
    vel_prev = None
    for k in range(N - 1):
        xi = xis[k]
        omega = xi[3:] / dt
        v = xi[:3] / dt
        if vel_prev is None:
            a = np.zeros(3)
        else:
            a = (v - vel_prev) / dt
        vel_prev = v
        # specific force = linear acceleration + gravity reaction in camera frame
        R_wc = poses_wc[k][:3, :3]
        g_cam = R_wc @ (up * GRAVITY)
        accel = a + g_cam
        if calib is not None:
            omega = omega + calib.bias_gyro
            accel = accel + calib.bias_accel
        omegas.append(omega + rng.normal(0, noise_gyro, 3))
        accels.append(accel + rng.normal(0, noise_accel, 3))
    return np.stack(omegas).astype(np.float32), np.stack(accels).astype(np.float32)
