"""Stereo + IMU SLAM: the SVI model family.

Equivalent of ``CTrackerSVI`` (CTrackerSVI.cpp): images are
histogram-equalized and undistorted/rectified (:339-341), the pose prior
comes from IMU integration instead of constant velocity (rotation from the
integrated gyro, translation from v dt + 1/2 a dt^2, :356-364, damped on
measurement gaps :377-398), the fallback chain ends in IMU dead reckoning,
and each keyframe contributes a gravity-direction prior to the pose graph
(the ``EdgeSE3LinearAcceleration`` unary edge, Cg2oOptimizer.cpp:411) and to
the full-graph BA.

The IMU must be calibrated first (``imu.interpolator.calibrate`` over a
static period — the pre-loop of tracker_svi.cpp:145-177).

The camera-frame velocity is carried on the device as a float32 tensor
(``velocity``), so neither the per-frame nor the chunked path reads it on
the host. The per-frame :meth:`StereoInertialTracker.process_imu_samples` and
the chunked :meth:`StereoInertialTracker.process_many_imu` run the same frame
step (``models.frame.process_frame_svi``); with the back-end off they give
the same bits. With the back-end on, the chunked path runs the keyframe tail
at the chunk boundary, as ``SLAMSystem.process_many`` does.

The tracker also runs on a state ``parallel.mesh.shard_state`` placed on a
``map`` mesh (every rank drives the same frames and samples): the IMU reads
the replicated pose, so every rank computes the same prior, fallback and
velocity bits, and every flag the step branches on is the same on every
rank.

``SLAMSystem``'s options pass through ``**kwargs``: with ``async_closure``
or ``overlap_backend`` the gravity observations are still recorded on the
tracker thread, once per keyframe before its event is handed over, and the
worker reads them for the pose graph's and BA's gravity unaries.
"""

from __future__ import annotations

import numpy as np
import torch

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, TrackingParams
from svi_mapper_tpu_torch.eval.timing import span
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.imu import interpolator as imu_mod
from svi_mapper_tpu_torch.models import frame as frame_mod
from svi_mapper_tpu_torch.models.slam import SLAMSystem
from svi_mapper_tpu_torch.ops.image import equalize_hist, to_u8
from svi_mapper_tpu_torch.solvers import pose_graph as pg_mod

_DOWN_W = np.array([0.0, -1.0, 0.0], np.float64)


class StereoInertialTracker(SLAMSystem):
    """SVI tracker: IMU-primed priors + gravity edges in the pose graph and
    the full-graph BA. ``device=None`` means CUDA; the camera must live on
    the same device."""

    def __init__(
        self,
        cam: StereoCamera,
        calibration: imu_mod.ImuCalibration,
        params: TrackingParams = DEFAULT_PARAMS,
        rectify_maps: tuple | None = None,
        equalize: bool = True,
        gravity_weight: float = 10.0,
        T_cam_imu: np.ndarray | None = None,
        **kwargs,
    ):
        super().__init__(cam, params, use_gt_pose=False, **kwargs)
        self.calib = calibration
        # camera<->IMU extrinsics (ref CPinholeCameraIMU.h:17-60 /
        # vi_sensor_camera_left.txt:17-23): IMU-frame rates/accelerations
        # rotate into the LEFT camera frame before integration. Identity by
        # default (IMU aligned with the camera).
        self.T_cam_imu = (np.eye(4, dtype=np.float32) if T_cam_imu is None
                          else np.asarray(T_cam_imu, np.float32))
        self._R_ci = self._dev(self.T_cam_imu[:3, :3], torch.float32)
        self._bias_gyro = self._dev(np.asarray(calibration.bias_gyro, np.float32))
        self._bias_accel = self._dev(np.asarray(calibration.bias_accel, np.float32))
        self.rectify_maps = None
        if rectify_maps is not None:
            self.rectify_maps = tuple(self._dev(np.asarray(m, np.float32))
                                      for m in rectify_maps)
        self.equalize = equalize
        self.gravity_weight = gravity_weight
        # gravity weight in the full-graph BA: the reprojection chi2 is in
        # px^2 (robust kernel 10 px^2) while the gravity residual is a unit
        # direction error — scale it so a few degrees of tilt costs like a
        # couple of robust-saturated observations
        self.gravity_ba_weight = 100.0 * gravity_weight
        self.velocity = torch.zeros(3, dtype=torch.float32, device=self.device)
        self._imu_sample_cap = 32      # static loop length (200 Hz / 20 Hz = 10)
        self.gravity_obs: list[np.ndarray] = []       # per-keyframe down directions

    # ------------------------------------------------------------------
    def preprocess(self, img) -> torch.Tensor:
        """equalizeHist of one raw frame (ref CTrackerSVI.cpp:339-341) as
        the JAX method gives it: with ``equalize``, the image clipped to
        [0, 255] and truncated to uint8 is equalized; float32 on the
        tracker's device either way. No remap (the frame steps remap
        through ``frame.svi_preprocess``)."""
        x = frame_mod._to_image(img, self.device)
        if self.equalize:
            x = equalize_hist(to_u8(x))
        return x.to(torch.float32)

    def _pad_samples(self, dts, omega, accel):
        """One frame's sample block padded to the cap on the host (the most
        recent ``cap`` rows kept if oversupplied): ``(dts [cap], omega
        [cap,3], accel [cap,3], valid [cap])`` numpy."""
        cap = self._imu_sample_cap
        d = np.asarray(dts, np.float32).reshape(-1)
        k = min(len(d), cap)
        out = (np.zeros(cap, np.float32), np.zeros((cap, 3), np.float32),
               np.zeros((cap, 3), np.float32), np.zeros(cap, bool))
        if k:
            out[0][:k] = d[-k:]
            out[1][:k] = np.asarray(omega, np.float32).reshape(-1, 3)[-k:]
            out[2][:k] = np.asarray(accel, np.float32).reshape(-1, 3)[-k:]
            out[3][:k] = True
        return out

    def process_imu(self, img_left, img_right, omega, accel, dt):
        """One SVI frame primed by ONE IMU sample extrapolated over ``dt``
        (ref CTrackerSVI.cpp:354-399): IMU prior -> visual solve -> velocity
        update. Measurements rotate from the IMU frame into the camera frame
        through the rig extrinsics."""
        dev = self.device
        mlx = mly = mrx = mry = None
        if self.rectify_maps is not None:
            mlx, mly, mrx, mry = self.rectify_maps
        L = frame_mod.svi_preprocess(frame_mod._to_image(img_left, dev),
                                     self.equalize, mlx, mly)
        R = frame_mod.svi_preprocess(frame_mod._to_image(img_right, dev),
                                     self.equalize, mrx, mry)
        T = self._local_state()[0].T_wc    # replicated on a sharded state
        rotate = imu_mod.matvec_ordered
        w = rotate(self._R_ci, self._dev(np.asarray(omega, np.float32)) - self._bias_gyro)
        a = imu_mod.gravity_filtered_accel(
            rotate(self._R_ci, self._dev(np.asarray(accel, np.float32))),
            T[:3, :3], rotate(self._R_ci, self._bias_accel))
        dt = float(np.float32(dt))
        T_prior = imu_mod.integrate_prior(T, w, a, self.velocity, dt)
        return self._process_with_prior(L, R, T_prior, T_before=T, dt=dt)

    def process_imu_samples(self, img_left, img_right, dts, omega, accel):
        """One SVI frame primed by the FULL high-rate IMU stream of the
        frame interval (per-sample integration,
        ``imu.interpolator.integrate_prior_samples``).

        Args:
          dts:   [n] per-sample time steps in seconds.
          omega: [n,3] raw IMU-frame angular velocities.
          accel: [n,3] raw IMU-frame specific forces.
        """
        with span("svi.frame.step", into=(self.timings, "frame_total")):
            d, om, ac, va = (self._dev(a) for a in self._pad_samples(dts, omega, accel))
            do_opt = (self.frame_count % self.landmark_opt_every) == 0
            self.state, out, self.velocity = frame_mod.process_frame_svi(
                self.state, img_left, img_right, self.cam, self.params,
                d, om, ac, va, self.velocity, self._R_ci,
                self._bias_gyro, self._bias_accel,
                do_landmark_opt=do_opt, equalize=self.equalize,
                rect_maps=self.rectify_maps, device=self.device,
            )
            out = out.to_host()            # all per-frame outputs in one read
        return self._record_frame(out)

    def process_many_imu(self, imgs_left, imgs_right, dts, omega, accel,
                         chunk: int = 16) -> list:
        """SVI throughput mode: chunked stereo-inertial tracking with the full
        back-end at chunk boundaries (the SVI analog of
        ``SLAMSystem.process_many``).

        Args:
          imgs_left/imgs_right: [N, H, W] RAW frames (equalization and
            rectification run inside the frame loop).
          dts / omega / accel: length-N sequences of per-frame IMU sample
            blocks ([n_i], [n_i,3], [n_i,3] — raw IMU frame), as produced
            by a 200 Hz stream split at frame boundaries.
        """
        L = frame_mod._to_image(imgs_left, self.device)
        R = frame_mod._to_image(imgs_right, self.device)
        n = L.shape[0]
        blocks = [self._pad_samples(dts[i], omega[i], accel[i]) for i in range(n)]
        d_all, om_all, ac_all, va_all = (
            self._dev(np.stack([b[j] for b in blocks])) for j in range(4))
        outs: list = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            with span("svi.frame.chunk", into=(self.timings, "frame_total")):
                self.state, self.velocity, stacked, snaps = frame_mod.process_chunk_svi(
                    self.state, L[s:e], R[s:e], self.cam, self.params,
                    d_all[s:e], om_all[s:e], ac_all[s:e], va_all[s:e],
                    self.velocity, self._R_ci, self._bias_gyro, self._bias_accel,
                    landmark_opt_every=self.landmark_opt_every,
                    equalize=self.equalize, rect_maps=self.rectify_maps,
                    device=self.device,
                )
                stacked = stacked.to_host()   # one copy for the chunk's outputs
            outs.extend(self._finish_chunk(stacked, snaps, e - s))
            self._apply_folds()       # no-op without the overlapped back-end
            self._maybe_world_shift()
        return outs

    def _note_keyframe_pose(self, T_wc: np.ndarray) -> None:
        """Record the measured gravity direction of a keyframe, index-aligned
        with ``slam_keyframes``, for the pose-graph/BA unaries (both paths
        call it once per keyframe, just before its event dispatches)."""
        R_wc = np.asarray(T_wc, np.float64)[:3, :3]
        self.gravity_obs.append((R_wc @ _DOWN_W).astype(np.float32))

    # ------------------------------------------------------------------
    def _process_with_prior(self, L, R, T_prior, T_before, dt):
        """The visual step under an external prior (the single-sample path)."""
        with span("svi.frame.step", into=(self.timings, "frame_total")):
            do_opt = (self.frame_count % self.landmark_opt_every) == 0
            state2, out = frame_mod.process_frame(
                self.state, L, R, self.cam, self.params, T_prior,
                use_external_prior=True, do_landmark_opt=do_opt,
                device=self.device,
            )
            # velocity from the visual solve delta, BEFORE back-end corrections
            # and the robocentric world shift change the gauge — differencing
            # across a rebase would absorb the shift into a huge spurious
            # velocity that poisons the next IMU prior
            self.state = state2
            self.velocity = frame_mod.svi_velocity(self._local_state()[0].T_wc, T_before,
                                                   dt, self.velocity)
            out = out.to_host()            # all per-frame outputs in one read
        return self._record_frame(out)

    def _record_frame(self, out):
        """Host bookkeeping of one per-frame SVI step, its outputs read: the
        trajectory, and the keyframe event with its gravity observation."""
        self.frame_count += 1
        self.trajectory.append(out.T_wc)
        self.outputs.append(out)
        if bool(out.is_keyframe):
            self._note_keyframe_pose(out.T_wc)
            self._on_keyframe(out)
        self._maybe_world_shift()
        return out

    # ------------------------------------------------------------------
    def _gravity_priors(self, N0: int, N: int):
        """Per-keyframe gravity unaries for the pose graph, shaped [N] with
        the first N0 rows real (ref EdgeSE3LinearAcceleration in the
        trajectory graph, Cg2oOptimizer.cpp:411)."""
        if len(self.gravity_obs) < N0:
            return None
        down = np.zeros((N, 3), np.float32)
        down[:N0] = np.stack(self.gravity_obs[:N0])
        w = np.zeros(N, np.float32)
        w[:N0] = self.gravity_weight
        v = np.zeros(N, bool)
        v[:N0] = True
        return pg_mod.GravityPriors(
            down_cam=self._dev(down), weight=self._dev(w), valid=self._dev(v))

    def _gravity_ba_terms(self, kfs: list, K: int):
        """Per-keyframe gravity unaries for the FULL-graph BA window (ref
        gravity edges added to every keyframe of the full graph,
        Cg2oOptimizer.cpp:982-997) — without them the incremental BA can
        rotate the map against gravity on IMU runs."""
        if not kfs or len(self.gravity_obs) <= kfs[-1].index:
            return None
        down = np.zeros((K, 3), np.float32)
        w = np.zeros(K, np.float32)
        for k, kf in enumerate(kfs):
            down[k] = self.gravity_obs[kf.index]
            w[k] = self.gravity_ba_weight
        return down, w
