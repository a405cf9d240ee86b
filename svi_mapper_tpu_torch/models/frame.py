"""The per-frame SLAM step on one device.

The equivalent of the reference's per-frame call tree (``CTracker*::process``
-> ``_trackLandmarks`` -> track / posit / measurement insertion / landmark
optimization / keyframe check / re-detection) over fixed-shape state:

  images -> dense BRIEF fields -> window tracking -> stereo posit
  -> regional recovery -> measurement append -> landmark GN refinement
  -> retirement -> masked detection + stereo triangulation -> landmark
  insertion -> keyframe decision.

Everything runs eagerly on the state's device. Where the JAX package uses
``lax.cond`` this step reads one flag on the host and branches in Python:
the rotation-only retry after a failed pose solve, and the recovery skip.
Host code feeds images and reads the per-frame outputs.

:func:`process_frame` and :func:`process_chunk` also take the state
``parallel.mesh.shard_state`` places on a ``map`` mesh, as the JAX
package's ``jit`` does. They unwrap its DTensors once, run every op on
this rank's rows of the table with the images, poses and scalars
replicated, and call the mesh's collectives (``parallel.mesh.LandmarkShards``)
where the step crosses the landmark axis: the pose solve (its matches
gathered, so every rank solves the whole table in the one-device order),
the recovery's skip flag and one-to-one assignment, the landmark GN's end
flag, the detection mask, the free-slot ranks of the insertion and the
output counts. Every flag read on the host is then the same on every rank,
and every sum of floats runs over the same rows in the same order as on
one device, so any mesh size gives the one-device bits. The state comes
back with its placements; the outputs are plain tensors, the same on every
rank. A state on one device takes none of these calls. The stereo-inertial
step (:func:`process_frame_svi`, :func:`process_chunk_svi`) unwraps the
same way; its IMU prior, fallback pose and velocity come from the
replicated pose, so it adds no collective.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from svi_mapper_tpu_torch.config import TrackingParams
from svi_mapper_tpu_torch.frontend import epipolar as epi
from svi_mapper_tpu_torch.frontend.recovery import regional_recovery
from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.frontend.tracking import track_landmarks
from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.imu import interpolator as imu_mod
from svi_mapper_tpu_torch.mapping import landmarks as lm
from svi_mapper_tpu_torch.ops.corners import detect_corners, occupancy_mask
from svi_mapper_tpu_torch.ops.descriptors import brief_at, smooth_brief_dense
from svi_mapper_tpu_torch.ops.image import _pad, equalize_hist, remap_bilinear, to_u8
from svi_mapper_tpu_torch.solvers.landmark_opt import optimize_landmarks
from svi_mapper_tpu_torch.solvers.posit import solve_stereo_posit
from svi_mapper_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class FrameState:
    """Tracking state threaded through the frame loop (replaces the mutable
    members of CTrackerSV/CFundamentalMatcher). All tensors on one device."""

    T_wc: torch.Tensor           # [4,4] current world->LEFT-camera estimate
    T_wc_prev: torch.Tensor      # [4,4] previous frame (constant-velocity prior)
    T_last_keyframe: torch.Tensor  # [4,4] pose at the last keyframe spawn
    table: lm.LandmarkTable
    next_uid: torch.Tensor       # int32
    frame_idx: torch.Tensor      # int32
    instability: torch.Tensor    # int32 (ref CTrackerSV.cpp:286-317: +5 on pose
                                 # failure, capped 20, -1 per good frame)

    @property
    def device(self) -> torch.device:
        return self.T_wc.device

    def replace(self, **changes) -> "FrameState":
        return dataclasses.replace(self, **changes)


_OUTPUT_INT_FIELDS = ("n_tracked", "n_active", "n_optimal", "n_new",
                      "inliers", "instability")
_OUTPUT_BOOL_FIELDS = ("posit_ok", "is_keyframe")


@dataclasses.dataclass
class FrameOutput:
    T_wc: torch.Tensor
    posit_ok: torch.Tensor       # bool — pose solve accepted (False in GT mode)
    n_tracked: torch.Tensor      # int32
    n_active: torch.Tensor       # int32
    n_optimal: torch.Tensor      # int32 visible optimal landmarks
    n_new: torch.Tensor          # int32 landmarks inserted
    is_keyframe: torch.Tensor    # bool
    avg_error_px2: torch.Tensor  # posit average inlier error
    inliers: torch.Tensor        # posit inlier count
    instability: torch.Tensor    # int32 — post-frame instability counter

    def to_host(self) -> "FrameOutput":
        """All fields as numpy values through ONE device->host copy. Works
        for a single frame and for a stacked chunk (leading axis N)."""
        lead = self.T_wc.shape[:-2]
        scalars = [getattr(self, f.name) for f in dataclasses.fields(self)
                   if f.name != "T_wc"]
        # float64 holds the float32 pose and every int32 counter exactly
        flat = torch.cat(
            [self.T_wc.reshape(lead + (16,)).to(torch.float64)]
            + [s.reshape(lead + (1,)).to(torch.float64) for s in scalars],
            dim=-1).cpu().numpy()
        vals = {"T_wc": flat[..., :16].reshape(lead + (4, 4)).astype(np.float32)}
        names = [f.name for f in dataclasses.fields(self) if f.name != "T_wc"]
        for i, name in enumerate(names):
            col = flat[..., 16 + i]
            if name in _OUTPUT_INT_FIELDS:
                vals[name] = col.astype(np.int32)
            elif name in _OUTPUT_BOOL_FIELDS:
                vals[name] = col != 0
            else:
                vals[name] = col.astype(np.float32)
        return FrameOutput(**vals)


@dataclasses.dataclass
class KeyframeSnapshot:
    """Per-frame landmark-table snapshot, so host keyframe handling sees the
    table AS OF the keyframe's own frame."""

    uid: torch.Tensor        # [L] int32
    active: torch.Tensor     # [L] bool
    optimal: torch.Tensor    # [L] bool
    tracked: torch.Tensor    # [L] bool — measurement landed this frame
    uv_left: torch.Tensor    # [L, 2] last left pixel
    disparity: torch.Tensor  # [L]
    pos_w: torch.Tensor      # [L, 3]
    desc: torch.Tensor       # [L, 8] int32 left reference descriptors
    bit_prob: torch.Tensor   # [L, 256] uint8 quantized bit probabilities


def snapshot_of(table: lm.LandmarkTable) -> KeyframeSnapshot:
    return KeyframeSnapshot(
        uid=table.uid,
        active=table.active,
        optimal=table.is_optimal,
        tracked=table.failed == 0,
        uv_left=table.uv_left_last,
        disparity=table.disparity_last,
        pos_w=table.pos_w,
        desc=table.desc_left_ref,
        bit_prob=lm.bit_prob_u8(table),
    )


def init_state(params: TrackingParams, T0=None,
               device: torch.device | str | None = None) -> FrameState:
    """Empty tracking state (``device=None`` means CUDA)."""
    dev = resolve_device(device)
    if T0 is None:
        eye = torch.eye(4, dtype=torch.float32, device=dev)
    else:
        eye = torch.as_tensor(np.asarray(T0, np.float32)).to(dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return FrameState(
        T_wc=eye,
        T_wc_prev=eye.clone(),
        T_last_keyframe=eye.clone(),
        table=lm.make_table(params.max_landmarks, params.max_measurements,
                            history_slots=params.desc_history_slots,
                            device=dev),
        next_uid=i32(0),
        frame_idx=i32(0),
        instability=i32(0),
    )


def _constant_velocity_prior(state: FrameState) -> torch.Tensor:
    """T_pred = (T_cur inv(T_prev)) T_cur (ref CTrackerSV constant-velocity
    prior, CTrackerSV.cpp:134-239)."""
    delta = state.T_wc @ se3.inv_T(state.T_wc_prev)
    return delta @ state.T_wc


def _to_image(img, dev: torch.device) -> torch.Tensor:
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.array(img, dtype=np.float32))
    return img.to(device=dev, dtype=torch.float32)


def _shards_of_rows(x):
    """The mesh collectives of a tensor of table rows: a
    ``parallel.mesh.LandmarkShards`` if it is a DTensor (which raises if
    its process group is gone), else None."""
    if "torch.distributed.tensor" not in sys.modules:   # no DTensor exists
        return None
    from svi_mapper_tpu_torch.parallel.mesh import LandmarkShards

    return LandmarkShards.of(x)


def shards_of(state: FrameState):
    """The collectives of a state ``parallel.mesh.shard_state`` placed,
    None for a state on one device."""
    return _shards_of_rows(state.table.active)


def process_frame(
    state: FrameState,
    img_left,                   # [H, W] float32 (tensor or numpy)
    img_right,
    cam: StereoCamera,
    params: TrackingParams,
    T_gt=None,                  # [4,4] GT pose, or external prior
    *,
    use_gt_pose: bool = False,
    use_external_prior: bool = False,   # T_gt is a PRIOR (IMU), posit still runs
    do_landmark_opt: bool = True,
    T_fallback=None,            # pose when the whole cascade fails (default:
                                # keep the raw prior)
    device: torch.device | str | None = None,
) -> tuple[FrameState, FrameOutput]:
    """Process one stereo frame on ``device`` (``None`` means CUDA); the
    state and the camera must already live there. A sharded state runs on
    this rank's rows and returns with its placements (module docstring)."""
    kw = dict(use_gt_pose=use_gt_pose, use_external_prior=use_external_prior,
              do_landmark_opt=do_landmark_opt, device=device)
    shards = shards_of(state)
    if shards is None:
        return _frame_step(state, img_left, img_right, cam, params, T_gt,
                           T_fallback=T_fallback, shards=None, **kw)
    loc = shards.local
    new_state, out = _frame_step(
        shards.local_state(state), loc(img_left), loc(img_right), cam, params,
        loc(T_gt), T_fallback=loc(T_fallback), shards=shards, **kw)
    return shards.wrap_state(new_state), out


def _frame_step(state, img_left, img_right, cam, params, T_gt, *, use_gt_pose,
                use_external_prior, do_landmark_opt, T_fallback, device, shards):
    """The body of :func:`process_frame` on plain tensors: the whole table,
    or this rank's rows of it with ``shards``."""
    dev = resolve_device(device)
    if state.device != dev or cam.device != dev:
        raise ValueError(
            f"state on {state.device}, camera on {cam.device}, but the frame "
            f"step was asked to run on {dev}")
    img_left = _to_image(img_left, dev)
    img_right = _to_image(img_right, dev)
    f32 = torch.float32

    # --- dense descriptor fields ------------------------------------------
    # Edge-extend the images to a 16-pixel-multiple width BEFORE describing,
    # as the JAX package does, so both packages describe the same field;
    # detection still runs on the unpadded image.
    wp = -(-img_left.shape[1] // 16) * 16
    if wp != img_left.shape[1]:
        ext = wp - img_left.shape[1]
        img_l_ext = _pad(img_left, 0, 0, 0, ext, "edge")
        img_r_ext = _pad(img_right, 0, 0, 0, ext, "edge")
    else:
        img_l_ext, img_r_ext = img_left, img_right
    dense_l = smooth_brief_dense(img_l_ext)
    dense_r = smooth_brief_dense(img_r_ext)

    # --- pose prior ------------------------------------------------------
    if use_gt_pose or use_external_prior:
        if T_gt is None:
            raise ValueError("GT mode and external-prior mode need T_gt")
        T_gt = torch.as_tensor(T_gt, dtype=f32).to(dev)
        T_prior = T_gt
    else:
        T_prior = _constant_velocity_prior(state)

    # search-window motion scaling from the frame-to-frame prior delta
    # (ref CTrackerGT.cpp:157: min(1 + 10|w| + 0.5|t|, 5))
    ms = epi.motion_scaling(T_prior @ se3.inv_T(state.T_wc),
                            params.motion_scaling_cap)

    track_kwargs = dict(
        cutoff_s1=params.matching_distance_tracking,
        cutoff_s2=params.matching_distance_tracking_stage2,
        cutoff_ref=params.matching_distance_epipolar,
        cutoff_stereo=params.matching_distance_triangulation,
        use_desc_history=params.use_desc_history,
    )

    # --- temporal tracking + frame pose ----------------------------------
    def _attempt(T_p):
        """One track-then-solve attempt under a given pose prior (the body
        of the reference's getPoseStereoPosit, CFundamentalMatcher.cpp:338:
        match collection reprojects with the prior, so a retry re-collects)."""
        tr = track_landmarks(dense_l, dense_r, state.table, T_p, cam, ms,
                             **track_kwargs)
        p_w, uv4, tracked = state.table.pos_w, tr.uv4, tr.tracked
        if shards is not None:
            # every rank solves the whole table's matches: one gather of 8
            # numbers a row, and the solve's sums run in the one-device order
            p_w, uv4, tracked = shards.gather(p_w, uv4, tracked)
        rs = solve_stereo_posit(
            T_p, p_w, uv4, tracked, cam,
            T_prior=T_p,
            kernel_px2=params.posit_kernel_px2,
            min_points=params.posit_min_points,
            min_inliers=params.posit_min_inliers,
            max_error_px2=params.posit_max_error_px2,
            max_risk_m2=params.posit_max_risk_m2,
            max_iterations=params.posit_max_iterations,
            convergence=params.posit_convergence,
        )
        return tr, rs

    if use_gt_pose:
        track = track_landmarks(dense_l, dense_r, state.table, T_prior, cam,
                                ms, **track_kwargs)
        T_new = T_gt
        posit_ok = torch.zeros((), dtype=torch.bool, device=dev)
        avg_err = torch.zeros((), dtype=f32, device=dev)
        inliers = torch.zeros((), dtype=torch.int32, device=dev)
        instability = state.instability
    else:
        # fallback cascade (ref CTrackerSV.cpp:271-318): raw prior ->
        # rotation-only prior (predicted rotation, LAST frame's camera
        # center) -> keep the raw prior with instability += 5
        track, res = _attempt(T_prior)
        if not bool(res.ok):      # one host read decides the retry
            R_prior = T_prior[:3, :3]
            c_last = -state.T_wc[:3, :3].T @ state.T_wc[:3, 3]
            T_rot = se3.make_T(R_prior, -R_prior @ c_last)
            track, res = _attempt(T_rot)
        posit_ok = res.ok
        avg_err = res.avg_error_px2
        inliers = res.inliers
        # final failure -> fallback pose (raw prior, or the caller's dead
        # reckoning) and raise the instability counter
        T_fb = (T_prior if T_fallback is None
                else torch.as_tensor(T_fallback, dtype=f32).to(dev))
        T_new = torch.where(posit_ok, res.T_wc, T_fb)
        instability = torch.clamp(
            torch.where(posit_ok, state.instability - 1, state.instability + 5),
            0, 20,
        )

    # --- regional detection recovery (stage-2 second chance under the
    #     refined pose, ref CFundamentalMatcher.cpp:495-727) ---------------
    if params.enable_recovery:
        rec = regional_recovery(
            dense_l, dense_r, img_left, state.table, track.tracked, T_new,
            cam, ms,
            cutoff=params.matching_distance_tracking_stage2,
            cutoff_stereo=params.matching_distance_triangulation,
            max_detections=params.recovery_max_detections,
            detect_cell=params.recovery_cell,
            use_desc_history=params.use_desc_history,
            shards=shards,
        )
        tracked_all = track.tracked | rec.recovered
        uv4_all = torch.where(track.tracked[:, None], track.uv4, rec.uv4)
        desc_all = torch.where(track.tracked[:, None], track.desc_left,
                               rec.desc_left)
    else:
        tracked_all = track.tracked
        uv4_all = track.uv4
        desc_all = track.desc_left
    n_tracked = torch.sum(tracked_all.to(torch.int32))

    # --- measurements ----------------------------------------------------
    table = lm.add_measurements(
        state.table, tracked_all, uv4_all, desc_all, T_new,
        hist_every=params.desc_history_every,
    )

    # --- landmark refinement (GT every frame, SV at the caller's cadence —
    #     ref CTrackerGT.cpp:196-198 / CTrackerSV.h:79) --------------------
    if bool(do_landmark_opt):
        table = optimize_landmarks(
            table, cam,
            min_measurements=params.landmark_min_measurements,
            kernel_px2=params.landmark_kernel_px2,
            max_error_px2=params.landmark_max_error_px2,
            min_inlier_ratio=params.landmark_min_inlier_ratio,
            max_iterations=params.landmark_max_iterations,
            convergence=params.landmark_convergence,
            idwa_fallback=params.landmark_idwa_fallback,
            shards=shards,
        )

    # --- retirement ------------------------------------------------------
    table = lm.retire_landmarks(table, params)

    # --- detection of new landmarks --------------------------------------
    allowed = occupancy_mask(
        tuple(img_left.shape), table.uv_left_last, table.active & tracked_all,
        radius=params.detect_min_distance,
    )
    if shards is not None:
        allowed = shards.all(allowed)
    uv_new, _, valid_new = detect_corners(
        img_left,
        k=params.max_detections,
        cell=params.detect_cell,
        quality=params.detect_quality,
        border=28,
        mask=allowed,
    )
    desc_new = brief_at(dense_l, uv_new)
    sm = match_stereo(
        dense_r, uv_new, desc_new, valid_new, cam,
        cutoff=params.matching_distance_triangulation,
        min_depth=params.min_depth_m,
        max_depth=params.max_depth_m,
    )
    desc_new_r = brief_at(dense_r, sm.uv_right)
    T_cw = se3.inv_T(T_new)
    pos_w_new = se3.transform(T_cw, sm.p_cam)
    uv4_new = torch.cat([uv_new, sm.uv_right], dim=-1)
    table, next_uid = lm.insert_landmarks(
        table, sm.ok, pos_w_new, uv_new, sm.disparity,
        desc_new, desc_new_r, uv4_new, T_new, state.next_uid, shards=shards,
    )
    n_new = next_uid - state.next_uid

    # --- keyframe decision (ref CTrackerGT.h:47-49,68) -------------------
    delta_kf = T_new @ se3.inv_T(state.T_last_keyframe)
    dt2 = torch.sum(delta_kf[:3, 3] ** 2)
    dr2 = torch.sum(se3.log_so3(delta_kf[:3, :3]) ** 2)
    n_optimal = torch.sum(
        (table.active & table.is_optimal & tracked_all).to(torch.int32))
    n_active = torch.sum(table.active.to(torch.int32))
    if shards is not None:
        n_tracked, n_optimal, n_active = shards.sum(n_tracked, n_optimal, n_active)
    is_keyframe = (
        (dt2 > params.keyframe_translation_m2) | (dr2 > params.keyframe_rotation_rad2)
    ) & (n_optimal >= params.keyframe_min_landmarks)

    # bump keyframe presences of the landmarks visible in a new keyframe
    # (promotion rule, ref CFundamentalMatcher.cpp:203-242)
    table = table.replace(
        keyframe_presences=torch.where(
            is_keyframe & table.active & tracked_all,
            table.keyframe_presences + 1,
            table.keyframe_presences,
        )
    )

    new_state = FrameState(
        T_wc=T_new,
        T_wc_prev=state.T_wc,
        T_last_keyframe=torch.where(is_keyframe, T_new, state.T_last_keyframe),
        table=table,
        next_uid=next_uid,
        frame_idx=state.frame_idx + 1,
        instability=state.instability if use_gt_pose else instability,
    )
    out = FrameOutput(
        T_wc=T_new,
        posit_ok=posit_ok,
        n_tracked=n_tracked,
        n_active=n_active,
        n_optimal=n_optimal,
        n_new=n_new,
        is_keyframe=is_keyframe,
        avg_error_px2=avg_err,
        inliers=inliers,
        instability=new_state.instability,
    )
    return new_state, out


def _stack(items):
    first = items[0]
    return type(first)(**{
        f.name: torch.stack([getattr(it, f.name) for it in items])
        for f in dataclasses.fields(first)})


def process_chunk(
    state: FrameState,
    imgs_left,                  # [N, H, W] float32 — staged frame chunk
    imgs_right,
    cam: StereoCamera,
    params: TrackingParams,
    T_gt=None,                  # [N,4,4] GT poses (GT mode only)
    *,
    use_gt_pose: bool = False,
    landmark_opt_every: int = 1,
    emit_snapshots: bool = False,
    device: torch.device | str | None = None,
):
    """Throughput mode: the frame step looped over a staged chunk, with no
    per-frame read of the outputs — they come back stacked, ``[N, ...]`` per
    field, on the device. Numerically identical to N sequential
    :func:`process_frame` calls; the landmark-opt cadence follows the
    carried frame index (one host read per chunk), so it survives chunk
    boundaries.

    With ``emit_snapshots=True`` a per-frame :class:`KeyframeSnapshot` is
    stacked as well and returned third. A sharded state is unwrapped once
    and rewrapped once (module docstring); its snapshots come back split
    over the mesh along their landmark axis (1), as :func:`snapshot_rows`
    reads them.
    """
    dev = resolve_device(device)
    shards = shards_of(state)
    if shards is not None:
        state = shards.local_state(state)
        imgs_left, imgs_right, T_gt = (shards.local(x) for x in (imgs_left, imgs_right, T_gt))
    imgs_left = _to_image(imgs_left, dev)
    imgs_right = _to_image(imgs_right, dev)
    every = max(1, landmark_opt_every)
    idx0 = int(state.frame_idx)
    outs, snaps = [], []
    for i in range(imgs_left.shape[0]):
        state, out = _frame_step(
            state, imgs_left[i], imgs_right[i], cam, params,
            None if T_gt is None else T_gt[i],
            use_gt_pose=use_gt_pose, use_external_prior=False,
            do_landmark_opt=((idx0 + i) % every) == 0,
            T_fallback=None, device=dev, shards=shards,
        )
        outs.append(out)
        if emit_snapshots:
            snaps.append(snapshot_of(state.table))
    if shards is not None:
        state = shards.wrap_state(state)
    if emit_snapshots:
        snaps = _stack(snaps)
        if shards is not None:
            snaps = KeyframeSnapshot(**{
                f.name: shards.wrap_rows(getattr(snaps, f.name), dim=1)
                for f in dataclasses.fields(KeyframeSnapshot)})
        return state, _stack(outs), snaps
    return state, _stack(outs)


def snapshot_rows(snaps: KeyframeSnapshot, sel: torch.Tensor) -> KeyframeSnapshot:
    """The frames ``sel`` of a stacked snapshot with every row of the
    table: ``field[sel]``, gathered over the ranks where
    :func:`process_chunk` split the stack over a mesh."""
    names = [f.name for f in dataclasses.fields(KeyframeSnapshot)]
    shards = _shards_of_rows(snaps.uid)
    if shards is None:
        return KeyframeSnapshot(**{n: getattr(snaps, n)[sel] for n in names})
    full = shards.gather(*[shards.local(getattr(snaps, n))[sel] for n in names], dim=1)
    return KeyframeSnapshot(**dict(zip(names, full)))


# ---------------------------------------------------------------------------
# the stereo-inertial frame step
# ---------------------------------------------------------------------------

def svi_preprocess(img: torch.Tensor, equalize: bool, map_x=None,
                   map_y=None) -> torch.Tensor:
    """equalizeHist + undistortAndrectify of one raw frame
    (ref CTrackerSVI.cpp:339-341); ``map_x`` None means no remap."""
    if equalize:
        img = equalize_hist(to_u8(img))
    if map_x is not None:
        img = remap_bilinear(img, map_x, map_y)
    return img


def svi_prior(T_wc: torch.Tensor, dts, omega, accel, valid, velocity,
              R_ci, bias_gyro, bias_accel):
    """The IMU prior of one frame interval and its dead-reckoning fallback:
    ``(T_prior, T_fallback, rot_total)``. The fallback is the integrated
    rotation with its x component zeroed, applied to ``T_wc`` without
    translation (ref CTrackerSVI.cpp:548-551)."""
    T_prior, rot_total = imu_mod.integrate_prior_samples(
        T_wc, dts, omega, accel, valid, velocity, R_ci, bias_gyro, bias_accel)
    rot_yz = torch.cat([torch.zeros_like(rot_total[:1]), rot_total[1:]])
    T_fb = imu_mod.matmul_ordered(
        se3.make_T(se3.exp_so3(rot_yz), torch.zeros_like(rot_total)), T_wc)
    return T_prior, T_fb, rot_total


def svi_velocity(T_new: torch.Tensor, T_before: torch.Tensor, dt_total,
                 velocity: torch.Tensor) -> torch.Tensor:
    """Camera-frame velocity from the accepted visual pose delta over the
    frame interval (finite difference); the old velocity where the interval
    is empty. It differences poses of one gauge: the caller takes it before
    any back-end correction or world shift."""
    xi = se3.log_se3(imu_mod.matmul_ordered(T_new, se3.inv_T(T_before)))
    dt_total = torch.as_tensor(dt_total, dtype=torch.float32, device=T_new.device)
    return torch.where(dt_total > 1e-6,
                       xi[:3] / torch.clamp(dt_total, min=1e-6), velocity)


def process_frame_svi(
    state: FrameState,
    img_left,                   # [H, W] RAW frame (tensor or numpy)
    img_right,
    cam: StereoCamera,
    params: TrackingParams,
    dts: torch.Tensor,          # [cap] per-sample time steps (0-padded)
    omega: torch.Tensor,        # [cap, 3] raw IMU angular velocities
    accel: torch.Tensor,        # [cap, 3] raw IMU specific forces
    valid: torch.Tensor,        # [cap] bool sample mask
    velocity: torch.Tensor,     # [3] camera-frame linear velocity carry-in
    R_ci: torch.Tensor,         # [3,3] IMU->camera rotation
    bias_gyro: torch.Tensor,    # [3]
    bias_accel: torch.Tensor,   # [3]
    *,
    do_landmark_opt: bool = True,
    equalize: bool = False,
    rect_maps: tuple | None = None,   # (mlx, mly, mrx, mry) or None
    device: torch.device | str | None = None,
):
    """One stereo-inertial frame: preprocess the raw frames, integrate the
    interval's IMU samples into a pose prior from the carried velocity,
    run the visual step with the IMU dead-reckoning fallback, and update
    the velocity from the accepted pose delta. No host read beyond
    :func:`process_frame`'s. Returns ``(state, output, velocity)``.

    A sharded state is unwrapped once and rewrapped once, as in
    :func:`process_frame`: the IMU prior, its fallback and the velocity are
    computed from the replicated pose on every rank, so they are the same
    bits everywhere and the step needs no collective beyond
    :func:`process_frame`'s."""
    dev = resolve_device(device)
    shards = shards_of(state)
    if shards is not None:
        state = shards.local_state(state)
    state, out, vel = _svi_step(
        state, img_left, img_right, cam, params, dts, omega, accel, valid,
        velocity, R_ci, bias_gyro, bias_accel, do_landmark_opt=do_landmark_opt,
        equalize=equalize, rect_maps=rect_maps, device=dev, shards=shards)
    if shards is not None:
        state = shards.wrap_state(state)
    return state, out, vel


def _svi_step(state, img_left, img_right, cam, params, dts, omega, accel, valid,
              velocity, R_ci, bias_gyro, bias_accel, *, do_landmark_opt, equalize,
              rect_maps, device, shards):
    """The body of :func:`process_frame_svi` on plain tensors: the whole
    table, or this rank's rows of it with ``shards`` (replicated inputs
    given as DTensors are read locally)."""
    if shards is not None:
        (img_left, img_right, dts, omega, accel, valid, velocity, R_ci, bias_gyro,
         bias_accel) = (shards.local(x) for x in (
             img_left, img_right, dts, omega, accel, valid, velocity, R_ci, bias_gyro,
             bias_accel))
        if rect_maps is not None:
            rect_maps = tuple(shards.local(m) for m in rect_maps)
    mlx = mly = mrx = mry = None
    if rect_maps is not None:
        mlx, mly, mrx, mry = rect_maps
    l = svi_preprocess(_to_image(img_left, device), equalize, mlx, mly)
    r = svi_preprocess(_to_image(img_right, device), equalize, mrx, mry)
    T = state.T_wc
    T_prior, T_fb, _ = svi_prior(T, dts, omega, accel, valid, velocity,
                                 R_ci, bias_gyro, bias_accel)
    state2, out = _frame_step(
        state, l, r, cam, params, T_prior, use_gt_pose=False,
        use_external_prior=True, do_landmark_opt=do_landmark_opt,
        T_fallback=T_fb, device=device, shards=shards,
    )
    vel = svi_velocity(state2.T_wc, T, torch.sum(dts * valid), velocity)
    return state2, out, vel


def process_chunk_svi(
    state: FrameState,
    imgs_left,                  # [N, H, W] RAW frames (preprocessing runs
    imgs_right,                 #   inside the loop)
    cam: StereoCamera,
    params: TrackingParams,
    dts: torch.Tensor,          # [N, cap] per-sample time steps (0-padded)
    omega: torch.Tensor,        # [N, cap, 3] raw IMU angular velocities
    accel: torch.Tensor,        # [N, cap, 3] raw IMU specific forces
    valid: torch.Tensor,        # [N, cap] bool sample mask
    velocity0: torch.Tensor,    # [3] camera-frame linear velocity carry-in
    R_ci: torch.Tensor,         # [3,3] IMU->camera rotation
    bias_gyro: torch.Tensor,    # [3]
    bias_accel: torch.Tensor,   # [3]
    *,
    landmark_opt_every: int = 1,
    equalize: bool = False,
    rect_maps: tuple | None = None,   # (mlx, mly, mrx, mry) or None
    device: torch.device | str | None = None,
):
    """SVI throughput mode: :func:`process_frame_svi` looped over a staged
    chunk with the velocity carried on the device — the same stepping as N
    sequential per-frame calls, with no per-frame read of the outputs (they
    come back stacked, as :func:`process_chunk` stacks them) and the
    landmark-opt cadence from the carried frame index (one host read per
    chunk).

    A sharded state is unwrapped once and rewrapped once, and its
    snapshots come back split along their landmark axis (1), as
    :func:`process_chunk` returns them.

    Returns ``(state, velocity, outputs, snapshots)``.
    """
    dev = resolve_device(device)
    shards = shards_of(state)
    if shards is not None:
        state = shards.local_state(state)
        imgs_left, imgs_right, dts, omega, accel, valid = (
            shards.local(x) for x in (imgs_left, imgs_right, dts, omega, accel, valid))
    imgs_left = _to_image(imgs_left, dev)
    imgs_right = _to_image(imgs_right, dev)
    every = max(1, landmark_opt_every)
    idx0 = int(state.frame_idx)
    vel = velocity0
    outs, snaps = [], []
    for i in range(imgs_left.shape[0]):
        state, out, vel = _svi_step(
            state, imgs_left[i], imgs_right[i], cam, params,
            dts[i], omega[i], accel[i], valid[i], vel, R_ci,
            bias_gyro, bias_accel,
            do_landmark_opt=((idx0 + i) % every) == 0,
            equalize=equalize, rect_maps=rect_maps, device=dev, shards=shards,
        )
        outs.append(out)
        snaps.append(snapshot_of(state.table))
    snaps = _stack(snaps)
    if shards is not None:
        state = shards.wrap_state(state)
        snaps = KeyframeSnapshot(**{
            f.name: shards.wrap_rows(getattr(snaps, f.name), dim=1)
            for f in dataclasses.fields(KeyframeSnapshot)})
    return state, vel, _stack(outs), snaps
