"""Checkpoint / resume of the full SLAM map state.

The reference is not resumable — its only persistence is g2o graph snapshots
(Cg2oOptimizer.cpp:493-514), keyframe cloud files (CKeyFrame.cpp:138-185)
and the final KITTI trajectory log. This module checkpoints the *whole* map
state (landmark table, keyframe poses, closure edges, the closure database
and the back-end's queue) so long runs can stop and resume exactly.

A checkpoint is one compressed ``.npz``: the ``FrameState`` fields, the
keyframe database pools, and the ragged host records (keyframes, closures)
stored as concatenated arrays + offsets. A JSON manifest (``__meta__``)
carries the scalars, the tracking parameters and the camera size, so
:func:`load_checkpoint` rebuilds a tracker without any other input.

The file is the JAX package's checkpoint, version 2, key for key and dtype
for dtype: a checkpoint written by either package resumes in the other.
Packed descriptors are ``uint32`` in the file (int32 with the same bits in
the port); integer state fields are int32. Not stored, in either package:
the closure database's in-run BoW vocabulary. A resumed run starts with
none and trains it anew over all stored pools at its next keyframe, so its
closure shortlists can differ from the uninterrupted run's (ROADMAP F12);
the frame step does not read it.

A system run with ``async_closure`` or ``overlap_backend`` is drained
(``flush_closures(block=True)``) before it is saved, so no search or
back-end step is in flight in the file. The file records whether the
closure database had a native index and whether the system ran the closure
worker, and a loaded system gets both back, the index rebuilt from the
stored pools. The overlapped back-end is not recorded (as in the JAX
package): a loaded system runs the back-end synchronously.

A tracker whose state ``parallel.mesh.shard_state`` placed on a ``map``
mesh saves the same file, with every row of the table: every rank calls
:func:`save_checkpoint` (the table is gathered, a collective), rank 0
writes, and all ranks return once the file is whole. :func:`load_checkpoint`
returns the state on one device; putting it back on a mesh is the caller's
``shard_state``, as in the JAX package, where saving a sharded state is a
gather and re-sharding on load is the caller's placement.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.ops.descriptors import (
    words_from_numpy,
    words_to_numpy,
    words_u32,
)
from svi_mapper_tpu_torch.utils.device import resolve_device
from svi_mapper_tpu_torch.utils.errors import InvalidFileError

# v2: closure waiting-queue state + per-edge uid_pairs/suppressed
CHECKPOINT_VERSION = 2

_STATE_FIELDS = (
    "T_wc", "T_wc_prev", "T_last_keyframe", "next_uid", "frame_idx",
    "instability",
)
_CAM_FIELDS = ("P", "K", "dist", "R_rect")
_DB_FIELDS = ("desc", "p_cam", "valid", "count", "T_wc")
_CALIB_FIELDS = ("R_imu_to_world", "bias_gyro", "bias_accel", "noise_gyro",
                 "noise_accel")


def _cat(arrays, dtype):
    """Concatenate a ragged list of [n, ...] arrays -> (flat, offsets)."""
    if not arrays:
        return np.zeros((0,), dtype), np.zeros(1, np.int64)
    flat = np.concatenate([np.asarray(a, dtype) for a in arrays], axis=0)
    offs = np.zeros(len(arrays) + 1, np.int64)
    np.cumsum([len(a) for a in arrays], out=offs[1:])
    return flat, offs


def _split(flat, offs):
    return [flat[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _kind(tracker) -> str:
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    if isinstance(tracker, StereoInertialTracker):
        return "svi"
    return "slam" if isinstance(tracker, SLAMSystem) else "tracker"


def save_checkpoint(path: str | Path, tracker) -> None:
    """Serialize a ``StereoTracker`` / ``SLAMSystem`` /
    ``StereoInertialTracker`` to ``path``.

    The checkpoint is self-contained: camera calibration and tracking
    parameters ride along, so resuming needs only the file. Reads the
    tracker's device state to the host, after waiting for the worker
    threads' pending work. For a sharded state every rank must call it:
    the table is gathered, rank 0 writes the file, and the ranks return
    together.
    """
    if hasattr(tracker, "flush_closures"):
        tracker.flush_closures(block=True)   # async searches must land first
    arrays: dict[str, np.ndarray] = {}
    state = convert.state_to_numpy(tracker.state)
    for f in _STATE_FIELDS:
        arrays[f"state__{f}"] = np.asarray(state[f])
    for name, a in state["table"].items():
        arrays[f"table__{name}"] = a

    if tracker.trajectory:
        arrays["trajectory"] = np.stack(
            [np.asarray(T, np.float64) for T in tracker.trajectory])
    # robocentric world-shift state (ref m_vecTranslationToG2o)
    arrays["world_offset"] = np.asarray(tracker.world_offset, np.float64)
    arrays["world_shifts"] = np.asarray(tracker.world_shifts, np.int64)

    for eye in ("left", "right"):
        c = getattr(tracker.cam, eye)
        for f in _CAM_FIELDS:
            arrays[f"cam__{eye}__{f}"] = _host(getattr(c, f))

    kind = _kind(tracker)
    meta = {
        "version": CHECKPOINT_VERSION,
        "kind": kind,
        "params": dataclasses.asdict(tracker.params),
        "use_gt_pose": tracker.use_gt_pose,
        "landmark_opt_every": tracker.landmark_opt_every,
        "frame_count": tracker.frame_count,
        "cam": {eye: {"width": getattr(tracker.cam, eye).width,
                      "height": getattr(tracker.cam, eye).height}
                for eye in ("left", "right")},
    }

    if kind in ("slam", "svi"):
        kfs = tracker.slam_keyframes
        meta["slam"] = {
            "enable_loop_closure": tracker.enable_loop_closure,
            "enable_local_ba": tracker.enable_local_ba,
            "ba_window": tracker.ba_window,
            "ba_max_points": tracker.ba_max_points,
            "consensus_window": tracker.consensus_window,
            "stats": tracker.stats,
            "kf_index": [k.index for k in kfs],
            "kf_frame_idx": [k.frame_idx for k in kfs],
            "db_n": tracker.db.n,
            "db_capacity": tracker.db.capacity,
            "db_pool_size": tracker.db.pool_size,
            "db_native_index": tracker.db.index is not None,
            "async_closure": tracker._closure_pool is not None,
            # incremental-BA / landmark-identity state
            "last_opt_kf": tracker._last_opt_kf,
            "uid_parent": {str(k): v for k, v in tracker._uid_parent.items()},
            "excised_uids": sorted(tracker._excised_uids),
            # closure waiting-queue state: a checkpoint taken with closures
            # queued resumes with the pending reconciliation trigger intact
            "last_closure_opt_kf": int(tracker._last_closure_opt_kf),
            "closure_kfs_in_queue": int(tracker._closure_kfs_in_queue),
            "closure_opt_lo": (None if tracker._closure_opt_lo is None
                               else int(tracker._closure_opt_lo)),
            "kf_since_local_ba": int(tracker._kf_since_local_ba),
        }
        if kfs:
            arrays["kf__T_wc"] = np.stack([k.T_wc for k in kfs])
            arrays["kf__obs_uids"], arrays["kf__obs_offs"] = _cat(
                [k.obs_uids for k in kfs], np.int64)
            arrays["kf__obs_uv4"] = np.concatenate([k.obs_uv4 for k in kfs], axis=0)
            # spawn-time world positions; only when every keyframe has them
            if all(len(k.obs_pos) == len(k.obs_uids) for k in kfs):
                arrays["kf__obs_pos"] = np.concatenate(
                    [k.obs_pos for k in kfs], axis=0)
            arrays["kf__pool_uids"], arrays["kf__pool_offs"] = _cat(
                [k.pool_uids for k in kfs], np.int64)
        for name, edges in (("cand", tracker.closure_candidates),
                            ("acc", tracker.accepted_closures)):
            if edges:
                arrays[f"cl__{name}__ij"] = np.asarray(
                    [(e.ref_kf, e.query_kf, int(e.accepted), int(e.suppressed))
                     for e in edges], np.int64)
                arrays[f"cl__{name}__T"] = np.stack([e.T_qr for e in edges])
                # matched landmark identities of the ICP inliers: restored
                # closures keep their identity-merge raw material
                (arrays[f"cl__{name}__pairs"],
                 arrays[f"cl__{name}__pairs_offs"]) = _cat(
                    [np.asarray(e.uid_pairs, np.int64).reshape(-1, 2)
                     for e in edges], np.int64)
        db = tracker.db
        arrays["db__desc"] = words_to_numpy(db.desc)
        for f in _DB_FIELDS[1:]:
            arrays[f"db__{f}"] = _host(getattr(db, f))
        if db.prob is not None:
            arrays["db__prob"] = _host(db.prob)
        if kind == "svi":
            meta["svi"] = {
                "equalize": tracker.equalize,
                "gravity_weight": tracker.gravity_weight,
                "calib_n_samples": tracker.calib.n_samples,
                "has_rectify_maps": tracker.rectify_maps is not None,
            }
            arrays["svi__velocity"] = _host(tracker.velocity)
            arrays["svi__T_cam_imu"] = np.asarray(tracker.T_cam_imu)
            if tracker.gravity_obs:
                arrays["svi__gravity_obs"] = np.stack(tracker.gravity_obs)
            for f in _CALIB_FIELDS:
                arrays[f"svi__calib__{f}"] = np.asarray(getattr(tracker.calib, f))
            if tracker.rectify_maps is not None:
                for k, m in enumerate(tracker.rectify_maps):
                    arrays[f"svi__rmap__{k}"] = _host(m)
    else:
        kfs = tracker.keyframes
        meta["kf_index"] = [k.index for k in kfs]
        meta["kf_frame_idx"] = [k.frame_idx for k in kfs]
        if kfs:
            arrays["kf__T_wc"] = np.stack([k.T_wc for k in kfs])
            arrays["kf__uids"], arrays["kf__offs"] = _cat(
                [k.landmark_uids for k in kfs], np.int64)
            arrays["kf__points_w"] = np.concatenate(
                [k.points_w for k in kfs], axis=0)
            arrays["kf__desc"] = np.concatenate(
                [words_u32(k.descriptors) for k in kfs], axis=0)

    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    convert.write_on_rank0(tracker.state, lambda: np.savez_compressed(path, **arrays))


def _table_dict(fresh: dict, arrays: dict) -> dict:
    """The table fields of the file over a freshly allocated table's: a
    field absent from an older checkpoint keeps its fresh value."""
    table = {name: arrays.get(f"table__{name}", a) for name, a in fresh.items()}
    if "table__desc_hist" not in arrays and "table__desc_left_ref" in arrays:
        # pre-ring checkpoint: the ring's slots hold genuine past
        # appearances, starting as copies of the creation descriptor
        # (mapping.landmarks). A zero-filled ring would let the all-zero
        # vector compete in the anchor argmin, so the creation descriptor
        # goes into every slot.
        ref = np.asarray(table["desc_left_ref"])
        table["desc_hist"] = np.broadcast_to(
            ref[:, None, :], fresh["desc_hist"].shape).copy()
        table["hist_next"] = np.zeros_like(fresh["hist_next"])
    return table


def load_checkpoint(path: str | Path, device=None):
    """Rebuild the tracker from a checkpoint file on ``device`` (``None``
    means CUDA) and return it, positioned exactly where ``save_checkpoint``
    left it: the same frame state, keyframe records, closure edges and
    database pools, bit for bit. A newer version raises
    :class:`InvalidFileError` (a ``ValueError``). A system saved with a
    native index or the closure worker comes back with them (building the
    native library raises ``RuntimeError`` if g++ cannot)."""
    from svi_mapper_tpu_torch.config import TrackingParams
    from svi_mapper_tpu_torch.geometry.camera import (
        StereoCamera,
        pinhole_from_projection,
    )
    from svi_mapper_tpu_torch.models.slam import ClosureEdge, SLAMKeyframe, SLAMSystem
    from svi_mapper_tpu_torch.models.tracker import KeyframeRecord, StereoTracker

    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    if meta["version"] > CHECKPOINT_VERSION:
        raise InvalidFileError(
            f"checkpoint {path} has unsupported version {meta['version']}")

    params = TrackingParams(**meta["params"])
    eyes = {}
    for eye in ("left", "right"):
        c = {f: arrays[f"cam__{eye}__{f}"] for f in _CAM_FIELDS}
        eyes[eye] = pinhole_from_projection(
            c["P"], meta["cam"][eye]["width"], meta["cam"][eye]["height"],
            K=c["K"], dist=c["dist"], R_rect=c["R_rect"],
            dtype=c["P"].dtype, device=dev)
    cam = StereoCamera(left=eyes["left"], right=eyes["right"])

    is_slam = meta["kind"] in ("slam", "svi")
    if is_slam:
        s = meta["slam"]
        slam_kwargs = dict(
            enable_loop_closure=s["enable_loop_closure"],
            enable_local_ba=s["enable_local_ba"],
            ba_window=s["ba_window"], ba_max_points=s["ba_max_points"],
            consensus_window=s["consensus_window"],
            max_keyframes=s["db_capacity"], pool_size=s["db_pool_size"],
            native_index=s.get("db_native_index", False),
            async_closure=s.get("async_closure", False),
            device=dev,
        )
        if meta["kind"] == "svi":
            from svi_mapper_tpu_torch.imu.interpolator import ImuCalibration
            from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

            sv = meta["svi"]
            calib = ImuCalibration(
                **{f: arrays[f"svi__calib__{f}"] for f in _CALIB_FIELDS},
                n_samples=sv["calib_n_samples"])
            rmaps = None
            if sv["has_rectify_maps"]:
                rmaps = tuple(arrays[f"svi__rmap__{k}"] for k in range(4))
            tracker = StereoInertialTracker(
                cam, calib, params, rectify_maps=rmaps,
                equalize=sv["equalize"], gravity_weight=sv["gravity_weight"],
                T_cam_imu=arrays.get("svi__T_cam_imu"), **slam_kwargs)
            tracker.velocity = torch.from_numpy(
                arrays["svi__velocity"].astype(np.float32)).to(dev)
            if "svi__gravity_obs" in arrays:
                tracker.gravity_obs = [np.array(g, np.float32)
                                       for g in arrays["svi__gravity_obs"]]
        else:
            tracker = SLAMSystem(cam, params, use_gt_pose=meta["use_gt_pose"],
                                 **slam_kwargs)
        tracker.stats = s["stats"]
    else:
        tracker = StereoTracker(cam, params, use_gt_pose=meta["use_gt_pose"],
                                landmark_opt_every=meta["landmark_opt_every"],
                                device=dev)
    tracker.frame_count = meta["frame_count"]

    # device state
    fresh = convert.table_to_numpy(tracker.state.table)
    tracker.state = convert.state_from_numpy(
        {**{f: arrays[f"state__{f}"] for f in _STATE_FIELDS},
         "table": _table_dict(fresh, arrays)}, dev)
    if "trajectory" in arrays:
        tracker.trajectory = list(arrays["trajectory"])
    if "world_offset" in arrays:
        tracker.world_offset = np.asarray(arrays["world_offset"], np.float64)
        tracker.world_shifts = int(arrays.get("world_shifts", 0))

    if is_slam:
        _load_slam_records(tracker, meta["slam"], arrays, dev,
                           SLAMKeyframe, ClosureEdge)
    elif meta["kf_index"]:
        uids = _split(arrays["kf__uids"], arrays["kf__offs"])
        pts = _split(arrays["kf__points_w"], arrays["kf__offs"])
        desc = _split(words_u32(arrays["kf__desc"]).view(np.int32), arrays["kf__offs"])
        tracker.keyframes = [
            KeyframeRecord(index=i, frame_idx=fi, T_wc=arrays["kf__T_wc"][k],
                           landmark_uids=uids[k], points_w=pts[k],
                           descriptors=desc[k])
            for k, (i, fi) in enumerate(zip(meta["kf_index"], meta["kf_frame_idx"]))
        ]
    return tracker


def _load_slam_records(tracker, s: dict, arrays: dict, dev, SLAMKeyframe,
                       ClosureEdge) -> None:
    """The SLAM system's host records, closure queue and database."""
    tracker._last_opt_kf = int(s.get("last_opt_kf", 0))
    tracker._uid_parent = {int(k): int(v) for k, v in s.get("uid_parent", {}).items()}
    tracker._excised_uids = set(s.get("excised_uids", []))
    if s["kf_index"]:
        uids = _split(arrays["kf__obs_uids"], arrays["kf__obs_offs"])
        uv4 = _split(arrays["kf__obs_uv4"], arrays["kf__obs_offs"])
        pools = _split(arrays["kf__pool_uids"], arrays["kf__pool_offs"])
        pos = (_split(arrays["kf__obs_pos"], arrays["kf__obs_offs"])
               if "kf__obs_pos" in arrays else None)
        tracker.slam_keyframes = [
            SLAMKeyframe(index=i, frame_idx=fi, T_wc=arrays["kf__T_wc"][k],
                         obs_uids=uids[k], obs_uv4=uv4[k], pool_uids=pools[k],
                         **({"obs_pos": pos[k]} if pos is not None else {}))
            for k, (i, fi) in enumerate(zip(s["kf_index"], s["kf_frame_idx"]))
        ]
    tracker._last_closure_opt_kf = int(s.get("last_closure_opt_kf", 0))
    tracker._closure_kfs_in_queue = int(s.get("closure_kfs_in_queue", 0))
    lo = s.get("closure_opt_lo")
    tracker._closure_opt_lo = None if lo is None else int(lo)
    tracker._kf_since_local_ba = int(s.get("kf_since_local_ba", 0))
    for name, dest in (("cand", "closure_candidates"), ("acc", "accepted_closures")):
        key = f"cl__{name}__ij"
        if key not in arrays:
            continue
        pairs = None
        if f"cl__{name}__pairs" in arrays:
            pairs = _split(arrays[f"cl__{name}__pairs"],
                           arrays[f"cl__{name}__pairs_offs"])
        setattr(tracker, dest, [
            ClosureEdge(
                ref_kf=int(row[0]), query_kf=int(row[1]),
                T_qr=arrays[f"cl__{name}__T"][k], accepted=bool(row[2]),
                # v1 checkpoints carry 3 columns and no pairs
                suppressed=bool(row[3]) if len(row) > 3 else False,
                uid_pairs=(np.asarray(pairs[k], np.int64).reshape(-1, 2)
                           if pairs is not None else np.zeros((0, 2), np.int64)))
            for k, row in enumerate(arrays[key])])
    db = tracker.db
    db.n = s["db_n"]
    db.desc = words_from_numpy(arrays["db__desc"], dev)
    for f in _DB_FIELDS[1:]:
        setattr(db, f, torch.from_numpy(np.ascontiguousarray(arrays[f"db__{f}"])).to(dev))
    # checkpoints from before probabilistic pools lack db__prob: matching
    # then degrades to exact Hamming
    db.prob = (torch.from_numpy(np.ascontiguousarray(arrays["db__prob"])).to(dev)
               if "db__prob" in arrays else None)
    db.capacity = int(arrays["db__desc"].shape[0])
    # the host mirrors, rebuilt from the stored pools (F12: the in-run
    # vocabulary is not stored; db.bow stays None and retrains at the next
    # add)
    db.count_host = [int(c) for c in arrays["db__count"][: db.n]]
    db.T_wc_host = np.asarray(arrays["db__T_wc"], np.float32).copy()
    db.bow = None
    if db.index is not None:
        # rebuild the native shortlist index from the stored pools
        desc, valid = arrays["db__desc"], arrays["db__valid"]
        for k in range(db.n):
            db.index.add(desc[k][valid[k]], k)
