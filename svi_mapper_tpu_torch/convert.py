"""State carried across: numpy dictionaries <-> the port's dataclasses.

The system has no weights; its state is the calibration, the parameters,
the ``FrameState``, and for the map optimisation a BA window, a pose graph's
edges and a vocabulary. These helpers take and give numpy only, so either
package can be started from the other's state and compared field by field:
a caller builds the dictionaries from the JAX pytrees with ``np.asarray``.
Packed descriptors cross as bit patterns: ``uint32`` on the numpy side,
``int32`` with the same bits in the port.

A state that ``parallel.mesh.shard_state`` placed on a ``map`` mesh is
read with every row (:func:`host_arrays`): a collective, so every rank must
make the same calls.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry.camera import (
    PinholeCamera,
    StereoCamera,
    pinhole_from_projection,
)
from svi_mapper_tpu_torch.imu.interpolator import ImuCalibration
from svi_mapper_tpu_torch.mapping.landmarks import LandmarkTable
from svi_mapper_tpu_torch.mapping.vocabulary import Vocabulary
from svi_mapper_tpu_torch.models.frame import FrameState, shards_of
from svi_mapper_tpu_torch.ops.descriptors import words_from_numpy, words_to_numpy, words_u32
from svi_mapper_tpu_torch.solvers.pose_graph import PoseGraphEdges
from svi_mapper_tpu_torch.utils.device import resolve_device

_DESC_FIELDS = ("desc_left_ref", "desc_right_ref", "desc_left_last", "desc_hist")


def host_arrays(*tensors) -> list[np.ndarray]:
    """Numpy copies of tensors with every element: the fields of a sharded
    table gathered over their mesh (``parallel.mesh.host_arrays``), a plain
    tensor (or an array) as it is. On a sharded state every rank must make
    the call."""
    if "torch.distributed.tensor" in sys.modules:   # a DTensor may exist
        from svi_mapper_tpu_torch.parallel.mesh import host_arrays as gathered

        return gathered(*tensors)
    return [t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in tensors]


def write_on_rank0(state: FrameState, write) -> None:
    """Call ``write()``, the file write of a host read of ``state``: on one
    device at once; on a sharded state on rank 0 alone, every rank calling
    this and all returning together (``LandmarkShards.write_on_rank0``)."""
    shards = shards_of(state)
    if shards is None:
        write()
    else:
        shards.write_on_rank0(write)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy()).to(device)


def _pinhole_to_numpy(c: PinholeCamera) -> dict:
    return {"P": c.P.cpu().numpy(), "K": c.K.cpu().numpy(),
            "dist": c.dist.cpu().numpy(), "R_rect": c.R_rect.cpu().numpy(),
            "width": c.width, "height": c.height}


def camera_from_numpy(d: dict, device=None) -> StereoCamera:
    """``{"left": {P, K, dist, R_rect, width, height}, "right": {...}}``."""
    dev = resolve_device(device)

    def one(c):
        return pinhole_from_projection(
            c["P"], c["width"], c["height"], K=c.get("K"), dist=c.get("dist"),
            R_rect=c.get("R_rect"), device=dev)

    return StereoCamera(left=one(d["left"]), right=one(d["right"]))


def camera_to_numpy(cam: StereoCamera) -> dict:
    return {"left": _pinhole_to_numpy(cam.left),
            "right": _pinhole_to_numpy(cam.right)}


def table_from_numpy(d: dict, device=None) -> LandmarkTable:
    """A dictionary with one numpy array per ``LandmarkTable`` field."""
    dev = resolve_device(device)
    vals = {}
    for f in dataclasses.fields(LandmarkTable):
        a = np.asarray(d[f.name])
        vals[f.name] = (words_from_numpy(a, dev) if f.name in _DESC_FIELDS
                        else _tensor(a, dev))
    return LandmarkTable(**vals)


def table_to_numpy(table: LandmarkTable) -> dict:
    """Every field with every row (one gather for a sharded table: every
    rank must call it)."""
    names = [f.name for f in dataclasses.fields(LandmarkTable)]
    arrays = host_arrays(*[getattr(table, n) for n in names])
    return {n: words_u32(a) if n in _DESC_FIELDS else a for n, a in zip(names, arrays)}


_STATE_SCALARS = ("next_uid", "frame_idx", "instability")
_STATE_POSES = ("T_wc", "T_wc_prev", "T_last_keyframe")


def state_from_numpy(d: dict, device=None) -> FrameState:
    """``{T_wc, T_wc_prev, T_last_keyframe, table: {...}, next_uid,
    frame_idx, instability}``."""
    dev = resolve_device(device)
    vals = {k: _tensor(np.asarray(d[k], np.float32), dev) for k in _STATE_POSES}
    vals.update({k: torch.tensor(int(d[k]), dtype=torch.int32, device=dev)
                 for k in _STATE_SCALARS})
    return FrameState(table=table_from_numpy(d["table"], dev), **vals)


def state_to_numpy(state: FrameState) -> dict:
    """The state with every row of its table (a sharded state's read is a
    collective: every rank must call it)."""
    names = _STATE_POSES + _STATE_SCALARS
    arrays = host_arrays(*[getattr(state, k) for k in names])
    out = dict(zip(_STATE_POSES, arrays))
    out.update({k: np.int32(a) for k, a in zip(_STATE_SCALARS, arrays[len(_STATE_POSES):])})
    out["table"] = table_to_numpy(state.table)
    return out


def ba_problem_from_numpy(d: dict, device=None) -> dict:
    """A BA window ``{T_wc [K,4,4], points_w [L,3], obs_uv [K,L,4], obs_mask
    [K,L], fix_mask [K]}`` and, where present, ``obs_w``, ``odo_M``, ``odo_w``,
    ``grav_d``, ``grav_w`` -> tensors on the device under the same names:
    floats as float32, the two masks as bool. The positional arguments of
    ``bundle_adjust`` are the first five in this order, the rest are its
    keywords."""
    dev = resolve_device(device)
    out = {}
    for name, a in d.items():
        a = np.asarray(a)
        dt = bool if name in ("obs_mask", "fix_mask") else np.float32
        out[name] = _tensor(a.astype(dt), dev)
    return out


def pose_graph_edges_from_numpy(d: dict, device=None) -> PoseGraphEdges:
    """``{i, j, T_ij, weight, valid[, info6]}`` -> ``PoseGraphEdges``."""
    dev = resolve_device(device)
    info6 = d.get("info6")
    return PoseGraphEdges(
        i=_tensor(np.asarray(d["i"], np.int32), dev),
        j=_tensor(np.asarray(d["j"], np.int32), dev),
        T_ij=_tensor(np.asarray(d["T_ij"], np.float32), dev),
        weight=_tensor(np.asarray(d["weight"], np.float32), dev),
        valid=_tensor(np.asarray(d["valid"], bool), dev),
        info6=None if info6 is None else _tensor(np.asarray(info6, np.float32), dev),
    )


def vocabulary_from_numpy(d: dict, device=None) -> Vocabulary:
    """``{k, levels, centroids: [uint32 [k**l,k,8]], child_valid: [bool
    [k**l,k]], weights}`` -> ``Vocabulary`` (centroid levels as int32 bit
    views)."""
    dev = resolve_device(device)
    return Vocabulary(
        k=int(d["k"]), levels=int(d["levels"]),
        centroids=tuple(words_from_numpy(np.asarray(c), dev) for c in d["centroids"]),
        child_valid=tuple(_tensor(np.asarray(v, bool), dev) for v in d["child_valid"]),
        weights=_tensor(np.asarray(d["weights"], np.float32), dev),
    )


def vocabulary_to_numpy(vocab: Vocabulary) -> dict:
    return {
        "k": vocab.k, "levels": vocab.levels,
        "centroids": [words_to_numpy(c) for c in vocab.centroids],
        "child_valid": [v.detach().cpu().numpy() for v in vocab.child_valid],
        "weights": vocab.weights.detach().cpu().numpy(),
    }


# ---------------------------------------------------------------------------
# the closure database and the SLAM keyframe records
# ---------------------------------------------------------------------------

def keyframe_db_from_numpy(d: dict, device=None):
    """``{capacity, pool_size, n, desc (uint32 or int32), p_cam, valid, count,
    T_wc, prob | None, count_host, auto_vocab, vocab_train_at, bow: None |
    {vocab: {...}, vectors, n}}`` -> ``KeyframeDatabase``: a database filled
    by either package answers the same query in the port. Descriptors cross
    as bit patterns; the vocabulary goes through
    :func:`vocabulary_from_numpy`."""
    from svi_mapper_tpu_torch.mapping.closure import KeyframeDatabase
    from svi_mapper_tpu_torch.mapping.vocabulary import BowDatabase

    dev = resolve_device(device)
    bow = None
    if d.get("bow") is not None:
        b = d["bow"]
        bow = BowDatabase(vocabulary_from_numpy(b["vocab"], dev), capacity=1)
        bow.vectors = _tensor(np.asarray(b["vectors"], np.float32), dev)
        bow.n = int(b["n"])
    T_wc = np.asarray(d["T_wc"], np.float32)
    prob = d.get("prob")
    return KeyframeDatabase(
        capacity=int(d["capacity"]), pool_size=int(d["pool_size"]),
        desc=words_from_numpy(np.asarray(d["desc"]), dev),
        p_cam=_tensor(np.asarray(d["p_cam"], np.float32), dev),
        valid=_tensor(np.asarray(d["valid"], bool), dev),
        count=_tensor(np.asarray(d["count"], np.int32), dev),
        T_wc=_tensor(T_wc, dev), n=int(d["n"]),
        prob=None if prob is None else _tensor(np.asarray(prob, np.uint8), dev),
        bow=bow, auto_vocab=bool(d.get("auto_vocab", True)),
        vocab_train_at=int(d.get("vocab_train_at", 8)),
        count_host=[int(c) for c in d.get("count_host", [])],
        T_wc_host=T_wc.copy(),
    )


def keyframe_db_to_numpy(db) -> dict:
    bow = None
    if db.bow is not None:
        bow = {"vocab": vocabulary_to_numpy(db.bow.vocab),
               "vectors": db.bow.vectors.detach().cpu().numpy(), "n": db.bow.n}
    return {
        "capacity": db.capacity, "pool_size": db.pool_size, "n": db.n,
        "desc": words_to_numpy(db.desc), "p_cam": db.p_cam.cpu().numpy(),
        "valid": db.valid.cpu().numpy(), "count": db.count.cpu().numpy(),
        "T_wc": db.T_wc.cpu().numpy(),
        "prob": None if db.prob is None else db.prob.cpu().numpy(),
        "count_host": list(db.count_host), "auto_vocab": db.auto_vocab,
        "vocab_train_at": db.vocab_train_at, "bow": bow,
    }


_KEYFRAME_FIELDS = ("index", "frame_idx", "T_wc", "obs_uids", "obs_uv4",
                    "pool_uids", "obs_pos")


def slam_keyframes_from_numpy(records: list) -> list:
    """A list of ``{index, frame_idx, T_wc, obs_uids, obs_uv4, pool_uids,
    obs_pos}`` dictionaries -> ``SLAMKeyframe`` records (host numpy on both
    sides; arrays are copied)."""
    from svi_mapper_tpu_torch.models.slam import SLAMKeyframe

    return [SLAMKeyframe(**{
        f: (int(r[f]) if f in ("index", "frame_idx") else np.array(r[f]))
        for f in _KEYFRAME_FIELDS if f in r}) for r in records]


def slam_keyframes_to_numpy(keyframes: list) -> list:
    return [{f: (getattr(kf, f) if f in ("index", "frame_idx")
                 else np.array(getattr(kf, f))) for f in _KEYFRAME_FIELDS}
            for kf in keyframes]


# ---------------------------------------------------------------------------
# the stereo-inertial tracker
# ---------------------------------------------------------------------------

_IMU_FIELDS = ("R_imu_to_world", "bias_gyro", "bias_accel", "noise_gyro",
               "noise_accel")


def imu_calibration_from_numpy(d) -> ImuCalibration:
    """A dictionary (or any object with the attributes) holding
    ``R_imu_to_world, bias_gyro, bias_accel, noise_gyro, noise_accel,
    n_samples`` -> the port's ``ImuCalibration`` (numpy fields, copied)."""
    get = d.get if isinstance(d, dict) else (lambda k: getattr(d, k))
    return ImuCalibration(
        **{k: np.array(get(k)) for k in _IMU_FIELDS},
        n_samples=int(get("n_samples")))


def svi_state_to_numpy(tracker) -> dict:
    """What a stereo-inertial tracker carries from frame to frame beyond the
    ``SLAMSystem`` records: ``{state, velocity [3], gravity_obs [n,3],
    T_cam_imu [4,4]}``."""
    return {"state": state_to_numpy(tracker.state),
            "velocity": tracker.velocity.detach().cpu().numpy(),
            "gravity_obs": np.array(tracker.gravity_obs, np.float32).reshape(-1, 3),
            "T_cam_imu": np.array(tracker.T_cam_imu, np.float32)}


def svi_state_from_numpy(tracker, d: dict) -> None:
    """Load ``{state, velocity, gravity_obs[, T_cam_imu]}`` (numpy, e.g.
    read from a JAX ``StereoInertialTracker``) into a port tracker on its
    device: the frame state, the carried velocity, the per-keyframe gravity
    observations and the rig extrinsics."""
    dev = tracker.device
    tracker.state = state_from_numpy(d["state"], dev)
    tracker.velocity = _tensor(np.asarray(d["velocity"], np.float32), dev)
    tracker.gravity_obs = [np.array(g, np.float32)
                           for g in np.asarray(d["gravity_obs"]).reshape(-1, 3)]
    if d.get("T_cam_imu") is not None:
        tracker.T_cam_imu = np.array(d["T_cam_imu"], np.float32)
        tracker._R_ci = _tensor(tracker.T_cam_imu[:3, :3], dev)
