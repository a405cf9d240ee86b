"""State carried across: numpy dictionaries <-> the port's dataclasses.

The system has no weights; its state is the calibration, the parameters,
the ``FrameState``, and for the map optimisation a BA window, a pose graph's
edges and a vocabulary. These helpers take and give numpy only, so either
package can be started from the other's state and compared field by field:
a caller builds the dictionaries from the JAX pytrees with ``np.asarray``.
Packed descriptors cross as bit patterns: ``uint32`` on the numpy side,
``int32`` with the same bits in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry.camera import (
    PinholeCamera,
    StereoCamera,
    pinhole_from_projection,
)
from svi_mapper_tpu_torch.mapping.landmarks import LandmarkTable
from svi_mapper_tpu_torch.mapping.vocabulary import Vocabulary
from svi_mapper_tpu_torch.models.frame import FrameState
from svi_mapper_tpu_torch.ops.descriptors import words_from_numpy, words_to_numpy
from svi_mapper_tpu_torch.solvers.pose_graph import PoseGraphEdges
from svi_mapper_tpu_torch.utils.device import resolve_device

_DESC_FIELDS = ("desc_left_ref", "desc_right_ref", "desc_left_last", "desc_hist")


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
    out = {}
    for f in dataclasses.fields(LandmarkTable):
        t = getattr(table, f.name)
        out[f.name] = (words_to_numpy(t) if f.name in _DESC_FIELDS
                       else t.detach().cpu().numpy())
    return out


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
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_POSES}
    out.update({k: np.int32(int(getattr(state, k))) for k in _STATE_SCALARS})
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
