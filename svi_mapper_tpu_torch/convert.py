"""State carried across: numpy dictionaries <-> the port's dataclasses.

The system has no weights; its state is the calibration, the parameters and
the ``FrameState``. These helpers take and give numpy only, so either
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
from svi_mapper_tpu_torch.models.frame import FrameState
from svi_mapper_tpu_torch.utils.device import resolve_device

_DESC_FIELDS = ("desc_left_ref", "desc_right_ref", "desc_left_last", "desc_hist")


def words_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """uint32 (or int32) packed words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"packed words must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of packed words -> uint32 numpy with the same bits."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


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
