"""Keyframe descriptor-cloud serialization.

Replaces the reference's binary ``.cloud`` files (written by
``CKeyFrame::saveCloudToFile`` CKeyFrame.cpp:138-185, re-loaded by the file
constructor :102-119, datum helpers CLogger.h:36-46): a keyframe's pose +
landmark snapshot {uid, world/camera positions, stereo UVs, descriptors}
persisted so the loop-closure subsystem can be exercised offline (the
``test_cloud_matching`` workflow, test_cloud_matching.cpp:17-180).

Format: NumPy ``.npz``, the schema of ``CDescriptorVectorPoint3DWORLD``
(TypesCloud.h:20-46), version 1 — the JAX package's format, so a file
written by either package loads in the other. Descriptors cross the file as
``uint32`` (the port holds them as int32 with the same bits). A path
ending in ``.svic`` goes through the native binary codec
(:func:`svi_mapper_tpu_torch.native.write_cloud_native` /
:func:`~svi_mapper_tpu_torch.native.read_cloud_native`, the JAX package's
byte layout), which builds the port's C++ library at first use.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from svi_mapper_tpu_torch.ops.descriptors import words_to_numpy, words_u32
from svi_mapper_tpu_torch.utils.errors import InvalidFileError

FORMAT_VERSION = 1


@dataclasses.dataclass
class KeyframeCloud:
    """Serializable keyframe snapshot (ref CDescriptorVectorPoint3DWORLD)."""

    keyframe_id: int
    frame_idx: int
    T_wc: np.ndarray          # [4,4]
    uids: np.ndarray          # [n] int64
    points_w: np.ndarray      # [n,3] world positions
    points_cam: np.ndarray    # [n,3] camera-frame positions
    uv_left: np.ndarray       # [n,2]
    uv_right: np.ndarray      # [n,2]
    descriptors: np.ndarray   # [n,8] uint32 packed BRIEF


def _native_path(path) -> bool:
    return str(path).endswith(".svic")


def save_cloud(path: str | Path, cloud: KeyframeCloud) -> None:
    """Write a cloud file: ``.svic`` through the native binary codec,
    anything else as ``.npz``."""
    if _native_path(path):
        from svi_mapper_tpu_torch import native

        native.write_cloud_native(path, cloud)
        return
    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        keyframe_id=cloud.keyframe_id,
        frame_idx=cloud.frame_idx,
        T_wc=np.asarray(cloud.T_wc).astype(np.float32),
        uids=np.asarray(cloud.uids).astype(np.int64),
        points_w=np.asarray(cloud.points_w).astype(np.float32),
        points_cam=np.asarray(cloud.points_cam).astype(np.float32),
        uv_left=np.asarray(cloud.uv_left).astype(np.float32),
        uv_right=np.asarray(cloud.uv_right).astype(np.float32),
        descriptors=words_u32(cloud.descriptors),
    )


def load_cloud(path: str | Path) -> KeyframeCloud:
    """Read a cloud file (``.svic``: the native codec, which raises
    ``IOError`` on a bad file); a newer ``.npz`` format version raises
    :class:`InvalidFileError`."""
    if _native_path(path):
        from svi_mapper_tpu_torch import native

        return native.read_cloud_native(path)
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise InvalidFileError(
                f"cloud file {path} has unsupported version {version}")
        return KeyframeCloud(
            keyframe_id=int(z["keyframe_id"]),
            frame_idx=int(z["frame_idx"]),
            T_wc=z["T_wc"],
            uids=z["uids"],
            points_w=z["points_w"],
            points_cam=z["points_cam"],
            uv_left=z["uv_left"],
            uv_right=z["uv_right"],
            descriptors=z["descriptors"],
        )


def cloud_from_slam_state(state, keyframe_id: int, frame_idx: int) -> KeyframeCloud:
    """Snapshot the visible optimal landmarks of a live ``FrameState``
    (the cloud the reference writes per keyframe, CTrackerGT.cpp:222-250).
    Reads the state to the host."""
    t = state.table
    sel = (t.active & t.is_optimal).cpu().numpy()
    T_wc = state.T_wc.cpu().numpy()
    pos_w = t.pos_w.cpu().numpy()[sel]
    p_cam = pos_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    uv_l = t.uv_left_last.cpu().numpy()[sel]
    disp = t.disparity_last.cpu().numpy()[sel]
    uv_r = np.stack([uv_l[:, 0] - disp, uv_l[:, 1]], axis=-1)
    return KeyframeCloud(
        keyframe_id=keyframe_id,
        frame_idx=frame_idx,
        T_wc=T_wc,
        uids=t.uid.cpu().numpy()[sel].astype(np.int64),
        points_w=pos_w,
        points_cam=p_cam,
        uv_left=uv_l,
        uv_right=uv_r,
        descriptors=words_to_numpy(t.desc_left_ref)[sel],
    )
