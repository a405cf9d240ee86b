"""Host-side tracker classes: the GT / SV model families.

Equivalent of the reference's tracker classes (``CTrackerGT`` — ground-truth
pose playback; ``CTrackerSV`` — pure stereo visual odometry). The device
does all dense work in :func:`svi_mapper_tpu_torch.models.frame.process_frame`;
this thin host class feeds images and keeps the trajectory/keyframe records.

``state`` may be one that ``parallel.mesh.shard_state`` placed on a ``map``
mesh: the frame step then runs on each rank's rows, the host records are
built from the gathered table and are the same on every rank, and the
world shift moves each rank's own rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, TrackingParams
from svi_mapper_tpu_torch.eval.timing import span
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.models import frame as frame_mod
from svi_mapper_tpu_torch.utils.device import resolve_device
from svi_mapper_tpu_torch.utils.errors import TrackLostError


@dataclasses.dataclass
class KeyframeRecord:
    """Host-side keyframe snapshot (ref CKeyFrame: pose + landmark cloud)."""

    index: int
    frame_idx: int
    T_wc: np.ndarray            # [4,4]
    landmark_uids: np.ndarray   # [n]
    points_w: np.ndarray        # [n, 3] world positions at spawn time
    descriptors: np.ndarray     # [n, 8] int32 left reference descriptors


def _output_at(stacked: frame_mod.FrameOutput, i: int) -> frame_mod.FrameOutput:
    return frame_mod.FrameOutput(**{
        f.name: getattr(stacked, f.name)[i]
        for f in dataclasses.fields(stacked)})


class StereoTracker:
    """Stereo visual odometry tracker (the ``tracker_sv`` model; pass
    ``use_gt_pose=True`` for the ``tracker_gt`` behavior). ``device=None``
    means CUDA; the camera must live on the same device."""

    def __init__(
        self,
        cam: StereoCamera,
        params: TrackingParams = DEFAULT_PARAMS,
        use_gt_pose: bool = False,
        landmark_opt_every: int = 1,
        raise_on_track_lost: bool = False,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        if cam.device != self.device:
            raise ValueError(
                f"camera on {cam.device}, tracker asked for {self.device}")
        self.cam = cam
        self.params = params
        self.use_gt_pose = use_gt_pose
        self.landmark_opt_every = max(1, landmark_opt_every)
        self.raise_on_track_lost = raise_on_track_lost
        self.state = frame_mod.init_state(params, device=self.device)
        self.trajectory: list[np.ndarray] = []
        self.keyframes: list[KeyframeRecord] = []
        self.outputs: list[frame_mod.FrameOutput] = []
        self.track_lost_events: list[int] = []   # frame indices
        self.frame_count = 0
        self.timings: dict[str, float] = {"frame_total": 0.0}
        # robocentric world shift (ref m_vecTranslationToG2o,
        # CTrackerGT.h:84): when the camera strays beyond the threshold the
        # INTERNAL world origin rebases to the camera, keeping every f32
        # world coordinate small; the f64 offset maps back to the output
        # frame (p_out = p_int + world_offset)
        self.world_shift_threshold_m: float = 512.0
        self.world_offset = np.zeros(3, np.float64)
        self.world_shifts = 0

    def process(self, img_left, img_right, T_gt=None) -> frame_mod.FrameOutput:
        with span("svi.frame.step", into=(self.timings, "frame_total")):
            do_opt = (self.frame_count % self.landmark_opt_every) == 0
            if self.use_gt_pose and T_gt is None:
                raise ValueError("GT tracker needs a ground-truth pose")
            if T_gt is not None:
                T_gt = self._to_internal(np.asarray(T_gt, np.float64)).astype(np.float32)
            self.state, out = frame_mod.process_frame(
                self.state, img_left, img_right, self.cam, self.params, T_gt,
                use_gt_pose=self.use_gt_pose,
                do_landmark_opt=do_opt,
                device=self.device,
            )
            out = out.to_host()            # all per-frame outputs in one read
        self.frame_count += 1
        self.trajectory.append(out.T_wc)
        # lost-track detection: >75 % of the previously-visible landmark set
        # gone this frame (ref CTrackerSV.cpp:338-349)
        if self.outputs:
            prev_active = int(self.outputs[-1].n_active)
            if prev_active >= 20 and int(out.n_tracked) < 0.25 * prev_active:
                self.track_lost_events.append(self.frame_count - 1)
                if self.raise_on_track_lost:
                    raise TrackLostError(
                        f"frame {self.frame_count - 1}: tracked "
                        f"{int(out.n_tracked)} of {prev_active} landmarks")
        self.outputs.append(out)
        if bool(out.is_keyframe):
            self._spawn_keyframe(out)
        self._maybe_world_shift()
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _translate4(c) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = c
        return T

    def _to_internal(self, T_out: np.ndarray) -> np.ndarray:
        """External (output-frame) world->camera pose -> internal frame."""
        if not self.world_shifts:
            return T_out
        return T_out @ self._translate4(self.world_offset)

    def _to_output(self, T_int: np.ndarray) -> np.ndarray:
        if not self.world_shifts:
            return np.asarray(T_int, np.float64)
        return np.asarray(T_int, np.float64) @ self._translate4(-self.world_offset)

    def _local_state(self):
        """``(state, shards)``: the live state on plain tensors (this
        rank's rows of a sharded table) and its mesh collectives, None on
        one device."""
        shards = frame_mod.shards_of(self.state)
        return (self.state if shards is None else shards.local_state(self.state)), shards

    def _set_local_state(self, state, shards) -> None:
        """Store a state :meth:`_local_state` gave out, with its placements."""
        self.state = state if shards is None else shards.wrap_state(state)

    def _table_rows(self, *tensors) -> list:
        """Tensors of the live table's rows with every row: gathered over
        the mesh of a sharded state, as they are on one device."""
        shards = frame_mod.shards_of(self.state)
        if shards is None:
            return list(tensors)
        return shards.gather(*[shards.local(t) for t in tensors])

    def _maybe_world_shift(self) -> None:
        if self.world_shift_threshold_m is None:
            return
        # read the latest RECORDED pose (already on the host) for the
        # threshold check; the live state is read only when a shift fires
        live = self._local_state()[0]
        if self.trajectory:
            T = np.asarray(self.trajectory[-1], np.float64)
        else:
            T = live.T_wc.cpu().numpy().astype(np.float64)
        c = -T[:3, :3].T @ T[:3, 3]              # camera center (internal)
        if not np.isfinite(c).all():
            # catastrophic tracking loss: rebasing about a NaN/inf center
            # would contaminate the ENTIRE recorded trajectory — keep the
            # frame, skip the shift
            return
        if np.linalg.norm(c) <= self.world_shift_threshold_m:
            return
        T_live = live.T_wc.cpu().numpy().astype(np.float64)
        c_live = -T_live[:3, :3].T @ T_live[:3, 3]
        if np.isfinite(c_live).all():
            self._world_shift(c_live)

    def _world_shift(self, c: np.ndarray) -> None:
        """Rebase the internal world origin to ``c``: p_int' = p_int - c,
        T' = T @ Translate(c) for every world->camera transform."""
        Tc = self._translate4(c)
        Tc32 = torch.from_numpy(Tc.astype(np.float32)).to(self.device)
        ct = torch.from_numpy(np.asarray(c, np.float32)).to(self.device)
        st, shards = self._local_state()
        t = st.table
        self._set_local_state(st.replace(
            T_wc=st.T_wc @ Tc32,
            T_wc_prev=st.T_wc_prev @ Tc32,
            T_last_keyframe=st.T_last_keyframe @ Tc32,
            table=t.replace(
                pos_w=t.pos_w - ct[None, :],
                meas_T_wc=torch.einsum("lmij,jk->lmik", t.meas_T_wc, Tc32),
            ),
        ), shards)
        # host records move to the new internal frame in float64
        self.trajectory = [np.asarray(T, np.float64) @ Tc
                           for T in self.trajectory]
        for kf in self.keyframes:
            kf.T_wc = np.asarray(kf.T_wc, np.float64) @ Tc
            kf.points_w = kf.points_w - c[None, :]
        self.world_offset = self.world_offset + c
        self.world_shifts += 1

    def process_many(self, imgs_left, imgs_right, T_gt=None,
                     chunk: int = 16) -> list[frame_mod.FrameOutput]:
        """Throughput mode: process a staged frame batch in chunks
        (models.frame.process_chunk: no per-frame output read, one
        device->host copy per chunk, numerically identical stepping).
        Keyframe snapshots are taken at chunk boundaries, so in this mode a
        keyframe's landmark cloud reflects the table at the END of its
        chunk; use chunk=1 (or ``process``) when per-frame keyframe
        snapshotting matters."""
        L = frame_mod._to_image(imgs_left, self.device)
        R = frame_mod._to_image(imgs_right, self.device)
        n = L.shape[0]
        outs: list[frame_mod.FrameOutput] = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            with span("svi.frame.chunk", into=(self.timings, "frame_total")):
                T_sl = None if T_gt is None else (
                    np.asarray(T_gt[s:e], np.float64)
                    @ self._translate4(self.world_offset)).astype(np.float32)
                self.state, stacked = frame_mod.process_chunk(
                    self.state, L[s:e], R[s:e], self.cam, self.params, T_sl,
                    use_gt_pose=self.use_gt_pose,
                    landmark_opt_every=self.landmark_opt_every,
                    device=self.device,
                )
                stacked = stacked.to_host()   # one copy for the chunk's outputs
            for i in range(e - s):
                out = _output_at(stacked, i)
                self.frame_count += 1
                self.trajectory.append(out.T_wc)
                self.outputs.append(out)
                outs.append(out)
                if bool(out.is_keyframe):
                    self._spawn_keyframe(out)
            self._maybe_world_shift()
        return outs

    def _spawn_keyframe(self, out) -> None:
        """Snapshot visible optimal landmarks (ref keyframe = cloud of
        visible optimal landmarks, CTrackerGT.cpp:222-250)."""
        t = self.state.table
        active, optimal, uid, pos_w, desc = self._table_rows(
            t.active, t.is_optimal, t.uid, t.pos_w, t.desc_left_ref)
        sel = (active & optimal).cpu().numpy()
        self.keyframes.append(
            KeyframeRecord(
                index=len(self.keyframes),
                frame_idx=self.frame_count - 1,
                T_wc=np.asarray(out.T_wc),
                landmark_uids=uid.cpu().numpy()[sel],
                points_w=pos_w.cpu().numpy()[sel],
                descriptors=desc.cpu().numpy()[sel],
            )
        )

    # ------------------------------------------------------------------
    @property
    def trajectory_array(self) -> np.ndarray:
        """Per-frame world->camera poses in the OUTPUT frame (internal
        robocentric shifts folded back out)."""
        if not self.trajectory:
            return np.zeros((0, 4, 4))
        raw = np.stack([np.asarray(T, np.float64) for T in self.trajectory])
        if self.world_shifts:
            raw = raw @ self._translate4(-self.world_offset)
        return raw

    def fps(self) -> float:
        if self.frame_count <= 1 or self.timings["frame_total"] <= 0:
            return 0.0
        return self.frame_count / self.timings["frame_total"]
