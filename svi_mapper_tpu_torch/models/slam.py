"""Full SLAM system: tracking front-end + loop closure + back-end optimization.

The equivalent of the complete ``CTrackerSV`` pipeline
(CTrackerSV.cpp:239-456): per-frame visual odometry (models.frame), keyframe
spawning, loop-closure search over the keyframe database with consensus
checking, trajectory-only pose-graph relaxation, and windowed
Schur-complement bundle adjustment with back-propagation of the corrections
into the live tracking state (the reference's
``_backPropagateTrajectoryToFull`` / ``_applyOptimizationToLandmarks``
family, Cg2oOptimizer.cpp:1468-1636).

Host/device split: the device runs every dense computation (frame step,
pool scoring, ICP, pose graph, BA); the host keeps the keyframe list,
decides when to run the back-end, runs the [C <= 16] closure consensus in
numpy, and shuffles small pose/uid arrays.

By default the keyframe tail runs inline at the keyframe (per-frame mode)
or at the chunk boundary (``process_many``). Two options move part of it
onto one worker thread, as in the JAX package:

* ``async_closure=True``: the closure search (pool scoring, matching, ICP)
  runs on a worker over a snapshot of the closure database
  (``KeyframeDatabase.snapshot``); its results are folded in at later
  keyframes and by ``flush_closures``;
* ``overlap_backend``: the whole keyframe tail (DB add, closure search,
  consensus, pose graph, BA) runs on a worker over queued keyframe
  snapshots. The worker never touches the live tracking state: it emits
  ordered "fold" operations (rigid gauge corrections, landmark positions by
  uid, identity-merge tables) that the tracker thread applies at chunk
  boundaries (``_apply_folds``), and its BA windows start from the landmark
  positions the keyframe snapshots carried. With one visible device of the
  system's type, ``True`` warns and runs synchronously; ``"force"`` keeps
  the worker.

Both threads submit to the device's default stream, so their device work
runs in the order it was submitted; what the threads race for is the host.
A worker's exception re-raises in the tracker thread, from
``flush_closures`` / ``flush_backend`` / ``finalize_backend`` or the next
fold. When a worker result lands depends on the threads' timing, so the
two options are held to the synchronous run's closures and accuracy, not to
its bits.

The ``timings`` of the keyframe tail are host clocks. ``kf_closure``,
``kf_ba`` and ``kf_pose_graph`` end in a read of their results and so
include the device's work; ``kf_db_add`` ends in no read and is the time to
enqueue the writes.
"""

from __future__ import annotations

import dataclasses
import queue
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS, TrackingParams
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.mapping import closure as closure_mod
from svi_mapper_tpu_torch.mapping import landmarks as lm_mod
from svi_mapper_tpu_torch.models import frame as frame_mod
from svi_mapper_tpu_torch.models.tracker import StereoTracker, _output_at
from svi_mapper_tpu_torch.solvers import ba as ba_mod
from svi_mapper_tpu_torch.solvers import ba_prep
from svi_mapper_tpu_torch.solvers import pose_graph as pg_mod
from svi_mapper_tpu_torch.utils.device import fetch_numpy

_SNAPSHOT_HOST_FIELDS = ("uid", "active", "optimal", "tracked", "uv_left",
                         "disparity", "pos_w", "desc")


@dataclasses.dataclass
class SLAMKeyframe:
    """Host keyframe record: pose + BA observations + closure pool."""

    index: int
    frame_idx: int
    T_wc: np.ndarray            # [4,4] current best estimate (updated by BA/PG)
    obs_uids: np.ndarray        # [n] tracked landmark uids at this frame
    obs_uv4: np.ndarray         # [n,4] their stereo measurements
    pool_uids: np.ndarray       # [m] optimal landmarks in the closure pool
    obs_pos: np.ndarray = dataclasses.field(     # [n,3] world positions of
        default_factory=lambda: np.zeros((0, 3), np.float32))
    # the observed landmarks at spawn time


@dataclasses.dataclass
class ClosureEdge:
    ref_kf: int
    query_kf: int
    T_qr: np.ndarray
    accepted: bool = False
    # near-duplicate of an already-accepted edge (same revisit event seen a
    # few keyframes later): kept out of the consensus window and the graph
    suppressed: bool = False
    # matched landmark identities (uid_query, uid_ref) of the ICP inliers —
    # the landmark-identity closure constraints (ref EdgePointXYZ with zero
    # measurement + fixed reference, Cg2oOptimizer.cpp:444-459)
    uid_pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))


def closure_kwargs(p: TrackingParams) -> dict:
    """The closure search's arguments (``find_closures`` /
    ``find_closures_batch``) as the tracking parameters set them."""
    return dict(
        min_matches=p.closure_min_matches,
        min_relative=p.closure_min_relative_matches,
        hamming_cutoff=p.closure_hamming_cutoff,
        exclude_recent=p.closure_exclude_recent,
        probabilistic=p.closure_probabilistic,
        prob_cutoff=p.closure_prob_cutoff,
        search_radius_m2=p.closure_search_radius_m2,
        direct_index_levels=p.closure_direct_index_levels,
        icp_kwargs=dict(
            inlier_m2=p.closure_icp_inlier_m,
            min_inliers=p.closure_icp_min_inliers,
            max_avg_error=p.closure_icp_max_error,
        ),
    )


def _devices_of_type(device: torch.device) -> int:
    """Visible devices of ``device``'s type: CUDA cards, or 1 for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _poses_rmul(T, Tp, Tk, A):
    return T @ A, Tp @ A, Tk @ A


def _ba_writeback(table, slots_good, pos, slots_dead):
    """BA result write-back: positions + ring clears for optimized
    landmarks, deactivation for excised ones. ``slots_*`` are int64 tensors
    of valid table rows only (the caller drops skipped rows on the host: an
    out-of-range index is a device-side fault on a CUDA tensor). Returns a
    new table; the old tensors are left as they were."""
    pos_w = table.pos_w.clone()
    meas_count = table.meas_count.clone()
    meas_next = table.meas_next.clone()
    active = table.active.clone()
    pos_w[slots_good] = pos
    meas_count[slots_good] = 0
    meas_next[slots_good] = 0
    active[slots_dead] = False
    return table.replace(pos_w=pos_w, meas_count=meas_count,
                         meas_next=meas_next, active=active)


class SLAMSystem(StereoTracker):
    """Stereo SLAM with loop closure and windowed BA. ``device=None`` means
    CUDA; the camera must live on the same device."""

    def __init__(
        self,
        cam: StereoCamera,
        params: TrackingParams = DEFAULT_PARAMS,
        use_gt_pose: bool = False,
        enable_loop_closure: bool = True,
        enable_local_ba: bool = True,
        ba_window: int = 8,
        ba_max_points: int = 1024,
        local_ba_every: int = 4,    # keyframes between windowed-BA runs;
                                    # per-keyframe BA clears measurement
                                    # rings too aggressively. The reference's
                                    # full optimization cadence is 20 KFs
                                    # (CTrackerGT.h:70) — this keeps a
                                    # denser refinement on top of the
                                    # incremental full-graph stage.
        consensus_window: int = 8,
        max_keyframes: int = 512,
        pool_size: int = 256,
        native_index: bool = False,
        auto_vocab: bool = True,            # train the BoW shortlist in-run
        async_closure: bool = False,
        overlap_backend: bool | str = False,
        graph_snapshot_dir: str | None = None,
        device: torch.device | str | None = None,
    ):
        self._closure_pool = None
        self._bk_pool = None
        if async_closure and overlap_backend:
            raise ValueError(
                "async_closure is subsumed by overlap_backend (the whole "
                "keyframe tail, closure search included, runs on the "
                "back-end worker) — enable only one")
        super().__init__(cam, params, use_gt_pose=use_gt_pose, device=device)
        self.enable_loop_closure = enable_loop_closure
        self.enable_local_ba = enable_local_ba
        self.ba_window = ba_window
        self.ba_max_points = ba_max_points
        self.local_ba_every = max(1, local_ba_every)
        self._kf_since_local_ba = 0
        self.consensus_window = consensus_window
        self.db = closure_mod.KeyframeDatabase.create(
            max_keyframes, pool_size, native_index=native_index,
            auto_vocab=auto_vocab, device=self.device,
        )
        self.slam_keyframes: list[SLAMKeyframe] = []
        self.closure_candidates: list[ClosureEdge] = []
        self.accepted_closures: list[ClosureEdge] = []
        self.stats = {"closures_found": 0, "closures_accepted": 0, "ba_runs": 0,
                      "pose_graph_runs": 0}
        # landmark-identity merge state: union-find over uids (accepted
        # closures identify re-observed landmarks; the canonical uid is the
        # OLDEST — ref fixes the reference-side vertex, Cg2o:444-459) and
        # a tombstone set of excised (insane) landmarks (ref erasure of bad
        # vertices post-BA, Cg2oOptimizer.cpp:1486-1504)
        self._uid_parent: dict[int, int] = {}
        self._excised_uids: set[int] = set()
        # incremental full-graph BA bookkeeping: the next run optimizes
        # keyframes [_last_opt_kf - 1 ..) (ref m_uIDOptimizedKeyFrameLAST,
        # Cg2oOptimizer.cpp:232-522)
        self._last_opt_kf = 0
        self.incremental_ba_max_window = 64
        # host mirror of (table.uid, table.pos_w) for BA window assembly;
        # None = read fresh from the device (invalidated by the frame loop,
        # rigid corrections, world shifts, identity merges and BA
        # write-backs)
        self._table_mirror: tuple | None = None
        # loop-closure waiting queue (ref CTrackerSV.cpp:418-451,
        # m_uLoopClosingKeyFramesInQueue / m_uLoopClosingKeyFrameWaitingQueue):
        # accepted closures BUFFER; ONE pose-graph + ONE incremental BA run
        # when either the keyframe-delta trigger or the queue trigger fires —
        # never one optimization per acceptance
        self._closure_kfs_in_queue = 0    # keyframes with closures waiting
        self._closure_opt_lo: int | None = None  # oldest queued ref keyframe
        self._last_closure_opt_kf = 0     # ref m_uIDLoopClosureOptimizedLAST
        self.closure_queue_wait = 1       # ref CTrackerSV.h:86 (trigger at >1)
        # per-optimization g2o snapshots (ref keyframes_*-*.g2o,
        # Cg2oOptimizer.cpp:493-514)
        self.graph_snapshot_dir = graph_snapshot_dir
        # chunk-mode gauge-correction accumulators: pose graph / BA runs
        # change the world gauge; corrections are accumulated so that raw
        # snapshots taken before them can be brought along
        # (p_new = _corr_P p_raw; T_new = T_raw @ _corr_M)
        self._corr_P = np.eye(4, dtype=np.float64)
        self._corr_M = np.eye(4, dtype=np.float64)
        # async loop closure: the search runs on a worker thread over a
        # database snapshot, and results fold in at the next keyframe
        # (the reference searches inline, CTrackerGT.cpp:257)
        self._pending_closures: list = []
        if async_closure:
            self._closure_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="loop-closure")
        # overlapped back-end: the whole keyframe tail on ONE worker thread
        # over queued keyframe snapshots. Every queued event carries the
        # number of corrections the tracker had folded when its snapshot
        # was taken; the worker brings late events into its own gauge with
        # the cumulative correction products.
        if overlap_backend and overlap_backend != "force" \
                and _devices_of_type(self.device) == 1:
            # one device: both threads' device work serialises on it, so
            # the worker adds queue and gauge work and nothing overlaps
            warnings.warn(
                "overlap_backend requested with a single visible device — "
                "falling back to the synchronous back-end (pass "
                "overlap_backend='force' to keep the worker thread)",
                stacklevel=2)
            overlap_backend = False
        if overlap_backend:
            self._bk_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="backend")
            self._bk_folds: queue.Queue = queue.Queue()
            self._bk_futures: list = []
            self._fold_version = 0               # corrections folded (main)
            self._bk_Pc = [np.eye(4)]            # cumulative map corrections
            self._bk_Mc = [np.eye(4)]            # cumulative pose corrections
            self._last_kf_frame_idx = 0          # trajectory-segment anchor

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------
    def process(self, img_left, img_right, T_gt=None):
        out = super().process(img_left, img_right, T_gt=T_gt)
        if bool(out.is_keyframe):
            self._on_keyframe(out)
        return out

    def process_many(self, imgs_left, imgs_right, T_gt=None,
                     chunk: int = 16) -> list:
        """Throughput mode WITH the back-end: the chunked frame loop emits
        per-frame table snapshots, and every keyframe in the chunk is folded
        through the full keyframe path (DB add -> closure search -> pose
        graph -> windowed BA) at the chunk boundary — the offline analog of
        the reference's inline back-end (CTrackerSV.cpp:440)."""
        L = frame_mod._to_image(imgs_left, self.device)
        R = frame_mod._to_image(imgs_right, self.device)
        n = L.shape[0]
        outs: list = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            t0 = time.perf_counter()
            T_sl = None if T_gt is None else (
                np.asarray(T_gt[s:e], np.float64)
                @ self._translate4(self.world_offset)).astype(np.float32)
            self.state, stacked, snaps = frame_mod.process_chunk(
                self.state, L[s:e], R[s:e], self.cam, self.params, T_sl,
                use_gt_pose=self.use_gt_pose,
                landmark_opt_every=self.landmark_opt_every,
                emit_snapshots=True, device=self.device,
            )
            stacked = stacked.to_host()   # one copy for the chunk's outputs
            self.timings["frame_total"] += time.perf_counter() - t0
            outs.extend(self._finish_chunk(stacked, snaps, e - s))
            # fold completed back-end results into the live state at the
            # chunk boundary (no-op without the overlapped back-end)
            self._apply_folds()
            self._maybe_world_shift()
        return outs

    def _finish_chunk(self, stacked, snaps, n_frames: int) -> list:
        """Per-frame bookkeeping + keyframe dispatch for one completed
        chunk."""
        self._table_mirror = None    # the frames moved landmark positions
        outs: list = []
        kf_mask = np.asarray(stacked.is_keyframe, bool)
        T_all = stacked.T_wc
        base = self.frame_count
        for i in range(n_frames):
            out = _output_at(stacked, i)
            self.frame_count += 1
            self.trajectory.append(T_all[i])
            self.outputs.append(out)
            outs.append(out)
            if kf_mask[i]:
                self._spawn_keyframe(out)
        if kf_mask.any():
            # gather ONLY the keyframe rows on the device before the
            # transfer: the snapshot stack is [chunk, L, ...] and keyframes
            # are sparse
            kf_rows = np.nonzero(kf_mask)[0]
            sel = torch.from_numpy(kf_rows).to(self.device)
            # everything EXCEPT the bit-probability plane crosses, in one
            # copy: at [L, 256] u8 the plane is most of the snapshot and its
            # only consumer, the closure DB, gathers from it on the device
            sn = dict(zip(_SNAPSHOT_HOST_FIELDS, fetch_numpy(
                [getattr(snaps, f)[sel] for f in _SNAPSHOT_HOST_FIELDS])))
            bitp_dev = snaps.bit_prob[sel]
            if self._bk_pool is not None:
                # overlapped back-end: queue raw snapshots (tagged with the
                # current fold version) for the worker, which brings them
                # into its own gauge
                for j, i in enumerate(kf_rows):
                    i = int(i)
                    self._note_keyframe_pose(T_all[i])
                    self._queue_keyframe_event(dict(
                        frame_idx=base + i,
                        T_wc=T_all[i].astype(np.float32),
                        uid=sn["uid"][j], active=sn["active"][j],
                        optimal=sn["optimal"][j], tracked=sn["tracked"][j],
                        uv_left=sn["uv_left"][j],
                        disparity=sn["disparity"][j],
                        pos_w=sn["pos_w"][j], desc=sn["desc"][j],
                        instability=int(stacked.instability[i]),
                        bit_prob=bitp_dev[j],
                        motion_scaling=self._kf_motion_scaling(base + i),
                    ))
                return outs
            self._corr_P = np.eye(4, dtype=np.float64)
            self._corr_M = np.eye(4, dtype=np.float64)
            deferred: list = []
            for j, i in enumerate(kf_rows):
                i = int(i)
                # corrections accumulated from earlier keyframes of this
                # chunk (none on the deferred path, where the back-end runs
                # only after all the chunk's records exist; the async-closure
                # path handles each keyframe inline)
                T_kf = T_all[i].astype(np.float64) @ self._corr_M
                P = self._corr_P
                pos_w = sn["pos_w"][j] @ P[:3, :3].T + P[:3, 3]
                self._note_keyframe_pose(T_kf)
                self._handle_keyframe(
                    frame_idx=base + i,
                    T_wc=T_kf.astype(np.float32),
                    uid=sn["uid"][j], active=sn["active"][j],
                    optimal=sn["optimal"][j], tracked=sn["tracked"][j],
                    uv_left=sn["uv_left"][j], disparity=sn["disparity"][j],
                    pos_w=pos_w.astype(np.float32), desc=sn["desc"][j],
                    instability=int(stacked.instability[i]),
                    # deferred path: the whole [B, L, 256] device plane stack
                    # (keyframe j <-> stack row j), from which the batched DB
                    # add gathers the pool rows; the async-closure inline
                    # path takes its row
                    bit_prob=(bitp_dev if self._closure_pool is None
                              else bitp_dev[j]),
                    motion_scaling=self._kf_motion_scaling(base + i),
                    _defer=deferred,
                )
                if not deferred:
                    # handled inline: anchor the recorded trajectory at the
                    # corrected pose
                    self.trajectory[base + i] = self.slam_keyframes[-1].T_wc
            self._process_deferred_keyframes(deferred)
        return outs

    def _process_deferred_keyframes(self, deferred: list) -> None:
        """Chunk-batched keyframe tail: ONE batched DB add and ONE batched
        closure query for ALL the chunk's keyframes, then the per-keyframe
        consensus/cadence in order. The pose graph at a trigger optimizes
        over every recorded keyframe, chunk-mates included."""
        if not deferred:
            return
        t_add0 = time.perf_counter()
        pools = [entry[3] for entry in deferred]
        plane = deferred[0][4]
        ks = self.db.add_many(pools, plane)
        for (kf, *_rest), k in zip(deferred, ks):
            if k != kf.index:
                raise RuntimeError(f"keyframe {kf.index} stored as {k}")
        tm = self.timings
        tm["kf_db_add"] = tm.get("kf_db_add", 0.0) + (
            time.perf_counter() - t_add0)

        t0 = time.perf_counter()
        if self.enable_loop_closure:
            founds = closure_mod.find_closures_batch(
                self.db, [entry[0].index for entry in deferred],
                **closure_kwargs(self.params))
        else:
            founds = [[] for _ in deferred]
        t1 = time.perf_counter()
        for (kf, inst, ms, _pool, _bp), found in zip(deferred, founds):
            if self.enable_loop_closure:
                self._apply_found_closures(found, kf.index)
            self._maybe_trigger_backend(inst, ms)
            # anchor the recorded trajectory at the (possibly corrected)
            # keyframe pose
            self.trajectory[kf.frame_idx] = kf.T_wc
        t2 = time.perf_counter()
        tm["kf_closure"] = tm.get("kf_closure", 0.0) + (t1 - t0)
        tm["kf_backend"] = tm.get("kf_backend", 0.0) + (t2 - t1)
        tm["kf_total"] = tm.get("kf_total", 0.0) + (t2 - t0)

    @staticmethod
    def _host_motion_scaling(T_prev: np.ndarray, T_cur: np.ndarray,
                             cap: float) -> float:
        """``min(1 + 10|w| + 0.5|t|, cap)`` of the frame delta
        ``T_cur inv(T_prev)`` (ref CTrackerGT.cpp:157) from host trajectory
        poses — the host-side twin of frontend.epipolar.motion_scaling."""
        D = (np.asarray(T_cur, np.float64)
             @ np.linalg.inv(np.asarray(T_prev, np.float64)))
        c = (np.trace(D[:3, :3]) - 1.0) * 0.5
        w = float(np.arccos(np.clip(c, -1.0, 1.0)))
        t = float(np.linalg.norm(D[:3, 3]))
        return float(min(1.0 + 10.0 * w + 0.5 * t, cap))

    def _kf_motion_scaling(self, frame_idx: int) -> float:
        """Two-frame motion-scaling average (ms + ms_last)/2 at a keyframe
        (the quantity the reference's optimization veto tests,
        CTrackerSV.cpp:431)."""
        cap = self.params.motion_scaling_cap
        traj = self.trajectory
        f = frame_idx
        if f < 1 or f >= len(traj):
            return 1.0
        ms = self._host_motion_scaling(traj[f - 1], traj[f], cap)
        ms_last = (self._host_motion_scaling(traj[f - 2], traj[f - 1], cap)
                   if f >= 2 else 1.0)
        return 0.5 * (ms + ms_last)

    def _note_keyframe_pose(self, T_wc: np.ndarray) -> None:
        """Hook invoked once per chunk-mode keyframe, in order, just before
        its event dispatches (a stereo-inertial tracker records the measured
        gravity direction here)."""

    # ------------------------------------------------------------------
    def _on_keyframe(self, out) -> None:
        t = self.state.table
        (T_wc, uid, active, optimal, failed, uv_left, disparity, pos_w, desc,
         inst) = fetch_numpy(
            (self.state.T_wc, t.uid, t.active, t.is_optimal, t.failed,
             t.uv_left_last, t.disparity_last, t.pos_w, t.desc_left_ref,
             self.state.instability))
        payload = dict(
            frame_idx=self.frame_count - 1,
            T_wc=T_wc,
            uid=uid,
            active=active,
            optimal=optimal,
            tracked=failed == 0,
            uv_left=uv_left,
            disparity=disparity,
            pos_w=pos_w,
            desc=desc,
            instability=int(inst),
            # the [L, 256] bit-probability plane stays on the device (the DB
            # add gathers the pool rows there)
            bit_prob=lm_mod.bit_prob_u8(t),
            motion_scaling=self._kf_motion_scaling(self.frame_count - 1),
        )
        if self._bk_pool is not None:
            self._queue_keyframe_event(payload)
            self._apply_folds()
            return
        self._handle_keyframe(**payload)
        # keep the recorded trajectory piecewise-consistent: after back-end
        # corrections the live pose changed; the keyframe's trajectory entry
        # must be the CORRECTED pose so each inter-keyframe segment is
        # internally consistent and anchors exactly at raw[kf.frame_idx]
        self.trajectory[-1] = self.state.T_wc.cpu().numpy()

    # ------------------------------------------------------------------
    # overlapped back-end: event queue (tracker thread) + fold application
    # ------------------------------------------------------------------
    def _queue_keyframe_event(self, payload: dict) -> None:
        """Submit a raw keyframe snapshot to the back-end worker, tagged
        with the tracker's current fold version so that the worker can
        bring it into its own (possibly further corrected) gauge."""
        payload["version"] = self._fold_version
        self._last_kf_frame_idx = payload["frame_idx"]
        self._bk_futures.append(
            self._bk_pool.submit(self._bk_handle_keyframe, payload))

    def _bk_handle_keyframe(self, payload: dict) -> None:
        """Worker thread: transform the snapshot from the tracker's gauge
        at queue time into the worker's, then run the whole keyframe tail
        (DB add, closure search, pose graph, BA)."""
        v = payload.pop("version")
        n = len(self._bk_Pc) - 1
        if v < n:
            # corrections (v..n] were emitted after this snapshot was taken
            # (prefix products cancel: Pc_n Pc_v^-1 = P_n ... P_{v+1})
            Pd = self._bk_Pc[n] @ np.linalg.inv(self._bk_Pc[v])
            Md = np.linalg.inv(self._bk_Mc[v]) @ self._bk_Mc[n]
            payload["T_wc"] = (
                payload["T_wc"].astype(np.float64) @ Md).astype(np.float32)
            payload["pos_w"] = (
                payload["pos_w"] @ Pd[:3, :3].T + Pd[:3, 3]
            ).astype(np.float32)
        self._handle_keyframe(**payload)

    def _emit_corr(self, P: np.ndarray, M: np.ndarray) -> None:
        """Worker thread: emit a rigid gauge correction for the live state
        (map points p -> P p; poses T -> T M) and extend the cumulative
        products used to transform late keyframe events."""
        self._bk_Pc.append(np.asarray(P, np.float64) @ self._bk_Pc[-1])
        self._bk_Mc.append(self._bk_Mc[-1] @ np.asarray(M, np.float64))
        self._bk_folds.put(("corr", np.asarray(P, np.float64),
                            np.asarray(M, np.float64)))

    def _apply_folds(self) -> None:
        """Tracker thread: re-raise a failed worker task, then apply every
        completed fold operation to the live state, in the order the worker
        emitted them."""
        if self._bk_pool is None:
            return
        still = []
        for f in self._bk_futures:
            if f.done():
                f.result()
            else:
                still.append(f)
        self._bk_futures = still
        while True:
            try:
                op = self._bk_folds.get_nowait()
            except queue.Empty:
                break
            kind = op[0]
            if kind == "corr":
                self._fold_corr(op[1], op[2])
            elif kind == "lmk":
                self._fold_landmarks(op[1], op[2], op[3])
            elif kind == "canon":
                self._apply_canon_to_live(op[1])

    def _fold_corr(self, P: np.ndarray, M: np.ndarray) -> None:
        """Apply a rigid back-end correction to the live tracking state:
        map p -> P p, pose chain T -> T M, stored observation poses
        X -> X P^-1 (the overlapped analog of _apply_world_correction /
        _attach_live_to_keyframe)."""
        Pj = self._dev(P, torch.float32)
        Mj = self._dev(M, torch.float32)
        Pinv = self._dev(np.linalg.inv(P), torch.float32)
        t = self.state.table
        pos_new = t.pos_w @ Pj[:3, :3].T + Pj[:3, 3]
        meas_T_new = torch.einsum("lmij,jk->lmik", t.meas_T_wc, Pinv)
        self.state = self.state.replace(
            T_wc=self.state.T_wc @ Mj,
            T_wc_prev=self.state.T_wc_prev @ Mj,
            T_last_keyframe=self.state.T_last_keyframe @ Mj,
            table=t.replace(pos_w=pos_new, meas_T_wc=meas_T_new),
        )
        self._table_mirror = None                       # positions moved
        # rewrite the current trajectory segment (anchor keyframe included)
        # so raw relative poses within the segment stay pure VO and the
        # post-fold chain continues from the corrected pose
        for j in range(self._last_kf_frame_idx, len(self.trajectory)):
            self.trajectory[j] = np.asarray(
                self.trajectory[j], np.float64) @ M
        self._fold_version += 1

    def _fold_landmarks(self, uids: np.ndarray, X: np.ndarray,
                        dead_uids: np.ndarray) -> None:
        """Write BA-optimised landmark positions into the live table by uid
        (slots may have been recycled since the worker's snapshot: only
        rows whose uid still matches are touched) and deactivate excised
        landmarks. Rows to skip are dropped on the host."""
        t = self.state.table
        live_uid = t.uid.cpu().numpy().astype(np.int64)
        cap = len(live_uid)
        order = np.argsort(live_uid, kind="stable")

        def to_slots(us: np.ndarray) -> np.ndarray:
            if len(us) == 0:
                return np.zeros(0, np.int64)
            pos = np.searchsorted(live_uid[order], us)
            slot = order[np.clip(pos, 0, cap - 1)]
            return np.where(live_uid[slot] == us, slot, cap)

        slots_good = to_slots(np.asarray(uids, np.int64))
        slots_dead = to_slots(np.asarray(dead_uids, np.int64))
        keep = slots_good < cap
        self.state = self.state.replace(table=_ba_writeback(
            t, self._dev(slots_good[keep], torch.int64),
            self._dev(np.asarray(X, np.float32)[keep], torch.float32),
            self._dev(slots_dead[slots_dead < cap], torch.int64)))
        self._table_mirror = None                       # positions changed

    def flush_backend(self) -> None:
        """Wait for the back-end worker to drain its queue, then fold all
        results (no-op without the overlapped back-end). A worker's
        exception re-raises here."""
        if self._bk_pool is None:
            return
        for f in self._bk_futures:
            f.result()
        self._bk_futures = []
        self._apply_folds()

    def _apply_canon_to_live(self, lut: dict) -> None:
        """Rewrite live-table uids through an identity-merge LUT and keep
        only the best-observed row per canonical identity."""
        if not lut:
            return
        t = self.state.table
        uid_np, active, meas = fetch_numpy(
            (t.uid, t.active, t.meas_count))
        canon = uid_np.copy()
        for u, c in lut.items():
            canon[uid_np == u] = c
        active = active.copy()
        order = np.argsort(-meas, kind="stable")
        seen: set[int] = set()
        for row in order:
            u = int(canon[row])
            if not active[row] or u < 0:
                continue
            if u in seen:
                active[row] = False
            else:
                seen.add(u)
        self._table_mirror = None                       # uids changed
        self.state = self.state.replace(table=t.replace(
            uid=self._dev(canon, torch.int32), active=self._dev(active)))

    def _handle_keyframe(
        self, *, frame_idx: int, T_wc: np.ndarray, uid: np.ndarray,
        active: np.ndarray, optimal: np.ndarray, tracked: np.ndarray,
        uv_left: np.ndarray, disparity: np.ndarray, pos_w: np.ndarray,
        desc: np.ndarray, instability: int = 0,
        bit_prob=None,
        motion_scaling: float = 1.0,
        _defer: list | None = None,
    ) -> None:
        """Keyframe event on explicit arrays (live table in per-frame mode,
        snapshots in chunk mode): record, DB add, closure search, windowed
        BA.

        Each stage accumulates wall time into ``self.timings`` (keys
        ``kf_db_add`` / ``kf_closure`` / ``kf_backend`` / ``kf_total``)."""
        t_kf0 = time.perf_counter()
        self._table_mirror = None    # frames ran since any cached read
        # observations for BA: landmarks tracked THIS frame (failed == 0)
        obs_sel = active & tracked
        uv4 = np.concatenate(
            [uv_left, uv_left[:, :1] - disparity[:, None], uv_left[:, 1:2]],
            axis=1,
        )
        kf = SLAMKeyframe(
            index=len(self.slam_keyframes),
            frame_idx=frame_idx,
            T_wc=T_wc.copy(),
            obs_uids=uid[obs_sel].copy(),
            obs_uv4=uv4[obs_sel].copy(),
            pool_uids=uid[active & optimal].copy(),
            obs_pos=pos_w[obs_sel].copy(),
        )
        self.slam_keyframes.append(kf)

        # closure pool: camera-frame points + descriptors of optimal landmarks
        pool_sel = active & optimal
        R, tt = T_wc[:3, :3], T_wc[:3, 3]
        p_cam = pos_w[pool_sel] @ R.T + tt
        sel_idx = np.nonzero(pool_sel)[0]
        tm = self.timings
        if _defer is not None and self._closure_pool is None:
            # chunk mode: DB add, closure search and back-end cadence run
            # batched over the whole chunk's keyframes after all records
            # exist (_process_deferred_keyframes). ``bit_prob`` here is the
            # chunk's whole [B, L, 256] device plane stack (row = the
            # keyframe's position in the chunk's keyframe order).
            _defer.append((kf, instability, motion_scaling,
                           (desc[pool_sel], p_cam, T_wc, sel_idx), bit_prob))
            tm["kf_total"] = tm.get("kf_total", 0.0) + (
                time.perf_counter() - t_kf0)
            return
        t0 = time.perf_counter()
        if bit_prob is None:
            prob_kw = {}
        elif torch.is_tensor(bit_prob):
            # the [L, 256] probability plane never crosses to the host
            prob_kw = {"prob_device": (bit_prob, sel_idx)}
        else:
            prob_kw = {"prob": bit_prob[pool_sel]}
        self.db.add(desc[pool_sel], p_cam, T_wc, **prob_kw)
        t1 = time.perf_counter()
        tm["kf_db_add"] = tm.get("kf_db_add", 0.0) + (t1 - t0)
        if self.enable_loop_closure:
            self._detect_closures(kf)
        t2 = time.perf_counter()
        self._maybe_trigger_backend(instability, motion_scaling)
        t3 = time.perf_counter()
        tm["kf_closure"] = tm.get("kf_closure", 0.0) + (t2 - t1)
        tm["kf_backend"] = tm.get("kf_backend", 0.0) + (t3 - t2)
        tm["kf_total"] = tm.get("kf_total", 0.0) + (t3 - t_kf0)

    def _maybe_trigger_backend(self, instability: int,
                               motion_scaling: float = 1.0) -> None:
        """Back-end cadence (ref CTrackerSV.cpp:430-451): instability OR
        high average motion scaling vetoes everything (the reference's
        combined critical-situation check at :431); otherwise ONE full
        optimization fires when the keyframe-delta trigger or the closure
        waiting-queue trigger is met (both strict greater-than, matching
        :437), and the cheap windowed refinement keeps its own cadence.

        ``motion_scaling`` is the two-frame average (ms + ms_last)/2 the
        caller computed from the host trajectory."""
        self._kf_since_local_ba += 1
        kf_id = len(self.slam_keyframes) - 1
        delta = self.params.optimize_every_keyframes
        kf_trigger = (kf_id - self._last_opt_kf) > delta
        lc_trigger = (self._closure_kfs_in_queue > self.closure_queue_wait
                      and (kf_id - self._last_closure_opt_kf) > delta)
        due_local = (self.enable_local_ba and len(self.slam_keyframes) >= 2
                     and self._kf_since_local_ba >= self.local_ba_every)
        calm = (instability == 0 and motion_scaling
                < self.params.max_motion_scaling_for_optimization)
        if calm:
            if kf_trigger or lc_trigger:
                self._kf_since_local_ba = 0
                self._run_queued_optimization()
            elif due_local:
                self._kf_since_local_ba = 0
                self._local_ba()
        elif due_local or kf_trigger or lc_trigger:
            self.stats["ba_vetoed"] = self.stats.get("ba_vetoed", 0) + 1

    def _run_queued_optimization(self) -> None:
        """ONE back-end optimization per trigger (the reference's single
        ``Cg2oOptimizer::optimize`` call, CTrackerSV.cpp:440): trajectory
        pose-graph relaxation if closures are queued (stage A,
        Cg2oOptimizer.cpp:258-377), then one incremental full-graph BA
        widened back to the oldest queued closure's reference keyframe
        (stage B, :394-522). Drains the closure waiting queue."""
        if len(self.slam_keyframes) < 2:
            return
        kf_id = len(self.slam_keyframes) - 1
        had_closures = self._closure_kfs_in_queue > 0
        self._snapshot_graph("pre")
        if had_closures:
            self._optimize_pose_graph()
        ba_ok = True
        if self.enable_local_ba:
            ba_ok = self._incremental_ba(lo=self._closure_opt_lo)
        self._snapshot_graph("post")
        if not self.enable_local_ba:
            # no BA stage to advance _last_opt_kf — advance it here so the
            # keyframe-delta trigger doesn't re-fire every keyframe
            self._last_opt_kf = len(self.slam_keyframes)
        elif not ba_ok:
            # BA bailed (under-constrained window / assembly failure): back
            # off instead of re-firing the full attempt on every subsequent
            # keyframe, and KEEP the queued closures so the next trigger
            # retries the reconciliation BA never ran
            self._last_opt_kf = len(self.slam_keyframes)
            if had_closures:
                self._last_closure_opt_kf = kf_id
                self.stats["closure_opt_deferred"] = (
                    self.stats.get("closure_opt_deferred", 0) + 1)
            return
        if had_closures:
            self._last_closure_opt_kf = kf_id
        self._closure_kfs_in_queue = 0
        self._closure_opt_lo = None

    # ------------------------------------------------------------------
    def _find_closures(self, db: closure_mod.KeyframeDatabase, kf_index: int):
        """Pure search stage (runs on the worker thread in async mode)."""
        return closure_mod.find_closures(db, kf_index, **closure_kwargs(self.params))

    def _detect_closures(self, kf: SLAMKeyframe) -> None:
        if self._closure_pool is not None:
            # fold in whatever earlier searches have finished, then start
            # this keyframe's search on the worker over a snapshot
            self.flush_closures(block=False)
            snap = self.db.snapshot()
            self._pending_closures.append(
                (kf.index, self._closure_pool.submit(
                    self._find_closures, snap, kf.index)))
            return
        self._apply_found_closures(self._find_closures(self.db, kf.index),
                                   kf.index)

    def flush_closures(self, block: bool = True) -> None:
        """Fold finished async closure searches into the graph; with
        ``block=True`` wait for all pending ones first (call before reading
        final results or checkpointing). With the overlapped back-end this
        drains the whole back-end queue. A worker's exception re-raises
        here."""
        if self._bk_pool is not None and block:
            self.flush_backend()
        if self._closure_pool is None:
            return
        still = []
        for (idx, fut) in self._pending_closures:
            if fut.done() or block:
                self._apply_found_closures(fut.result(), idx)
            else:
                still.append((idx, fut))
        self._pending_closures = still

    def _closure_redundant(self, ref_kf: int, query_kf: int,
                           extra: list | None = None) -> bool:
        """True when an accepted edge already covers this revisit event:
        both endpoints within ``closure_dedup_radius_kf`` keyframes of an
        accepted (or tentatively kept) edge. Redundant edges add pose-graph
        rows and identity-merge work with no new information."""
        r = self.params.closure_dedup_radius_kf
        if r < 0:
            return False
        for e in self.accepted_closures + (extra or []):
            if abs(e.ref_kf - ref_kf) <= r and abs(e.query_kf - query_kf) <= r:
                return True
        return False

    def _apply_found_closures(self, found, kf_index: int) -> None:
        self.stats["closures_found"] += len(found)
        for c in found:
            # near-duplicate suppression at arrival: skip candidates whose
            # revisit span an accepted edge already covers (one edge per
            # revisit event)
            if self._closure_redundant(c.ref_kf, c.query_kf):
                self.stats["closures_deduped"] = (
                    self.stats.get("closures_deduped", 0) + 1)
                continue
            # resolve matched pool slots to landmark uids (pool slot i of
            # keyframe k holds uid pool_uids[i] — same selection order as
            # the DB add in _handle_keyframe)
            uq = self.slam_keyframes[c.query_kf].pool_uids
            ur = self.slam_keyframes[c.ref_kf].pool_uids
            pairs = c.pairs[(c.pairs[:, 0] < len(uq)) & (c.pairs[:, 1] < len(ur))]
            uid_pairs = np.stack(
                [uq[pairs[:, 0]], ur[pairs[:, 1]]], -1).astype(np.int64) \
                if len(pairs) else np.zeros((0, 2), np.int64)
            self.closure_candidates.append(
                ClosureEdge(ref_kf=c.ref_kf, query_kf=c.query_kf, T_qr=c.T_qr,
                            uid_pairs=uid_pairs)
            )
        # windowed consensus over recent candidates
        # (ref ClosureBuffer + LoopClosureChecker, Cg2oOptimizer.cpp:267-325)
        window = [
            c for c in self.closure_candidates
            if c.query_kf >= kf_index - self.consensus_window
            and not c.accepted and not c.suppressed
        ]
        if not window:
            return
        newly = []
        if len(window) == 1:
            # single candidate: accept on ICP validity alone once it has
            # strong support (the reference requires >= 1 consensus inlier;
            # a lone candidate trivially agrees with itself)
            window[0].accepted = True
            newly = [window[0]]
        else:
            # host consensus (closure_mod.consensus_matrix_np): [C<=16]
            # rigid algebra, no device round trip
            M = np.stack([c.T_qr for c in window])
            T_i = np.stack(
                [self.slam_keyframes[c.ref_kf].T_wc for c in window])
            T_j = np.stack(
                [self.slam_keyframes[c.query_kf].T_wc for c in window])
            chi2 = closure_mod.consensus_matrix_np(M, T_i, T_j)
            inlier = chi2 < self.params.closure_consensus_chi2
            counts = inlier.sum(1)
            accept = inlier[int(np.argmax(counts))]
            for c, a in zip(window, accept):
                if a:
                    c.accepted = True
                    newly.append(c)
        # acceptance-time dedup: a batch can accept several edges covering
        # one revisit event, and a lingering window candidate can become
        # redundant against an edge accepted after it arrived
        kept = []
        for c in newly:
            if self._closure_redundant(c.ref_kf, c.query_kf, kept):
                c.accepted = False
                c.suppressed = True
                self.stats["closures_deduped"] = (
                    self.stats.get("closures_deduped", 0) + 1)
            else:
                kept.append(c)
        newly = kept
        if newly:
            self.accepted_closures.extend(newly)
            self.stats["closures_accepted"] += len(newly)
            # landmark-identity constraints merge immediately (cheap
            # union-find + uid LUT); the EXPENSIVE pose-graph + BA work
            # BUFFERS in the waiting queue — one optimization per trigger,
            # not per acceptance (ref m_uLoopClosingKeyFramesInQueue,
            # CTrackerSV.cpp:418-423)
            for c in newly:
                self._merge_closure_landmarks(c)
            lo = min(c.ref_kf for c in newly)
            self._closure_opt_lo = (lo if self._closure_opt_lo is None
                                    else min(self._closure_opt_lo, lo))
            self._closure_kfs_in_queue += 1

    # ------------------------------------------------------------------
    # landmark identity merging (ref EdgePointXYZ closure constraints,
    # Cg2oOptimizer.cpp:444-459 — realized as hard identity: re-observed
    # duplicates collapse onto the oldest uid, so BA sees ONE landmark with
    # observations from both sides of the loop)
    # ------------------------------------------------------------------
    def _uid_find(self, u: int) -> int:
        root = u
        while self._uid_parent.get(root, root) != root:
            root = self._uid_parent[root]
        while self._uid_parent.get(u, u) != u:       # path compression
            self._uid_parent[u], u = root, self._uid_parent[u]
        return root

    def _uid_union(self, a: int, b: int) -> bool:
        ra, rb = self._uid_find(int(a)), self._uid_find(int(b))
        if ra == rb:
            return False
        hi, lo = (ra, rb) if ra > rb else (rb, ra)   # canonical = oldest uid
        self._uid_parent[hi] = lo
        return True

    def _canon_uids(self, uids: np.ndarray) -> np.ndarray:
        """Vectorized canonical-uid map (identity for unmerged uids)."""
        if not self._uid_parent:
            return uids
        out = uids.copy()
        uniq = np.unique(uids)
        lut = {int(u): self._uid_find(int(u)) for u in uniq if int(u) >= 0}
        changed = {u: c for u, c in lut.items() if c != u}
        if not changed:
            return out
        keys = np.fromiter(changed.keys(), np.int64, len(changed))
        vals = np.fromiter(changed.values(), np.int64, len(changed))
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        pos = np.searchsorted(keys, uids)
        pos_c = np.clip(pos, 0, len(keys) - 1)
        hit = (keys[pos_c] == uids) & (uids >= 0)
        out[hit] = vals[pos_c[hit]]
        return out

    def _merge_closure_landmarks(self, edge: ClosureEdge) -> int:
        """Union the matched uid pairs of an accepted closure and collapse
        duplicate live-table rows onto the canonical landmark (directly in
        synchronous mode; as a fold operation in overlapped mode)."""
        n_new = 0
        for (uq, ur) in edge.uid_pairs:
            if int(uq) < 0 or int(ur) < 0 or int(uq) == int(ur):
                continue
            if self._uid_union(int(uq), int(ur)):
                n_new += 1
        if n_new == 0:
            return 0
        # full changed-uid LUT (covers earlier merges too — a recycled slot
        # may still carry a stale pre-merge uid)
        lut = {u: self._uid_find(u) for u in list(self._uid_parent)}
        lut = {u: c for u, c in lut.items() if u != c}
        if self._bk_pool is not None:
            self._bk_folds.put(("canon", lut))
        else:
            self._apply_canon_to_live(lut)
        self.stats["landmarks_merged"] = (
            self.stats.get("landmarks_merged", 0) + n_new)
        return n_new

    def _snapshot_graph(self, tag: str) -> None:
        """g2o snapshot around each optimization (ref Cg2oOptimizer.cpp:493-514)."""
        if not self.graph_snapshot_dir or not self.slam_keyframes:
            return
        from pathlib import Path

        from svi_mapper_tpu_torch.io.g2o_export import snapshot_slam

        d = Path(self.graph_snapshot_dir)
        d.mkdir(parents=True, exist_ok=True)
        n = len(self.slam_keyframes)
        snapshot_slam(self, d / f"keyframes_0-{n - 1}_{tag}.g2o")

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket(n: int, floor: int) -> int:
        """Next power-of-two shape bucket. It sizes the BA window: the
        keyframe count decides which Schur-assembly kernel takes it
        (K <= 32, or a multiple of 32 up to 128), and an unbucketed K = 40
        would take neither."""
        b = floor
        while b < n:
            b *= 2
        return b

    def _optimize_pose_graph(self) -> None:
        """Trajectory-only relaxation over ALL keyframes + accepted closures
        (the reference's trajectory graph, Cg2oOptimizer.cpp:342-377). The
        graph goes to the solver at its own size, with no padding."""
        N0 = len(self.slam_keyframes)
        if N0 < 2:
            return
        t_pg0 = time.perf_counter()
        T0 = np.stack([k.T_wc for k in self.slam_keyframes]).astype(np.float64)
        # sequential odometry edges, batched (ref info scaling
        # Cg2oOptimizer.cpp:1258-1266)
        M_seq = np.matmul(T0[1:], np.linalg.inv(T0[:-1]))
        w_seq = 1.0 / (1.0 + np.sum(M_seq[:, :3, 3] ** 2, axis=-1))
        ei = list(range(N0 - 1)) + [c.ref_kf for c in self.accepted_closures]
        ej = list(range(1, N0)) + [c.query_kf for c in self.accepted_closures]
        Ms = np.concatenate(
            [M_seq] + [c.T_qr[None].astype(np.float64)
                       for c in self.accepted_closures], axis=0)
        n_clo = len(self.accepted_closures)
        ws = np.concatenate([w_seq, np.ones(n_clo)])
        # anisotropic closure information: the translation-z component (the
        # ICP depth direction along the optical axis) is damped x100 (ref
        # _getInformationNoZ info(2,2) /= 100, Cg2oOptimizer.cpp:1542-1550,
        # applied to every loop-closure EdgeSE3 :1075-1133)
        info6 = np.ones((N0 - 1 + n_clo, 6), np.float32)
        info6[N0 - 1:, 2] = self.params.closure_z_info_damping
        E0 = len(ei)
        edges = pg_mod.PoseGraphEdges(
            i=self._dev(ei, torch.int32), j=self._dev(ej, torch.int32),
            T_ij=self._dev(Ms, torch.float32), weight=self._dev(ws, torch.float32),
            valid=torch.ones(E0, dtype=torch.bool, device=self.device),
            info6=self._dev(info6),
        )
        fix = np.zeros(N0, bool)
        fix[0] = True
        res = pg_mod.optimize_pose_graph(
            self._dev(T0, torch.float32), edges, self._dev(fix),
            gravity=self._gravity_priors(N0, N0), device=self.device)
        T_opt, chi2_initial, chi2_final = fetch_numpy(
            (res.T_wc, res.chi2_initial, res.chi2_final))
        self.stats["pose_graph_runs"] += 1
        # last-run wall + graph size (the dense [6N,6N] Cholesky cost grows
        # with keyframes)
        dt_pg = time.perf_counter() - t_pg0
        self.timings["pose_graph_last_s"] = dt_pg
        self.timings["pose_graph_last_n"] = float(N0)
        self.timings["kf_pose_graph"] = (
            self.timings.get("kf_pose_graph", 0.0) + dt_pg)
        if not np.isfinite(T_opt).all() or float(chi2_final) > float(chi2_initial):
            self.stats["pose_graph_rejected"] = self.stats.get("pose_graph_rejected", 0) + 1
            return
        # write back + propagate the last-keyframe correction to live state
        for k, kf in enumerate(self.slam_keyframes):
            kf.T_wc = T_opt[k]
        self.db.update_poses(T_opt)
        if self._bk_pool is not None:
            # overlapped mode: emit the rigid world correction for the
            # tracker thread to fold (p -> G p, T -> T G^-1)
            G = self._world_correction(T0[-1], T_opt[-1].astype(np.float64))
            self._emit_corr(G, np.linalg.inv(G))
        else:
            self._apply_world_correction(T0[-1].astype(np.float32), T_opt[-1])

    # ------------------------------------------------------------------
    def _gravity_priors(self, N0: int, N: int):
        """Per-keyframe gravity unaries for the pose graph, or None. The
        stereo-only system has no gravity observations; a stereo-inertial
        tracker overrides this (ref EdgeSE3LinearAcceleration,
        Cg2oOptimizer.cpp:411)."""
        return None

    def _gravity_ba_terms(self, kfs: list, K: int):
        """(down_cam [K,3], weight [K]) gravity unaries for a BA window, or
        None. Overridden by a stereo-inertial tracker (ref gravity edges in
        the FULL graph, Cg2oOptimizer.cpp:982-997)."""
        return None

    # ------------------------------------------------------------------
    def _attach_live_to_keyframe(self, T_kf_old: np.ndarray, T_kf_new: np.ndarray) -> None:
        """Rigidly attach the live pose chain to a corrected keyframe pose:
        T_live_new inv(T_kf_new) == T_live_old inv(T_kf_old). Used after BA,
        where landmarks are updated directly and only the live pose must
        follow (ref back-propagation of the BA result into the tracker pose,
        CTrackerSV.cpp:454-456)."""
        A_np = np.linalg.inv(T_kf_old.astype(np.float64)) @ T_kf_new
        self._corr_M = self._corr_M @ A_np
        T, Tp, Tk = _poses_rmul(
            self.state.T_wc, self.state.T_wc_prev,
            self.state.T_last_keyframe, self._dev(A_np, torch.float32))
        self.state = self.state.replace(
            T_wc=T, T_wc_prev=Tp, T_last_keyframe=Tk)

    @staticmethod
    def _world_correction(T_old: np.ndarray, T_new: np.ndarray) -> np.ndarray:
        """G: world-frame map correction st. camera-frame geometry at the
        last keyframe is preserved: p_w_new = G p_w_old."""
        return np.linalg.inv(T_new) @ T_old

    def _apply_world_correction(self, T_old: np.ndarray, T_new: np.ndarray) -> None:
        """Rigidly move the live map/state into the corrected world frame
        (the batched analog of _backPropagateTrajectoryToFull +
        _applyOptimizationToLandmarks, Cg2oOptimizer.cpp:1468-1603)."""
        G = self._world_correction(T_old, T_new)        # p_w_new = G p_w_old
        self._table_mirror = None                       # positions moved
        self._corr_P = G.astype(np.float64) @ self._corr_P
        self._corr_M = self._corr_M @ np.linalg.inv(G.astype(np.float64))
        Gj = self._dev(G, torch.float32)
        t = self.state.table
        pos_new = t.pos_w @ Gj[:3, :3].T + Gj[:3, 3]
        # every world->camera transform X must satisfy p_c invariance:
        # X_new = X_old G^-1  (then X_new p_w_new == X_old p_w_old)
        Ginv = self._dev(np.linalg.inv(G), torch.float32)
        meas_T_new = torch.einsum("lmij,jk->lmik", t.meas_T_wc, Ginv)
        self.state = self.state.replace(
            T_wc=self.state.T_wc @ Ginv,
            T_wc_prev=self.state.T_wc_prev @ Ginv,
            T_last_keyframe=self.state.T_last_keyframe @ Ginv,
            table=t.replace(pos_w=pos_new, meas_T_wc=meas_T_new),
        )
        # the returned per-frame trajectory list keeps raw VO poses; the
        # OPTIMIZED trajectory is reconstructed via optimized_trajectory()

    # ------------------------------------------------------------------
    def _assemble_ba_window(self, kfs: list[SLAMKeyframe], K: int | None = None):
        """Vectorized observation-tensor assembly for a keyframe window:
        returns (uids [L0], obs [K,Lpad,4], mask [K,Lpad], X0 [Lpad,3],
        slot [Lpad]) with shapes padded to buckets, or None if
        under-constrained.

        Observation uids are mapped through the closure identity merges
        (duplicates collapse onto one column — the landmark-identity
        constraint in effect) and excised landmarks are dropped."""
        K0 = len(kfs)
        all_uids = np.concatenate([kf.obs_uids for kf in kfs]).astype(np.int64)
        all_uv = np.concatenate([kf.obs_uv4 for kf in kfs])
        all_k = np.concatenate(
            [np.full(len(kf.obs_uids), k, np.int32) for k, kf in enumerate(kfs)])
        if len(all_uids) == 0:
            return None
        all_uids = self._canon_uids(all_uids)
        if self._excised_uids:
            dead = np.isin(all_uids,
                           np.fromiter(self._excised_uids, np.int64))
            all_uids = np.where(dead, -1, all_uids)
        ok_obs = all_uids >= 0
        uids, inv = np.unique(all_uids, return_inverse=True)
        # duplicate observations of one landmark in the SAME keyframe (a
        # merged pair seen twice) keep the first occurrence only
        if len(uids) < 8:
            return None
        keep = ok_obs & (inv < self.ba_max_points + (uids[0] < 0))
        drop_neg = int(uids[0] < 0)
        uids = uids[drop_neg: drop_neg + self.ba_max_points]
        inv = inv - drop_neg
        L0 = len(uids)
        if L0 < 8:
            return None
        Lpad = self._bucket(max(L0, 64), 64)
        K = self.ba_window if K is None else K

        obs = np.zeros((K, Lpad, 4), np.float32)
        mask = np.zeros((K, Lpad), bool)
        obs[all_k[keep], inv[keep]] = all_uv[keep]
        mask[all_k[keep], inv[keep]] = True
        # landmarks observed in >= 2 keyframes constrain the window
        seen = mask.sum(0)
        mask &= (seen >= 2)[None, :]
        # density gate: an under-constrained window lets BA run wild
        if mask.sum() < 20 * K0:
            return None

        if self._bk_pool is not None:
            # overlapped mode (worker thread): the live table belongs to the
            # tracker thread — initialise each landmark from the NEWEST
            # keyframe snapshot that observed it (assignment order = kf
            # order, so later keyframes win)
            all_pos = np.concatenate([kf.obs_pos for kf in kfs])
            if len(all_pos) != len(all_uids):
                return None      # snapshot positions missing (keyframes
                                 # restored from a file without them)
            X0 = np.zeros((Lpad, 3), np.float32)
            havep = np.zeros(Lpad, bool)
            sel = keep & (inv >= 0) & (inv < L0)
            X0[inv[sel]] = all_pos[sel]
            havep[inv[sel]] = True
            mask &= havep[None, :]
            if mask.sum() < 24:
                return None
            return uids, obs, mask, X0, np.full(Lpad, -1, np.int32)

        # current landmark positions by uid lookup in the live table. The
        # (uid, pos_w) host mirror is cached between chunk boundaries and
        # invalidated by whatever changes the table. Staleness within a
        # boundary would only be the previous BA's own refinement.
        if self._table_mirror is None:
            t = self.state.table
            self._table_mirror = fetch_numpy((t.uid, t.pos_w))
        table_uids, table_pos = self._table_mirror
        table_uids = table_uids.astype(np.int64)
        order = np.argsort(table_uids, kind="stable")
        pos = np.searchsorted(table_uids[order], uids)
        pos_c = np.clip(pos, 0, len(order) - 1)
        slot = order[pos_c]
        have = (table_uids[slot] == uids) & (uids >= 0)
        X0 = np.zeros((Lpad, 3), np.float32)
        X0[:L0][have] = table_pos[slot[have]]
        havep = np.zeros(Lpad, bool)
        havep[:L0] = have
        mask &= havep[None, :]
        if mask.sum() < 24:
            return None
        slot_pad = np.zeros(Lpad, np.int32)
        slot_pad[:L0] = np.where(have, slot, -1)
        slot_pad[L0:] = -1
        return uids, obs, mask, X0, slot_pad

    def _local_ba(self) -> None:
        """Windowed Schur BA over the last ``ba_window`` keyframes
        (the per-keyframe refinement; the growing-range stage is
        _incremental_ba, ref Cg2oOptimizer.cpp:394-522)."""
        kfs = self.slam_keyframes[-self.ba_window:]
        if len(kfs) < 2:
            return
        self._run_ba(kfs, self.ba_window, max_chunks=1, correction_cap=0.5)

    def _incremental_ba(self, lo: int | None = None) -> bool:
        """Incremental full-graph BA: optimize from the last-optimized
        keyframe forward over the growing graph, up to 100 LM iterations
        until the chi^2 gain drops below 1%, then excise insane landmarks
        (ref Cg2oOptimizer::optimize + _optimizeUnLimited,
        Cg2oOptimizer.cpp:232-522, 954-980; excision :1486-1504).

        ``lo`` optionally widens the range backward (a closure's reference
        keyframe must join the optimization so the loop reconciles)."""
        n = len(self.slam_keyframes)
        start = max(0, self._last_opt_kf - 1)
        start = max(start, n - self.incremental_ba_max_window)
        if lo is not None:
            # the closure's reference keyframe must join the optimization:
            # long loops widen past the max-window clamp
            start = min(start, lo)
        kfs = self.slam_keyframes[start:]
        if len(kfs) < 2:
            return False
        K = self._bucket(len(kfs), 8)
        ok = self._run_ba(kfs, K, max_chunks=10, correction_cap=None,
                          excise=True)
        if ok:
            self._last_opt_kf = n
        return ok

    def _run_ba(self, kfs, K: int, *, max_chunks: int,
                correction_cap: float | None, excise: bool = False) -> bool:
        """Shared BA routine: assemble, LM with the <1% chi^2 stopping rule
        (ref Cg2oOptimizer.cpp:954-980), gates, write-back, optional
        insane-landmark excision."""
        t_ba0 = time.perf_counter()
        try:
            return self._run_ba_inner(kfs, K, max_chunks=max_chunks,
                                      correction_cap=correction_cap,
                                      excise=excise)
        finally:
            self.timings["kf_ba"] = (self.timings.get("kf_ba", 0.0)
                                     + time.perf_counter() - t_ba0)

    def _run_ba_inner(self, kfs, K: int, *, max_chunks: int,
                      correction_cap: float | None,
                      excise: bool = False) -> bool:
        K0 = len(kfs)
        asm = self._assemble_ba_window(kfs, K)
        if asm is None:
            return False
        uids, obs, mask, X0, slot_pad = asm

        T0 = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        T0[:K0] = np.stack([kf.T_wc for kf in kfs]).astype(np.float32)
        fix = np.zeros(K, bool)
        fix[0] = True
        fix[K0:] = True

        # on-device window preparation (solvers.ba_prep): the depth-
        # consistency gate, measurement self-consistency re-init, and
        # depth-tiered observation information; no host read — its outputs
        # ride along with the solve's in the one read below
        dev = self.device
        T_cur, obs_j, fix_j = self._dev(T0), self._dev(obs), self._dev(fix)
        prep = ba_prep.prepare_ba_window(
            T_cur, obs_j, self._dev(mask), self._dev(X0), self.cam,
            far_d2=self.params.ba_far_depth2_m2,
            min_far_disparity=self.params.ba_min_far_disparity_px,
            depth_weighting=self.params.ba_depth_weighting,
            device=dev,
        )

        # pose-pose odometry chain anchored to the CURRENT (post-pose-graph)
        # keyframe chain, information 1e5/(1 + |dt|^2) as in the reference
        # full graph (Cg2oOptimizer.cpp:1258-1266; measurements updated by
        # back-propagation :1552-1603 — hence "current" chain, not raw VO)
        odo_M = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        odo_w = np.zeros(K, np.float32)
        if K0 >= 2:
            D = np.matmul(T0[1:K0],
                          np.linalg.inv(T0[: K0 - 1].astype(np.float64))
                          ).astype(np.float32)
            odo_M[: K0 - 1] = D
            odo_w[: K0 - 1] = 1e5 / (1.0 + np.sum(D[:, :3, 3] ** 2, -1))

        # per-keyframe gravity unaries in the FULL graph (stereo-inertial
        # runs; ref Cg2oOptimizer.cpp:982-997) — None on stereo-only systems
        grav = self._gravity_ba_terms(kfs, K)
        grav_kw = {}
        if grav is not None:
            grav_kw = dict(grav_d=self._dev(grav[0], torch.float32),
                           grav_w=self._dev(grav[1], torch.float32))
        # ONE call for the whole optimization: accept/reject keeps chi^2
        # monotone and ``min_rel_improvement`` IS the reference's <1% stop
        # (Cg2oOptimizer.cpp:966-977), so the chunks of 10 iterations
        # collapse into one loop with the same iteration budget
        res = ba_mod.bundle_adjust(
            T_cur, prep.X0, obs_j, prep.mask, self.cam, fix_j,
            kernel_px2=self.params.posit_kernel_px2,
            max_iterations=10 * max_chunks,
            min_rel_improvement=0.01,
            odo_M=self._dev(odo_M), odo_w=self._dev(odo_w), obs_w=prep.obs_w,
            device=dev, **grav_kw,
        )
        self.stats["ba_runs"] += 1
        fetch = [prep.mask, prep.n_gated, prep.n_reinit, prep.n_obs,
                 res.chi2_initial, res.chi2_final, res.T_wc, res.points_w]
        if excise:
            fetch += list(ba_mod.reprojection_stats(
                res.T_wc[:K0], res.points_w, obs_j[:K0], prep.mask[:K0],
                self.cam, device=dev))
        fetched = fetch_numpy(fetch)       # the ONE read
        (mask, n_gated, n_reinit, n_obs_left,
         chi2_init, chi2_prev, T_opt, X_opt) = fetched[:8]
        if int(n_reinit):
            self.stats["landmarks_reinit"] = (
                self.stats.get("landmarks_reinit", 0) + int(n_reinit))
        if int(n_gated):
            self.stats["obs_depth_gated"] = (
                self.stats.get("obs_depth_gated", 0) + int(n_gated))
        if int(n_obs_left) < 24:
            return False
        chi2_init, chi2_prev = float(chi2_init), float(chi2_prev)
        if not np.isfinite(chi2_prev) or chi2_prev > chi2_init:
            return False
        if chi2_prev > 0.999 * chi2_init:
            # no-op optimization (every LM step rejected / nothing to gain):
            # do NOT write back. The write-back clears the window landmarks'
            # measurement rings (the reference clears histories because
            # optimization CHANGED the landmark, CLandmark.cpp:299) — doing
            # that after a zero-gain solve strips the per-frame landmark GN
            # of its measurements for nothing
            return True
        T_opt = T_opt[:K0]
        T0 = T0[:K0]
        # sanity gate on the correction magnitude (the BA analog of the
        # posit RISK check, CSolverStereoPosit.h:89-98): a window BA must
        # not teleport keyframes. The incremental run after a closure is
        # EXPECTED to move keyframes by the loop-drift magnitude, so the
        # cap only applies to the per-keyframe refinement.
        if correction_cap is not None and np.abs(T_opt - T0).max() > correction_cap:
            self.stats["ba_rejected"] = self.stats.get("ba_rejected", 0) + 1
            return False

        # insane-vertex excision (ref _applyOptimizationToLandmarks erasure,
        # Cg2oOptimizer.cpp:1486-1504): landmarks whose post-BA mean
        # reprojection error stays far outside the robust kernel, or that
        # land behind an observing camera, leave the map
        bad = np.zeros(X_opt.shape[0], bool)
        if excise:
            err2, depth = fetched[8], fetched[9]
            seen = mask[:K0].any(0)
            bad = seen & ((err2 > 4.0 * self.params.posit_kernel_px2)
                          | (depth < 0.01))
            for u in uids[bad[: len(uids)]]:
                self._excised_uids.add(int(u))
            if bad.any():
                self.stats["landmarks_excised"] = (
                    self.stats.get("landmarks_excised", 0) + int(bad.sum()))

        # write back keyframe poses
        for k, kf in enumerate(kfs):
            kf.T_wc = T_opt[k]

        if self._bk_pool is not None:
            # overlapped mode: the live table belongs to the tracker thread —
            # emit the landmark updates (keyed by uid, not slot: slots may
            # have been recycled) and the rigid pose correction as folds
            L0 = len(uids)
            used = mask[:, :L0].any(0)
            good = used & ~bad[:L0]
            dead = used & bad[:L0]
            gu, gx = uids[good], X_opt[:L0][good]
            # refresh the window's snapshot positions so the NEXT window's
            # initialiser starts from the BA result
            if len(gu):
                for kf in kfs:
                    if len(kf.obs_pos) != len(kf.obs_uids):
                        continue
                    cu = self._canon_uids(kf.obs_uids.astype(np.int64))
                    p = np.searchsorted(gu, cu)
                    pc = np.clip(p, 0, len(gu) - 1)
                    ok = gu[pc] == cu
                    kf.obs_pos[ok] = gx[pc[ok]]
            self._bk_folds.put(("lmk", gu, gx, uids[dead]))
            A = (np.linalg.inv(T0[-1].astype(np.float64))
                 @ T_opt[-1].astype(np.float64))
            self._emit_corr(np.eye(4), A)
            return True

        # write back landmark positions (only BA'd, still-live landmarks);
        # excised landmarks deactivate instead. BA'd landmarks also get
        # their measurement rings cleared — the stored observation poses
        # predate the correction and would make the per-frame landmark GN
        # fight the BA result (the reference clears measurement histories on
        # optimization, CLandmark::clearMeasurements CLandmark.cpp:299).
        # Rows to skip are dropped here, on the host.
        used = mask.any(0) & (slot_pad >= 0)
        if used.any():
            good = used & ~bad
            dead = used & bad
            self.state = self.state.replace(table=_ba_writeback(
                self.state.table, self._dev(slot_pad[good], torch.int64),
                self._dev(X_opt[good], torch.float32),
                self._dev(slot_pad[dead], torch.int64)))
            self._table_mirror = None                   # positions changed
        # attach the live pose rigidly to the corrected last keyframe
        # (landmarks were updated DIRECTLY by BA above — no map transform)
        self._attach_live_to_keyframe(T0[-1], T_opt[-1])
        return True

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Drain and shut down the worker threads (idempotent). After
        ``close()`` the system keeps working in synchronous mode."""
        if self._closure_pool is not None:
            self.flush_closures(block=True)
            self._closure_pool.shutdown(wait=True)
            self._closure_pool = None
        if self._bk_pool is not None:
            self.flush_backend()
            self._bk_pool.shutdown(wait=True)
            self._bk_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown, half-built object
            pass

    def finalize_backend(self) -> None:
        """Drain every pending back-end stage: async closure searches, the
        overlapped worker queue, and the closure waiting queue (queued
        closures whose optimization trigger never fired before the stream
        ended still reconcile — the reference leaves them unoptimized,
        which is wrong for a finite replay)."""
        self.flush_closures(block=True)   # no-op in synchronous mode
        if self._closure_kfs_in_queue > 0:
            self._run_queued_optimization()
            self._apply_folds()           # overlapped mode: fold corrections

    def optimized_trajectory(self) -> np.ndarray:
        """Per-frame trajectory with keyframe corrections interpolated:
        each frame's raw VO pose is corrected by its most recent keyframe's
        accumulated optimization delta."""
        self.finalize_backend()
        raw = self.trajectory_array
        if not self.slam_keyframes:
            return raw
        out = raw.copy()
        kf_frames = [kf.frame_idx for kf in self.slam_keyframes]
        # original (spawn-time) poses are the raw trajectory at those frames
        for i in range(len(raw)):
            # find latest keyframe at or before frame i
            k = int(np.searchsorted(kf_frames, i, side="right")) - 1
            if k < 0:
                continue
            kf = self.slam_keyframes[k]
            # anchor = the recorded (post-spawn-correction) keyframe pose;
            # rigid attachment: out[i] inv(kf.T_wc) == raw[i] inv(anchor)
            anchor = raw[kf.frame_idx]
            # raw[i] @ inv(anchor) is frame-invariant; the keyframe pose
            # converts from the internal (robocentric) to the output frame
            out[i] = raw[i] @ np.linalg.inv(anchor) @ self._to_output(kf.T_wc)
        return out

    def _world_shift(self, c: np.ndarray) -> None:
        """Robocentric rebase extended to the back-end state: keyframe
        poses, the closure database, and the chunk gauge accumulators all
        move into the new internal frame (ref m_vecTranslationToG2o is
        threaded through every g2o call, CTrackerGT.h:84).

        With the overlapped back-end the (rare) shift is a synchronisation
        point: the worker drains first so that both threads cross the gauge
        change together."""
        self.flush_backend()
        self._table_mirror = None                       # positions rebased
        super()._world_shift(c)
        Tc = self._translate4(c)
        for kf in self.slam_keyframes:
            kf.T_wc = np.asarray(kf.T_wc, np.float64) @ Tc
        n = len(self.slam_keyframes)
        if n:
            Tdb = self.db.poses_host()
            self.db.update_poses(
                (Tdb[:n].astype(np.float64) @ Tc).astype(np.float32))
        # the shift is a world correction G = Translate(-c) for snapshots
        # still pending in the current chunk
        G = self._translate4(-c)
        self._corr_P = G @ self._corr_P
        self._corr_M = self._corr_M @ Tc
