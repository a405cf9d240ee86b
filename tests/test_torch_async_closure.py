"""Async loop closure in the port: the closure search runs on a worker
thread over database snapshots (``SLAMSystem(async_closure=True)``).

Mirrors ``tests/test_async_closure.py`` on the small loop of
``test_torch_slam.py`` (``LOOP``, ``LOOP_KW``: 384 x 192, a loop of 9 m
radius driven 1.15 times), cut from 80 frames to 72 (the loop is driven in
fewer, larger steps and still revisits its start), rendered once by the JAX
package and fed to both as numpy, frame by frame through ``process`` with
local BA off, as the JAX test runs it. Both packages run with ``use_gt_pose=True`` (see
``test_torch_slam.py``: two free-running float32 front-ends part ways on
this loop). The port's async run must find and accept the same closures as
its own synchronous run and as the JAX package's async run, with the same
keyframes; the closure transforms agree to 2e-2, the bound of
``test_torch_slam.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu.models import slam as jslam
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS as TPARAMS
from svi_mapper_tpu_torch.models import slam as tslam

import torch_parity as tp
from test_torch_slam import LOOP, LOOP_KW

N_FRAMES = 72


@pytest.fixture(scope="module")
def loop_runs():
    """The same revisiting loop tracked by the port synchronously and
    asynchronously, and by the JAX package asynchronously."""
    seq = jsyn.SyntheticSequence(**dict(LOOP, n_frames=N_FRAMES))
    frames = [tuple(np.asarray(x) for x in seq.frame(i)) for i in range(N_FRAMES)]
    out, threads = {}, set()
    for mode in ("sync", "async"):
        s = tslam.SLAMSystem(tp.torch_camera(seq.cam),
                             dataclasses.replace(TPARAMS, **LOOP_KW),
                             use_gt_pose=True, enable_local_ba=False,
                             enable_loop_closure=True,
                             async_closure=(mode == "async"), device="cpu")
        search = s._find_closures

        def searching(db, kf, search=search):
            threads.add(threading.current_thread().name)
            return search(db, kf)

        s._find_closures = searching
        for L, R, T in frames:
            s.process(L, R, T_gt=T)
        s.flush_closures(block=True)
        out[mode] = s
    j = jslam.SLAMSystem(seq.cam, dataclasses.replace(JPARAMS, **LOOP_KW),
                         use_gt_pose=True, enable_local_ba=False,
                         enable_loop_closure=True, async_closure=True)
    for L, R, T in frames:
        j.process(L, R, T_gt=T)
    j.flush_closures(block=True)
    out["jax"] = j
    yield seq, out, threads
    for s in out.values():
        s.close()


def test_async_finds_the_same_closures(loop_runs):
    _, runs, threads = loop_runs
    sync, asyn, jax_ = runs["sync"], runs["async"], runs["jax"]
    assert asyn.stats["closures_found"] >= 1
    assert asyn.stats["closures_accepted"] >= 1
    # the searches are identical computations over the same pools; only the
    # fold-in timing differs: found counts equal exactly
    for other in (sync, jax_):
        assert asyn.stats["closures_found"] == other.stats["closures_found"]
        assert asyn.stats["closures_accepted"] == other.stats["closures_accepted"]
        assert asyn.stats.get("closures_deduped", 0) == other.stats.get("closures_deduped", 0)
        assert [(c.ref_kf, c.query_kf) for c in asyn.accepted_closures] == [
            (c.ref_kf, c.query_kf) for c in other.accepted_closures]
        assert [kf.frame_idx for kf in asyn.slam_keyframes] == [
            kf.frame_idx for kf in other.slam_keyframes]
        for a, b in zip(asyn.accepted_closures, other.accepted_closures):
            np.testing.assert_allclose(a.T_qr, b.T_qr, atol=2e-2)
    # the async searches ran on the worker, the synchronous ones on the
    # tracker thread
    assert threads == {"MainThread", "loop-closure_0"}


def test_async_trajectory_stays_consistent(loop_runs):
    _, runs, _ = loop_runs
    asyn = runs["async"]
    T = asyn.optimized_trajectory()
    assert np.isfinite(T).all()
    assert len(T) == asyn.frame_count


def test_flush_is_idempotent_and_sync_mode_noop(loop_runs):
    _, runs, _ = loop_runs
    for s in (runs["sync"], runs["async"]):
        before = s.stats["closures_found"]
        s.flush_closures(block=True)
        s.flush_closures(block=True)
        assert s.stats["closures_found"] == before
    assert not runs["async"]._pending_closures
    assert runs["sync"]._closure_pool is None


def test_snapshot_keeps_its_poses(loop_runs):
    """A snapshot taken before ``update_poses`` keeps the poses it was
    taken with (the pose-graph write-back rebinds the live database's pose
    tensor and host mirror)."""
    _, runs, _ = loop_runs
    db = runs["async"].db
    snap = db.snapshot()
    n = db.n
    T_before = snap.T_wc[:n].clone()
    host_before = snap.poses_host()[:n].copy()
    moved = db.poses_host()[:n].copy()
    moved[:, 0, 3] += 5.0
    db.update_poses(moved)
    assert (db.T_wc[:n, 0, 3] - T_before[:, 0, 3]).abs().min() > 4.9
    assert snap.T_wc[:n].equal(T_before)
    np.testing.assert_array_equal(snap.poses_host()[:n], host_before)
    assert snap.n == n and snap.count_host[:n] == db.count_host[:n]
    db.update_poses(host_before)                       # as it was


def test_worker_exception_reraises(loop_runs):
    """A search that fails on the worker raises in the tracker thread at
    the next blocking flush; nothing catches it."""
    seq, _, _ = loop_runs
    s = tslam.SLAMSystem(tp.torch_camera(seq.cam), TPARAMS, async_closure=True,
                         device="cpu")

    def failing(db, kf):
        raise RuntimeError("planted search failure")

    s._find_closures = failing
    s._pending_closures.append((0, s._closure_pool.submit(s._find_closures, s.db, 0)))
    with pytest.raises(RuntimeError, match="planted"):
        s.flush_closures(block=True)
    s._pending_closures = []
    s.close()
