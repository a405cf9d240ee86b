"""The overlapped back-end of the port: the keyframe tail (DB add, closure
search, pose graph, BA) on a worker thread, reconciled with the live state
through fold operations (``SLAMSystem(overlap_backend=...)``).

Mirrors ``tests/test_overlap.py`` on the small loop of ``test_torch_slam.py``
(``LOOP``, ``LOOP_KW``: 384 x 192, a loop of 9 m radius; here 72 frames, the
loop driven in fewer, larger steps, as in ``test_torch_async_closure.py``),
rendered once by the JAX package. The JAX tests run on eight virtual CPU
devices, where ``overlap_backend=True`` keeps the worker; the port counts
the devices of its own type, one CPU, so these tests pass ``"force"``, and
``True`` on the CPU is the single-device case: a warning and the
synchronous back-end.

When a fold lands depends on the threads' timing, so the overlapped run is
held to the JAX tests' gates, not to bits: closures, pose graph and BA ran,
every future drained, ATE < max(1.25 x the synchronous run's, 0.25 m) and
< 0.5 m. ``test_torch_overlap_replay.py`` holds the worker's computation
itself against the JAX package's, in a deterministic replay.
"""

import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch

from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS as TPARAMS
from svi_mapper_tpu_torch.eval import trajectory as ev
from svi_mapper_tpu_torch.models import slam as tslam

import torch_parity as tp
from test_torch_slam import LOOP, LOOP_KW

N_FRAMES = 72


@pytest.fixture(scope="module")
def world():
    seq = jsyn.SyntheticSequence(**dict(LOOP, n_frames=N_FRAMES))
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    L = np.stack([np.asarray(f[0]) for f in frames])
    R = np.stack([np.asarray(f[1]) for f in frames])
    return seq, tp.torch_camera(seq.cam), L, R


def _run(world, overlap) -> tslam.SLAMSystem:
    seq, cam, L, R = world
    s = tslam.SLAMSystem(cam, dataclasses.replace(TPARAMS, **LOOP_KW),
                         enable_local_ba=True, enable_loop_closure=True,
                         overlap_backend=overlap, device="cpu")
    s.process_many(L, R, chunk=16)
    s.finalize_backend()      # drain the worker + the closure waiting queue
    return s


@pytest.fixture(scope="module")
def runs(world):
    out = {"overlap": _run(world, "force"), "sync": _run(world, False)}
    yield out
    for s in out.values():
        s.close()


def test_overlap_closes_the_loop(runs):
    s = runs["overlap"]
    assert s._bk_pool is not None
    assert s.stats["closures_accepted"] >= 1
    assert s.stats["pose_graph_runs"] >= 1
    assert s.stats["ba_runs"] >= 1
    # the worker queue drained and every future completed without error
    assert not s._bk_futures
    assert s._bk_folds.empty()
    assert s._fold_version >= s.stats["pose_graph_runs"]


def test_overlap_accuracy_matches_sync(runs, world):
    """Overlapping must not cost accuracy: the optimised ATE stays in the
    synchronous run's band on the same loop."""
    seq = world[0]
    gt = seq.poses_wc[:N_FRAMES]
    ate_ov = ev.evaluate(runs["overlap"].optimized_trajectory(), gt).ate_rmse_m
    ate_sy = ev.evaluate(runs["sync"].optimized_trajectory(), gt).ate_rmse_m
    assert np.isfinite(ate_ov) and np.isfinite(ate_sy)
    assert ate_ov < max(1.25 * ate_sy, 0.25)
    assert ate_ov < 0.5


def test_overlap_keyframes_sane(runs):
    s = runs["overlap"]
    assert len(s.slam_keyframes) >= 8
    for kf in s.slam_keyframes:
        assert np.isfinite(kf.T_wc).all()
        R = kf.T_wc[:3, :3]
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
        # overlap mode records snapshot positions for worker-side BA inits
        assert kf.obs_pos.shape == (len(kf.obs_uids), 3)
    assert s.db.n == len(s.slam_keyframes)


def test_overlap_single_device_falls_back_to_sync(world):
    """One visible device of the system's type (here the CPU): True warns
    and runs synchronously; 'force' keeps the worker."""
    cam = world[1]
    with pytest.warns(UserWarning, match="single visible device"):
        s = tslam.SLAMSystem(cam, TPARAMS, overlap_backend=True, device="cpu")
    assert s._bk_pool is None            # synchronous
    s.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s2 = tslam.SLAMSystem(cam, TPARAMS, overlap_backend="force", device="cpu")
    assert s2._bk_pool is not None       # worker kept on request
    s2.close()
    assert tslam._devices_of_type(torch.device("cpu")) == 1


def test_overlap_rejects_async_closure_combo(world):
    with pytest.raises(ValueError, match="subsumed"):
        tslam.SLAMSystem(world[1], TPARAMS, overlap_backend="force",
                         async_closure=True, device="cpu")


def test_overlap_per_frame_mode(world):
    """The per-frame process() path also routes keyframes through the
    worker and folds at keyframe boundaries; the keyframe tail ran on the
    worker thread."""
    _, cam, L, R = world
    s = tslam.SLAMSystem(cam, dataclasses.replace(TPARAMS, **LOOP_KW),
                         enable_local_ba=True, enable_loop_closure=True,
                         overlap_backend="force", device="cpu")
    threads = set()
    handle = s._handle_keyframe

    def handling(**kw):
        threads.add(threading.current_thread().name)
        return handle(**kw)

    s._handle_keyframe = handling
    for i in range(36):                  # keyframes at frames 5 and 33-35
        s.process(L[i], R[i])
    s.flush_backend()
    assert len(s.slam_keyframes) >= 2
    assert np.isfinite(s.trajectory_array).all()
    assert threads == {"backend_0"}
    s.close()


def test_worker_exception_reraises(world):
    s = tslam.SLAMSystem(world[1], TPARAMS, overlap_backend="force", device="cpu")

    def failing(payload):
        raise RuntimeError("planted back-end failure")

    s._bk_futures.append(s._bk_pool.submit(failing, {}))
    with pytest.raises(RuntimeError, match="planted"):
        s.flush_backend()
    s._bk_futures = []
    s.close()
