"""Checkpoint / resume of the port (``io/checkpoint.py``), mirroring
``tests/test_checkpoint.py``, and the same file read across the two packages.

The port's own round trip is exact: a tracker resumed from its checkpoint
continues with the same bits as the uninterrupted one (one package, one
device). Across the packages the file is the same format key for key and
dtype for dtype; a checkpoint written by either resumes in the other, and
over the next three frames the two agree on every integer field of the frame
state and on the recorded poses within 1e-5 m (the JAX test's own ``atol``;
found 2.1e-6 m). The stereo-inertial tracker's poses are held within 5e-4 m:
its prior integrates the velocity, the float32 log of the last pose step,
and where that step turns between 1e-4 and 1e-2 rad the JAX package's
``log_se3`` has no digits left (ROADMAP F6: 3.4e-3 m/s off, 1.7e-4 m over
one 0.05 s frame); found 1.9e-4 m at the third resumed frame, the integer
state equal. F12: the in-run BoW vocabulary is not stored; after a load both packages
retrain the same vocabulary at the next keyframe.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.imu import interpolator as j_imu
from svi_mapper_tpu.io import checkpoint as jck
from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu.models.slam import SLAMSystem as JSLAM
from svi_mapper_tpu.models.svi import StereoInertialTracker as JSVI
from svi_mapper_tpu.models.tracker import StereoTracker as JTracker
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.io import checkpoint as ck
from svi_mapper_tpu_torch.models.slam import ClosureEdge, SLAMKeyframe, SLAMSystem
from svi_mapper_tpu_torch.models.svi import StereoInertialTracker
from svi_mapper_tpu_torch.models.tracker import StereoTracker
from svi_mapper_tpu_torch.utils.errors import InvalidFileError

from test_imu import _fine_trajectory
from torch_parity import state_dict, torch_camera

CPU = "cpu"
W, H, N_RUN, N_MORE = 256, 192, 5, 3
CAPS = dict(max_landmarks=128, max_detections=128, max_measurements=8)
PARAMS = dataclasses.replace(DEFAULT_PARAMS, **CAPS)
JP = dataclasses.replace(JPARAMS, **CAPS)
POSE_ATOL = {"tracker": 1e-5, "slam": 1e-5, "svi": 5e-4}
SUB, DT_FINE = 10, 0.005
KINDS = ("tracker", "slam", "svi")


# ---------------------------------------------------------------------------
# fixtures: the same frames (the JAX package's renderer) for both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    jseq = jsyn.SyntheticSequence(n_frames=N_RUN + N_MORE, width=W, height=H, step=0.35)
    frames = [(np.asarray(L), np.asarray(R), T) for L, R, T in jseq]
    fine = _fine_trajectory(N_RUN + N_MORE, SUB, DT_FINE)
    calib0 = j_imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3), bias_accel=np.zeros(3),
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200)
    omega, accel = j_imu.synthesize_measurements(fine, DT_FINE, calib=calib0, seed=1)
    svi_frames = [tuple(np.asarray(x) for x in jsyn.render_stereo(jseq.cam, jnp.asarray(T)))
                  for T in fine[::SUB][:N_RUN + N_MORE]]
    blocks = [(np.full(SUB, DT_FINE, np.float32), omega[i * SUB:(i + 1) * SUB],
               accel[i * SUB:(i + 1) * SUB]) for i in range(N_RUN + N_MORE)]
    return dict(jcam=jseq.cam, cam=torch_camera(jseq.cam), frames=frames,
                svi_frames=svi_frames, blocks=blocks, calib=calib0)


def _jax_tracker(kind, world):
    if kind == "tracker":
        return JTracker(world["jcam"], JP)
    if kind == "slam":
        return JSLAM(world["jcam"], JP, enable_local_ba=False)
    return JSVI(world["jcam"], world["calib"], JP, equalize=False,
                enable_loop_closure=False, enable_local_ba=False)


def _port_tracker(kind, world):
    if kind == "tracker":
        return StereoTracker(world["cam"], PARAMS, device=CPU)
    if kind == "slam":
        return SLAMSystem(world["cam"], PARAMS, enable_local_ba=False, device=CPU)
    return StereoInertialTracker(
        world["cam"], convert.imu_calibration_from_numpy(world["calib"]), PARAMS,
        equalize=False, enable_loop_closure=False, enable_local_ba=False, device=CPU)


def _step(tracker, kind, world, i):
    if kind == "svi":
        L, R = world["svi_frames"][i]
        return tracker.process_imu_samples(L, R, *world["blocks"][i])
    L, R, _ = world["frames"][i]
    return tracker.process(L, R)


def _run(tracker, kind, world, lo, hi):
    for i in range(lo, hi):
        _step(tracker, kind, world, i)
    return tracker


def _ints(state: dict) -> dict:
    """The integer and boolean fields of a frame-state dictionary (packed
    descriptors included: their bits are integers)."""
    out = {k: np.asarray(state[k]) for k in ("next_uid", "frame_idx", "instability")}
    out.update({f"table.{k}": v for k, v in state["table"].items()
                if v.dtype.kind in "biu"})
    return out


def _assert_ints_equal(a: dict, b: dict) -> None:
    ia, ib = _ints(a), _ints(b)
    assert ia.keys() == ib.keys()
    for k in ia:
        np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_files(world, tmp_path_factory):
    """Per kind: a JAX checkpoint after N_RUN frames, and the JAX tracker's
    state and trajectory after N_MORE more."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    out = {}
    for kind in KINDS:
        jt = _run(_jax_tracker(kind, world), kind, world, 0, N_RUN)
        path = d / f"{kind}.npz"
        jck.save_checkpoint(path, jt)
        _run(jt, kind, world, N_RUN, N_RUN + N_MORE)
        out[kind] = (path, state_dict(jt.state), np.stack(jt.trajectory))
    return out


def _file(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rewrite(path, arrays: dict, meta: dict) -> None:
    arrays = dict(arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def _meta(arrays: dict) -> dict:
    return json.loads(bytes(arrays["__meta__"]).decode())


# ---------------------------------------------------------------------------
# the port on its own (mirrors tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _port_state_equal(a, b):
    sa, sb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for f in ("T_wc", "T_wc_prev", "T_last_keyframe", "next_uid", "frame_idx",
              "instability"):
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f"state.{f}")
    for f, v in sa["table"].items():
        np.testing.assert_array_equal(v, sb["table"][f], err_msg=f"table.{f}")


@pytest.mark.parametrize("kind", ["tracker", "slam"])
def test_checkpoint_roundtrip_and_resume(tmp_path, world, kind):
    tr = _run(_port_tracker(kind, world), kind, world, 0, N_RUN)
    path = tmp_path / "ckpt.npz"
    ck.save_checkpoint(path, tr)
    tr2 = ck.load_checkpoint(path, device=CPU)

    assert type(tr2) is type(tr)
    assert tr2.frame_count == tr.frame_count
    assert tr2.params == tr.params
    _port_state_equal(tr.state, tr2.state)
    np.testing.assert_array_equal(np.stack(tr.trajectory), np.stack(tr2.trajectory))
    if kind == "slam":
        assert len(tr2.slam_keyframes) == len(tr.slam_keyframes)
        assert tr2.db.n == tr.db.n
        for f in ("desc", "p_cam", "valid", "count", "T_wc", "prob"):
            assert np.array_equal(getattr(tr2.db, f).numpy(), getattr(tr.db, f).numpy()), f
        assert tr2.db.count_host == tr.db.count_host
        np.testing.assert_array_equal(tr2.db.T_wc_host, tr.db.T_wc_host)
        assert tr2.stats == tr.stats
    else:
        assert len(tr2.keyframes) == len(tr.keyframes)
        for a, b in zip(tr.keyframes, tr2.keyframes):
            np.testing.assert_array_equal(a.descriptors, b.descriptors)

    # one package, one device: the resumed tracker continues with the same bits
    _run(tr, kind, world, N_RUN, N_RUN + N_MORE)
    _run(tr2, kind, world, N_RUN, N_RUN + N_MORE)
    np.testing.assert_array_equal(np.stack(tr.trajectory), np.stack(tr2.trajectory))
    _port_state_equal(tr.state, tr2.state)


def test_checkpoint_svi_roundtrip(tmp_path):
    """The SVI tracker's IMU state (calibration, velocity, gravity
    observations, rectify maps) survives checkpoint/resume (a mini EuRoC
    folder written by the JAX package's test helper)."""
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io.euroc import EurocSequence

    from test_euroc import _write_mini_euroc

    _write_mini_euroc(tmp_path / "ds")
    seq = EurocSequence(tmp_path / "ds", device=CPU)
    static = seq.static_imu_window(0.3)
    calib = imu.calibrate(static[:, 1:4], static[:, 4:7], device=CPU)
    tr = StereoInertialTracker(seq.cam, calib, PARAMS, rectify_maps=seq.rectify_maps,
                               enable_loop_closure=False, enable_local_ba=False,
                               device=CPU)
    prev_t = None
    for (t, L, R, imu_rows) in seq:
        dt = (t - prev_t) if prev_t is not None else 0.05
        prev_t = t
        om = imu_rows[:, 1:4].mean(0) if len(imu_rows) else np.zeros(3)
        ac = imu_rows[:, 4:7].mean(0) if len(imu_rows) else np.zeros(3)
        tr.process_imu(L, R, om, ac, dt)
    tr.gravity_obs.append(np.array([0, -1, 0], np.float32))

    path = tmp_path / "svi.npz"
    ck.save_checkpoint(path, tr)
    tr2 = ck.load_checkpoint(path, device=CPU)
    assert type(tr2) is StereoInertialTracker
    assert np.array_equal(tr2.velocity.numpy(), tr.velocity.numpy())
    for f in ("bias_gyro", "R_imu_to_world", "bias_accel", "noise_gyro", "noise_accel"):
        np.testing.assert_array_equal(getattr(tr2.calib, f), getattr(tr.calib, f))
    np.testing.assert_array_equal(np.stack(tr2.gravity_obs), np.stack(tr.gravity_obs))
    np.testing.assert_array_equal(tr2.T_cam_imu, tr.T_cam_imu)
    assert tr2.rectify_maps is not None
    for a, b in zip(tr2.rectify_maps, tr.rectify_maps):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _port_state_equal(tr.state, tr2.state)
    # the resumed tracker keeps processing
    tr2.process_imu(np.zeros((48, 64), np.float32), np.zeros((48, 64), np.float32),
                    np.zeros(3), np.zeros(3), 0.05)
    assert tr2.frame_count == tr.frame_count + 1


def _queued_system():
    """A fabricated drifting loop: 12 keyframes walking +z with a small
    per-step drift in x; the closure says kf11 coincides with kf0, queued
    (trigger not yet fired)."""
    s = SLAMSystem(_small_port_camera(), PARAMS, enable_local_ba=False,
                   enable_loop_closure=True, device=CPU)
    for k in range(12):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.05 * k
        T[2, 3] = -(k % 6)
        s.slam_keyframes.append(SLAMKeyframe(
            index=k, frame_idx=4 * k, T_wc=T, obs_uids=np.zeros(0, np.int64),
            obs_uv4=np.zeros((0, 4), np.float32), pool_uids=np.zeros(0, np.int64)))
    edge = ClosureEdge(ref_kf=0, query_kf=11, T_qr=np.eye(4, dtype=np.float32),
                       accepted=True, uid_pairs=np.array([[7, 3], [9, 4]], np.int64))
    s.accepted_closures.append(edge)
    s.closure_candidates.append(edge)
    s._closure_kfs_in_queue = 2
    s._closure_opt_lo = 0
    s._last_closure_opt_kf = 1
    s._kf_since_local_ba = 3
    return s


def _small_port_camera():
    from svi_mapper_tpu_torch.io.synthetic import default_camera

    return default_camera(128, 96, device=CPU)


def test_checkpoint_mid_closure_queue(tmp_path):
    """A checkpoint taken with closures QUEUED resumes with the pending
    reconciliation intact: ``finalize_backend()`` after reload gives the same
    optimised keyframe chain as the uninterrupted run, and restored edges
    keep their uid pairs."""
    ref = _queued_system()
    ref.finalize_backend()
    assert ref.stats["pose_graph_runs"] == 1
    T_ref = np.stack([k.T_wc for k in ref.slam_keyframes])

    s = _queued_system()
    path = tmp_path / "midq.npz"
    ck.save_checkpoint(path, s)
    s2 = ck.load_checkpoint(path, device=CPU)
    assert s2._closure_kfs_in_queue == 2
    assert s2._closure_opt_lo == 0
    assert s2._last_closure_opt_kf == 1
    assert s2._kf_since_local_ba == 3
    assert len(s2.accepted_closures) == 1
    np.testing.assert_array_equal(s2.accepted_closures[0].uid_pairs,
                                  np.array([[7, 3], [9, 4]], np.int64))
    assert s2.accepted_closures[0].suppressed is False
    s2.finalize_backend()
    assert s2.stats["pose_graph_runs"] == 1
    np.testing.assert_array_equal(np.stack([k.T_wc for k in s2.slam_keyframes]), T_ref)
    assert s2._closure_kfs_in_queue == 0 and ref._closure_kfs_in_queue == 0


def test_checkpoint_rejects_future_version(tmp_path, world):
    tr = StereoTracker(world["cam"], PARAMS, device=CPU)
    path = tmp_path / "c.npz"
    ck.save_checkpoint(path, tr)
    arrays = _file(path)
    meta = _meta(arrays)
    meta["version"] = 99
    _rewrite(path, arrays, meta)
    with pytest.raises(InvalidFileError, match="version"):
        ck.load_checkpoint(path, device=CPU)
    with pytest.raises(ValueError, match="version"):      # as the JAX reader
        ck.load_checkpoint(path, device=CPU)


def test_load_defaults_to_cuda(tmp_path, world):
    """``device=None`` means CUDA: without a card the load raises."""
    import torch

    path = tmp_path / "c.npz"
    ck.save_checkpoint(path, StereoTracker(world["cam"], PARAMS, device=CPU))
    if torch.cuda.is_available():
        assert ck.load_checkpoint(path).state.T_wc.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.load_checkpoint(path)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_resumes_in_port(jax_files, world, kind):
    path, j_state, j_traj = jax_files[kind]
    tr = ck.load_checkpoint(path, device=CPU)
    assert type(tr).__name__ == {"tracker": "StereoTracker", "slam": "SLAMSystem",
                                 "svi": "StereoInertialTracker"}[kind]
    assert tr.frame_count == N_RUN
    # the load itself: every state field the file holds, bit for bit
    arrays = _file(path)
    got = convert.state_to_numpy(tr.state)
    for f in ck._STATE_FIELDS:
        np.testing.assert_array_equal(got[f], arrays[f"state__{f}"], err_msg=f)
    for f, v in got["table"].items():
        np.testing.assert_array_equal(v, arrays[f"table__{f}"], err_msg=f)
    # the next frames: integer state bit for bit, poses to the JAX test's atol
    _run(tr, kind, world, N_RUN, N_RUN + N_MORE)
    _assert_ints_equal(convert.state_to_numpy(tr.state), j_state)
    np.testing.assert_allclose(np.stack(tr.trajectory), j_traj, rtol=0,
                               atol=POSE_ATOL[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_resumes_in_jax(tmp_path, world, kind):
    tr = _run(_port_tracker(kind, world), kind, world, 0, N_RUN)
    path = tmp_path / f"{kind}.npz"
    ck.save_checkpoint(path, tr)
    jt = jck.load_checkpoint(path)
    assert type(jt).__name__ == type(tr).__name__
    np.testing.assert_array_equal(np.asarray(jt.state.table.desc_hist),
                                  convert.table_to_numpy(tr.state.table)["desc_hist"])
    if kind == "svi":
        np.testing.assert_array_equal(np.asarray(jt.velocity), tr.velocity.numpy())
    _run(tr, kind, world, N_RUN, N_RUN + N_MORE)
    _run(jt, kind, world, N_RUN, N_RUN + N_MORE)
    _assert_ints_equal(convert.state_to_numpy(tr.state), state_dict(jt.state))
    np.testing.assert_allclose(np.stack(tr.trajectory), np.stack(jt.trajectory),
                               rtol=0, atol=POSE_ATOL[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_writers_same_keys_and_dtypes(tmp_path, jax_files, kind):
    """The port writes what the JAX package writes: a JAX checkpoint loaded
    by the port and saved again has the same keys, dtypes, shapes and values
    (the manifest equal as JSON)."""
    path = jax_files[kind][0]
    again = tmp_path / "again.npz"
    ck.save_checkpoint(again, ck.load_checkpoint(path, device=CPU))
    a, b = _file(path), _file(again)
    assert sorted(a) == sorted(b)
    assert _meta(a) == _meta(b)
    for k in a:
        if k == "__meta__":
            continue
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("key", ["db_native_index", "async_closure"])
def test_unported_options_raise(tmp_path, jax_files, key):
    """A JAX checkpoint of a system run with the native index or the closure
    worker loads with that option on (the index rebuilt from the stored
    pools: one entry per valid pool slot), saves it again, and without a
    device raises for want of CUDA."""
    arrays = _file(jax_files["slam"][0])
    meta = _meta(arrays)
    meta["slam"][key] = True
    path = tmp_path / "opt.npz"
    _rewrite(path, arrays, meta)
    t = ck.load_checkpoint(path, device=CPU)
    try:
        if key == "db_native_index":
            n = meta["slam"]["db_n"]
            assert t.db.index is not None
            assert t.db.index.size == int(arrays["db__valid"][:n].sum())
            assert t._closure_pool is None
        else:
            assert t._closure_pool is not None and t.db.index is None
        ck.save_checkpoint(tmp_path / "again.npz", t)
        assert _meta(_file(tmp_path / "again.npz"))["slam"][key] is True
    finally:
        t.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.load_checkpoint(path)


@pytest.mark.parametrize("option", ["native_index", "async_closure"])
def test_option_checkpoints_cross(tmp_path, world, option):
    """A system run with the native index or the closure worker, saved by
    one package and loaded by the other, both ways: the option comes back
    (the index rebuilt from the stored pools, the same descriptors stored),
    and the loaded system carries on as the saved one does. Keyframes are
    made easier to spawn (at frames 4 and 7), so that one is in the file and
    one comes after."""
    kw = {option: True}
    easy = dict(keyframe_translation_m2=1.0, keyframe_min_landmarks=8)
    for writer in ("port", "jax"):
        if writer == "port":
            src = SLAMSystem(world["cam"], dataclasses.replace(PARAMS, **easy),
                             enable_local_ba=False, device=CPU, **kw)
        else:
            src = JSLAM(world["jcam"], dataclasses.replace(JP, **easy),
                        enable_local_ba=False, **kw)
        _run(src, "slam", world, 0, N_RUN)
        path = tmp_path / f"{writer}_{option}.npz"
        (ck if writer == "port" else jck).save_checkpoint(path, src)
        assert _meta(_file(path))["slam"][
            "db_native_index" if option == "native_index" else option] is True
        dst = (jck.load_checkpoint(path) if writer == "port"
               else ck.load_checkpoint(path, device=CPU))
        assert src.db.n == dst.db.n >= 1
        if option == "native_index":
            assert dst.db.index is not None and dst.db.index.size == src.db.index.size
            assert dst.db.bow is None and src.db.bow is None
        else:
            assert dst._closure_pool is not None
        _run(src, "slam", world, N_RUN, N_RUN + N_MORE)
        _run(dst, "slam", world, N_RUN, N_RUN + N_MORE)
        for s in (src, dst):
            s.flush_closures(block=True)
        port, jax_ = (src, dst) if writer == "port" else (dst, src)
        _assert_ints_equal(convert.state_to_numpy(port.state), state_dict(jax_.state))
        np.testing.assert_allclose(np.stack(port.trajectory), np.stack(jax_.trajectory),
                                   rtol=0, atol=POSE_ATOL["slam"])
        assert port.db.n == jax_.db.n == 2
        assert port.stats["closures_found"] == jax_.stats["closures_found"]
        if option == "native_index":
            assert port.db.index.size == jax_.db.index.size
        src.close()
        dst.close()


def test_reads_v1_edges_and_pre_ring_tables(tmp_path, jax_files):
    """The JAX reader's two compatibility paths: v1 closure edges (3
    columns, no uid pairs) and a table from before the descriptor ring
    (``desc_left_ref`` broadcast into ``desc_hist``). Both packages read the
    same edited file to the same state."""
    arrays = _file(jax_files["slam"][0])
    meta = _meta(arrays)
    meta["version"] = 1
    for k in ("table__desc_hist", "table__hist_next"):
        arrays.pop(k)
    T = np.eye(4, dtype=np.float32)
    arrays["cl__acc__ij"] = np.array([[0, 1, 1]], np.int64)
    arrays["cl__acc__T"] = T[None]
    path = tmp_path / "v1.npz"
    _rewrite(path, arrays, meta)
    tr = ck.load_checkpoint(path, device=CPU)
    jt = jck.load_checkpoint(path)
    ref = arrays["table__desc_left_ref"]
    hist = convert.table_to_numpy(tr.state.table)["desc_hist"]
    np.testing.assert_array_equal(hist, np.broadcast_to(ref[:, None], hist.shape))
    np.testing.assert_array_equal(hist, np.asarray(jt.state.table.desc_hist))
    assert not tr.state.table.hist_next.any()
    (e,) = tr.accepted_closures
    assert (e.ref_kf, e.query_kf, e.accepted, e.suppressed) == (0, 1, True, False)
    assert e.uid_pairs.shape == (0, 2)
    assert jt.accepted_closures[0].uid_pairs.shape == (0, 2)


def test_vocabulary_retrained_alike_after_load(tmp_path, jax_files):
    """F12: the vocabulary is not in the file. A database loaded with
    ``n >= vocab_train_at`` pools trains a new one at its next add, over all
    stored pools, in both packages alike (the same words)."""
    from svi_mapper_tpu_torch.ops.descriptors import words_to_numpy

    rng = np.random.default_rng(12)
    arrays = _file(jax_files["slam"][0])
    meta = _meta(arrays)
    n, P = 8, arrays["db__desc"].shape[1]
    counts = rng.integers(20, P, n).astype(np.int32)
    desc = rng.integers(0, 2 ** 32, arrays["db__desc"].shape, dtype=np.uint64).astype(np.uint32)
    valid = np.arange(P)[None, :] < np.concatenate(
        [counts, np.zeros(len(desc) - n, np.int32)])[:, None]
    arrays.update(db__desc=desc * valid[..., None], db__valid=valid,
                  db__count=np.where(np.arange(len(desc)) < n,
                                     np.pad(counts, (0, len(desc) - n)), 0).astype(np.int32))
    meta["slam"]["db_n"] = n
    path = tmp_path / "vocab.npz"
    _rewrite(path, arrays, meta)
    tr = ck.load_checkpoint(path, device=CPU)
    jt = jck.load_checkpoint(path)
    assert tr.db.bow is None and jt.db.bow is None
    pool = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    p_cam = rng.normal(size=(40, 3)).astype(np.float32)
    tr.db.add(pool, p_cam, np.eye(4, dtype=np.float32))
    jt.db.add(pool, p_cam, np.eye(4, dtype=np.float32))
    assert tr.db.bow is not None and jt.db.bow is not None
    for a, b in zip(tr.db.bow.vocab.centroids, jt.db.bow.vocab.centroids):
        np.testing.assert_array_equal(words_to_numpy(a), np.asarray(b))
    np.testing.assert_allclose(tr.db.bow.vectors[: n + 1].numpy(),
                               np.asarray(jt.db.bow.vectors)[: n + 1], rtol=1e-6, atol=1e-7)
