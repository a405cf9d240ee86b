"""``SLAMSystem`` of the port against the JAX package's.

Three layers:

* the host logic on fabricated keyframes (triggers, veto, dedup, queue
  drain, BA back-off, union-find, ``_apply_canon_to_live``,
  ``_assemble_ba_window``): the same calls into both packages, decisions and
  ``stats`` equal;
* the rigid corrections (``_apply_world_correction``,
  ``_attach_live_to_keyframe``, ``_world_shift``) on a state converted from
  the JAX package: 1e-5 on poses and positions of metres;
* the slice as a whole on a small loop rendered once by the JAX package and
  fed to both as numpy (80 frames of 384 x 192, 384 landmarks, a loop of
  9 m radius driven 1.15 times, ``closure_exclude_recent`` lowered to 8 so
  that the short loop revisits), through ``process_many`` -> ``finalize_backend``
  -> ``optimized_trajectory``. Both run with ``use_gt_pose=True``: at this
  size the loop turns 5 degrees a frame, the free-running pose solve is
  rejected on several frames in either package, and two float32 front-ends
  then part ways within 40 frames, so that nothing downstream could be held
  equal. With the pose given, everything else still runs (tracking,
  landmark refinement, keyframe decisions, snapshots, DB add, closure query,
  consensus, pose graph, BA and its write-backs) and is held to: the same
  keyframe frames, the same accepted ``(ref_kf, query_kf)`` edges, the same
  closure, pose-graph and BA counts, descriptor pools bit-equal, closure
  transforms to 2e-2. The optimised trajectories agree to 0.15 m and each
  lies within 0.3 m of the ground truth: the two packages' ``log_se3``
  differ for rotations of 1e-4..1e-3 rad (the JAX package's is wrong there
  in float32), and pose-graph and odometry-chain residuals converge into
  that range, so LM steps are accepted differently.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu.mapping import closure as jclosure
from svi_mapper_tpu.models import slam as jslam
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS as TPARAMS
from svi_mapper_tpu_torch.io import synthetic as tsyn
from svi_mapper_tpu_torch.mapping import closure as tclosure
from svi_mapper_tpu_torch.models import slam as tslam

import torch_parity as tp


def _systems(**kw):
    j = jslam.SLAMSystem(jsyn.default_camera(128, 64), JPARAMS, **kw)
    t = tslam.SLAMSystem(tsyn.default_camera(128, 64, device="cpu"), TPARAMS,
                         device="cpu", **kw)
    return j, t


def _push_keyframe(s, mod, rng=None, n_obs=0):
    k = len(s.slam_keyframes)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.5 * k
    kw = {}
    if n_obs:
        uids = np.sort(rng.choice(200, n_obs, replace=False)).astype(np.int64)
        kw = dict(obs_uids=uids, obs_uv4=rng.uniform(0, 100, (n_obs, 4)).astype(np.float32),
                  pool_uids=uids[: n_obs // 2],
                  obs_pos=rng.normal(size=(n_obs, 3)).astype(np.float32))
    else:
        kw = dict(obs_uids=np.zeros(0, np.int64), obs_uv4=np.zeros((0, 4), np.float32),
                  pool_uids=np.zeros(0, np.int64))
    s.slam_keyframes.append(mod.SLAMKeyframe(index=k, frame_idx=4 * k, T_wc=T, **kw))


def _counted(s, monkeypatch):
    """Replace the expensive stages by call counters that keep the real
    methods' bookkeeping."""
    calls = {"full": 0, "local": 0, "pg": 0}

    def fake_full():
        calls["full"] += 1
        if s._closure_kfs_in_queue > 0:
            calls["pg"] += 1
            s._last_closure_opt_kf = len(s.slam_keyframes) - 1
        s._last_opt_kf = len(s.slam_keyframes)
        s._closure_kfs_in_queue = 0
        s._closure_opt_lo = None

    monkeypatch.setattr(s, "_run_queued_optimization", fake_full)
    monkeypatch.setattr(s, "_local_ba",
                        lambda: calls.__setitem__("local", calls["local"] + 1))
    return calls


# one scripted keyframe stream per case: (instability, motion scaling,
# closure accepted at this keyframe)
STREAMS = {
    "delta_trigger": [(0, 1.0, False)] * 45,
    "closure_burst": [(0, 1.0, False)] * 25 + [(0, 1.0, True)] * 5 + [(0, 1.0, False)] * 10,
    "instability_veto": [(5, 1.0, False)] * 25 + [(0, 1.0, False)] * 3,
    "motion_veto": [(0, 2.0, False)] * 25 + [(0, 1.0, False)] * 3,
    "mixed": [(i % 7 == 3 and 2 or 0, 1.0 + 0.1 * (i % 9), i % 11 == 5)
              for i in range(60)],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_trigger_decisions_equal(monkeypatch, name):
    j, t = _systems(local_ba_every=4)
    cj, ct = _counted(j, monkeypatch), _counted(t, monkeypatch)
    for inst, ms, closed in STREAMS[name]:
        for s, mod in ((j, jslam), (t, tslam)):
            _push_keyframe(s, mod)
            if closed:
                s._closure_kfs_in_queue += 1
                s._closure_opt_lo = 2
            s._maybe_trigger_backend(instability=inst, motion_scaling=ms)
        assert ct == cj
        assert (t._closure_kfs_in_queue, t._last_opt_kf, t._last_closure_opt_kf,
                t._kf_since_local_ba) == (
            j._closure_kfs_in_queue, j._last_opt_kf, j._last_closure_opt_kf,
            j._kf_since_local_ba)
    assert t.stats == j.stats
    if name == "delta_trigger":
        assert ct == {"full": 2, "local": ct["local"], "pg": 0} and ct["local"] >= 8
    if name == "closure_burst":
        assert ct["pg"] == 1
    if name.endswith("veto"):
        assert ct["full"] == 1 and t.stats["ba_vetoed"] > 0
    j.finalize_backend()
    t.finalize_backend()
    assert ct == cj and t._closure_kfs_in_queue == 0


def test_ba_failure_backs_off_and_retains_queue(monkeypatch):
    j, t = _systems()
    attempts = {"j": 0, "t": 0}
    for key, s in (("j", j), ("t", t)):
        def failing(lo=None, key=key):
            attempts[key] += 1
            return False
        monkeypatch.setattr(s, "_incremental_ba", failing)
        monkeypatch.setattr(s, "_optimize_pose_graph", lambda: None)
    for step in range(28):
        for s, mod in ((j, jslam), (t, tslam)):
            _push_keyframe(s, mod)
            if step == 22:
                s._closure_kfs_in_queue, s._closure_opt_lo = 2, 3
            s._maybe_trigger_backend(instability=0)
        assert attempts["t"] == attempts["j"]
    assert t._closure_kfs_in_queue == j._closure_kfs_in_queue == 2
    assert t._closure_opt_lo == j._closure_opt_lo == 3
    assert t.stats == j.stats and t.stats["closure_opt_deferred"] >= 1


def _cand(mod, q, r, T=None, pairs=None):
    return mod.ClosureCandidate(
        query_kf=q, ref_kf=r, T_qr=np.eye(4, dtype=np.float32) if T is None else T,
        inliers=30, matches=40,
        pairs=np.zeros((0, 2), np.int32) if pairs is None else pairs)


def test_closure_dedup_and_consensus_equal(rng):
    j, t = _systems(enable_local_ba=False)
    for _ in range(40):
        _push_keyframe(j, jslam, np.random.default_rng(len(j.slam_keyframes)), 30)
        _push_keyframe(t, tslam, np.random.default_rng(len(t.slam_keyframes)), 30)
    off = np.eye(4, dtype=np.float32)
    off[0, 3] = 3.0                                     # disagrees with the rest
    pairs = np.stack([np.arange(10), np.arange(10)], -1).astype(np.int32)
    script = [(q, [(q, q - 25, None)]) for q in range(30, 35)]
    script += [(36, [(36, 2, None), (36, 9, off), (36, 3, None)]),
               (38, [(38, 20, None)])]
    for kf_index, found in script:
        for s, cmod in ((j, jclosure), (t, tclosure)):
            s._apply_found_closures(
                [_cand(cmod, q, r, T, pairs) for q, r, T in found], kf_index)
        assert t.stats == j.stats
        assert [(c.ref_kf, c.query_kf) for c in t.accepted_closures] == [
            (c.ref_kf, c.query_kf) for c in j.accepted_closures]
        assert [(c.accepted, c.suppressed) for c in t.closure_candidates] == [
            (c.accepted, c.suppressed) for c in j.closure_candidates]
        assert (t._closure_kfs_in_queue, t._closure_opt_lo) == (
            j._closure_kfs_in_queue, j._closure_opt_lo)
    assert t.stats["closures_accepted"] >= 2 and t.stats["closures_deduped"] >= 4
    for a, b in zip(t.accepted_closures, j.accepted_closures):
        np.testing.assert_array_equal(a.uid_pairs, b.uid_pairs)
    assert t._uid_parent == j._uid_parent and t.stats.get("landmarks_merged", 0) > 0
    uids = np.arange(-1, 200, dtype=np.int64)
    np.testing.assert_array_equal(t._canon_uids(uids), j._canon_uids(uids))


def _give_table(j, t, rng, L=64):
    """The same fabricated landmark table in both systems."""
    uid = rng.permutation(300)[:L].astype(np.int32)
    uid[5] = uid[9]                                     # a duplicate identity
    active = rng.random(L) > 0.2
    meas = rng.integers(0, 9, L).astype(np.int32)
    pos = rng.normal(0, 5, (L, 3)).astype(np.float32)
    jt = j.state.table
    j.state = j.state.replace(table=jt.replace(
        uid=jnp.asarray(uid), active=jnp.asarray(active),
        meas_count=jnp.asarray(meas), pos_w=jnp.asarray(pos)))
    t.state = convert.state_from_numpy(tp.state_dict(j.state), device="cpu")
    return uid


def _params(L):
    return (dataclasses.replace(JPARAMS, max_landmarks=L, max_detections=L),
            dataclasses.replace(TPARAMS, max_landmarks=L, max_detections=L))


def _small_systems(L=64, **kw):
    pj, pt = _params(L)
    j = jslam.SLAMSystem(jsyn.default_camera(128, 64), pj, **kw)
    t = tslam.SLAMSystem(tsyn.default_camera(128, 64, device="cpu"), pt, device="cpu", **kw)
    return j, t


def test_apply_canon_to_live_equal(rng):
    j, t = _small_systems()
    uid = _give_table(j, t, rng)
    lut = {int(uid[3]): int(uid[7]), int(uid[20]): int(uid[7]), int(uid[30]): 1000}
    t._table_mirror = ("stale",)
    j._apply_canon_to_live(lut)
    t._apply_canon_to_live(lut)
    np.testing.assert_array_equal(t.state.table.uid.numpy(), np.asarray(j.state.table.uid))
    np.testing.assert_array_equal(t.state.table.active.numpy(),
                                  np.asarray(j.state.table.active))
    assert t._table_mirror is None          # the uids changed under the mirror
    canon = t.state.table.uid.numpy()[t.state.table.active.numpy()]
    assert len(np.unique(canon)) == len(canon)


def test_assemble_ba_window_equal(rng):
    j, t = _small_systems(L=256)
    _give_table(j, t, rng, L=256)
    for _ in range(6):
        _push_keyframe(j, jslam, np.random.default_rng(len(j.slam_keyframes)), 120)
        _push_keyframe(t, tslam, np.random.default_rng(len(t.slam_keyframes)), 120)
    for s in (j, t):
        s._uid_union(10, 4)
        s._uid_union(11, 4)
        s._excised_uids.update({20, 21})
    for K in (None, 8):
        a = j._assemble_ba_window(j.slam_keyframes, K)
        b = t._assemble_ba_window(t.slam_keyframes, K)
        assert a is not None and b is not None
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert b[1].shape[0] == 8 and b[1].shape[1] == 256
    assert t._assemble_ba_window(t.slam_keyframes[:1]) is None
    assert j._assemble_ba_window(j.slam_keyframes[:1]) is None
    assert [tslam.SLAMSystem._bucket(n, 8) for n in (2, 8, 9, 40, 65)] == [
        jslam.SLAMSystem._bucket(n, 8) for n in (2, 8, 9, 40, 65)] == [8, 8, 16, 64, 128]


def _assert_states_close(j, t, atol=1e-5):
    for name in ("T_wc", "T_wc_prev", "T_last_keyframe"):
        np.testing.assert_allclose(getattr(t.state, name).numpy(),
                                   np.asarray(getattr(j.state, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(t.state.table.pos_w.numpy(),
                               np.asarray(j.state.table.pos_w), atol=atol)
    np.testing.assert_allclose(t.state.table.meas_T_wc.numpy(),
                               np.asarray(j.state.table.meas_T_wc), atol=atol)
    np.testing.assert_allclose(t._corr_P, j._corr_P, atol=1e-9)
    np.testing.assert_allclose(t._corr_M, j._corr_M, atol=1e-9)


def test_rigid_corrections_equal(rng):
    j, t = _small_systems()
    _give_table(j, t, rng)
    T_old = tp.exp_se3_np(rng.normal(0, 0.3, 6)).astype(np.float32)
    T_new = (tp.exp_se3_np(rng.normal(0, 0.05, 6)) @ T_old).astype(np.float32)
    for s in (j, t):
        s._apply_world_correction(T_old, T_new)
    _assert_states_close(j, t)
    np.testing.assert_allclose(tslam.SLAMSystem._world_correction(T_old, T_new),
                               jslam.SLAMSystem._world_correction(T_old, T_new))
    for s in (j, t):
        s._attach_live_to_keyframe(T_old, T_new)
    _assert_states_close(j, t)
    # a world shift moves keyframes, the database and the accumulators too
    pools, _ = tp.keyframe_pools(seed=6, n_kf=3, pool=16)
    for s, mod in ((j, jslam), (t, tslam)):
        s.trajectory = [np.eye(4, dtype=np.float32)]
        for kf in pools:
            _push_keyframe(s, mod)
            s.db.add(kf["desc"], kf["p_cam"], kf["T_wc"])
        s._world_shift(np.array([10.0, -2.0, 30.0]))
    _assert_states_close(j, t)
    for a, b in zip(t.slam_keyframes, j.slam_keyframes):
        np.testing.assert_allclose(a.T_wc, b.T_wc, atol=1e-9)
    np.testing.assert_allclose(t.db.T_wc[:3].numpy(), np.asarray(j.db.T_wc[:3]), atol=1e-6)
    np.testing.assert_array_equal(t.db.poses_host()[:3], t.db.T_wc[:3].numpy())
    np.testing.assert_allclose(t.world_offset, j.world_offset)
    assert t.world_shifts == j.world_shifts == 1


def test_host_motion_scaling_equal(rng):
    for _ in range(5):
        A = tp.exp_se3_np(rng.normal(0, 0.3, 6))
        B = tp.exp_se3_np(rng.normal(0, 0.2, 6)) @ A
        assert tslam.SLAMSystem._host_motion_scaling(A, B, 5.0) == pytest.approx(
            jslam.SLAMSystem._host_motion_scaling(A, B, 5.0), abs=1e-12)


def test_ba_writeback_skips_rows_on_the_host(rng):
    """Rows that the JAX package drops with an out-of-range index are
    filtered before the write: same table afterwards."""
    j, t = _small_systems()
    _give_table(j, t, rng)
    L = 64
    slot = np.array([3, L, 7, 9, L, 11], np.int32)      # L = "skip this row"
    pos = rng.normal(size=(6, 3)).astype(np.float32)
    dead = np.array([L, 20, L], np.int32)
    jt = jslam._ba_writeback(j.state.table, jnp.asarray(slot), jnp.asarray(pos),
                             jnp.asarray(dead))
    keep, keep_d = slot < L, dead < L
    tt = tslam._ba_writeback(
        t.state.table, torch.from_numpy(slot[keep].astype(np.int64)),
        torch.from_numpy(pos[keep]), torch.from_numpy(dead[keep_d].astype(np.int64)))
    tp.assert_tables_equal(jt, tt)
    assert not bool(tt.active[20]) and int(tt.meas_count[7]) == 0
    assert torch.equal(t.state.table.pos_w, tp.t32(np.asarray(j.state.table.pos_w)))


def test_left_out_options_raise():
    """Each option of item 7c constructs and closes as in the JAX package:
    the closure worker, the back-end worker ("force"; True on the CPU, one
    device, warns and runs synchronously), the native index; both workers
    at once raise ValueError in both packages; without a device, CUDA is
    required."""
    cam = tsyn.default_camera(128, 64, device="cpu")
    s = tslam.SLAMSystem(cam, TPARAMS, device="cpu", async_closure=True)
    assert s._closure_pool is not None and s._bk_pool is None
    s.close()
    s.close()                                       # idempotent
    assert s._closure_pool is None
    s = tslam.SLAMSystem(cam, TPARAMS, device="cpu", overlap_backend="force")
    assert s._bk_pool is not None and s._closure_pool is None
    s.close()
    with pytest.warns(UserWarning, match="single visible device"):
        s = tslam.SLAMSystem(cam, TPARAMS, device="cpu", overlap_backend=True)
    assert s._bk_pool is None
    s = tslam.SLAMSystem(cam, TPARAMS, device="cpu", native_index=True)
    assert s.db.index is not None and s.db.index.size == 0
    for pkg, c in ((jslam, jsyn.default_camera(128, 64)), (tslam, cam)):
        kw = {} if pkg is jslam else {"device": "cpu"}
        with pytest.raises(ValueError, match="subsumed"):
            pkg.SLAMSystem(c, async_closure=True, overlap_backend="force", **kw)
    s = tslam.SLAMSystem(cam, TPARAMS, device="cpu")
    s.close()
    assert s._gravity_priors(3, 3) is None and s._gravity_ba_terms([], 8) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tslam.SLAMSystem(cam, TPARAMS, async_closure=True)


def test_keyframe_records_cross(rng):
    j, _ = _systems()
    for _ in range(3):
        _push_keyframe(j, jslam, rng, 12)
    recs = [{f.name: getattr(kf, f.name) for f in dataclasses.fields(kf)}
            for kf in j.slam_keyframes]
    kfs = convert.slam_keyframes_from_numpy(recs)
    assert all(isinstance(k, tslam.SLAMKeyframe) for k in kfs)
    back = convert.slam_keyframes_to_numpy(kfs)
    for a, b in zip(back, recs):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

LOOP = dict(n_frames=80, width=384, height=192, trajectory="loop", loop_radius=9.0)
LOOP_KW = dict(max_landmarks=384, max_detections=384, closure_exclude_recent=8,
               max_motion_scaling_for_optimization=2.5)


def _ate(est, gt):
    def centres(poses):
        poses = np.asarray(poses, np.float64)
        rel = poses @ np.linalg.inv(poses[0])
        return -np.einsum("nji,nj->ni", rel[:, :3, :3], rel[:, :3, 3])
    d = centres(est) - centres(gt)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


@pytest.fixture(scope="module")
def loop_runs():
    seq = jsyn.SyntheticSequence(**LOOP)
    frames = [seq.frame(i) for i in range(seq.n_frames)]
    L = np.stack([np.asarray(f[0]) for f in frames])
    R = np.stack([np.asarray(f[1]) for f in frames])
    j = jslam.SLAMSystem(seq.cam, dataclasses.replace(JPARAMS, **LOOP_KW),
                         use_gt_pose=True)
    t = tslam.SLAMSystem(tp.torch_camera(seq.cam), dataclasses.replace(TPARAMS, **LOOP_KW),
                         use_gt_pose=True, device="cpu")
    spawn = {}
    for name, s in (("j", j), ("t", t)):
        outs = s.process_many(L, R, T_gt=seq.poses_wc, chunk=16)
        s.finalize_backend()
        spawn[name] = outs
    return seq, j, t, spawn


def test_loop_keyframes_and_closures_equal(loop_runs):
    seq, j, t, outs = loop_runs
    assert [bool(o.is_keyframe) for o in outs["t"]] == [
        bool(o.is_keyframe) for o in outs["j"]]
    assert [int(o.n_tracked) for o in outs["t"]] == [int(o.n_tracked) for o in outs["j"]]
    assert [kf.frame_idx for kf in t.slam_keyframes] == [
        kf.frame_idx for kf in j.slam_keyframes]
    assert len(t.slam_keyframes) >= 10
    assert [(c.ref_kf, c.query_kf) for c in t.accepted_closures] == [
        (c.ref_kf, c.query_kf) for c in j.accepted_closures]
    assert len(t.accepted_closures) >= 1
    for name in ("closures_found", "closures_accepted", "closures_deduped",
                 "pose_graph_runs"):
        assert t.stats.get(name, 0) == j.stats.get(name, 0), name
    assert t.stats["ba_runs"] == j.stats["ba_runs"]
    assert t.stats["ba_runs"] >= 1 and t.stats["pose_graph_runs"] >= 1
    assert t.db.n == j.db.n == len(t.slam_keyframes)
    for a, b in zip(t.accepted_closures, j.accepted_closures):
        np.testing.assert_allclose(a.T_qr, b.T_qr, atol=2e-2)


def test_loop_trajectories(loop_runs):
    seq, j, t, _ = loop_runs
    for kf in t.slam_keyframes:
        assert np.isfinite(kf.T_wc).all()
        np.testing.assert_allclose(kf.T_wc[:3, :3] @ kf.T_wc[:3, :3].T, np.eye(3), atol=1e-4)
    opt_t, opt_j = t.optimized_trajectory(), j.optimized_trajectory()
    assert opt_t.shape == opt_j.shape == (LOOP["n_frames"], 4, 4)
    ate_t, ate_j = _ate(opt_t, seq.poses_wc), _ate(opt_j, seq.poses_wc)
    assert np.isfinite(ate_t) and ate_t < 0.3 and ate_j < 0.3
    centre = lambda T: -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])  # noqa: E731
    assert np.abs(centre(opt_t) - centre(opt_j)).max() < 0.15      # found 0.079


def test_loop_pools_equal_before_optimisation(loop_runs):
    """The closure database holds what the front-end gave it: descriptor
    pools exactly, pool points to the front-end's float tolerance."""
    _, j, t, _ = loop_runs
    want, got = tp.keyframe_db_dict(j.db), convert.keyframe_db_to_numpy(t.db)
    n = want["n"]
    np.testing.assert_array_equal(got["count"][:n], want["count"][:n])
    np.testing.assert_array_equal(got["desc"][:n], want["desc"][:n])
    # pool points are the landmarks' running estimates: 99 % within 2 cm, the
    # rest (distant landmarks, whose depth a float32 refinement barely
    # constrains, and landmarks a BA wrote back) within 20 % of their range
    diff = np.abs(got["p_cam"][:n] - want["p_cam"][:n]).max(-1)
    rng_m = np.linalg.norm(want["p_cam"][:n], axis=-1)
    assert (diff < 2e-2).mean() > 0.99
    assert (diff <= 2e-2 + 0.2 * rng_m).all()
    assert np.mean(got["prob"][:n] != want["prob"][:n]) < 1e-3
