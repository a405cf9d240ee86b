"""The port's multi-process layer (``parallel/``) on ``torch.distributed``:
the landmark-sharded Schur BA over 2 gloo processes on the CPU against the
single-process solve and the JAX package's sharded BA on its 8-device CPU
mesh; one rank against ``bundle_adjust`` bit for bit; ``shard_ba_inputs``
against the slices the sharded BA cuts; the landmark-sharded frame step
(one frame against the JAX package's, a chunked corridor and
``SLAMSystem`` against the port's unsharded run, bit for bit with one
rank); the stereo-inertial tracker on the sharded state against the
unsharded port and against the JAX package's tracker on its 8-device CPU
mesh; every host read of a sharded state (checkpoint and resume, cloud,
g2o, viewer, loggers) against the same read of the state gathered; the
pod mesh, the state placements, and the bring-up's no-op. Mirrors
``tests/test_distributed_multiprocess.py`` and ``tests/test_parallel.py``.
Each world (2 ranks, 1 rank) is started once for the module.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

WORKER = Path(__file__).with_name("torch_distributed_worker.py")
REPO = WORKER.parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _problem(L: int, noise: float, seed: int, weighted: bool = False) -> dict:
    """The JAX worker's window (``tests/distributed_worker.py``): K = 4
    keyframes 0.4 m apart over L landmarks at 320 x 240, numpy only; with
    ``weighted``, a per-observation information scale ``obs_w`` of 0.1 to 3
    (the back-end passes one with every window)."""
    from svi_mapper_tpu_torch.io.synthetic import default_camera

    cam = default_camera(320, 240, device="cpu")
    fx, cx, cy, bq = cam.left.fx, cam.left.cx, cam.left.cy, cam.right.p03
    K = 4
    rng = np.random.default_rng(seed)
    X = rng.uniform([-5, -2, 3], [5, 2, 25], (L, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -np.arange(K, dtype=np.float32) * 0.4
    p_c = np.einsum("kij,lj->kli", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p_c[..., 2]
    obs = np.stack([fx * p_c[..., 0] / z + cx, fx * p_c[..., 1] / z + cy,
                    (fx * p_c[..., 0] + bq) / z + cx, fx * p_c[..., 1] / z + cy],
                   -1).astype(np.float32)
    obs += rng.normal(0, noise, obs.shape).astype(np.float32)
    X0 = (X + rng.normal(0, 0.05 if noise else 0.0, X.shape)).astype(np.float32)
    fix = np.zeros(K, bool)
    fix[0] = True
    out = dict(T=T, X0=X0, obs=obs, mask=z > 0.5, fix=fix)
    if weighted:
        out["obs_w"] = rng.uniform(0.1, 3.0, (K, L)).astype(np.float32)
    return out


# name: (L, observation noise in px); "weighted" also has obs_w, and its
# L = 101 pads too
PROBLEMS = {"noisy": (64, 0.3), "pad101": (101, 0.0), "weighted": (101, 0.3)}


# test_torch_svi.py's frames and IMU blocks at 512 x 256, first 8 frames; a
# table of 128 landmarks (64 rows a gloo rank, 16 a JAX device) keeps the
# CPU run short
SVI_FRAMES, SVI_CAPACITY = 8, 128


@pytest.fixture(scope="module")
def svi_data():
    from test_torch_svi import make_data

    return make_data(SVI_FRAMES)


def _svi_params(base):
    """test_torch_svi.py's parameters (its 0.2 m keyframe baseline) on a
    table of ``SVI_CAPACITY``."""
    from test_torch_svi import _params

    return dataclasses.replace(_params(base), max_landmarks=SVI_CAPACITY,
                               max_detections=SVI_CAPACITY)


def _svi_arrays(data) -> dict:
    """``svi.npz`` for the worker: the frames, the IMU blocks zero-padded to
    10 samples with their counts, the port's camera, the calibration and
    the parameters' changes (numpy only)."""
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS

    n = np.array([len(b[0]) for b in data["blocks"]])
    pad = lambda a, shape: np.concatenate([a, np.zeros(shape, np.float32)])  # noqa: E731
    out = {"L": np.stack([f[0] for f in data["frames"]]).astype(np.float32),
           "R": np.stack([f[1] for f in data["frames"]]).astype(np.float32), "n": n,
           "dts": np.stack([pad(b[0], (10 - len(b[0]),)) for b in data["blocks"]]),
           "omega": np.stack([pad(b[1], (10 - len(b[1]), 3)) for b in data["blocks"]]),
           "accel": np.stack([pad(b[2], (10 - len(b[2]), 3)) for b in data["blocks"]])}
    for eye, d in convert.camera_to_numpy(data["cam"]).items():
        out.update({f"cam/{eye}/{k}": np.asarray(v) for k, v in d.items()})
    for k in ("R_imu_to_world", "bias_gyro", "bias_accel", "noise_gyro", "noise_accel",
              "n_samples"):
        out[f"calib/{k}"] = np.asarray(getattr(data["calib"], k))
    changed = _svi_params(DEFAULT_PARAMS)
    for f in ("max_landmarks", "max_detections", "keyframe_translation_m2",
              "keyframe_rotation_rad2"):
        out[f"params/{f}"] = np.asarray(getattr(changed, f))
    return out


@pytest.fixture(scope="module")
def jax_svi(svi_data):
    """The JAX package's ``StereoInertialTracker`` on its 8-device CPU mesh
    (``shard_state(state, make_map_mesh(8))``): frame 0 through
    ``process_imu``, frames 1-7 through ``process_imu_samples``; its
    per-frame outputs, its keyframe frames, the sharding of its table, and
    its state before each frame (the lock step's starting points)."""
    from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
    from svi_mapper_tpu.models.svi import StereoInertialTracker as JTracker
    from svi_mapper_tpu.parallel import mesh as mesh_mod
    from test_torch_svi import _jax_svi_dict

    frames, blocks = svi_data["frames"], svi_data["blocks"]
    jt = JTracker(svi_data["jcam"], svi_data["calib"], _svi_params(JPARAMS),
                  equalize=False, enable_loop_closure=False, enable_local_ba=False)
    jt.state = mesh_mod.shard_state(jt.state, mesh_mod.make_map_mesh(8))
    before = [_jax_svi_dict(jt)]
    outs = [jt.process_imu(*frames[0], blocks[0][1][0], blocks[0][2][0],
                           float(blocks[0][0][0]))]
    for i in range(1, SVI_FRAMES):
        before.append(_jax_svi_dict(jt))
        outs.append(jt.process_imu_samples(*frames[i], *blocks[i]))
    return {"outs": outs, "before": before,
            "keyframe_frames": [k.frame_idx for k in jt.slam_keyframes],
            "spec": str(jt.state.table.pos_w.sharding.spec)}


def _lock_arrays(before: list) -> dict:
    """The lock step's states for ``svi.npz``: ``lock/<i>/...`` per frame."""
    out = {}
    for i, d in enumerate(before):
        st = dict(d["state"])
        out.update({f"lock/{i}/table/{k}": np.asarray(v) for k, v in st.pop("table").items()})
        out.update({f"lock/{i}/state/{k}": np.asarray(v) for k, v in st.items()})
        out.update({f"lock/{i}/{k}": np.asarray(d[k]) for k in ("velocity", "gravity_obs",
                                                                 "T_cam_imu")})
    return out


@pytest.fixture(scope="module")
def problems(tmp_path_factory, svi_data, jax_svi):
    path = tmp_path_factory.mktemp("problem") / "problems.npz"
    arrays = {}
    for name, (L, noise) in PROBLEMS.items():
        arrays.update({f"{name}/{k}": v for k, v in
                       _problem(L, noise, seed=7, weighted=name == "weighted").items()})
    np.savez(path, **arrays)
    np.savez(path.with_name("svi.npz"), **_svi_arrays(svi_data),
             **_lock_arrays(jax_svi["before"]))
    return path


@pytest.fixture(scope="module")
def world2(problems, tmp_path_factory):
    return _run_world(2, problems, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world1(problems, tmp_path_factory):
    return _run_world(1, problems, tmp_path_factory.mktemp("world1"))


def _run_world(n: int, problems: Path, out_dir: Path) -> list[dict]:
    """The ranks' ``rank<r>.npz``, with the world's directory under
    ``"dir"`` (the checkpoints the ranks saved are there)."""
    address = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), address, str(n), str(r), str(problems), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, f"rank {r} failed:\n{out[-3000:]}"
    return [dict(np.load(out_dir / f"rank{r}.npz"), dir=out_dir) for r in range(n)]


def _jax_sharded(p: dict):
    """The JAX package's ``bundle_adjust_sharded`` on its 8-device CPU mesh.
    That function pads the landmark axis but not ``obs_w`` (ROADMAP queue
    3, F20), so a weighted problem is given to it already padded to a
    multiple of 8 with unobserved landmarks, which is what its own padding
    adds."""
    from svi_mapper_tpu.io.synthetic import default_camera
    from svi_mapper_tpu.parallel import mesh as mesh_mod
    from svi_mapper_tpu.parallel import sharded_ba

    L = p["X0"].shape[0]
    kw = {}
    if "obs_w" in p:
        pad = (-L) % 8
        p = {**p, "X0": np.pad(p["X0"], ((0, pad), (0, 0))),
             "obs": np.pad(p["obs"], ((0, 0), (0, pad), (0, 0))),
             "mask": np.pad(p["mask"], ((0, 0), (0, pad)))}
        kw["obs_w"] = jnp.asarray(np.pad(p["obs_w"], ((0, 0), (0, pad))))
    res = sharded_ba.bundle_adjust_sharded(
        mesh_mod.make_map_mesh(8), jnp.asarray(p["T"]), jnp.asarray(p["X0"]),
        jnp.asarray(p["obs"]), jnp.asarray(p["mask"]), default_camera(320, 240),
        jnp.asarray(p["fix"]), max_iterations=5, min_rel_improvement=0.0, **kw)
    return np.asarray(res.T_wc), float(res.chi2_final), np.asarray(res.points_w)[:L]


def test_two_rank_sharded_ba(problems, world2):
    """2 gloo ranks: both give the same chi^2 and poses bit for bit; within
    the JAX worker's bounds (chi^2 1 %, pose 1e-3) of the single-process
    solve and of the JAX package's sharded BA on 8 devices, also with a
    per-observation ``obs_w`` (cut with the observations); L = 101 pads to
    102 and returns 101 landmarks; the pod mesh and placements hold (in the
    workers); ``shard_ba_inputs`` places each rank's shards as the sharded
    BA cuts them."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    r0, r1 = world2
    z = np.load(problems)
    for name in PROBLEMS:
        for key in ("T_wc", "points_w", "chi2", "chi2_initial"):
            assert np.array_equal(r0[f"{name}/{key}"], r1[f"{name}/{key}"]), (name, key)
        chi2, ref = float(r0[f"{name}/chi2"]), float(r0[f"{name}/ref_chi2"])
        assert abs(chi2 - ref) < 0.01 * ref + 1e-3, (name, chi2, ref)
        assert np.abs(r0[f"{name}/T_wc"] - r0[f"{name}/ref_T_wc"]).max() < 1e-3
        p = {k.split("/")[1]: z[k] for k in z.files if k.startswith(name + "/")}
        jT, jchi2, jX = _jax_sharded(p)
        assert abs(chi2 - jchi2) < 0.01 * jchi2 + 1e-3, (name, chi2, jchi2)
        assert np.abs(r0[f"{name}/T_wc"] - jT).max() < 1e-3
        assert r0[f"{name}/points_w"].shape == jX.shape == (p["X0"].shape[0], 3)
    assert float(r0["pad101/chi2"]) < 1e-2        # noise-free: the JAX test's bound
    for r in (r0, r1):
        for name in PROBLEMS:
            assert bool(r[f"{name}/placed_equals_cut"]), name
            assert [str(x) for x in r[f"{name}/placements"]] == [
                "(Replicate(),)", "(Shard(dim=0),)", "(Shard(dim=1),)", "(Shard(dim=1),)",
                "(Replicate(),)"], name


def test_one_rank_gives_bundle_adjust_bits(world1):
    """World size 1 runs the reduction through a one-rank group and gives
    ``bundle_adjust``'s bits; ``shard_ba_inputs`` places the whole problem
    on the one rank."""
    (r0,) = world1
    for name in PROBLEMS:
        for key in ("T_wc", "points_w", "chi2"):
            assert np.array_equal(r0[f"{name}/{key}"], r0[f"{name}/ref_{key}"]), (name, key)
        assert bool(r0[f"{name}/placed_equals_cut"]), name


INT_OUTPUTS = ("posit_ok", "n_tracked", "n_active", "n_optimal", "n_new", "is_keyframe",
               "inliers", "instability")
INT_TABLE = ("active", "uid", "age", "failed", "keyframe_presences", "opt_success",
             "opt_failed", "is_optimal", "desc_left_ref", "desc_right_ref", "desc_left_last",
             "desc_hist", "hist_next", "meas_count", "meas_next")


def _jax_one_frame():
    """``tests/test_parallel.py``'s frame: the JAX package's ``process_frame``
    under ``jit`` on one CPU device (that test shows its 8-device sharded
    run equal to this one)."""
    import dataclasses

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.io.synthetic import default_camera
    from svi_mapper_tpu.models import frame as frame_mod

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=128, max_detections=128,
                                 max_measurements=4)
    cam = default_camera(256, 128)
    img = jnp.asarray(np.random.default_rng(0).random((128, 256)).astype(np.float32) * 255)
    s1, o1 = jax.jit(lambda s, l, r: frame_mod.process_frame(
        s, l, r, cam, params, use_gt_pose=False, do_landmark_opt=True))(
        frame_mod.init_state(params), img, img)
    return s1, o1


def test_two_rank_frame_step_matches_jax(world2):
    """One frame on 2 gloo ranks (64 rows each) at the JAX test's size and
    image, against the JAX package's frame step: ``n_active`` and ``n_new``
    equal, ``T_wc`` within 1e-5, the sorted active ``pos_w`` within 1e-4
    (the JAX test's gates); both ranks return the same bits."""
    r0, r1 = world2
    s1, o1 = _jax_one_frame()
    for key in ("n_active", "n_new", "T_wc", "pos_w", "active"):
        assert np.array_equal(r0[f"one_frame/sharded/{key}"], r1[f"one_frame/sharded/{key}"])
    assert int(r0["one_frame/sharded/n_active"]) == int(o1.n_active) > 0
    assert int(r0["one_frame/sharded/n_new"]) == int(o1.n_new)
    assert np.allclose(r0["one_frame/sharded/T_wc"], np.asarray(o1.T_wc), atol=1e-5)
    a_port = r0["one_frame/sharded/pos_w"][r0["one_frame/sharded/active"]]
    a_jax = np.asarray(s1.table.pos_w)[np.asarray(s1.table.active)]
    assert np.allclose(np.sort(a_port.ravel()), np.sort(a_jax.ravel()), atol=1e-4)


def test_two_rank_chunk_matches_unsharded(world2):
    """The 8-frame corridor through ``process_chunk`` (two chunks) on 2 gloo
    ranks: every frame's integer outputs, the gathered table's integer
    fields row for row and the keyframe snapshots' uids equal the unsharded
    run's; poses within 1e-4 of it (the pose solve's sums run in another
    order); both ranks the same bits."""
    r0, r1 = world2
    for key in [k for k in r0 if k.startswith("chunk/sharded/")]:
        assert np.array_equal(r0[key], r1[key]), key
    assert r0["chunk/ref/posit_ok"][1:].all() and r0["chunk/ref/n_tracked"][-1] > 20
    for f in INT_OUTPUTS + ("snapshot_uid",):
        assert np.array_equal(r0[f"chunk/sharded/{f}"], r0[f"chunk/ref/{f}"]), f
    for f in INT_TABLE:
        assert np.array_equal(r0[f"chunk/sharded/table/{f}"], r0[f"chunk/ref/table/{f}"]), f
    assert np.abs(r0["chunk/sharded/T_wc"] - r0["chunk/ref/T_wc"]).max() <= 1e-4


def test_two_rank_slam_system(world2):
    """``SLAMSystem.process_many(chunk=4)`` + ``finalize_backend`` on the
    sharded state with ``dryrun_multichip``'s parameters on 2 gloo ranks:
    8 frames, a finite trajectory, the unsharded run's keyframe count, and
    the same trajectory bits on both ranks (the back-end runs replicated)."""
    r0, r1 = world2
    assert int(r0["slam/sharded/frame_count"]) == 8
    assert np.isfinite(r0["slam/sharded/trajectory"]).all()
    assert np.isfinite(r0["slam/sharded/optimized"]).all()
    assert int(r0["slam/sharded/keyframes"]) == int(r0["slam/ref/keyframes"]) > 1
    for key in ("trajectory", "optimized", "keyframes", "ba_runs"):
        assert np.array_equal(r0[f"slam/sharded/{key}"], r1[f"slam/sharded/{key}"]), key


def test_two_rank_back_end_writes(world2):
    """The back-end's writes on the sharded state of the SLAM run above: a
    BA write-back by global slot (three rows, on both ranks) with two rows
    excised, an identity merge, then a world correction and a world shift.
    The gathered table's integer fields equal the unsharded system's; the
    written rows hold the written positions; the moved positions are
    within 1e-4 of the unsharded system's (which drifted from the sharded
    one by the pose solve's sum order)."""
    r0, r1 = world2
    for key in [k for k in r0 if k.startswith(("writes/sharded/", "moved/sharded/"))]:
        assert np.array_equal(r0[key], r1[key]), key
    cap = r0["writes/ref/uid"].shape[0]
    rows = [0, cap // 2 + 1, cap - 1]
    X = np.arange(9, dtype=np.float32).reshape(3, 3) + 0.5
    for part in ("writes", "moved"):
        for f in INT_TABLE:
            assert np.array_equal(r0[f"{part}/sharded/{f}"], r0[f"{part}/ref/{f}"]), (part, f)
    assert np.array_equal(r0["writes/sharded/pos_w"][rows], X)
    assert not r0["writes/sharded/active"][[1, cap // 2]].any()
    assert np.array_equal(r0["writes/sharded/meas_count"][rows], [0, 0, 0])
    assert not np.allclose(r0["moved/sharded/pos_w"][rows], X)
    assert np.abs(r0["moved/sharded/pos_w"] - r0["moved/ref/pos_w"]).max() <= 1e-3
    assert np.abs(r0["moved/sharded/T_wc"] - r0["moved/ref/T_wc"]).max() <= 1e-4


@pytest.mark.parametrize("worker", ["overlap", "async"])
def test_two_rank_slam_system_with_a_worker(world2, worker):
    """``dryrun_multichip``'s system with the back-end worker (its last
    part; ``"force"``, as one visible device would otherwise run it
    synchronously) and with the closure worker, on the sharded state over 2
    gloo ranks: 8 frames, a finite trajectory, and the two ranks the same
    bits (each folds only what every rank's worker has finished)."""
    r0, r1 = world2
    assert int(r0[f"workers/{worker}/frame_count"]) == 8
    assert np.isfinite(r0[f"workers/{worker}/optimized"]).all()
    for key in ("keyframes", "optimized", "pos_w"):
        assert np.array_equal(r0[f"workers/{worker}/{key}"], r1[f"workers/{worker}/{key}"],
                              equal_nan=True), key


def test_shard_state_rejects_uneven_capacity(world2, world1):
    """A capacity of 2 x 64 + 1 does not split over 2 ranks: ``shard_state``
    raises ``ValueError``; 65 rows on one rank split."""
    for r in world2:
        assert str(r["odd_capacity_error"]).startswith("ValueError"), r["odd_capacity_error"]
    assert str(world1[0]["odd_capacity_error"]) == ""


@pytest.mark.parametrize("part", ["one_frame", "chunk", "slam", "writes", "moved", "svi"])
def test_one_rank_frame_step_gives_unsharded_bits(world1, part):
    """On a one-rank mesh every collective of the sharded step reduces one
    operand: the frame, the chunked corridor, ``SLAMSystem`` and the
    stereo-inertial tracker give the unsharded run's bits in every output
    and table field."""
    (r0,) = world1
    keys = [k for k in r0 if k.startswith(f"{part}/sharded/")]
    assert keys
    for key in keys:
        ref = key.replace("/sharded/", "/ref/")
        assert np.array_equal(r0[key], r0[ref], equal_nan=True), key


SVI_INT_OUTPUTS = INT_OUTPUTS + ("keyframe_frames",)


@pytest.mark.parametrize("variant", ["svi", "svi_equalize"])
def test_two_rank_svi_matches_unsharded(world2, variant):
    """``StereoInertialTracker`` on the sharded state over 2 gloo ranks
    (``process_imu`` on frame 0, ``process_imu_samples`` on frame 1,
    ``process_many_imu(chunk=3)`` on frames 2-7; as is and with
    ``equalize=True``) against the unsharded port in the same rank: every
    integer output, the keyframe frames and every integer table field
    equal; poses within 1e-4 and the velocity within 1e-3 m/s (the pose
    solve's sums may run in another order on the CPU; the velocity is a
    pose difference over 5-50 ms); both ranks the same bits."""
    r0, r1 = world2
    for key in [k for k in r0 if k.startswith(f"{variant}/sharded/")]:
        assert np.array_equal(r0[key], r1[key]), key
    assert r0[f"{variant}/sharded/posit_ok"][1:].all()
    assert r0[f"{variant}/sharded/keyframe_frames"].size >= 1
    for f in SVI_INT_OUTPUTS:
        assert np.array_equal(r0[f"{variant}/sharded/{f}"], r0[f"{variant}/ref/{f}"]), f
    for f in INT_TABLE:
        assert np.array_equal(r0[f"{variant}/sharded/table/{f}"],
                              r0[f"{variant}/ref/table/{f}"]), f
    assert np.abs(r0[f"{variant}/sharded/T_wc"] - r0[f"{variant}/ref/T_wc"]).max() <= 1e-4
    assert np.abs(r0[f"{variant}/sharded/gravity_obs"]
                  - r0[f"{variant}/ref/gravity_obs"]).max() <= 1e-4
    assert np.abs(r0[f"{variant}/sharded/velocity"]
                  - r0[f"{variant}/ref/velocity"]).max() <= 1e-3


def test_two_rank_svi_matches_jax_free_running(world2, jax_svi):
    """The sharded port (2 gloo ranks; frames 2-7 through
    ``process_many_imu(chunk=3)``, which gives the per-frame path's bits,
    test_torch_svi_system.py) against the JAX package's sharded tracker (8
    CPU devices) on the same frames and IMU blocks, free running:
    ``n_active``, ``n_new`` and ``posit_ok`` on every frame and the keyframe
    frames equal; the JAX table stays sharded. The two free-running float32
    front-ends drift apart in pose (ROADMAP F9; found 1.3e-4 m by frame 7),
    so the poses are held in lock step below."""
    r0 = world2[0]
    assert jax_svi["spec"] == "PartitionSpec('map',)"
    assert len(jax_svi["outs"]) == SVI_FRAMES
    for f in ("n_active", "n_new", "posit_ok"):
        assert np.array_equal(r0[f"svi/sharded/{f}"],
                              [np.asarray(getattr(o, f)) for o in jax_svi["outs"]]), f
    assert list(r0["svi/sharded/keyframe_frames"]) == jax_svi["keyframe_frames"]


def test_two_rank_svi_matches_jax_in_lock_step(world2, jax_svi):
    """Lock step (test_torch_svi.py's): before every frame both ranks start
    the sharded port from the JAX sharded tracker's state (``shard_state``
    of ``convert.svi_state_from_numpy``), then step it as the JAX tracker
    did (``process_imu``, ``process_imu_samples``; a one-frame
    ``process_many_imu`` for frames 2-7). Per frame: ``posit_ok``,
    ``is_keyframe``, ``n_tracked``, ``n_active``, ``n_new`` and ``inliers``
    equal, the pose within 1e-4 m and 1e-5 rad; both ranks the same bits."""
    from test_torch_svi import _pose_diff

    r0, r1 = world2
    for key in [k for k in r0 if k.startswith("svi_lock/")]:
        assert np.array_equal(r0[key], r1[key]), key
    outs = jax_svi["outs"]
    for f in ("posit_ok", "is_keyframe", "n_tracked", "n_active", "n_new", "inliers"):
        assert np.array_equal(r0[f"svi_lock/{f}"],
                              [np.asarray(getattr(o, f)) for o in outs]), f
    for i, o in enumerate(outs):
        dpos, drot = _pose_diff(o.T_wc, r0["svi_lock/T_wc"][i])
        assert dpos < 1e-4 and drot < 1e-5, (i, dpos, drot)


@pytest.mark.parametrize("kind", ["slam", "svi"])
def test_sharded_checkpoint_holds_every_row(world2, kind):
    """``save_checkpoint`` of a sharded ``SLAMSystem`` / ``StereoInertialTracker``
    (every rank calls it, rank 0 writes): every ``table__*`` array of the
    file has the capacity's rows and equals, bit for bit, the table
    gathered on each rank when it was saved."""
    for r in world2:
        names = [k.split("/")[-1] for k in r if k.startswith(f"{kind}_ckpt/file/")]
        table = [k.split("/")[-1] for k in r if k.startswith(f"{kind}_ckpt/table/")]
        assert sorted(names) == sorted(table) and set(INT_TABLE) <= set(names)
        cap = r[f"{kind}_ckpt/table/uid"].shape[0]
        assert cap == (64 if kind == "slam" else SVI_CAPACITY)
        for name in names:
            got, want = r[f"{kind}_ckpt/file/{name}"], r[f"{kind}_ckpt/table/{name}"]
            assert got.shape[0] == cap, name
            assert got.tobytes() == want.astype(got.dtype).tobytes(), name


@pytest.mark.parametrize("kind", ["slam", "svi"])
def test_jax_package_reads_sharded_checkpoint(world2, kind):
    """The JAX package's ``load_checkpoint`` reads the file the sharded
    port saved: the same kind of tracker, the whole table."""
    from svi_mapper_tpu.io.checkpoint import load_checkpoint
    from svi_mapper_tpu.models.slam import SLAMSystem
    from svi_mapper_tpu.models.svi import StereoInertialTracker as JTracker

    r0 = world2[0]
    jt = load_checkpoint(str(r0["dir"] / f"{kind}_ckpt.npz"))
    assert isinstance(jt, JTracker if kind == "svi" else SLAMSystem)
    for name in INT_TABLE:
        got = np.asarray(getattr(jt.state.table, name))
        assert got.tobytes() == r0[f"{kind}_ckpt/file/{name}"].astype(got.dtype).tobytes(), name
    assert np.array_equal(np.asarray(jt.state.table.pos_w), r0[f"{kind}_ckpt/file/pos_w"],
                          equal_nan=True)


def test_sharded_resume_gives_uninterrupted_bits(world2):
    """``load_checkpoint`` -> ``shard_state`` -> the rest of the run, on
    both ranks: ``SLAMSystem`` (the second chunk and ``finalize_backend``)
    and the stereo-inertial tracker (frames 5-7) give the uninterrupted
    sharded run's trajectory, keyframes, velocity and table bit for bit."""
    for r in world2:
        assert np.array_equal(r["slam_ckpt/resumed/trajectory"], r["slam/sharded/trajectory"])
        assert np.array_equal(r["slam_ckpt/resumed/optimized"], r["slam/sharded/optimized"])
        assert int(r["slam_ckpt/resumed/keyframes"]) == int(r["slam/sharded/keyframes"])
        assert np.array_equal(r["svi_ckpt/resumed/T_wc"], r["svi/sharded/T_wc"][5:])
        assert np.array_equal(r["svi_ckpt/resumed/velocity"], r["svi/sharded/velocity"][-1])
        for kind, done in (("slam", "slam_ckpt/uninterrupted"), ("svi", "svi/sharded")):
            keys = [k for k in r if k.startswith(f"{kind}_ckpt/resumed/table/")]
            assert keys
            for k in keys:
                want = r[k.replace(f"{kind}_ckpt/resumed", done)]
                assert np.array_equal(r[k], want, equal_nan=True), k


HOST_READS = {"cloud": ("cloud/",), "g2o": ("g2o",), "viewer": ("viewer/",),
              "logs": ("logs/landmarks_final", "logs/trajectory_kitti")}


@pytest.mark.parametrize("world", ["world2", "world1"])
@pytest.mark.parametrize("read", list(HOST_READS))
def test_host_reads_of_a_sharded_system(request, world, read):
    """``cloud_from_slam_state``, ``snapshot_slam`` (with landmarks, the g2o
    bytes), ``snapshot_tracker`` and the logger's ``finalize`` dumps (bytes)
    of the sharded ``SLAMSystem`` equal the same call on its state gathered,
    unsharded, on every rank; the cloud holds landmarks and the g2o text
    holds them. The attached logger's landmark-creation log, written by rank
    0 from the replicated ``next_uid``, equals the unsharded run's."""
    ranks = request.getfixturevalue(world)
    prefixes = tuple(f"host/sharded/{p}" for p in HOST_READS[read])
    for r in ranks:
        keys = [k for k in r if k.startswith(prefixes)]
        assert len(keys) >= len(prefixes)
        for k in keys:
            assert np.array_equal(r[k], r[k.replace("/sharded/", "/gathered/")],
                                  equal_nan=True), k
        assert np.array_equal(r[k], ranks[0][k], equal_nan=True)
    r0 = ranks[0]
    assert r0["host/sharded/cloud/uids"].size > 0
    assert bytes(r0["host/sharded/g2o"]).count(b"VERTEX_TRACKXYZ") > 0
    assert np.array_equal(r0["host/sharded/logs/landmark_creation"],
                          r0["host/ref/logs/landmark_creation"])


def test_host_read_keeps_nan_and_signed_zero_bits(world2, world1):
    """``parallel.mesh.host_arrays`` of a ``Shard(0)`` float32 field whose
    rows hold NaNs of two payloads, -0.0 and +0.0: every rank's rows in
    rank order, bit for bit, on 2 ranks and on 1; a replicated field as it
    is."""
    for ranks in (world2, world1):
        for r in ranks:
            assert r["bits/gathered"].shape == (2 * len(ranks), 5)
            assert np.array_equal(r["bits/gathered"], r["bits/want"])
            assert np.array_equal(r["bits/replicated"], np.arange(4.0))


def test_initialize_without_configuration(monkeypatch):
    """No coordinator and no process count: a no-op that returns False and
    opens no group; a partial configuration raises."""
    import torch.distributed as dist

    from svi_mapper_tpu_torch.parallel import distributed

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")
    assert not dist.is_initialized()


def test_bench_scaling_over_gloo(capsys):
    """``bench_scaling --cpu --ranks 2`` spawns world sizes 1 and 2 through
    ``torch.multiprocessing`` and ``initialize``: one line each with the JAX
    tool's keys, the same problem solved to the same chi^2 within 1 %."""
    import json

    from svi_mapper_tpu_torch.tools import bench_scaling

    bench_scaling.main(["--cpu", "--ranks", "2", "--points", "256", "--kfs", "4",
                        "--reps", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["devices"] for ln in lines] == [1, 2]
    assert all(set(ln) == {"metric", "devices", "value", "unit", "efficiency_vs_1dev",
                           "chi2_final"} for ln in lines)
    assert lines[0]["efficiency_vs_1dev"] == 1.0 and lines[1]["value"] > 0
    assert abs(lines[1]["chi2_final"] - lines[0]["chi2_final"]) < 0.01 * lines[0]["chi2_final"]
