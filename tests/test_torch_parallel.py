"""The port's multi-process layer (``parallel/``) on ``torch.distributed``:
the landmark-sharded Schur BA over 2 gloo processes on the CPU against the
single-process solve and the JAX package's sharded BA on its 8-device CPU
mesh; one rank against ``bundle_adjust`` bit for bit; ``shard_ba_inputs``
against the slices the sharded BA cuts; the landmark-sharded frame step
(one frame against the JAX package's, a chunked corridor and
``SLAMSystem`` against the port's unsharded run, bit for bit with one
rank); the pod mesh, the state placements, and the bring-up's no-op.
Mirrors ``tests/test_distributed_multiprocess.py`` and
``tests/test_parallel.py``. Each world (2 ranks, 1 rank) is started once
for the module.
"""

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


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    path = tmp_path_factory.mktemp("problem") / "problems.npz"
    arrays = {}
    for name, (L, noise) in PROBLEMS.items():
        arrays.update({f"{name}/{k}": v for k, v in
                       _problem(L, noise, seed=7, weighted=name == "weighted").items()})
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def world2(problems, tmp_path_factory):
    return _run_world(2, problems, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world1(problems, tmp_path_factory):
    return _run_world(1, problems, tmp_path_factory.mktemp("world1"))


def _run_world(n: int, problems: Path, out_dir: Path) -> list[dict]:
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
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]


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


@pytest.mark.parametrize("part", ["one_frame", "chunk", "slam", "writes", "moved"])
def test_one_rank_frame_step_gives_unsharded_bits(world1, part):
    """On a one-rank mesh every collective of the sharded step reduces one
    operand: the frame, the chunked corridor and ``SLAMSystem`` give the
    unsharded run's bits in every output and table field."""
    (r0,) = world1
    keys = [k for k in r0 if k.startswith(f"{part}/sharded/")]
    assert keys
    for key in keys:
        ref = key.replace("/sharded/", "/ref/")
        assert np.array_equal(r0[key], r0[ref], equal_nan=True), key


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
