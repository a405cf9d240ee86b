"""The port's multi-process layer (``parallel/``) on ``torch.distributed``:
the landmark-sharded Schur BA over 2 gloo processes on the CPU against the
single-process solve and the JAX package's sharded BA on its 8-device CPU
mesh; one rank against ``bundle_adjust`` bit for bit; the pod mesh, the
state placements, and the bring-up's no-op. Mirrors
``tests/test_distributed_multiprocess.py`` and ``tests/test_parallel.py``.
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


def test_two_rank_sharded_ba(problems, tmp_path):
    """2 gloo ranks: both give the same chi^2 and poses bit for bit; within
    the JAX worker's bounds (chi^2 1 %, pose 1e-3) of the single-process
    solve and of the JAX package's sharded BA on 8 devices, also with a
    per-observation ``obs_w`` (cut with the observations); L = 101 pads to
    102 and returns 101 landmarks; the pod mesh and placements hold (in the
    workers); the eager frame step does not take the sharded state (ROADMAP
    queue 3, F18)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    r0, r1 = _run_world(2, problems, tmp_path)
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
    stop = str(r0["frame_step_error"])
    assert "replication_pad2d" in stop, stop


def test_one_rank_gives_bundle_adjust_bits(problems, tmp_path):
    """World size 1 runs the reduction through a one-rank group and gives
    ``bundle_adjust``'s bits."""
    (r0,) = _run_world(1, problems, tmp_path)
    for name in PROBLEMS:
        for key in ("T_wc", "points_w", "chi2"):
            assert np.array_equal(r0[f"{name}/{key}"], r0[f"{name}/ref_{key}"]), (name, key)
    assert str(r0["frame_step_error"]).startswith("NotImplementedError")


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
