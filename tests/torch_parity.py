"""Shared helpers of the ``test_torch_*`` parity tests: conversion between
the JAX package's pytrees and the port's dataclasses, through numpy only."""

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch import convert

CPU = "cpu"

# the suite runs several worker processes side by side; PyTorch's default of
# one intra-op thread per core in each of them oversubscribes the machine
torch.set_num_threads(2)


def words(a) -> torch.Tensor:
    """JAX/numpy uint32 packed words -> the port's int32 tensor (same bits)."""
    return convert.words_from_numpy(np.asarray(a), CPU)


def unwords(t) -> np.ndarray:
    """The port's int32 words -> uint32 numpy (same bits)."""
    return convert.words_to_numpy(t)


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tint(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32))


def tbool(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=bool))


def camera_dict(jcam) -> dict:
    def one(c):
        return {"P": np.asarray(c.P), "K": np.asarray(c.K),
                "dist": np.asarray(c.dist), "R_rect": np.asarray(c.R_rect),
                "width": c.width, "height": c.height}
    return {"left": one(jcam.left), "right": one(jcam.right)}


def torch_camera(jcam):
    return convert.camera_from_numpy(camera_dict(jcam), device=CPU)


def table_dict(jtable) -> dict:
    return {f.name: np.asarray(getattr(jtable, f.name))
            for f in dataclasses.fields(jtable)}


def torch_table(jtable):
    return convert.table_from_numpy(table_dict(jtable), device=CPU)


def state_dict(jstate) -> dict:
    d = {k: np.asarray(getattr(jstate, k))
         for k in ("T_wc", "T_wc_prev", "T_last_keyframe", "next_uid",
                   "frame_idx", "instability")}
    d["table"] = table_dict(jstate.table)
    return d


def torch_state(jstate):
    return convert.state_from_numpy(state_dict(jstate), device=CPU)


def assert_tables_equal(jtable, ttable, float_atol=1e-6, skip=()):
    """Integer/bool/descriptor fields exactly, float fields to ``float_atol``."""
    got = convert.table_to_numpy(ttable)
    for f in dataclasses.fields(jtable):
        if f.name in skip:
            continue
        want = np.asarray(getattr(jtable, f.name))
        have = got[f.name]
        assert want.shape == have.shape, f.name
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(have, want, atol=float_atol, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=f.name)


# ---------------------------------------------------------------------------
# seeded problems of the map-optimisation slice (numpy only)
# ---------------------------------------------------------------------------

def exp_se3_np(xi) -> np.ndarray:
    """float64 SE(3) exponential of a twist ``[rho, phi]`` (Rodrigues)."""
    xi = np.asarray(xi, np.float64)
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    P = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-9:
        R, V = np.eye(3) + P, np.eye(3) + 0.5 * P
    else:
        A, B, C = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
        R = np.eye(3) + A * P + B * P @ P
        V = np.eye(3) + B * P + C * P @ P
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ rho
    return T


def stereo_intrinsics(width: int = 640, height: int = 480, baseline: float = 0.54):
    """``(fx, fy, cx, cy, bq)`` of both packages' ``default_camera``, as the
    float32 values its projection matrices hold."""
    fx = 718.856 * width / 1241.0
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return f32(fx), f32(fx), f32(width / 2.0), f32(height / 2.0), f32(-fx * baseline)


def ba_window(K=8, L=640, seed=0, noise=1.5, drop=0.2, width=640, height=480,
              pose_noise=0.0):
    """A seeded BA window: forward-moving keyframes over a box of landmarks,
    noisy stereo observations with ``drop`` of them masked, perturbed
    landmark estimates (and poses, with ``pose_noise``). Returns a dict of
    numpy arrays: ``intr``, ``T_true``, ``T``, ``X_true``, ``X``, ``obs``,
    ``mask``, ``fix``."""
    fx, fy, cx, cy, bq = intr = stereo_intrinsics(width, height)
    rng = np.random.default_rng(seed)
    X = rng.uniform([-10, -3, 4], [10, 3, 40], (L, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -np.arange(K) * 0.8
    T[:, 0, 3] = rng.normal(0, 0.1, K)
    p_c = np.einsum("kij,lj->kli", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p_c[..., 2]
    obs = np.stack([fx * p_c[..., 0] / z + cx, fy * p_c[..., 1] / z + cy,
                    (fx * p_c[..., 0] + bq) / z + cx,
                    fy * p_c[..., 1] / z + cy], -1)
    obs += rng.normal(0, noise, obs.shape)
    mask = (z > 1.0) & (rng.random((K, L)) > drop)
    Xp = (X + rng.normal(0, 0.1, X.shape)).astype(np.float32)
    T0 = T.copy()
    if pose_noise > 0:
        for k in range(1, K):
            T0[k] = (exp_se3_np(rng.normal(0, pose_noise, 6)) @ T[k]).astype(np.float32)
    fix = np.zeros(K, bool)
    fix[0] = True
    return dict(intr=intr, T_true=T, T=T0, X_true=X, X=Xp,
                obs=obs.astype(np.float32), mask=mask, fix=fix)


def pose_chain(rng, n, step=0.8, noise=0.0):
    """Ground-truth pose chain and an odometry estimate with per-step noise:
    ``(T_true [n,4,4], T_est [n,4,4])`` float32."""
    T_true = [np.eye(4)]
    for k in range(1, n):
        d = exp_se3_np([0.01 * rng.normal(), 0, step, 0, 0.02 * np.sin(k * 0.3), 0])
        T_true.append(d @ T_true[-1])
    T_true = np.stack(T_true).astype(np.float32)
    if noise == 0.0:
        return T_true, T_true.copy()
    T_est = [T_true[0]]
    for k in range(1, n):
        M = T_true[k] @ np.linalg.inv(T_true[k - 1])
        T_est.append((exp_se3_np(rng.normal(0, noise, 6)) @ M @ T_est[-1]).astype(np.float32))
    return T_true, np.stack(T_est)


def chain_edges(T_est, closures=(), weights=None):
    """Sequential edges measured on ``T_est`` plus closure edges
    ``(i, j, M_ij)``: a dict for ``pose_graph_edges_from_numpy``."""
    n = len(T_est)
    ei = list(range(n - 1))
    ej = list(range(1, n))
    Ms = [(T_est[k] @ np.linalg.inv(T_est[k - 1])).astype(np.float32)
          for k in range(1, n)]
    for i, j, M in closures:
        ei.append(i)
        ej.append(j)
        Ms.append(np.asarray(M, np.float32))
    E = len(ei)
    return dict(i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
                T_ij=np.stack(Ms),
                weight=(np.ones(E, np.float32) if weights is None
                        else np.asarray(weights, np.float32)),
                valid=np.ones(E, bool))


def clustered_descs(rng, n_clusters, per_cluster, flip_bits=8):
    """Descriptors in tight Hamming clusters: centre + a few flipped bits.
    ``(desc [n,8] uint32, labels [n], centres [c,8] uint32)``."""
    centers = rng.integers(0, 2 ** 32, (n_clusters, 8), dtype=np.uint64).astype(np.uint32)
    out, labels = [], []
    for c in range(n_clusters):
        for _ in range(per_cluster):
            d = centers[c].copy()
            for _ in range(flip_bits):
                b = int(rng.integers(0, 256))
                d[b // 32] ^= np.uint32(1 << (b % 32))
            out.append(d)
            labels.append(c)
    return np.stack(out), np.asarray(labels), centers


def random_descs(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
