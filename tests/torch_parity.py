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


def float64_bundle_adjust(mp) -> None:
    """Through the monkeypatch ``mp``, run both packages' ``bundle_adjust``
    (as ``models.slam`` calls it) in float64: the float inputs widened, the
    float results rounded back to float32. A float32 BA of a window with far
    landmarks is ill-conditioned in both packages; in float64 the two agree
    to float32 rounding."""
    import jax
    import jax.numpy as jnp

    from svi_mapper_tpu.models import slam as jslam
    from svi_mapper_tpu_torch.models import slam as tslam

    jba, tba = jslam.ba_mod.bundle_adjust, tslam.ba_mod.bundle_adjust

    def port(*a, **k):
        wide = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731
        r = tba(*map(wide, a), **{n: wide(v) for n, v in k.items()})
        return dataclasses.replace(r, **{
            f.name: getattr(r, f.name).float() for f in dataclasses.fields(r)
            if getattr(r, f.name).is_floating_point()})

    def jax_(*a, **k):
        def wide(x):
            if isinstance(x, (np.ndarray, jax.Array)) and jnp.issubdtype(x.dtype, jnp.floating):
                return jnp.asarray(np.asarray(x), jnp.float64)
            return x
        with jax.enable_x64():
            r = jba(*map(wide, a), **{n: wide(v) for n, v in k.items()})
            out = {f.name: np.asarray(getattr(r, f.name)) for f in dataclasses.fields(r)}
        return type(r)(**{n: jnp.asarray(v.astype(np.float32) if v.dtype == np.float64 else v)
                          for n, v in out.items()})

    mp.setattr(jslam.ba_mod, "bundle_adjust", jax_)
    mp.setattr(tslam.ba_mod, "bundle_adjust", port)


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


def ba_chain_problem(K, L, seed):
    """A :func:`ba_window` with every term of ``bundle_adjust`` on: the pose
    chain, the gravity unaries and per-observation weights. Returns
    ``(args, fix_mask, keywords)`` as CPU tensors: ``args`` is ``(T_wc,
    points_w, obs_uv, obs_mask)``."""
    w = ba_window(K=K, L=L, seed=seed, noise=0.5, pose_noise=0.01)
    rng = np.random.default_rng(seed + 100)
    M = np.stack([exp_se3_np(rng.normal(0, 0.01, 6)) @ w["T_true"][min(k + 1, K - 1)]
                  @ np.linalg.inv(w["T_true"][k]) for k in range(K)])
    d = -w["T_true"][:, :3, 1] + rng.normal(0, 0.01, (K, 3))
    args = (t32(w["T"]), t32(w["X"]), t32(w["obs"]), tbool(w["mask"]))
    kw = dict(odo_M=t32(M), odo_w=torch.full((K,), 50.0),
              grav_d=t32(d / np.linalg.norm(d, axis=1, keepdims=True)),
              grav_w=torch.full((K,), 100.0), obs_w=t32(rng.uniform(0.3, 2.0, (K, L))))
    return args, tbool(w["fix"]), kw


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


# ---------------------------------------------------------------------------
# seeded keyframe pools of the closure slice (numpy only)
# ---------------------------------------------------------------------------

def flip_bits(rng, desc, n_bits):
    """A copy of uint32 descriptors ``[n, 8]`` with ``n_bits`` random bits
    of each flipped."""
    out = desc.copy()
    for row in out:
        for b in rng.choice(256, size=n_bits, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def bit_prob_of(rng, desc, noise=20):
    """uint8 bit probabilities ``[n, 256]`` near the descriptor's own bits:
    0/255 moved inward by up to ``noise``."""
    bits = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(len(desc), 256)
    jitter = rng.integers(0, noise + 1, bits.shape)
    return np.where(bits == 1, 255 - jitter, jitter).astype(np.uint8)


def keyframe_pools(seed=0, n_kf=40, pool=64, revisits=None, decoys=None,
                   twins=None, spacing=3.0, flip=6, point_noise=0.02):
    """Keyframe pools along a straight drive, ``spacing`` m apart, with
    planted revisits and decoys (numpy only). Returns a list of dicts
    ``{desc [n,8] uint32, p_cam [n,3], T_wc [4,4], prob [n,256] uint8}`` and
    the dict ``T_qr_true`` of planted relative transforms.

    * ``revisits`` ``{q: r}``: keyframe ``q`` sees the pool of ``r`` again:
      its descriptors with ``flip`` bits flipped, in another order, its
      points moved by a known ``T_qr`` plus ``point_noise`` m, and a pose
      that lies ``T_qr`` from ``r``'s (so the radius gate passes);
    * ``decoys`` ``{q: r}``: the descriptors of ``r`` again, but with the
      points scrambled, so that matching succeeds and the ICP must refuse;
    * ``twins`` ``{q: r}``: ``q`` is an exact copy of ``r`` (pool, points
      and pose): equal BoW scores and equal match counts against any query.
    Keyframe pools hold between ``pool - 8`` and ``pool`` entries."""
    rng = np.random.default_rng(seed)
    revisits, decoys, twins = revisits or {}, decoys or {}, twins or {}
    out, T_qr_true = [], {}
    for k in range(n_kf):
        n = int(rng.integers(pool - 8, pool + 1))
        desc = random_descs(rng, n)
        p = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 30, n)], -1).astype(np.float32)
        T = np.eye(4)
        T[:3, 3] = [-spacing * k, 0.0, 0.0]
        src = revisits.get(k, decoys.get(k, twins.get(k)))
        if src is not None:
            ref = out[src]
            desc, p, T = ref["desc"].copy(), ref["p_cam"].copy(), ref["T_wc"].copy()
        if k in revisits:
            order = rng.permutation(len(desc))
            desc = flip_bits(rng, desc[order], flip)
            T_qr = exp_se3_np(rng.normal(0, [0.3, 0.1, 0.3, 0.01, 0.03, 0.01]))
            p = (p[order] @ T_qr[:3, :3].T + T_qr[:3, 3]
                 + rng.normal(0, point_noise, p.shape)).astype(np.float32)
            T = T_qr @ T
            T_qr_true[k] = T_qr
        elif k in decoys:
            desc = flip_bits(rng, desc, flip)
            p = p[rng.permutation(len(p))] + rng.normal(0, 3.0, p.shape).astype(np.float32)
        out.append(dict(desc=desc, p_cam=p.astype(np.float32),
                        T_wc=T.astype(np.float32),
                        prob=bit_prob_of(rng, desc)))
    return out, T_qr_true


def vocabulary_dict(jvocab) -> dict:
    return {"k": jvocab.k, "levels": jvocab.levels,
            "centroids": [np.asarray(c) for c in jvocab.centroids],
            "child_valid": [np.asarray(v) for v in jvocab.child_valid],
            "weights": np.asarray(jvocab.weights)}


def keyframe_db_dict(jdb) -> dict:
    """The JAX package's ``KeyframeDatabase`` as the numpy dictionary that
    ``convert.keyframe_db_from_numpy`` takes."""
    bow = None
    if jdb.bow is not None:
        bow = {"vocab": vocabulary_dict(jdb.bow.vocab),
               "vectors": np.asarray(jdb.bow.vectors), "n": jdb.bow.n}
    return {
        "capacity": jdb.capacity, "pool_size": jdb.pool_size, "n": jdb.n,
        "desc": np.asarray(jdb.desc), "p_cam": np.asarray(jdb.p_cam),
        "valid": np.asarray(jdb.valid), "count": np.asarray(jdb.count),
        "T_wc": np.asarray(jdb.T_wc),
        "prob": None if jdb.prob is None else np.asarray(jdb.prob),
        "count_host": list(jdb.count_host), "auto_vocab": jdb.auto_vocab,
        "vocab_train_at": jdb.vocab_train_at, "bow": bow,
    }


def fill_databases(pools, capacity=16, pool_size=64, store_prob=True,
                   with_prob=True):
    """The same pools added one by one to a JAX ``KeyframeDatabase`` and to
    the port's (on the CPU): ``(jdb, tdb)``."""
    from svi_mapper_tpu.mapping import closure as jclosure
    from svi_mapper_tpu_torch.mapping import closure as tclosure

    jdb = jclosure.KeyframeDatabase.create(capacity, pool_size, store_prob=store_prob)
    tdb = tclosure.KeyframeDatabase.create(capacity, pool_size, store_prob=store_prob,
                                           device=CPU)
    for kf in pools:
        prob = kf["prob"] if (with_prob and store_prob) else None
        jdb.add(kf["desc"], kf["p_cam"], kf["T_wc"], prob=prob)
        tdb.add(kf["desc"], kf["p_cam"], kf["T_wc"], prob=prob)
    return jdb, tdb
