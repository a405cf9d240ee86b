"""The map-optimisation slice, BA part: the port's fused Schur assembly
(plain versions of kernels K4 / K5), ``bundle_adjust``, ``prepare_ba_window``
and ``reprojection_stats`` against the JAX package on seeded numpy inputs,
all on the CPU. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.geometry.linalg import inv3x3 as j_inv3x3
from svi_mapper_tpu.io.synthetic import default_camera as j_default_camera
from svi_mapper_tpu.ops import ba_kernel as j_bk
from svi_mapper_tpu.solvers import ba as j_ba
from svi_mapper_tpu.solvers import ba_prep as j_prep
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.ops import ba_kernel as t_bk
from svi_mapper_tpu_torch.solvers import ba as t_ba
from svi_mapper_tpu_torch.solvers import ba_prep as t_prep
from tests import torch_parity as tp

NAMES = ("S", "rhs", "Hinv", "b_l", "W")
# the JAX package's own tolerances (tests/test_ba_kernel.py): relative to the
# largest entry; rhs is a difference of nearly cancelling float32 terms, so
# it is held against the scale of its constituents (100 x max|b_l|)
TOL = dict(S=2e-4, rhs=5e-3, Hinv=2e-4, b_l=2e-4, W=2e-4)
# Hinv's largest entries are the unobserved landmarks' 1 / damping, a thousand
# times an observed landmark's: each 3x3 block is also held against its own
# largest entry. 5e-3, because the cofactors cancel: float32 alone is up to
# 8e-4 from float64 on a weakly observed landmark; a wrong block is off by
# its own size
TOL_HINV_BLOCK = 5e-3


@pytest.fixture(scope="module")
def cams():
    jcam = j_default_camera(640, 480)
    return jcam, tp.torch_camera(jcam)


def _hard_window(K, L, seed=0):
    """A window that reaches every branch: 20 % dropped observations, some
    landmarks never observed, some unmasked observations of points behind
    (or almost in the plane of) the camera, residuals on both sides of the
    robust kernel."""
    w = tp.ba_window(K=K, L=L, seed=seed)
    mask = w["mask"].copy()
    mask[:, :7] = False                                   # unobserved landmarks
    X = w["X"].copy()
    X[7:12, 2] = -w["T"][K - 2, 2, 3] + np.array(
        [-0.3, 0.0, 0.03, 0.06, 1e-7], np.float32)        # z_c ~ 0 at k = K-2
    mask[:, 7:12] = True
    w.update(mask=mask, X=X)
    return w


def _oracle(intr, T, Xp, obs, maskf, lam, kernel_px2=10.0, pd=1e-6):
    """The Schur quantities formed from the JAX package's materialised
    residuals and Jacobians (the shape of ``tests/test_ba_kernel.py``'s
    oracle)."""
    fx, fy, cx, cy, bq = intr
    K, L = maskf.shape
    Tj, Xj = jnp.asarray(T), jnp.asarray(Xp)
    r, p_c = j_ba._residuals(Tj, Xj, jnp.asarray(obs, jnp.float32), fx, fy, cx, cy, bq)
    err2 = jnp.sum(r * r, -1)
    w = jnp.where(err2 > kernel_px2, kernel_px2 / jnp.maximum(err2, 1e-12), 1.0)
    w = w * jnp.asarray(maskf, jnp.float32) * (p_c[..., 2] > 0.05)
    Jp, Jl = j_ba._jacobians(p_c, Tj, fx, fy, bq)
    H_pp = jnp.einsum("klri,kl,klrj->kij", Jp, w, Jp)
    H_ll = jnp.einsum("klri,kl,klrj->lij", Jl, w, Jl)
    H_pl = jnp.einsum("klri,kl,klrj->klij", Jp, w, Jl)
    b_p = jnp.einsum("klri,kl,klr->ki", Jp, w, r)
    b_l = jnp.einsum("klri,kl,klr->li", Jl, w, r)
    Hinv = j_inv3x3(H_ll + (lam + pd) * jnp.eye(3))
    A = jnp.einsum("klab,lbc->klac", H_pl, Hinv)
    S = -jnp.einsum("klac,Klbc->kaKb", A, H_pl)
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(H_pp)
    rhs = b_p - jnp.einsum("klac,lc->ka", A, b_l)
    W = jnp.transpose(H_pl, (3, 0, 2, 1)).reshape(3, K * 6, L)
    return [np.asarray(a, np.float64) for a in (S, rhs, Hinv, b_l, W)]


def _errors(got, want):
    """Per output: max |got - want| over the scale the tolerance names."""
    out = {}
    for nm, a, b in zip(NAMES, got, want):
        a = np.asarray(a, np.float64)
        scale = (np.abs(want[3]).max() * 100 if nm == "rhs"
                 else max(np.abs(b).max(), 1e-9))
        out[nm] = np.abs(a - b).max() / scale
    d = np.abs(np.asarray(got[2], np.float64) - want[2]).max(axis=(1, 2))
    out["Hinv_block"] = (d / np.abs(want[2]).max(axis=(1, 2))).max()
    return out


def _assert_within_tolerance(got, want):
    for nm, err in _errors([g.numpy() for g in got], want).items():
        assert err < dict(TOL, Hinv_block=TOL_HINV_BLOCK)[nm], f"{nm}: {err:.2e}"


def _torch_args(w):
    return (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]),
            tp.t32(w["mask"].astype(np.float32)))


def _intr_kw(w):
    return dict(zip(("fx", "fy", "cx", "cy", "bq"), w["intr"]))


@pytest.mark.parametrize("fn,K,L", [
    (t_bk.schur_assemble, 8, 640),
    (t_bk.schur_assemble_plain, 5, 203),
    (t_bk.schur_assemble_tiled, 64, 640),
])
def test_schur_plain_matches_xla_quantities(fn, K, L):
    w = _hard_window(K, L)
    lam = 1e-3
    got = fn(*_torch_args(w), lam, **_intr_kw(w))
    want = _oracle(w["intr"], w["T"], w["X"], w["obs"],
                   w["mask"].astype(np.float32), lam)
    assert got[0].shape == (K, 6, K, 6) and got[4].shape == (3, 6 * K, L)
    _assert_within_tolerance(got, want)
    # the window does reach the branches it was built for
    r, p_c = j_ba._residuals(jnp.asarray(w["T"]), jnp.asarray(w["X"]),
                             jnp.asarray(w["obs"]), *w["intr"])
    err2 = np.asarray(jnp.sum(r * r, -1))[w["mask"]]
    z = np.asarray(p_c[..., 2])[w["mask"]]
    assert (err2 > 10.0).any() and (err2 < 10.0).any()
    assert (z < 0.05).any() and (np.abs(z) < 1e-6).any()
    # an unobserved landmark: 1 / (lam + point_damping) on the diagonal, no W
    Hinv = got[2].numpy()
    np.testing.assert_allclose(Hinv[0], np.eye(3) / (1e-3 + 1e-6), rtol=1e-5)
    assert np.abs(got[4].numpy()[:, :, :7]).max() == 0.0


def test_schur_plain_matches_pallas_kernel_interpreted():
    """The plain K4 against the Pallas kernel itself (interpret mode), at
    K = 4, L = 512: a larger window takes the interpreter tens of seconds."""
    w = _hard_window(4, 512, seed=1)
    lam = 1e-3
    want = j_bk.schur_assemble(
        jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
        jnp.asarray(w["mask"], jnp.float32), jnp.float32(lam),
        **_intr_kw(w), interpret=True)
    got = t_bk.schur_assemble(*_torch_args(w), lam, **_intr_kw(w))
    want = [np.asarray(a, np.float64) for a in want]
    _assert_within_tolerance(got, want)


@pytest.mark.slow
def test_schur_tiled_plain_matches_pallas_kernel_interpreted():
    """The plain K5 against the tiled Pallas kernel in interpret mode. The
    tile is fixed at 32 keyframes, which takes the interpreter minutes."""
    w = _hard_window(32, 512, seed=2)
    lam = 1e-3
    want = j_bk.schur_assemble_tiled(
        jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
        jnp.asarray(w["mask"], jnp.float32), jnp.float32(lam),
        **_intr_kw(w), interpret=True)
    got = t_bk.schur_assemble_tiled(*_torch_args(w), lam, **_intr_kw(w))
    want = [np.asarray(a, np.float64) for a in want]
    _assert_within_tolerance(got, want)


def test_schur_tiled_goes_through_the_tile_sums():
    """Two tiles against one pass over all keyframes: the same numbers up
    to the order of the sum over keyframes."""
    w = _hard_window(64, 200, seed=3)
    a = t_bk.schur_assemble_tiled_plain(*_torch_args(w), 1e-3, **_intr_kw(w))
    b = t_bk.schur_assemble_plain(*_torch_args(w), 1e-3, **_intr_kw(w))
    for nm, err in _errors([x.numpy() for x in a],
                           [x.double().numpy() for x in b]).items():
        assert err < 1e-5, f"{nm}: {err:.2e}"


def test_schur_tiled_rejects_ragged_windows():
    w = tp.ba_window(K=8, L=64)
    for fn in (t_bk.schur_assemble_tiled, t_bk.schur_assemble_tiled_plain):
        with pytest.raises(ValueError, match="K % 32"):
            fn(*_torch_args(w), 1e-3, **_intr_kw(w))
    with pytest.raises(ValueError):
        j_bk.schur_assemble_tiled(
            jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
            jnp.asarray(w["mask"], jnp.float32), jnp.float32(1e-3),
            **_intr_kw(w), interpret=True)


def test_kernel_gate_is_by_shape():
    assert t_ba.SCHUR_KERNEL_MAX_K == j_ba.SCHUR_KERNEL_MAX_K == 32
    assert t_ba.SCHUR_KERNEL_TILED_MAX_K == j_ba.SCHUR_KERNEL_TILED_MAX_K == 128
    for K, want in ((1, True), (32, True), (33, False), (64, True), (96, True),
                    (100, False), (128, True), (160, False)):
        assert t_ba.schur_kernel_auto(K, torch.float32, "cuda") is want
        assert t_ba.schur_kernel_auto(K, torch.float32, "cpu") is False
    assert t_ba.schur_kernel_auto(8, torch.float64, "cuda") is False


_CARD, _PLAIN = "_CardKernelBuffers", "_KernelBuffers"
_MAT, _OBS = "_MaterialisedBuffers", "_ObsBuffers"
ROUTES = [
    # use_schur_kernel=None, float32: by shape on the card, K > 128 listed everywhere
    *[(K, torch.float32, "cuda", None, route, path) for K, route, path in (
        (8, _CARD, "cuda:schur_assemble"), (32, _CARD, "cuda:schur_assemble"),
        (40, _MAT, "torch:materialised"), (64, _CARD, "cuda:schur_assemble_tiled"),
        (128, _CARD, "cuda:schur_assemble_tiled"), (136, _OBS, "torch:observation_list"),
        (745, _OBS, "torch:observation_list"))],
    *[(K, torch.float32, "cpu", None, _MAT if K <= 128 else _OBS,
       "torch:materialised" if K <= 128 else "torch:observation_list")
      for K in (8, 32, 40, 64, 128, 136, 745)],
    # no kernel takes float64
    (8, torch.float64, "cuda", None, _MAT, "torch:materialised"),
    (745, torch.float64, "cuda", None, _OBS, "torch:observation_list"),
    # forced either way
    (745, torch.float32, "cuda", True, _CARD, "cuda:schur_assemble_tiled"),
    (745, torch.float32, "cpu", True, _PLAIN, "torch:schur_assemble_tiled_plain"),
    (8, torch.float32, "cpu", True, _PLAIN, "torch:schur_assemble_plain"),
    (745, torch.float32, "cuda", False, _MAT, "torch:materialised"),
    (745, torch.float32, "cpu", False, _MAT, "torch:materialised"),
]


@pytest.mark.parametrize("K,dtype,device,use,route,path", ROUTES)
def test_schur_route_table(K, dtype, device, use, route, path):
    """The one route decision of ``bundle_adjust``, by K, dtype, device and
    ``use_schur_kernel``, and the name ``ops.paths.kernel_paths`` reports."""
    got = t_ba.schur_route(K, dtype, device, use)
    assert got is getattr(t_ba, route)
    assert got.path(K) == path


# ---------------------------------------------------------------------------
# bundle_adjust
# ---------------------------------------------------------------------------

def _ba_case(name):
    """``(window, extra keyword arrays)`` of one bundle_adjust case."""
    K, L = 8, 256
    w = tp.ba_window(K=K, L=L, seed=11, noise=0.5, pose_noise=0.01)
    rng = np.random.default_rng(5)
    extra = {}
    if name == "obs_w":
        extra["obs_w"] = rng.uniform(0.3, 2.0, (K, L)).astype(np.float32)
    elif name == "odometry":
        M = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        # measurements a good 0.01 rad / 0.01 m off the truth: the chain's
        # residual rotation stays clear of 1e-4 .. 1e-3 rad, where the JAX
        # package's float32 ``log_se3`` divides by a (1 - cos) that rounded
        # to zero and its LM rejects steps at random
        for k in range(K - 1):
            M[k] = (tp.exp_se3_np(rng.normal(0, 0.01, 6)) @ w["T_true"][k + 1]
                    @ np.linalg.inv(w["T_true"][k]))
        extra["odo_M"] = M
        extra["odo_w"] = np.full(K, 50.0, np.float32)
    elif name == "gravity":
        d = -w["T_true"][:, :3, 1] + rng.normal(0, 0.01, (K, 3))
        extra["grav_d"] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        extra["grav_w"] = np.full(K, 100.0, np.float32)
    elif name == "fixed_pose_3":
        fix = np.zeros(K, bool)
        fix[3] = True
        w["fix"] = fix
    elif name == "outliers":
        w["obs"][:, :10, 0] += 50.0
    return w, extra


@pytest.mark.parametrize("name", ["plain", "obs_w", "odometry", "gravity",
                                  "fixed_pose_3", "outliers"])
def test_bundle_adjust_matches_jax(cams, name):
    jcam, tcam = cams
    w, extra = _ba_case(name)
    jres = j_ba.bundle_adjust(
        jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
        jnp.asarray(w["mask"]), jcam, jnp.asarray(w["fix"]),
        use_schur_kernel=False, **{k: jnp.asarray(v) for k, v in extra.items()})
    p = convert.ba_problem_from_numpy(
        dict(T_wc=w["T"], points_w=w["X"], obs_uv=w["obs"], obs_mask=w["mask"],
             fix_mask=w["fix"], **extra), device="cpu")
    pos = [p.pop(k) for k in ("T_wc", "points_w", "obs_uv", "obs_mask")]
    tres = t_ba.bundle_adjust(*pos, tcam, p.pop("fix_mask"), device="cpu", **p)

    c0, c1 = float(jres.chi2_initial), float(jres.chi2_final)
    assert float(tres.chi2_initial) == pytest.approx(c0, rel=1e-5)
    # equal, or off by one: the stop compares a relative gain with 1 %, and
    # float32 sums in another order can put that gain on the other side
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert float(tres.chi2_final) == pytest.approx(c1, rel=1e-3)
    assert c1 < 0.5 * c0
    Tj, Tt = np.asarray(jres.T_wc), tres.T_wc.numpy()
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() < 1e-4          # metres
    assert np.abs(Tt[:, :3, :3] - Tj[:, :3, :3]).max() < 1e-4        # ~radians
    dX = np.abs(tres.points_w.numpy() - np.asarray(jres.points_w)).max(axis=1)
    if name == "outliers":
        # the ten corrupted landmarks hang on down-weighted observations: at
        # 38 m their depth moves by millimetres with the order of a sum
        assert dX[:10].max() < 2e-2
        dX = dX[10:]
    assert dX.max() < 1e-3
    fixed = np.flatnonzero(w["fix"])
    # gauge: a zero update still passes the re-orthogonalisation (one ulp)
    np.testing.assert_allclose(Tt[fixed], w["T"][fixed], rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tt[fixed], Tj[fixed], rtol=0, atol=1e-6)
    assert tres.iterations.dtype == torch.int32


@pytest.mark.parametrize("K", [8, 32])
def test_bundle_adjust_kernel_route_converges_like_materialised(cams, K):
    """The port's kernel-shaped route (the plain K4 on the CPU) against its
    materialised route: both converge to the same optimum."""
    _, tcam = cams
    w = tp.ba_window(K=K, L=256, seed=4, noise=0.5)
    args = (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]), tp.tbool(w["mask"]),
            tcam, tp.tbool(w["fix"]))
    kw = dict(max_iterations=8, min_rel_improvement=0.0, device="cpu")
    n0 = t_bk.schur_assemble_launches
    res_x = t_ba.bundle_adjust(*args, use_schur_kernel=False, **kw)
    res_k = t_ba.bundle_adjust(*args, use_schur_kernel=True, **kw)
    assert t_bk.schur_assemble_launches == n0          # CPU: plain, no launch
    c_x, c_k = float(res_x.chi2_final), float(res_k.chi2_final)
    assert c_k == pytest.approx(c_x, rel=1e-3)
    assert c_x < 0.2 * float(res_x.chi2_initial)
    assert int(res_x.iterations) == int(res_k.iterations) == 8
    assert np.abs(res_k.T_wc.numpy() - res_x.T_wc.numpy()).max() < 5e-3
    assert np.abs(res_k.points_w.numpy() - res_x.points_w.numpy()).max() < 2e-2


def test_bundle_adjust_tiled_route_on_cpu(cams):
    """K = 64 with ``use_schur_kernel=True`` takes the tiled assembly."""
    _, tcam = cams
    w = tp.ba_window(K=64, L=128, seed=6, noise=0.5)
    args = (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]), tp.tbool(w["mask"]),
            tcam, tp.tbool(w["fix"]))
    kw = dict(max_iterations=4, min_rel_improvement=0.0, device="cpu")
    res_x = t_ba.bundle_adjust(*args, use_schur_kernel=False, **kw)
    res_k = t_ba.bundle_adjust(*args, use_schur_kernel=True, **kw)
    assert float(res_k.chi2_final) == pytest.approx(float(res_x.chi2_final), rel=1e-3)
    assert float(res_k.chi2_final) < float(res_k.chi2_initial)
    with pytest.raises(ValueError, match="K % 32"):
        t_ba.bundle_adjust(*[a[:40] if i in (0, 2, 3, 5) else a
                             for i, a in enumerate(args)],
                           use_schur_kernel=True, **kw)


def _frozen_bundle_adjust(T_wc, points_w, obs_uv, obs_mask, cam, fix_mask, *,
                          kernel_px2=10.0, max_iterations=10, lm_lambda0=1e-4,
                          point_damping=1e-6, min_rel_improvement=0.01, odo_M=None,
                          odo_w=None, grav_d=None, grav_w=None, obs_w=None,
                          use_schur_kernel=False):
    """``bundle_adjust``'s LM loop as it was before its buffer sets, on the
    CPU without the collective hook: fresh tensors every iteration, the
    accepted state rebound. Frozen here as what the sets are held to."""
    from svi_mapper_tpu_torch.geometry import se3
    from svi_mapper_tpu_torch.geometry.linalg import cholesky_solve_or_nan, inv3x3
    from svi_mapper_tpu_torch.solvers.pose_graph import adjoint

    dtype = points_w.dtype
    fx, fy, cx, cy, bq = t_ba._intrinsics(cam)
    K, L = T_wc.shape[0], points_w.shape[0]
    maskf = obs_mask.to(dtype)
    if obs_w is not None:
        maskf = maskf * obs_w

    def robust_w(r):
        err2 = torch.sum(r * r, dim=-1)
        w = torch.where(err2 > kernel_px2, kernel_px2 / torch.clamp(err2, min=1e-12),
                        torch.ones_like(err2))
        return w * maskf

    use_odo, use_grav = odo_M is not None, grav_d is not None
    if use_odo:
        odo_Minv, wo = se3.inv_T(odo_M[: K - 1]), odo_w[: K - 1]

    def odo_residuals(T):
        Dk = T[1:] @ se3.inv_T(T[:-1])
        return Dk, se3.log_se3(Dk @ odo_Minv)

    def total_chi2(T, X):
        r, _ = t_ba._residuals(T, X, obs_uv, fx, fy, cx, cy, bq)
        c = t_ba._chi2(r, robust_w(r))
        odo = grav = torch.zeros((), dtype=dtype)
        if use_odo:
            r_o = odo_residuals(T)[1]
            odo = torch.sum(wo * torch.sum(r_o * r_o, dim=-1))
        if use_grav:
            r_g = -T[:, :3, 1] - grav_d
            grav = torch.sum(grav_w * torch.sum(r_g * r_g, dim=-1))
        return c + odo + grav

    kk, eye6, free = torch.arange(K), torch.eye(6, dtype=dtype), (~fix_mask).to(dtype)
    assemble = t_bk.schur_assemble if K <= 32 else t_bk.schur_assemble_tiled

    def lm_step(T, X, lam):
        if use_schur_kernel:
            S, rhs, H_ll_inv, b_l, Wpl = assemble(
                T, X, obs_uv, maskf, lam, fx=fx, fy=fy, cx=cx, cy=cy, bq=bq,
                kernel_px2=kernel_px2, point_damping=point_damping)
            S[kk, :, kk, :] += lam * eye6
        else:
            r, p_c = t_ba._residuals(T, X, obs_uv, fx, fy, cx, cy, bq)
            w = robust_w(r) * (p_c[..., 2] > 0.05).to(dtype)
            J_pose, J_point = t_ba._jacobians(p_c, T, fx, fy, bq)
            Jpw4 = J_pose * w[..., None, None]
            Jp, Jpw = J_pose.reshape(K, L * 4, 6), Jpw4.reshape(K, L * 4, 6)
            Jl = J_point.permute(1, 0, 2, 3).reshape(L, K * 4, 3)
            Jlw = (J_point * w[..., None, None]).permute(1, 0, 2, 3).reshape(L, K * 4, 3)
            H_pp = Jpw.transpose(1, 2) @ Jp
            H_ll = Jlw.transpose(1, 2) @ Jl
            H_pl = Jpw4.transpose(-1, -2) @ J_point
            b_p = (Jpw.transpose(1, 2) @ r.reshape(K, L * 4, 1))[..., 0]
            b_l = (Jlw.transpose(1, 2) @ r.permute(1, 0, 2).reshape(L, K * 4, 1))[..., 0]
            H_ll_inv = inv3x3(H_ll + (lam + point_damping) * torch.eye(3, dtype=dtype))
            A = (H_pl @ H_ll_inv[None]).permute(0, 2, 1, 3).reshape(K * 6, L * 3)
            B = H_pl.permute(0, 2, 1, 3).reshape(K * 6, L * 3)
            S = (-(A @ B.T)).reshape(K, 6, K, 6)
            rhs = b_p - (A @ b_l.reshape(L * 3)).reshape(K, 6)
            S[kk, :, kk, :] += H_pp + lam * eye6
        if use_odo:
            Dk, r_o = odo_residuals(T)
            Adj = adjoint(Dk)
            AdjT = Adj.transpose(1, 2)
            ks, wk = kk[: K - 1], wo[:, None, None]
            S[ks + 1, :, ks + 1, :] += wk * eye6
            S[ks, :, ks, :] += wk * (AdjT @ Adj)
            S[ks, :, ks + 1, :] += -wk * AdjT
            S[ks + 1, :, ks, :] += -wk * Adj
            rhs[ks + 1] += wo[:, None] * r_o
            rhs[ks] += -wo[:, None] * torch.einsum("kji,kj->ki", Adj, r_o)
        if use_grav:
            Rg = -T[:, :3, 1]
            Ag = -se3.hat(Rg)
            S[kk, 3:, kk, 3:] += grav_w[:, None, None] * (Ag.transpose(1, 2) @ Ag)
            rhs[:, 3:] += grav_w[:, None] * torch.einsum("kji,kj->ki", Ag, Rg - grav_d)
        Sm = S * free[:, None, None, None] * free[None, None, :, None]
        Sm[kk, :, kk, :] += (1.0 - free)[:, None, None] * eye6
        dp = -cholesky_solve_or_nan(Sm.reshape(K * 6, K * 6), (rhs * free[:, None]).reshape(K * 6))
        dp = dp.reshape(K, 6) * free[:, None]
        if use_schur_kernel:
            Wdp = torch.einsum("bql,q->lb", Wpl, dp.reshape(K * 6))
        else:
            Wdp = (B.T @ dp.reshape(K * 6)).reshape(L, 3)
        dx = -(H_ll_inv @ (b_l + Wdp)[..., None])[..., 0]
        return se3.apply_left_update(dp, T), X + dx

    T, X = T_wc, points_w
    chi2 = chi2_init = total_chi2(T, X)
    lam, iters = np.float32(lm_lambda0), 0
    while iters < max_iterations:
        T_new, X_new = lm_step(T, X, float(lam))
        chi2_new = total_chi2(T_new, X_new)
        accept = bool(chi2_new < chi2)
        done = accept and bool((chi2 - chi2_new) / torch.clamp(chi2, min=1e-12)
                               < min_rel_improvement)
        if accept:
            T, X, chi2 = T_new, X_new, chi2_new
        lam = lam * np.float32(0.3) if accept else lam * np.float32(8.0)
        iters += 1
        if done:
            break
    return t_ba.BAResult(T_wc=T, points_w=X, chi2_initial=chi2_init, chi2_final=chi2,
                         iterations=torch.tensor(iters, dtype=torch.int32))


@pytest.mark.parametrize("route,K,L", [("materialised", 8, 256), ("kernel", 8, 256),
                                       ("tiled", 64, 128)])
def test_bundle_adjust_buffer_set_keeps_the_loops_bits(cams, route, K, L):
    """Two problems of one shape solved in turn through one buffer set, every
    term on: each returns the bits and the iteration count of the loop as it
    was before the sets (frozen above); the second solve leaves the first's
    results as they were; the second problem solved alone, in a fresh set,
    gives the same bits. On the CPU nothing is captured or replayed."""
    _, tcam = cams
    kw = dict(use_schur_kernel=route != "materialised", max_iterations=6)
    problems = [tp.ba_chain_problem(K, L, seed) for seed in (21, 22)]
    counts = t_ba.graph_counts()
    got = [t_ba.bundle_adjust(*args, tcam, fix, device="cpu", **kw, **extra)
           for args, fix, extra in problems]
    first = [t.clone() for t in (got[0].T_wc, got[0].points_w)]
    t_ba._buffer_sets.clear()
    args, fix, extra = problems[1]
    alone = t_ba.bundle_adjust(*args, tcam, fix, device="cpu", **kw, **extra)

    fields = ("T_wc", "points_w", "chi2_initial", "chi2_final", "iterations")
    for res, (args, fix, extra) in zip(got, problems):
        want = _frozen_bundle_adjust(*args, tcam, fix, **kw, **extra)
        assert 1 < int(want.iterations) <= 6
        for f in fields:
            assert torch.equal(getattr(res, f), getattr(want, f)), f
    assert torch.equal(got[0].T_wc, first[0]) and torch.equal(got[0].points_w, first[1])
    for f in fields:
        assert torch.equal(getattr(alone, f), getattr(got[1], f)), f
    assert t_ba.graph_counts() == counts


def test_bundle_adjust_respects_observation_mask(cams):
    _, tcam = cams
    w = tp.ba_window(K=4, L=64, seed=2, noise=0.0, drop=0.0)
    obs = w["obs"].copy()
    mask = np.ones((4, 64), bool)
    mask[2, :20] = False
    obs[2, :20] = 9999.0                 # garbage under the mask
    res = t_ba.bundle_adjust(tp.t32(w["T"]), tp.t32(w["X_true"]), tp.t32(obs),
                             tp.tbool(mask), tcam, tp.tbool(w["fix"]), device="cpu")
    assert float(res.chi2_final) < 1e-3
    assert np.abs(res.T_wc.numpy() - w["T"]).max() < 1e-3


# ---------------------------------------------------------------------------
# prepare_ba_window, reprojection_stats, the slice as a whole
# ---------------------------------------------------------------------------

def _prep_window():
    """A window with landmarks whose estimate is far off (re-seeded),
    observations whose range disagrees (gated) and far landmarks with
    sub-pixel disparity (dropped)."""
    w = tp.ba_window(K=6, L=300, seed=8, noise=0.2, drop=0.1)
    X = w["X"].copy()
    X[:15] *= 1.8                        # estimates 80 % too far: re-seed
    obs = w["obs"].copy()
    obs[1, 20:40, 2] -= 6.0              # disparity off in one keyframe: gate
    Xf = w["X_true"].copy()
    w.update(X=X, obs=obs)
    # far landmarks: 250-400 m, disparity below one pixel
    fx, fy, cx, cy, bq = w["intr"]
    far = slice(280, 300)
    Xf[far, 2] = np.linspace(250, 400, 20)
    p_c = np.einsum("kij,lj->kli", w["T"][:, :3, :3], Xf[far]) + w["T"][:, None, :3, 3]
    z = p_c[..., 2]
    obs[:, far] = np.stack([fx * p_c[..., 0] / z + cx, fy * p_c[..., 1] / z + cy,
                            (fx * p_c[..., 0] + bq) / z + cx,
                            fy * p_c[..., 1] / z + cy], -1)
    X[far] = Xf[far]
    w["mask"][:, far] = True
    return w


@pytest.mark.parametrize("depth_weighting", [True, False])
def test_prepare_ba_window_matches_jax(cams, depth_weighting):
    jcam, tcam = cams
    w = _prep_window()
    jp = j_prep.prepare_ba_window(
        jnp.asarray(w["T"]), jnp.asarray(w["obs"]), jnp.asarray(w["mask"]),
        jnp.asarray(w["X"]), jcam, depth_weighting=depth_weighting)
    pp = t_prep.prepare_ba_window(
        tp.t32(w["T"]), tp.t32(w["obs"]), tp.tbool(w["mask"]), tp.t32(w["X"]),
        tcam, depth_weighting=depth_weighting, device="cpu")
    # integer and boolean results exactly: the planted cases sit far from
    # the band edges (0.75 / 1.25, 1 px, 25 % spread), the rest by margin
    np.testing.assert_array_equal(pp.mask.numpy(), np.asarray(jp.mask))
    for f in ("n_gated", "n_reinit", "n_obs"):
        assert int(getattr(pp, f)) == int(getattr(jp, f)), f
        assert getattr(pp, f).dtype == torch.int32
    assert int(pp.n_reinit) >= 15 and int(pp.n_gated) >= 10
    assert not pp.mask.numpy()[:, 280:].any()            # far tier dropped
    np.testing.assert_allclose(pp.X0.numpy(), np.asarray(jp.X0), atol=1e-4)
    np.testing.assert_allclose(pp.obs_w.numpy(), np.asarray(jp.obs_w),
                               rtol=1e-5, atol=1e-6)


def test_prepare_ba_window_edge_cases(cams):
    """Planted: a landmark left with one observation loses it; an invalid
    (zero) disparity never counts; an empty window gives zero counts."""
    _, tcam = cams
    w = tp.ba_window(K=4, L=32, seed=9, noise=0.0, drop=0.0)
    mask = np.ones((4, 32), bool)
    mask[1:, 0] = False                                  # one observation
    obs = w["obs"].copy()
    obs[:, 1, 2] = obs[:, 1, 0]                          # zero disparity
    pp = t_prep.prepare_ba_window(tp.t32(w["T"]), tp.t32(obs), tp.tbool(mask),
                                  tp.t32(w["X_true"]), tcam, device="cpu")
    m = pp.mask.numpy()
    assert not m[:, 0].any() and not m[:, 1].any() and m[:, 2:].all()
    assert int(pp.n_obs) == 4 * 30 and int(pp.n_reinit) == 0
    assert (pp.obs_w.numpy()[~m] == 0).all()
    assert float(pp.obs_w.numpy()[m].mean()) == pytest.approx(1.0, rel=1e-5)
    empty = t_prep.prepare_ba_window(
        tp.t32(w["T"]), tp.t32(obs), tp.tbool(np.zeros((4, 32), bool)),
        tp.t32(w["X_true"]), tcam, device="cpu")
    assert int(empty.n_obs) == int(empty.n_gated) == 0
    assert torch.isfinite(empty.obs_w).all()


def test_reprojection_stats_matches_jax(cams):
    jcam, tcam = cams
    w = _hard_window(6, 200, seed=3)
    je, jd = j_ba.reprojection_stats(
        jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
        jnp.asarray(w["mask"]), jcam)
    te, td = t_ba.reprojection_stats(
        tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]), tp.tbool(w["mask"]),
        tcam, device="cpu")
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert np.isinf(td.numpy()[:7]).all()               # unobserved: +inf


def test_map_optimisation_chain_matches_jax(cams):
    """The slice as a whole: a seeded window through ``prepare_ba_window``
    -> ``bundle_adjust`` -> ``reprojection_stats`` in both packages."""
    jcam, tcam = cams
    w = _prep_window()
    w["T"] = tp.ba_window(K=6, L=300, seed=8, pose_noise=0.01)["T"]

    jp = j_prep.prepare_ba_window(
        jnp.asarray(w["T"]), jnp.asarray(w["obs"]), jnp.asarray(w["mask"]),
        jnp.asarray(w["X"]), jcam)
    jres = j_ba.bundle_adjust(
        jnp.asarray(w["T"]), jp.X0, jnp.asarray(w["obs"]), jp.mask, jcam,
        jnp.asarray(w["fix"]), obs_w=jp.obs_w, use_schur_kernel=False)
    je, jd = j_ba.reprojection_stats(jres.T_wc, jres.points_w,
                                     jnp.asarray(w["obs"]), jp.mask, jcam)

    T, obs = tp.t32(w["T"]), tp.t32(w["obs"])
    pp = t_prep.prepare_ba_window(T, obs, tp.tbool(w["mask"]), tp.t32(w["X"]),
                                  tcam, device="cpu")
    tres = t_ba.bundle_adjust(T, pp.X0, obs, pp.mask, tcam, tp.tbool(w["fix"]),
                              obs_w=pp.obs_w, device="cpu")
    te, td = t_ba.reprojection_stats(tres.T_wc, tres.points_w, obs, pp.mask,
                                     tcam, device="cpu")

    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert float(tres.chi2_final) == pytest.approx(float(jres.chi2_final), rel=1e-3)
    assert float(tres.chi2_final) < 0.5 * float(tres.chi2_initial)
    assert np.abs(tres.T_wc.numpy() - np.asarray(jres.T_wc)).max() < 1e-4
    seen = pp.mask.numpy().any(0)
    # the end of the chain: per-landmark error (px^2) and depth (m)
    np.testing.assert_allclose(te.numpy()[seen], np.asarray(je)[seen],
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(td.numpy()[seen], np.asarray(jd)[seen],
                               rtol=1e-4, atol=1e-3)
    # and against the truth the window was generated from
    assert np.abs(tres.T_wc.numpy() - w["T_true"]).max() < 0.02
