"""The port's pose-graph optimiser against the JAX package on seeded chains
(the cases of ``tests/test_backend.py``), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svi_mapper_tpu.geometry import se3 as j_se3
from svi_mapper_tpu.solvers import pose_graph as j_pg
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.geometry import se3 as t_se3
from svi_mapper_tpu_torch.solvers import ba as t_ba
from svi_mapper_tpu_torch.solvers import pose_graph as t_pg
from tests import torch_parity as tp

# poses of the two packages after the same number of GN iterations: float32
# sums in another order than XLA's, 1e-4 m / rad
POSE_TOL = 1e-4


def _j_edges(e, info6=None):
    return j_pg.PoseGraphEdges(
        i=jnp.asarray(e["i"]), j=jnp.asarray(e["j"]), T_ij=jnp.asarray(e["T_ij"]),
        weight=jnp.asarray(e["weight"]), valid=jnp.asarray(e["valid"]),
        info6=None if info6 is None else jnp.asarray(info6))


def _both(T_est, e, fix, info6=None, gravity=None, **kw):
    jg = tg = None
    if gravity is not None:
        jg = j_pg.GravityPriors(*(jnp.asarray(a) for a in gravity))
        tg = t_pg.GravityPriors(tp.t32(gravity[0]), tp.t32(gravity[1]),
                                tp.tbool(gravity[2]))
    jres = j_pg.optimize_pose_graph(jnp.asarray(T_est), _j_edges(e, info6),
                                    jnp.asarray(fix), gravity=jg, **kw)
    d = dict(e) if info6 is None else dict(e, info6=info6)
    tres = t_pg.optimize_pose_graph(
        tp.t32(T_est), convert.pose_graph_edges_from_numpy(d, device="cpu"),
        tp.tbool(fix), gravity=tg, device="cpu", **kw)
    return jres, tres


def _centres(T):
    return np.linalg.inv(np.asarray(T, np.float64))[:, :3, 3]


def _assert_same(jres, tres, pose_tol=POSE_TOL, same_iterations=True):
    assert float(tres.chi2_initial) == pytest.approx(float(jres.chi2_initial),
                                                     rel=1e-4, abs=1e-9)
    if same_iterations:
        assert int(tres.iterations) == int(jres.iterations)
    assert np.abs(tres.T_wc.numpy() - np.asarray(jres.T_wc)).max() < pose_tol
    assert float(tres.chi2_final) == pytest.approx(float(jres.chi2_final),
                                                   rel=5e-2, abs=1e-6)
    assert tres.iterations.dtype == torch.int32


def _fix0(n):
    fix = np.zeros(n, bool)
    fix[0] = True
    return fix


def test_pose_graph_closes_loop(rng):
    N = 40
    T_true, T_est = tp.pose_chain(rng, N, noise=0.01)
    closure = (0, N - 1, T_true[N - 1] @ np.linalg.inv(T_true[0]))
    e = tp.chain_edges(T_est, [closure])
    # a fixed number of iterations: the step falls to the 1e-6 stop only in
    # float noise, where the two packages need not stop together
    jres, tres = _both(T_est, e, _fix0(N), max_iterations=8)
    _assert_same(jres, tres)
    drift0 = np.linalg.norm(_centres(T_est)[-1] - _centres(T_true)[-1])
    drift1 = np.linalg.norm(_centres(tres.T_wc.numpy())[-1] - _centres(T_true)[-1])
    assert drift1 < 0.05 * max(drift0, 1e-9)
    assert float(tres.chi2_final) < float(tres.chi2_initial)
    assert np.allclose(tres.T_wc.numpy()[0], T_est[0])  # gauge


def test_pose_graph_invalid_edges_ignored(rng):
    N = 10
    T_true, T_est = tp.pose_chain(rng, N, noise=0.0)
    bogus = np.eye(4, dtype=np.float32)
    bogus[0, 3] = 500.0
    e = tp.chain_edges(T_true, [(0, N - 1, bogus)])
    e["valid"][-1] = False
    jres, tres = _both(T_est, e, _fix0(N), max_iterations=4)
    # an exact chain: the steps are float noise around the 1e-6 stop, so the
    # two packages need not stop together
    _assert_same(jres, tres, same_iterations=False)
    assert np.abs(tres.T_wc.numpy() - T_true).max() < 1e-3


def test_pose_graph_z_damped_closure_edge(rng):
    N = 30
    T_true, T_est = tp.pose_chain(rng, N, noise=0.008)
    M_clo = T_true[N - 1] @ np.linalg.inv(T_true[0])
    z_err = np.eye(4, dtype=np.float32)
    z_err[2, 3] = 2.0
    e = tp.chain_edges(T_est, [(0, N - 1, z_err @ M_clo)])
    w_seq = t_pg.sequential_edge_weight(tp.t32(e["T_ij"][:-1])).numpy()
    np.testing.assert_allclose(
        w_seq, np.asarray(j_pg.sequential_edge_weight(jnp.asarray(e["T_ij"][:-1]))),
        rtol=1e-6)
    e["weight"][:-1] = w_seq
    errs = {}
    for name, zdamp in (("iso", 1.0), ("damped", 0.01)):
        info6 = np.ones((len(e["i"]), 6), np.float32)
        info6[-1, 2] = zdamp
        jres, tres = _both(T_est, e, _fix0(N), info6=info6, max_iterations=10)
        # 1e-3 here: the chain's residual rotations pass through the range
        # where the JAX package's float32 log_se3 is off (see the last test),
        # and the 2 m closure error sits on the robust kernel's slope
        _assert_same(jres, tres, pose_tol=1e-3)
        d = _centres(tres.T_wc.numpy()) - _centres(T_true)
        errs[name] = float(np.sqrt((d ** 2).sum(-1).mean()))
    assert errs["damped"] < errs["iso"], errs


def test_pose_graph_gravity_priors(rng):
    """Gravity unaries pull the drifting rotations back: same result in both
    packages, and a smaller tilt than without them."""
    N = 20
    T_true, T_est = tp.pose_chain(rng, N, noise=0.01)
    e = tp.chain_edges(T_est)
    down = (T_true[:, :3, :3] @ np.array([0.0, -1.0, 0.0])).astype(np.float32)
    valid = np.ones(N, bool)
    valid[5] = False
    down[5] = [1.0, 0.0, 0.0]                     # invalid: must not matter
    gravity = (down, np.full(N, 10.0, np.float32), valid)
    jres, tres = _both(T_est, e, _fix0(N), gravity=gravity, max_iterations=8)
    _assert_same(jres, tres)

    def tilt(T):
        return np.abs(np.asarray(T)[:, :3, 1] - T_true[:, :3, 1]).max()
    assert tilt(tres.T_wc.numpy()) < 0.5 * tilt(T_est)


def test_pose_graph_stops_when_converged(rng):
    """The convergence stop: a chain with one closure converges before the
    iteration cap, after the same number of steps in both packages (or one
    apart: the last step's size is compared with the threshold in float32)."""
    T_true, T_est = tp.pose_chain(rng, 12, noise=0.005)
    closure = (0, 11, T_true[11] @ np.linalg.inv(T_true[0]))
    jres, tres = _both(T_est, tp.chain_edges(T_est, [closure]), _fix0(12),
                       convergence=1e-3)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert 1 <= int(tres.iterations) < 20
    assert np.abs(tres.T_wc.numpy() - np.asarray(jres.T_wc)).max() < 2e-3


def test_adjoint_identity_and_make_edges(rng):
    """Ad(T) satisfies T exp(xi) T^-1 = exp(Ad(T) xi); both adjoints equal
    the JAX package's."""
    T = tp.exp_se3_np(rng.normal(0, 0.5, 6)).astype(np.float32)
    xi = rng.normal(0, 0.1, 6).astype(np.float32)
    Ad = t_pg.adjoint(tp.t32(T)).numpy()
    np.testing.assert_allclose(Ad, np.asarray(j_pg.adjoint(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose(t_ba._adjoint(tp.t32(T)[None]).numpy()[0], Ad, atol=1e-6)
    lhs = T @ tp.exp_se3_np(xi) @ np.linalg.inv(T)
    np.testing.assert_allclose(lhs, tp.exp_se3_np(Ad @ xi), atol=1e-4)
    e, je = t_pg.make_edges(5, device="cpu"), j_pg.make_edges(5)
    for f in ("i", "j", "T_ij", "weight", "valid"):
        np.testing.assert_array_equal(getattr(e, f).numpy(), np.asarray(getattr(je, f)))
    assert e.info6 is None and e.i.dtype == torch.int32


@pytest.mark.parametrize("theta", [5e-5, 1.2e-4, 2e-4, 4e-4, 2e-3, 0.3])
def test_log_se3_small_angles_against_float64(theta):
    """The port's ``log_se3`` inverts ``exp_se3`` at every small angle. The
    JAX package's float32 ``log_se3`` does not between 1e-4 and ~1e-3 rad
    (``1 - cos`` rounds to 0 or one ulp: NaN, or a translation off by
    centimetres); its rotation part is right everywhere."""
    xi = np.array([0.3, -0.2, 0.5, 0.6 * theta, -0.64 * theta, 0.48 * theta])
    T = tp.exp_se3_np(xi).astype(np.float32)
    got = t_se3.log_se3(tp.t32(T)).numpy()
    np.testing.assert_allclose(got, xi, atol=2e-6)
    ref = np.asarray(j_se3.log_se3(jnp.asarray(T)))
    np.testing.assert_allclose(ref[3:], xi[3:], atol=2e-6)
    if theta < 1e-4 or theta > 0.1:
        np.testing.assert_allclose(got, ref, atol=2e-6)
    elif theta < 1e-3:
        assert not np.abs(ref[:3] - xi[:3]).max() < 1e-3     # the fault, if fixed there


# ---------------------------------------------------------------------------
# against the JAX package in float64, where its float32 log_se3 is no reference
# ---------------------------------------------------------------------------

def _j_optimize_float64(T_est, e, fix, **kw):
    """The JAX package's optimiser on float64 copies of the same arrays."""
    with jax.enable_x64():
        edges = j_pg.PoseGraphEdges(
            i=jnp.asarray(e["i"]), j=jnp.asarray(e["j"]),
            T_ij=jnp.asarray(e["T_ij"], jnp.float64),
            weight=jnp.asarray(e["weight"], jnp.float64), valid=jnp.asarray(e["valid"]))
        res = j_pg.optimize_pose_graph(jnp.asarray(T_est, jnp.float64), edges,
                                       jnp.asarray(fix), **kw)
        return (np.asarray(res.T_wc), float(res.chi2_initial),
                float(res.chi2_final), int(res.iterations))


def _edge_angles(T, e):
    """Rotation angle of every edge's residual ``T_ij^-1 T_j T_i^-1`` (float64)."""
    T = np.asarray(T, np.float64)
    E = np.linalg.inv(e["T_ij"].astype(np.float64)) @ T[e["j"]] @ np.linalg.inv(T[e["i"]])
    tr = np.trace(E[:, :3, :3], axis1=1, axis2=2)
    return np.arccos(np.clip((tr - 1) / 2, -1, 1))


@pytest.mark.parametrize("theta", [5e-5, 1.2e-4, 2e-4, 4e-4, 9e-4, 2e-3, 0.3])
def test_log_se3_matches_jax_float64(theta):
    """The port's float32 ``log_se3`` against the JAX package's run in
    float64 on the same matrix: 2e-6 at every angle, the range 1e-4 .. 1e-3
    rad included."""
    xi = np.array([0.3, -0.2, 0.5, 0.6 * theta, -0.64 * theta, 0.48 * theta])
    T = tp.exp_se3_np(xi).astype(np.float32)
    with jax.enable_x64():
        want = np.asarray(j_se3.log_se3(jnp.asarray(T, jnp.float64)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(t_se3.log_se3(tp.t32(T)).numpy(), want, atol=2e-6)


def test_pose_graph_small_residual_angles_against_float64(rng):
    """A chain whose edge residuals converge INTO 1e-4 .. 1e-3 rad, where
    the JAX package's float32 result is NaN: the port in float32 against the
    JAX package in float64, poses 1e-4, chi2 1e-3 relative."""
    N = 40
    T_true, T_est = tp.pose_chain(rng, N, noise=0.001)
    e = tp.chain_edges(T_est, [(0, N - 1, T_true[N - 1] @ np.linalg.inv(T_true[0]))])
    T64, chi0, chi1, its = _j_optimize_float64(T_est, e, _fix0(N), max_iterations=8)
    ang = _edge_angles(T64, e)
    assert 1e-4 < np.percentile(ang, 5) and np.percentile(ang, 95) < 1e-3
    tres = t_pg.optimize_pose_graph(
        tp.t32(T_est), convert.pose_graph_edges_from_numpy(e, device="cpu"),
        tp.tbool(_fix0(N)), max_iterations=8, device="cpu")
    assert int(tres.iterations) == its == 8
    assert float(tres.chi2_initial) == pytest.approx(chi0, rel=1e-3)
    assert float(tres.chi2_final) == pytest.approx(chi1, rel=1e-3)
    assert np.abs(tres.T_wc.numpy() - T64).max() < POSE_TOL


def test_pose_graph_ring_of_680_against_float64():
    """The ring of ``chip_smoke.py``'s pose-graph phase (680 keyframes,
    drift, twelve closure edges; half its edge residuals end between 1e-4
    and 1e-3 rad) on the CPU against the JAX package in float64. The ring is
    about 80 m across, where one float32 ulp is 8e-6 m: poses to 5e-3."""
    n = 680
    T_true, T_est, e, fix = chip_smoke.ring_graph(n, seed=7)
    T64, chi0, chi1, its = _j_optimize_float64(T_est, e, fix)
    ang = _edge_angles(T64, e)
    assert ((ang > 1e-4) & (ang < 1e-3)).mean() > 0.4
    tres = t_pg.optimize_pose_graph(
        tp.t32(T_est), convert.pose_graph_edges_from_numpy(e, device="cpu"),
        tp.tbool(fix), device="cpu")
    assert int(tres.iterations) == its
    assert float(tres.chi2_initial) == pytest.approx(chi0, rel=1e-4)
    assert float(tres.chi2_final) == pytest.approx(chi1, rel=1e-2)
    assert chi1 < 1e-4 * chi0
    assert np.abs(tres.T_wc.numpy() - T64).max() < 5e-3
    assert (chip_smoke.end_point_error(tres.T_wc.numpy(), T_true)
            < 0.7 * chip_smoke.end_point_error(T_est, T_true))


def _scatter_assembly(H_ii, H_jj, H_ij, b_i, b_j, ei, ej, N):
    """The assembly before the sums were given a fixed order: four
    scatter-adds into the blocks and two into b."""
    H = torch.zeros((N, N, 6, 6), dtype=H_ii.dtype)
    H.index_put_((ei, ei), H_ii, accumulate=True)
    H.index_put_((ej, ej), H_jj, accumulate=True)
    H.index_put_((ei, ej), H_ij, accumulate=True)
    H.index_put_((ej, ei), H_ij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((N, 6), dtype=b_i.dtype)
    b.index_add_(0, ei, b_i)
    b.index_add_(0, ej, b_j)
    return H, b


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_order_assembly_same_bits_and_scatter_sums(seed):
    """F8: the edges' blocks, given in a shuffled order with repeated pairs,
    self-loops and invalid edges, are summed into the same H and b bits on
    two runs, each with its own plan; the sums equal the scatter-adds to
    1e-6 relative, and an invalid edge contributes nothing."""
    rng = np.random.default_rng(seed)
    N = 30
    ei = np.concatenate([np.arange(N - 1), rng.integers(0, N, 60)])
    ej = np.concatenate([np.arange(1, N), rng.integers(0, N, 60)])
    ei[-5:], ej[-5:] = 3, 3                            # self-loops
    ei[-10:-5], ej[-10:-5] = 2, 7                      # a repeated pair
    order = rng.permutation(len(ei))
    ei, ej = ei[order], ej[order]
    E = len(ei)
    valid = rng.random(E) > 0.1
    blocks = [torch.from_numpy(rng.normal(0, 1, (E, 6, 6)).astype(np.float32))
              for _ in range(3)]
    bs = [torch.from_numpy(rng.normal(0, 1, (E, 6)).astype(np.float32)) for _ in range(2)]
    tei, tej = torch.from_numpy(ei).long(), torch.from_numpy(ej).long()
    tvalid = torch.from_numpy(valid)
    runs = []
    for _ in range(2):
        plan_H, plan_b = t_pg.plan_assembly(tei, tej, tvalid, N)
        runs.append(t_pg.assemble_normal_equations(*blocks, *bs, plan_H, plan_b, N))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    m = tvalid[:, None, None].float()
    H_old, b_old = _scatter_assembly(blocks[0] * m, blocks[1] * m, blocks[2] * m,
                                     bs[0] * m[:, :, 0], bs[1] * m[:, :, 0], tei, tej, N)
    H, b = runs[0]
    assert H.shape == (N, N, 6, 6) and b.shape == (N, 6)
    np.testing.assert_allclose(H.numpy(), H_old.numpy(), rtol=1e-6,
                               atol=1e-6 * float(H_old.abs().max()))
    np.testing.assert_allclose(b.numpy(), b_old.numpy(), rtol=1e-6,
                               atol=1e-6 * float(b_old.abs().max()))
    # a block no valid edge touches stays an exact zero
    touched = np.zeros((N, N), bool)
    for i, j in zip(ei[valid], ej[valid]):
        touched[[i, j, i, j], [i, j, j, i]] = True
    assert (H.numpy()[~touched] == 0).all()


def test_pose_graph_same_bits_twice(rng):
    N = 24
    T_true, T_est = tp.pose_chain(rng, N, noise=0.01)
    rel = lambda i, j: T_true[j] @ np.linalg.inv(T_true[i])  # noqa: E731
    e = tp.chain_edges(T_est, [(0, N - 1, rel(0, N - 1)), (2, N - 3, rel(2, N - 3))])
    e["valid"][-1] = False
    runs = [t_pg.optimize_pose_graph(
        torch.from_numpy(T_est), convert.pose_graph_edges_from_numpy(e, device="cpu"),
        torch.from_numpy(_fix0(N)), device="cpu") for _ in range(2)]
    assert torch.equal(runs[0].T_wc, runs[1].T_wc)
    assert int(runs[0].iterations) == int(runs[1].iterations)
