"""The port's cloud alignment against the JAX package on seeded clouds (the
cases of ``tests/test_backend.py``), single and batched, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.solvers import icp as j_icp
from svi_mapper_tpu_torch.solvers import icp as t_icp
from tests import torch_parity as tp


def _world(rng, n):
    return np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                     rng.uniform(5, 60, n)], axis=-1).astype(np.float32)


def _cloud_pair(rng, n, xi, noise=0.0, outliers=0):
    p_ref = _world(rng, n)
    T = tp.exp_se3_np(xi).astype(np.float32)
    p_q = (p_ref @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    p_q += rng.normal(0, noise, p_q.shape).astype(np.float32)
    p_q[:outliers] += 30.0
    return p_q, p_ref, T


def _assert_same(jres, tres):
    """Gates and counts exactly; the transform to 1e-5 (the loop stops at a
    1e-5 step), the error to 1e-4 relative."""
    assert bool(tres.ok) == bool(jres.ok)
    assert int(tres.inliers) == int(jres.inliers)
    assert int(tres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(tres.T_qr.numpy(), np.asarray(jres.T_qr), atol=1e-5)
    assert float(tres.avg_error) == pytest.approx(float(jres.avg_error),
                                                  rel=1e-4, abs=1e-7)


def test_icp_recovers_transform(rng):
    p_q, p_ref, T = _cloud_pair(rng, 100, [1.0, -0.5, 2.0, 0.05, 0.1, -0.02], 0.02)
    valid = np.ones(100, bool)
    jres = j_icp.align_clouds(jnp.asarray(p_q), jnp.asarray(p_ref), jnp.asarray(valid))
    tres = t_icp.align_clouds(tp.t32(p_q), tp.t32(p_ref), tp.tbool(valid), device="cpu")
    _assert_same(jres, tres)
    assert bool(tres.ok) and int(tres.inliers) == 100
    assert np.abs(tres.T_qr.numpy() - T).max() < 0.02
    assert tres.inliers.dtype == tres.iterations.dtype == torch.int32


def test_icp_robust_and_gates(rng):
    p_q, p_ref, T = _cloud_pair(rng, 60, [0.5, 0, 1.0, 0, 0.05, 0], outliers=12)
    valid = np.ones(60, bool)
    jres = j_icp.align_clouds(jnp.asarray(p_q), jnp.asarray(p_ref), jnp.asarray(valid))
    tres = t_icp.align_clouds(tp.t32(p_q), tp.t32(p_ref), tp.tbool(valid), device="cpu")
    _assert_same(jres, tres)
    assert bool(tres.ok) and np.abs(tres.T_qr.numpy() - T).max() < 0.05
    # too few points -> the gate fails, in both
    j2 = j_icp.align_clouds(jnp.asarray(p_q[:10]), jnp.asarray(p_ref[:10]),
                            jnp.ones(10, bool))
    t2 = t_icp.align_clouds(tp.t32(p_q[:10]), tp.t32(p_ref[:10]),
                            tp.tbool(np.ones(10, bool)), device="cpu")
    assert not bool(t2.ok) and not bool(j2.ok)
    assert int(t2.inliers) == int(j2.inliers)


def test_icp_options(rng):
    """``T_init``, the iteration cap and the gates as keywords."""
    p_q, p_ref, T = _cloud_pair(rng, 80, [0.4, 0.1, -0.6, 0.02, -0.04, 0.01], 0.01)
    valid = rng.random(80) > 0.2
    T0 = tp.exp_se3_np([0.3, 0, -0.5, 0, 0, 0]).astype(np.float32)
    kw = dict(max_iterations=2, min_inliers=70, inlier_m2=0.5)
    jres = j_icp.align_clouds(jnp.asarray(p_q), jnp.asarray(p_ref), jnp.asarray(valid),
                              T_init=jnp.asarray(T0), **kw)
    tres = t_icp.align_clouds(tp.t32(p_q), tp.t32(p_ref), tp.tbool(valid),
                              T_init=tp.t32(T0), device="cpu", **kw)
    _assert_same(jres, tres)
    assert int(tres.iterations) == 2 and not bool(tres.ok)     # 64 < 70 inliers


def test_icp_batch_freezes_finished_candidates(rng):
    """Four candidates that need different numbers of iterations: in the
    batch each keeps its own count and its own transform, as under the JAX
    package's ``vmap``."""
    pairs = [_cloud_pair(rng, 64, xi, noise, out) for xi, noise, out in (
        ([0, 0, 0, 0, 0, 0], 0.0, 0),
        ([1.0, -0.5, 2.0, 0.05, 0.1, -0.02], 0.02, 0),
        ([3.0, 1.0, -2.0, 0.2, -0.3, 0.1], 0.05, 10),
        ([0.5, 0, 1.0, 0, 0.05, 0], 0.0, 45))]
    p_q = np.stack([p[0] for p in pairs])
    p_ref = np.stack([p[1] for p in pairs])
    valid = np.ones((4, 64), bool)
    valid[1, 50:] = False
    jres = j_icp.align_clouds_batch(jnp.asarray(p_q), jnp.asarray(p_ref),
                                    jnp.asarray(valid))
    tres = t_icp.align_clouds_batch(tp.t32(p_q), tp.t32(p_ref), tp.tbool(valid),
                                    device="cpu")
    its = tres.iterations.tolist()
    assert its == np.asarray(jres.iterations).tolist()
    assert len(set(its)) > 1                                 # they do differ
    assert tres.ok.tolist() == np.asarray(jres.ok).tolist()
    assert tres.inliers.tolist() == np.asarray(jres.inliers).tolist()
    np.testing.assert_allclose(tres.T_qr.numpy(), np.asarray(jres.T_qr), atol=1e-5)
    for b in range(4):
        one = t_icp.align_clouds(tp.t32(p_q[b]), tp.t32(p_ref[b]), tp.tbool(valid[b]),
                                 device="cpu")
        assert int(one.iterations) == its[b]
        np.testing.assert_allclose(one.T_qr.numpy(), tres.T_qr[b].numpy(), atol=1e-6)
        assert bool(one.ok) == bool(tres.ok[b])
