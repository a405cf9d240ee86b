"""The port's copy of ``eval/trajectory.py`` against the JAX package's on
seeded trajectories (numpy only on both sides: results equal to 1e-12)."""

import numpy as np
import pytest

from svi_mapper_tpu.eval import trajectory as j_ev
from svi_mapper_tpu_torch.eval import trajectory as t_ev

from torch_parity import exp_se3_np

TOL = 1e-12


def _trajectories(seed, n=40, noise=0.05):
    rng = np.random.default_rng(seed)
    gt = np.stack([np.linalg.inv(exp_se3_np(np.r_[0.3 * np.sin(0.2 * k), 0.02 * k, 0.8 * k,
                                                   0.01 * k, 0.05 * np.sin(0.1 * k), 0.0]))
                   for k in range(n)])
    est = np.stack([exp_se3_np(rng.normal(0, [noise] * 3 + [noise / 10] * 3)) @ T
                    for T in gt])
    # a rigid offset of the whole estimate, which alignment removes
    G = exp_se3_np(np.array([1.0, -2.0, 0.5, 0.1, -0.2, 0.3]))
    return (est @ G).astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match(seed):
    est, gt = _trajectories(seed)
    for align in (True, False):
        assert abs(t_ev.ate_rmse(est, gt, align) - j_ev.ate_rmse(est, gt, align)) < TOL
    a, b = j_ev.evaluate(est, gt), t_ev.evaluate(est, gt)
    for f in ("ate_rmse_m", "rel_trans_err_m", "rel_trans_ratio", "rel_rot_err_rad",
              "precision", "n_frames"):
        assert abs(getattr(a, f) - getattr(b, f)) < TOL, f
    for x, y in zip(j_ev.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]),
                    t_ev.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])):
        np.testing.assert_allclose(y, x, atol=TOL, rtol=0)
    for x, y in zip(j_ev.align_trajectory(est, gt), t_ev.align_trajectory(est, gt)):
        np.testing.assert_allclose(y, x, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_ev.rotation_error(est[:, :3, :3], gt[:, :3, :3]),
                               j_ev.rotation_error(est[:, :3, :3], gt[:, :3, :3]), atol=TOL)
    # alignment removes the rigid offset: what is left is the noise
    assert t_ev.ate_rmse(est, gt) < 0.2 < t_ev.ate_rmse(est, gt, align=False)


def test_interpolation_and_kitti_files(tmp_path):
    est, gt = _trajectories(4, n=12)
    times = np.arange(12) * 0.1
    dst = np.array([-0.05, 0.0, 0.03, 0.25, 0.55, 1.1, 1.2])
    np.testing.assert_array_equal(t_ev.interpolate_trajectory(times, gt, dst),
                                  j_ev.interpolate_trajectory(times, gt, dst))
    path = tmp_path / "t.txt"
    t_ev.save_kitti_trajectory(path, est)
    text = path.read_text()
    j_ev.save_kitti_trajectory(tmp_path / "j.txt", est)
    assert text == (tmp_path / "j.txt").read_text()
    back = t_ev.load_kitti_trajectory(path)
    np.testing.assert_array_equal(back, j_ev.load_kitti_trajectory(path))
    np.testing.assert_allclose(back, est, atol=1e-5)
