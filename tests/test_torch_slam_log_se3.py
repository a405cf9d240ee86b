"""The loop of ``test_torch_slam.py`` once more, with the port's ``log_se3``
switched to the JAX package's branch point.

``test_torch_slam.py`` finds the two packages' optimised trajectories 0.079 m
apart on its 9 m loop and names ``log_se3`` as the reason: the port takes
the series below theta^2 = 1e-4, the JAX package below 1e-8, and in float32
the JAX package's closed form is wrong for rotations of 1e-4..1e-3 rad,
where pose-graph and odometry-chain residuals end up, so LM steps are
accepted differently. Here that reason is measured: with the branch point
set to the JAX package's, the port makes the same decisions and its
optimised trajectory and keyframe poses are held to 6e-3 m and 2e-3 in
rotation entries of the JAX package's (found: 1.9e-3 m, 1.4e-3 m, 3.5e-4).
A wrong BA write-back or pose-graph weight does not pass these bounds.
Same inputs as the other file: 80 frames of 384 x 192 rendered by the JAX
package, ``use_gt_pose=True`` in both.
"""

import dataclasses

import numpy as np
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io import synthetic as jsyn
from svi_mapper_tpu.models import slam as jslam
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS as TPARAMS
from svi_mapper_tpu_torch.geometry import se3 as tse3
from svi_mapper_tpu_torch.models import slam as tslam

import torch_parity as tp
from test_torch_slam import LOOP, LOOP_KW


@pytest.fixture(scope="module")
def runs():
    seq = jsyn.SyntheticSequence(**LOOP)
    frames = [seq.frame(i) for i in range(seq.n_frames)]
    L = np.stack([np.asarray(f[0]) for f in frames])
    R = np.stack([np.asarray(f[1]) for f in frames])
    j = jslam.SLAMSystem(seq.cam, dataclasses.replace(JPARAMS, **LOOP_KW),
                         use_gt_pose=True)
    t = tslam.SLAMSystem(tp.torch_camera(seq.cam), dataclasses.replace(TPARAMS, **LOOP_KW),
                         use_gt_pose=True, device="cpu")
    j.process_many(L, R, T_gt=seq.poses_wc, chunk=16)
    j.finalize_backend()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tse3, "_LOG_SE3_TAYLOR", 1e-8)     # the JAX package's
        t.process_many(L, R, T_gt=seq.poses_wc, chunk=16)
        t.finalize_backend()
    return j, t


def _centres(T):
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def test_same_decisions(runs):
    j, t = runs
    assert [kf.frame_idx for kf in t.slam_keyframes] == [
        kf.frame_idx for kf in j.slam_keyframes]
    assert [(c.ref_kf, c.query_kf) for c in t.accepted_closures] == [
        (c.ref_kf, c.query_kf) for c in j.accepted_closures]
    assert len(t.accepted_closures) >= 1
    for name in ("closures_found", "closures_accepted", "closures_deduped",
                 "pose_graph_runs", "ba_runs", "landmarks_merged"):
        assert t.stats.get(name, 0) == j.stats.get(name, 0), name
    assert t.stats["ba_runs"] >= 1 and t.stats["pose_graph_runs"] >= 1


def test_optimised_trajectory_within_millimetres(runs):
    j, t = runs
    opt_t, opt_j = t.optimized_trajectory(), j.optimized_trajectory()
    assert np.abs(_centres(opt_t) - _centres(opt_j)).max() < 6e-3      # found 1.9e-3


def test_keyframe_poses_within_millimetres(runs):
    j, t = runs
    kf_t = np.stack([kf.T_wc for kf in t.slam_keyframes])
    kf_j = np.stack([kf.T_wc for kf in j.slam_keyframes])
    assert np.abs(_centres(kf_t) - _centres(kf_j)).max() < 6e-3        # found 1.4e-3
    assert np.abs(kf_t[:, :3, :3] - kf_j[:, :3, :3]).max() < 2e-3      # found 3.5e-4
