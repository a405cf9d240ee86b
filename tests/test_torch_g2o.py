"""The port's g2o reader and writer against the JAX package's (numpy on both
sides): the same text out, and files cross both ways."""

import numpy as np
import pytest

from svi_mapper_tpu.io import g2o_export as jg2o
from svi_mapper_tpu_torch.io import g2o_export as tg2o

import torch_parity as tp


def _graph(rng, n=7):
    T_true, T_est = tp.pose_chain(rng, n, noise=0.01)
    edges = [(k - 1, k, T_est[k] @ np.linalg.inv(T_est[k - 1])) for k in range(1, n)]
    edges.append((0, n - 1, T_true[n - 1] @ np.linalg.inv(T_true[0])))
    # a half turn: the quaternion branch with w near 0
    T_est[3, :3, :3] = T_est[3, :3, :3] @ np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    lm = rng.normal(0, 5, (9, 3))
    ids = rng.permutation(50)[:9]
    return T_est, edges, lm, ids


def test_same_text(tmp_path, rng):
    T, edges, lm, ids = _graph(rng)
    jg2o.save_g2o(tmp_path / "j.g2o", T, edges, landmarks=lm, landmark_ids=ids)
    tg2o.save_g2o(tmp_path / "t.g2o", T, edges, landmarks=lm, landmark_ids=ids)
    assert (tmp_path / "t.g2o").read_text() == (tmp_path / "j.g2o").read_text()
    assert tg2o.LANDMARK_ID_SHIFT == jg2o.LANDMARK_ID_SHIFT


@pytest.mark.parametrize("writer,reader", [(jg2o, tg2o), (tg2o, jg2o), (tg2o, tg2o)])
def test_files_cross(tmp_path, rng, writer, reader):
    T, edges, lm, ids = _graph(rng)
    path = tmp_path / "graph.g2o"
    writer.save_g2o(path, T, edges, landmarks=lm, landmark_ids=ids, fixed=0)
    T2, edges2, lm2 = reader.load_g2o(path)
    np.testing.assert_allclose(T2, T, atol=1e-5)
    assert [(i, j) for i, j, _ in edges2] == [(i, j) for i, j, _ in edges]
    for (_, _, a), (_, _, b) in zip(edges2, edges):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert sorted(lm2) == sorted(int(i) for i in ids)
    for uid, p in zip(ids, lm):
        np.testing.assert_allclose(lm2[int(uid)], p, atol=1e-8)


def test_snapshot_of_a_slam_system(tmp_path):
    """``snapshot_slam`` on the port's system: keyframe chain, closure edge
    and the active landmarks of its table."""
    import torch

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.models import slam

    s = slam.SLAMSystem(default_camera(128, 64, device="cpu"), DEFAULT_PARAMS,
                        device="cpu", graph_snapshot_dir=str(tmp_path / "snaps"))
    for k in range(4):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = -0.5 * k
        s.slam_keyframes.append(slam.SLAMKeyframe(
            index=k, frame_idx=k, T_wc=T, obs_uids=np.zeros(0, np.int64),
            obs_uv4=np.zeros((0, 4), np.float32), pool_uids=np.zeros(0, np.int64)))
    s.accepted_closures.append(slam.ClosureEdge(0, 3, np.eye(4, dtype=np.float32), True))
    t = s.state.table
    active = torch.zeros_like(t.active)
    active[:5] = True
    s.state = s.state.replace(table=t.replace(
        active=active, uid=torch.arange(t.capacity, dtype=torch.int32)))
    s._snapshot_graph("pre")
    T2, edges, lm = tg2o.load_g2o(tmp_path / "snaps" / "keyframes_0-3_pre.g2o")
    assert T2.shape == (4, 4, 4) and len(edges) == 4 and sorted(lm) == [0, 1, 2, 3, 4]
    assert (edges[-1][0], edges[-1][1]) == (0, 3)
