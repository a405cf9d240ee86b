"""The port's headless viewer (``eval/viewer.py``) and ``tools/view_map``
against the JAX package's: the HTML file byte for byte, the snapshot of a
JAX-written checkpoint loaded by each package, and the PNG."""

import sys

import numpy as np
import pytest

from svi_mapper_tpu.eval import viewer as jviewer
from svi_mapper_tpu_torch.eval import viewer as tviewer

import torch_parity  # noqa: F401  (thread count for the parallel suite)


def _traj(n, seed=0):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, 0, 3] = -np.arange(n, dtype=np.float32)
    T[:, 2, 3] = rng.normal(0, 0.3, n).astype(np.float32)
    return T


def _snapshot():
    rng = np.random.default_rng(1)
    return dict(trajectory=_traj(9), landmarks=rng.normal(size=(40, 3)),
                keyframe_indices=[0, 4, 8], closures=[(0, 8)],
                ground_truth=_traj(9, seed=2),
                hud={"tracked": list(range(9)), "active": [40] * 9})


def test_export_html_byte_identical(tmp_path):
    snap = _snapshot()
    for kw in ({}, {"title": "a map", "max_landmarks": 7}):
        tviewer.export_html(tmp_path / "t.html", **snap, **kw)
        jviewer.export_html(tmp_path / "j.html", **snap, **kw)
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    tviewer.export_html(tmp_path / "t.html", _traj(3))
    jviewer.export_html(tmp_path / "j.html", _traj(3))
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_render_map_png(tmp_path):
    pytest.importorskip("matplotlib")
    tviewer.render_map(tmp_path / "m.png", **_snapshot())
    assert (tmp_path / "m.png").read_bytes()[:4] == b"\x89PNG"


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX SLAMSystem after 12 frames of the corridor at 512 x 256 (two
    keyframes), saved by the JAX package."""
    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.io.checkpoint import save_checkpoint
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.slam import SLAMSystem

    seq = SyntheticSequence(n_frames=12, width=512, height=256, step=1.0)
    s = SLAMSystem(seq.cam, DEFAULT_PARAMS, enable_local_ba=False, use_gt_pose=True)
    for (L, R, T) in seq:
        s.process(np.asarray(L), np.asarray(R), T_gt=np.asarray(T))
    path = tmp_path_factory.mktemp("ckpt") / "slam.npz"
    save_checkpoint(path, s)
    return path, seq.poses_wc


def test_snapshot_of_a_jax_checkpoint(jax_checkpoint):
    """The JAX-written checkpoint loaded by each package gives the same
    snapshot (no HUD: the per-frame outputs are not checkpointed)."""
    from svi_mapper_tpu.io.checkpoint import load_checkpoint as jload
    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint as tload

    path, _ = jax_checkpoint
    a = jviewer.snapshot_tracker(jload(path))
    b = tviewer.snapshot_tracker(tload(path, device="cpu"))
    assert sorted(a) == sorted(b) == ["closures", "keyframe_indices", "landmarks",
                                      "trajectory"]
    assert a["keyframe_indices"] == b["keyframe_indices"] and len(b["keyframe_indices"]) >= 1
    assert a["closures"] == b["closures"]
    np.testing.assert_array_equal(np.asarray(a["landmarks"]), b["landmarks"])
    assert len(b["landmarks"]) > 10
    np.testing.assert_array_equal(np.asarray(a["trajectory"]), b["trajectory"])


def test_view_map_same_html_as_jax(jax_checkpoint, tmp_path, capsys):
    """``view_map CKPT --html`` (the port loads the checkpoint onto the CPU
    itself) writes the JAX tool's file; so does a trajectory file with a
    ground truth."""
    import jax

    from svi_mapper_tpu.eval import trajectory as jev
    from svi_mapper_tpu.tools import view_map as jtool
    from svi_mapper_tpu_torch.tools import view_map as ttool

    path, poses = jax_checkpoint
    jev.save_kitti_trajectory(tmp_path / "gt.txt", poses)
    for src, extra in ((str(path), []), (str(tmp_path / "gt.txt"),
                                         ["--gt", str(tmp_path / "gt.txt")])):
        ttool.main([src, "--html", str(tmp_path / "t.html")] + extra)
        old = sys.argv
        sys.argv = ["view_map", src, "--html", str(tmp_path / "j.html")] + extra
        try:
            jtool.main()
        finally:
            sys.argv = old
            jax.config.update("jax_platforms", "cpu")
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ttool.main([str(path)])
