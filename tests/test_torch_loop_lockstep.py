"""The bench loop's front-end in lock step at full width (ROADMAP F9): the
port's ``process_frame`` against the JAX package's ``StereoTracker`` over
frames 0-32 of the 208-frame, 26 m loop at 376 x 1241 with the bench's
parameters (``bench.py:bench_full_slam``), frames rendered by the JAX
package's renderer. Before every frame the port starts from the JAX
tracker's state, so each frame step is compared on identical inputs.

The span covers the first crossing of the corridor wall's plane at frames
21-24, where the pose solve refuses frames in both packages. Bounds, as
``test_torch_frontend.py::test_lockstep_flags_counts_and_pose`` and the F9
note state them: ``posit_ok``, ``is_keyframe``, ``n_tracked``, ``inliers``
and ``instability`` equal on every frame; the pose within 1e-3 m and
1e-4 rad (found before this test: 3.9e-4 m at frame 18, 8e-6 m elsewhere).
"""

import dataclasses

import numpy as np
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.models.tracker import StereoTracker as JTracker
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.models import frame as frame_mod

from torch_parity import torch_camera, torch_state

LOOP_FRAMES, FRAMES, H, W = 208, 33, 376, 1241


def _params(base):
    return dataclasses.replace(base, max_landmarks=1024, max_detections=1024,
                               keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
                               max_motion_scaling_for_optimization=2.5)


def _pose_diff(A, B):
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    ca = -A[:3, :3].T @ A[:3, 3]
    cb = -B[:3, :3].T @ B[:3, 3]
    D = A[:3, :3] @ B[:3, :3].T
    w = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.linalg.norm(ca - cb)), float(np.arcsin(min(1.0, np.linalg.norm(w))))


@pytest.fixture(scope="module")
def lockstep():
    seq = SyntheticSequence(n_frames=LOOP_FRAMES, width=W, height=H, trajectory="loop",
                            loop_radius=26.0)
    cam = torch_camera(seq.cam)
    jt = JTracker(seq.cam, _params(JPARAMS))
    params = _params(DEFAULT_PARAMS)
    rows = []
    for i in range(FRAMES):
        L, R, _ = seq.frame(i)
        L, R = np.asarray(L), np.asarray(R)
        state_in = torch_state(jt.state)
        a = jt.process(L, R)
        _, b = frame_mod.process_frame(state_in, L, R, cam, params, device="cpu")
        rows.append((a, b.to_host()))
    centres = -np.einsum("nji,nj->ni", seq.poses_wc[:FRAMES, :3, :3],
                         seq.poses_wc[:FRAMES, :3, 3])
    return rows, centres


def test_loop_lockstep_flags_counts_and_pose(lockstep):
    rows, centres = lockstep
    for i, (a, b) in enumerate(rows):
        assert bool(a.posit_ok) == bool(b.posit_ok), i
        assert bool(a.is_keyframe) == bool(b.is_keyframe), i
        for name in ("n_tracked", "inliers", "instability"):
            assert int(getattr(a, name)) == int(getattr(b, name)), (i, name)
        dpos, drot = _pose_diff(a.T_wc, b.T_wc)
        assert dpos < 1e-3 and drot < 1e-4, (i, dpos, drot)


def test_span_covers_the_first_wall_crossing(lockstep):
    """The loop crosses the plane of the wall at x = 9 m inside the span,
    and the pose solve refuses frames there (in both packages, by the test
    above), and only there."""
    rows, centres = lockstep
    side = centres[:, 0] > 9.0
    crossings = [i for i in range(1, FRAMES) if side[i] != side[i - 1]]
    assert crossings and all(20 <= i <= 25 for i in crossings)
    refused = [i for i, (a, _) in enumerate(rows[1:], 1) if not bool(a.posit_ok)]
    assert refused and all(abs(i - crossings[0]) <= 2 for i in refused)
    assert sum(bool(a.is_keyframe) for a, _ in rows) >= 3
