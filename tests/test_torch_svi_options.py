"""``StereoInertialTracker`` with ``SLAMSystem``'s worker and index options,
passed through ``**kwargs`` as in the JAX package: the closure worker, the
back-end worker (``"force"``: one CPU is one device), the native index.

The corridor run of ``test_torch_svi_system.py``'s gravity test (16 frames
at 512 x 256, keyframes every 0.5 m, BA every 2 keyframes) per frame and
chunked: the gravity observations are recorded on the tracker thread once
per keyframe, the worker's BA windows get their gravity unaries, and the
keyframe rotations stay within 0.995 (cosine) of the recorded gravity, as
in the synchronous test.
"""

import dataclasses
import threading

import numpy as np
import pytest

from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.imu import interpolator as imu
from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence
from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

from test_torch_svi_system import UP, _corridor_imu

CPU = "cpu"


@pytest.mark.parametrize("option,chunked", [
    ({"async_closure": True}, False),
    ({"overlap_backend": "force"}, False),
    ({"overlap_backend": "force"}, True),
    ({"native_index": True}, True),
])
def test_options_keep_the_gravity_unaries(option, chunked):
    rng = np.random.default_rng(0)
    seq = SyntheticSequence(n_frames=16, width=512, height=256, step=0.5, device=CPU)
    dt = 0.05
    omega, accel, calib = _corridor_imu(seq, dt, rng)
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=512, max_detections=512,
        keyframe_translation_m2=0.25, keyframe_rotation_rad2=0.01,
        optimize_every_keyframes=4)
    windows = []

    class Recording(StereoInertialTracker):
        def _gravity_ba_terms(self, kfs, K):
            terms = super()._gravity_ba_terms(kfs, K)
            windows.append((terms is not None, threading.current_thread().name))
            return terms

    tr = Recording(seq.cam, calib, params, equalize=False, enable_loop_closure=True,
                   enable_local_ba=True, local_ba_every=2, device=CPU, **option)
    frames = list(seq)
    om = [np.zeros(3)] + [omega[i - 1] for i in range(1, len(frames))]
    ac = [UP * imu.GRAVITY] + [accel[i - 1] for i in range(1, len(frames))]
    if chunked:
        tr.process_many_imu(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
                            [np.full(1, dt, np.float32)] * len(frames),
                            [np.asarray(o, np.float32)[None] for o in om],
                            [np.asarray(a, np.float32)[None] for a in ac], chunk=8)
    else:
        for (L, R, _), o, a in zip(frames, om, ac):
            tr.process_imu(L, R, o, a, dt)
    tr.finalize_backend()
    assert not tr._pending_closures
    assert tr.stats["ba_runs"] >= 1 and windows and all(ok for ok, _ in windows)
    worker = {"async_closure": "MainThread", "overlap_backend": "backend_0",
              "native_index": "MainThread"}[next(iter(option))]
    assert {name for _, name in windows} == {worker}
    assert len(tr.slam_keyframes) >= 4
    assert len(tr.gravity_obs) == len(tr.slam_keyframes) == tr.db.n
    if "native_index" in option:
        assert tr.db.index.size == sum(tr.db.count_host)
    for k, kf in enumerate(tr.slam_keyframes):
        d = -np.asarray(kf.T_wc)[:3, 1]     # R_wc @ (0,-1,0)
        g = tr.gravity_obs[k]
        cosang = float(np.dot(d, g) / (np.linalg.norm(d) * np.linalg.norm(g)))
        assert cosang > 0.995, f"keyframe {k} tilted {np.degrees(np.arccos(min(cosang, 1))):.1f} deg"
    tr.close()
