"""``eval/utilization.py`` of the port: what it counts and the rows it
gives, against the JAX package's module on the CPU. The card's rows (peaks,
shares, the four stages at 1241 x 376) come from ``chip_smoke.py``'s
``utilization`` phase."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.eval import utilization as jutil
from svi_mapper_tpu_torch.eval import utilization as tutil
from svi_mapper_tpu_torch.ops import paths

import torch_parity  # noqa: F401  (thread count for the parallel suite)

M, K, N = 48, 40, 56


def _matmul_args():
    rng = np.random.default_rng(0)
    return rng.random((M, K), dtype=np.float32), rng.random((K, N), dtype=np.float32)


@pytest.mark.parametrize("peaks", [None, ("1e6", "1e6")])
def test_matmul_stage_rows_match_jax(monkeypatch, peaks):
    """A matrix product: flops 2MNK, the JAX row's count; bytes the inputs
    plus the output; the row's keys those of the JAX package's row, without
    and with peaks given through the environment."""
    for var, val in zip(("SVI_PEAK_TFLOPS_BF16", "SVI_PEAK_HBM_GBPS"), peaks or (None, None)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    a, b = _matmul_args()
    row = tutil.analyze_stage(torch.matmul, (torch.from_numpy(a), torch.from_numpy(b)),
                              reps_sync=2, reps_stream=2, device="cpu")
    jrow = jutil.analyze_stage(jnp.matmul, (jnp.asarray(a), jnp.asarray(b)),
                               reps_sync=2, reps_stream=2)
    assert row["flops"] == 2 * M * N * K == jrow["flops"]
    assert row["bytes"] == 4 * (M * K + K * N + M * N)
    assert set(row) == set(jrow)
    assert row["bound"] in (("unknown",) if peaks is None else ("dispatch", "hbm", "compute"))
    if peaks:
        assert 0 < row["mfu"] <= 1.05 and 0 < row["hbm_frac"] <= 1.05


def test_bytes_count_each_op_once():
    """Views and allocations move nothing; a broadcast input counts its
    distinct elements; an in-place op reads and writes its tensor."""
    x = torch.ones(64, 1)
    flops, moved, kernels = tutil.count_work(lambda t: t.expand(64, 32).sum(), (x,), "cpu")
    assert (flops, kernels) == (0.0, {})
    assert moved == 64 * 4 + 4            # the broadcast input once, the sum out
    # reshaping the broadcast copies it once (read 64, write 64 x 32); the
    # sum then reads the copy
    _, moved, _ = tutil.count_work(lambda t: t.expand(64, 32).reshape(-1).sum(), (x,), "cpu")
    assert moved == 64 * 4 + 2 * 64 * 32 * 4 + 4
    _, moved, _ = tutil.count_work(lambda t: torch.empty(1000).add_(1.0), (x,), "cpu")
    assert moved == 2 * 1000 * 4


def test_kernel_work_is_read_only_while_recording():
    """A launch reports its function's work beside its count; the report is
    evaluated only inside ``recording_work``, and the count's own tensor ops
    are not counted as the stage's."""
    from svi_mapper_tpu_torch.ops import hamming

    calls = []

    def work():
        calls.append(1)
        torch.ones(10).sum()               # an op of the count itself
        return paths.hamming_matrix_work(1, 256, 4096)

    paths.reset_launch_counts()
    paths.count_launch(hamming.__name__, "hamming_matrix", work=work)
    assert calls == [] and paths.launch_counts()["hamming_matrix"] == 1
    flops, moved, kernels = tutil.count_work(
        lambda: paths.count_launch(hamming.__name__, "hamming_matrix", work=work), (), "cpu")
    b, o = paths.hamming_matrix_work(1, 256, 4096)
    assert kernels == {"hamming_matrix": [b, o]} and (moved, flops) == (b, o)
    assert calls == [1]
    assert (b, o) == ((256 + 4096) * 32 + 256 * 4096 * 4, 2 * 256 * 4096 * 256)
    paths.reset_launch_counts()


def test_work_formulas():
    """The formulas chip_smoke.py's bounds take, on small inputs whose
    counts are known."""
    assert paths.brief_dense_work(2, 16) == (32 * 36 + 4096, 32 * 276)
    assert paths.track_scores_work(3, 10, 7) == (320 + 3 * 108, 7 * 66)
    assert paths.pool_nn_counts_work(2, 4, 3, 5) == (2 * (4 * 33 + 15 * 33 + 12),
                                                      2 * 2 * 4 * 3 * 5 * 256)
    mask = np.zeros((3, 4), bool)
    mask[:, 0] = True                       # one landmark seen by 3 keyframes
    mask[0, 1] = True                       # one seen by 1
    w = paths.schur_work(mask, 3, 4)
    assert w["observations"] == 4
    assert w["product_flops_upper"] == 216 * (6 + 1)
    assert w["flops"] == 4 * (paths.SCHUR_FLOPS_PER_OBSERVATION + 126) + 216 * 7
    # the touched pixels of one landmark's window: every listed pixel once
    from svi_mapper_tpu_torch.frontend.epipolar import fixed_band_params
    from svi_mapper_tpu_torch.ops import stereo_kernel, track_kernel

    uv = torch.tensor([[60.0, 40.0], [60.0, 40.0]])
    touched, scored = track_kernel.scored_pixels(96, 128, uv, fixed_band_params(2, 28, 20))
    assert scored == 2 * touched > 0
    assert stereo_kernel.span_pixels(uv, 96, 128, 32) == 32


def test_peaks_and_the_device_rule(monkeypatch):
    monkeypatch.delenv("SVI_PEAK_TFLOPS_BF16", raising=False)
    monkeypatch.delenv("SVI_PEAK_HBM_GBPS", raising=False)
    assert tutil.device_peaks("cpu") is None
    assert tutil._PEAKS["NVIDIA H100 80GB HBM3"] == (989.0, 3350.0)
    monkeypatch.setenv("SVI_PEAK_TFLOPS_BF16", "1e-9")
    monkeypatch.setenv("SVI_PEAK_HBM_GBPS", "1e-9")
    assert tutil.device_peaks("cpu") == (1e-9, 1e-9)
    a, b = _matmul_args()
    with pytest.raises(RuntimeError, match="miscounted"):
        tutil.analyze_stage(torch.matmul, (torch.from_numpy(a), torch.from_numpy(b)),
                            reps_sync=1, reps_stream=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tutil.utilization_report(160, 96)
    rep = {"device_kind": "cpu", "peak_tflops_bf16": None, "peak_hbm_gbps": None,
           "stages": {"s": {"wall_sync_ms": 1.0, "wall_stream_ms": 0.5, "gflops_s": 2.0,
                            "gbytes_s": 3.0, "bound": "unknown"}}}
    assert tutil.format_report(rep).splitlines()[3] == jutil.format_report(rep).splitlines()[3]
