"""The yardstick of the Schur assembly (kernels K4 / K5 of
``svi_mapper_tpu_torch/ops/ba_kernel.py``): the work it must do on one
window and the card's published peaks, frozen here so that the roofline
share means the same in every later measurement, whatever the program
becomes.

Copied from ``svi_mapper_tpu_torch/ops/paths.py`` (``schur_work`` and
``SCHUR_FLOPS_PER_OBSERVATION``) as they stood when the benchmark was
defined; the peaks are NVIDIA's data sheet for the H100 SXM at its full
700 W: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import torch

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float operations per (keyframe, landmark) of the assembly's shared body:
# point 18, projection and residuals 31, weight 8, Jacobian rows
# 24 + 36 + 60, H_ll / b_l 63, W rows 126, H_pp / b_p 189
SCHUR_FLOPS_PER_OBSERVATION = 555


def schur_work(mask, K: int, L: int) -> dict:
    """The assembly of one ``[K, L]`` window: each input read once and each
    output written once; the assembly's operations per observation, and
    C = W Hll^-1 (90 per observed keyframe-landmark pair), the rhs column
    (36) and the product (216 per 6x6 block and landmark) only where an
    observation is, the product over the upper block triangle: n (n + 1) / 2
    blocks for a landmark that n keyframes observe."""
    n_l = (torch.as_tensor(mask) > 0).sum(0).to(torch.int64)
    n_obs = int(n_l.sum())
    pairs = int((n_l * (n_l + 1) // 2).sum())
    moved_in = 4 * (16 * K + 3 * L + 5 * K * L)
    moved_out = 4 * (36 * K * K + 6 * K + 12 * L + 18 * K * L)
    return dict(bytes=moved_in + moved_out,
                flops=n_obs * (SCHUR_FLOPS_PER_OBSERVATION + 90 + 36) + 216 * pairs,
                observations=n_obs)


def bound_seconds(work: dict) -> float:
    """The least time the card could take: operations at the float32 peak
    or bytes at the memory peak, whichever is longer."""
    return max(work["flops"] / PEAK_FLOPS_F32, work["bytes"] / PEAK_BYTES_PER_S)
