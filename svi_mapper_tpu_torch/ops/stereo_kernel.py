"""Stereo scanline Hamming profiles: kernel K2 and its plain version.

For each left keypoint, the Hamming distance of its descriptor against the
``De = min(max_disparity, W)`` candidate pixels of row ``v_r`` of the RIGHT
dense field, starting at column ``x0 = clip(u_r - (De-1), 0, W-De)``. The
profile is returned in REVERSED column order, so index ``i`` corresponds to
column ``x0 + (De-1) - i`` and disparities ascend with ``i``. All matching
semantics (disparity grid, masks, argmin, sub-pixel parabola, gates) stay in
``frontend.stereo.match_stereo``; this module only replaces the fetch +
popcount.

:func:`row_span_profiles` is the plain PyTorch version;
:func:`stereo_profiles` launches the hand-written CUDA kernel
(``csrc/stereo_profiles.cu``) for CUDA tensors and takes the plain version
only for CPU tensors.

Replaces the TPU kernel ``svi_mapper_tpu/ops/stereo_kernel.py``
``stereo_profiles`` (``_kernel``). Its row sort, slab streaming, 16-px
aligned span origin and span padding served the TPU's memory layout and are
not carried over.

Bound on the card (K = 1024, De = 128): each keypoint reads a 4 KB row span
and its 32-byte descriptor and writes 512 bytes: 4.7 MB in all (spans of
different keypoints rarely coincide, so each counts) against
K * De * ~24 integer operations = ~3 M operations. Bytes bound it. Design:
one warp per keypoint, the descriptor in registers, lanes stride over the
candidate columns with two 16-byte loads each and write the profile
coalesced.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops import cuda_build
from svi_mapper_tpu_torch.ops.descriptors import (
    DESCRIPTOR_WORDS,
    hamming_words,
    round_pixel,
)


def span_origin(uv_left: torch.Tensor, h: int, w: int, De: int):
    """Rounded keypoint pixel and clamped span origin, all ``[K]`` int32.
    Non-finite coordinates read pixel (0, 0): every candidate of such a row
    is masked by ``match_stereo`` afterwards. Rounded by
    :func:`~svi_mapper_tpu_torch.ops.descriptors.round_pixel`."""
    u_r, v_r = round_pixel(
        torch.nan_to_num(uv_left, nan=0.0, posinf=0.0, neginf=0.0), h, w)
    x0 = torch.clamp(u_r - (De - 1), 0, w - De)
    return u_r, v_r, x0


def row_span_profiles(dense_right, v_r, x0, desc_left, De: int) -> torch.Tensor:
    """Plain PyTorch profile: ``[K, De]`` int32, ascending disparity."""
    dev = dense_right.device
    cols = (x0[:, None] + (De - 1)
            - torch.arange(De, dtype=torch.int32, device=dev)[None, :])
    cand = dense_right[v_r[:, None].to(torch.int64), cols.to(torch.int64)]
    return hamming_words(cand, desc_left[:, None, :])


stereo_profiles_launches = 0


def stereo_profiles(
    dense_right: torch.Tensor,    # [H, W, 8] int32 dense BRIEF field
    uv_left: torch.Tensor,        # [K, 2] float left keypoints
    desc_left: torch.Tensor,      # [K, 8] int32
    *,
    max_disparity: int = 128,
):
    """Scanline Hamming profiles of every keypoint.

    Returns ``(profile [K, De] int32, u_r [K] int32, x0 [K] int32)`` with
    ``profile[k, i] = Hamming(desc_left[k],
    dense_right[v_r[k], x0[k] + De-1 - i])``.

    A CUDA field goes through the hand-written kernel (or raises); only a
    CPU field takes the plain version.
    """
    h, w, _ = dense_right.shape
    K = uv_left.shape[0]
    De = min(max_disparity, w)
    u_r, v_r, x0 = span_origin(uv_left, h, w, De)
    if not dense_right.is_cuda:
        return row_span_profiles(dense_right, v_r, x0, desc_left, De), u_r, x0

    lib = cuda_build.load_library()
    cuda_build.require_int32_contiguous(dense_right, "dense_right",
                                        (DESCRIPTOR_WORDS,))
    desc = desc_left.contiguous()
    cuda_build.require_int32_contiguous(desc, "desc_left", (DESCRIPTOR_WORDS,))
    if not (desc.is_cuda and uv_left.is_cuda and desc.shape[0] == K):
        raise ValueError("stereo_profiles: keypoint inputs must be CUDA [K, ...]")
    out = launch_stereo_profiles(lib, dense_right, v_r.contiguous(),
                                 x0.contiguous(), desc, De)
    return out, u_r, x0


def launch_stereo_profiles(lib, dense_right, v_r, x0, desc, De: int):
    """Allocate the profile and launch the kernel on checked, contiguous
    CUDA inputs."""
    global stereo_profiles_launches
    K = desc.shape[0]
    w = dense_right.shape[1]
    out = torch.empty((K, De), dtype=torch.int32, device=dense_right.device)
    if K > 0:
        with torch.cuda.device(dense_right.device):
            err = lib.svi_stereo_profiles(
                dense_right.data_ptr(), v_r.data_ptr(), x0.data_ptr(),
                desc.data_ptr(), out.data_ptr(), K, De, w,
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_stereo_profiles")
        stereo_profiles_launches += 1
    return out
