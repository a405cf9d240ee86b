"""Stereo scanline Hamming profiles and the fused scanline match: kernel K2
and its plain versions.

For each left keypoint, the Hamming distance of its descriptor against the
``De = min(max_disparity, W)`` candidate pixels of row ``v_r`` of the RIGHT
dense field, starting at column ``x0 = clip(u_r - (De-1), 0, W-De)``. The
profile is in REVERSED column order, so index ``i`` corresponds to column
``x0 + (De-1) - i`` and disparities ascend with ``i``.

Two functions, one CUDA source (``csrc/stereo_profiles.cu``, one scoring
core behind two C entries):

  * :func:`stereo_profiles` — the TPU kernel's function: ``(profile [K, De],
    u_r, x0)``; plain version :func:`row_span_profiles` after
    :func:`span_origin`;
  * :func:`stereo_match` — what ``frontend.stereo.match_stereo`` needs of
    the profile, fused: the candidate masks, the first masked minimum and
    its two neighbours, as one ``[6, K]`` int32 tensor (rows
    :data:`MATCH_ROWS`); plain version :func:`stereo_match_plain`. The
    ``[K, De]`` profile is never written on the card.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors.

Replaces the TPU kernel ``svi_mapper_tpu/ops/stereo_kernel.py``
``stereo_profiles`` (``_kernel``). Its row sort, slab streaming, 16-px
aligned span origin and span padding served the TPU's memory layout and are
not carried over.

Bound on the card (K = 1024, De = 128): each keypoint reads a 4 KB row span
and its 32-byte descriptor (4.2 MB in all: spans of different keypoints
rarely coincide, so each counts) against K * De * ~24 integer operations;
bytes bound it. Design: one warp per keypoint, every load instruction of a
warp reads 512 contiguous bytes of the span, a lane starts all its loads
before its first popcount, and the rounding and span origin are computed
in the kernel (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths
from svi_mapper_tpu_torch.ops.descriptors import (
    DESCRIPTOR_WORDS,
    hamming_words,
    round_pixel,
)

_BIG = 1 << 20
# the rows of stereo_match's [6, K] result
MATCH_ROWS = ("best", "best_dist", "dm", "dp", "u_r", "x0")
_WARPS = 4                  # keypoints per block in csrc/stereo_profiles.cu
_SHARED_MAX = 48 * 1024     # static limit of a block's dynamic shared memory


def span_origin(uv_left: torch.Tensor, h: int, w: int, De: int):
    """Rounded keypoint pixel and clamped span origin, all ``[K]`` int32.
    Non-finite coordinates read pixel (0, 0): every candidate of such a row
    is masked by ``match_stereo`` afterwards. Rounded by
    :func:`~svi_mapper_tpu_torch.ops.descriptors.round_pixel`
    (``csrc/round_pixel.cuh`` in the kernel)."""
    u_r, v_r = round_pixel(
        torch.nan_to_num(uv_left, nan=0.0, posinf=0.0, neginf=0.0), h, w)
    x0 = torch.clamp(u_r - (De - 1), 0, w - De)
    return u_r, v_r, x0


def span_pixels(uv_left: torch.Tensor, h: int, w: int, De: int) -> int:
    """The distinct field pixels the spans of all keypoints cover (the
    data-dependent count of a call's work)."""
    _, v_r, x0 = span_origin(uv_left, h, w, De)
    cols = x0[:, None] + torch.arange(De, device=uv_left.device)[None, :]
    return paths.unique_pixels(h, w, v_r[:, None].expand(-1, De), cols)


def row_span_profiles(dense_right, v_r, x0, desc_left, De: int) -> torch.Tensor:
    """Plain PyTorch profile: ``[K, De]`` int32, ascending disparity."""
    dev = dense_right.device
    cols = (x0[:, None] + (De - 1)
            - torch.arange(De, dtype=torch.int32, device=dev)[None, :])
    cand = dense_right[v_r[:, None].to(torch.int64), cols.to(torch.int64)]
    return hamming_words(cand, desc_left[:, None, :])


def stereo_match_plain(dense_right, uv_left, desc_left, *, max_disparity: int = 128,
                       min_disparity: float = 0.5, disparity_center=None,
                       search_range=None) -> torch.Tensor:
    """Plain version of :func:`stereo_match`: the profile, then the
    candidate masks of ``match_stereo`` (inside the image in FLOAT
    coordinates ``d <= u``, the disparity floor and ceiling, the optional
    range ``|d - center| <= range``, 60 px when only the centre is given),
    the first masked minimum and its neighbours' masked distances."""
    h, w, _ = dense_right.shape
    K = uv_left.shape[0]
    dt, dev = uv_left.dtype, uv_left.device
    De = min(max_disparity, w)
    u_r, v_r, x0 = span_origin(uv_left, h, w, De)
    dist = row_span_profiles(dense_right, v_r, x0, desc_left, De)
    # disparity of profile index i: u = x0 + (De-1) - i, d = u_r - u
    base = (u_r - x0 - (De - 1)).to(dt)                          # [K] (<= 0)
    disps = base[:, None] + torch.arange(De, dtype=dt, device=dev)[None, :]
    okc = (disps >= min_disparity) & (disps <= uv_left[:, 0:1]) \
        & (disps <= De - 1)
    if disparity_center is not None:
        rng = (search_range if search_range is not None
               else torch.full((K,), 60.0, dtype=dt, device=dev))
        okc = okc & (torch.abs(disps - disparity_center[:, None]) <= rng[:, None])
    dist = torch.where(okc, dist, torch.full_like(dist, _BIG))
    best_dist, best = torch.min(dist, dim=1)                     # the first minimum
    dm = torch.gather(dist, 1, torch.clamp(best - 1, 0, De - 1)[:, None])[:, 0]
    dp = torch.gather(dist, 1, torch.clamp(best + 1, 0, De - 1)[:, None])[:, 0]
    return torch.stack([best.to(torch.int32), best_dist, dm, dp, u_r, x0])


stereo_profiles_launches = 0
stereo_match_launches = 0


def _check_inputs(name, dense_right, uv_left, desc_left):
    """The contiguous CUDA inputs the kernels take, or raise."""
    K = uv_left.shape[0]
    cuda_build.require_int32_contiguous(dense_right, "dense_right", (DESCRIPTOR_WORDS,))
    desc = desc_left.contiguous()
    cuda_build.require_int32_contiguous(desc, "desc_left", (DESCRIPTOR_WORDS,))
    uv = uv_left.contiguous()
    if not (desc.is_cuda and uv.is_cuda and uv.dtype == torch.float32
            and uv.shape == (K, 2) and desc.shape[0] == K
            and uv.device == desc.device == dense_right.device):
        raise ValueError(f"{name}: keypoints must be CUDA float32 [K, 2] with "
                         "[K, 8] int32 descriptors on the field's device")
    return uv, desc


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
    De = min(max_disparity, w)
    if not dense_right.is_cuda:
        u_r, v_r, x0 = span_origin(uv_left, h, w, De)
        return row_span_profiles(dense_right, v_r, x0, desc_left, De), u_r, x0
    uv, desc = _check_inputs("stereo_profiles", dense_right, uv_left, desc_left)
    return launch_stereo_profiles(cuda_build.load_library(), dense_right, uv, desc, De)


def launch_stereo_profiles(lib, dense_right, uv, desc, De: int):
    """Allocate ``(profile, u_r, x0)`` and launch the profile kernel on
    checked, contiguous CUDA inputs."""
    K = desc.shape[0]
    h, w = dense_right.shape[:2]
    out = torch.empty((K * (De + 2),), dtype=torch.int32, device=dense_right.device)
    profile, u_r, x0 = out[:K * De].view(K, De), out[K * De:K * (De + 1)], out[K * (De + 1):]
    if K > 0:
        with torch.cuda.device(dense_right.device):
            err = lib.svi_stereo_profiles(
                dense_right.data_ptr(), uv.data_ptr(), desc.data_ptr(),
                profile.data_ptr(), u_r.data_ptr(), x0.data_ptr(), K, De, h, w,
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_stereo_profiles")
        paths.count_launch(__name__, "stereo_profiles", work=lambda: paths.stereo_profiles_work(
            K, De, span_pixels(uv, h, w, De)))
    return profile, u_r, x0


def stereo_match(
    dense_right: torch.Tensor,    # [H, W, 8] int32 dense BRIEF field
    uv_left: torch.Tensor,        # [K, 2] float32 left keypoints
    desc_left: torch.Tensor,      # [K, 8] int32
    *,
    max_disparity: int = 128,
    min_disparity: float = 0.5,
    disparity_center: torch.Tensor | None = None,   # [K]
    search_range: torch.Tensor | None = None,       # [K]
) -> torch.Tensor:
    """The integers ``match_stereo`` takes from the scanline search, one
    ``[6, K]`` int32 tensor with the rows :data:`MATCH_ROWS`: the index of
    the first masked minimum, its distance (``1 << 20`` if every candidate
    is masked), the masked distances at the index before and after it
    (clamped to the span), ``u_r`` and ``x0``.

    A CUDA field goes through the hand-written kernel (or raises); only a
    CPU field takes :func:`stereo_match_plain`.
    """
    kw = dict(max_disparity=max_disparity, min_disparity=min_disparity,
              disparity_center=disparity_center, search_range=search_range)
    if not dense_right.is_cuda:
        return stereo_match_plain(dense_right, uv_left, desc_left, **kw)
    uv, desc = _check_inputs("stereo_match", dense_right, uv_left, desc_left)
    ranges = []
    for name, t in (("disparity_center", disparity_center), ("search_range", search_range)):
        if t is not None:
            t = t.contiguous()
            if not (t.dtype == torch.float32 and t.shape == (uv.shape[0],)
                    and t.device == uv.device):
                raise ValueError(f"stereo_match: {name} must be CUDA float32 [K]")
        ranges.append(t)
    De = min(max_disparity, dense_right.shape[1])
    return launch_stereo_match(cuda_build.load_library(), dense_right, uv, desc,
                               *ranges, De, min_disparity)


def launch_stereo_match(lib, dense_right, uv, desc, center, search_range, De: int,
                        min_disparity: float) -> torch.Tensor:
    """Allocate the ``[6, K]`` result and launch the match kernel on checked,
    contiguous CUDA inputs (``center`` / ``search_range`` may be None; the
    range applies only with a centre)."""
    K = desc.shape[0]
    h, w = dense_right.shape[:2]
    if _WARPS * De * 4 > _SHARED_MAX:
        raise ValueError(f"stereo_match: a span of {De} pixels exceeds shared memory")
    out = torch.empty((len(MATCH_ROWS), K), dtype=torch.int32, device=dense_right.device)
    if K > 0:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(dense_right.device):
            err = lib.svi_stereo_match(
                dense_right.data_ptr(), uv.data_ptr(), desc.data_ptr(), ptr(center),
                ptr(search_range) if center is not None else None, out.data_ptr(),
                K, De, h, w, ctypes.c_float(min_disparity),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_stereo_match")
        paths.count_launch(__name__, "stereo_match", work=lambda: paths.stereo_match_work(
            K, De, span_pixels(uv, h, w, De)))
    return out
