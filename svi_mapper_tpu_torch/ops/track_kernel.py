"""Dense window scoring for temporal tracking: kernel K1 and its plain
version.

For every landmark, each pixel of the ``WIN_H x WIN_W`` window around the
rounded predicted reprojection is XOR-popcount scored against the
landmark's last and anchor descriptors, masked into three tiers (see
:func:`tier_scores`) and reduced by a min over ``score * 4096 + position``
(window-local row-major position, so ties resolve to the first pixel in
row-major order).

:func:`window_scores` is the plain PyTorch version; :func:`track_scores` is
the wrapper that launches the hand-written CUDA kernel
(``csrc/track_scores.cu``) for CUDA tensors and takes the plain version only
for CPU tensors.

Replaces the TPU kernel ``svi_mapper_tpu/ops/track_kernel.py``
``track_scores`` (``_kernel`` / ``_score_window``). What that kernel did
for the TPU's memory system — sorting landmarks by row, streaming row slabs
through fast memory, 16-px-aligned over-wide blocks, a matrix product to sum
8-word popcounts — is not carried over: here blocks run in any order, the
field stays in the L2 cache and popcount is an instruction.

Bound on the card (L = 1024, 376x1248 field): the inputs are the field
pixels the tiers can accept (a few hundred per landmark, many shared) plus
~0.1 MB of per-landmark data, read once; the work is ~66 integer operations
per such pixel. Bytes bound it. Design: one block per landmark; the
prediction is rounded in the kernel; :func:`tier_row_intervals` gives each
window row's column intervals of the tier-1 box and the tier-2 band, and
only those pixels are loaded (two 16-byte loads each) and popcounted, not
the whole 41x57 window; the block reduces the min key by warp shuffles.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths
from svi_mapper_tpu_torch.ops.descriptors import (
    DESCRIPTOR_WORDS,
    hamming_words,
    round_pixel,
)

# window geometry — the acceptance-mask reach of frontend.tracking
REACH_X = 28                 # ref: epipolar reach, <= the 28 px FoV inset
REACH_Y = 20                 # vertical reach for steep epipolar lines
WIN_W = 2 * REACH_X + 1      # 57
WIN_H = 2 * REACH_Y + 1      # 41

# fixed-point scale of the band test and the accepted half width (+-2.5 px)
BAND_SCALE = 256
BAND_HALF_WIDTH_Q = 640

# score bias per tier: stage-1 hits dominate stage-2 dominate stage-3
TIER_BIAS = (0, 1000, 2000)
BIG = 1 << 20
# rejected-candidate sentinel before the BIG rewrite: keeps the fused
# (score, position) key ``score * 4096 + pos`` exact in int32
_BIG_K = 4096


def tier_scores(dx, dy, d_last, ref_ok, nxq, nyq, c0q, ru, rv,
                cutoff_s1, cutoff_s2):
    """The per-pixel tier scoring over integer window offsets — THE tracking
    acceptance spec, restated in integers by ``csrc/track_scores.cu``.

    ``dx, dy`` are int32 offsets from the rounded prediction pixel;
    ``d_last`` the Hamming distance to the last descriptor; ``ref_ok`` the
    dual-descriptor gate; ``nxq/nyq/c0q/ru/rv`` the per-landmark band
    parameters broadcast alongside. Tiers are CUMULATIVE fallbacks, as in
    the reference's cascade (CFundamentalMatcher.cpp:391-2397):

      tier 0: the 3x3 cell at the prediction, cutoff ``cutoff_s1``;
      tier 1: |dx|, |dy| <= 8, cutoff ``cutoff_s2``;
      tier 2: the oriented epipolar band
              ``|c0q + nxq*dx + nyq*dy| <= 640`` within the (ru, rv) reach,
              cutoff ``cutoff_s2``.

    Per-pixel score = min over tiers of ``d_last + tier_bias`` where the
    tier's region and cutoff accept (``4096`` where nothing accepts).
    """
    adx, ady = torch.abs(dx), torch.abs(dy)
    t0 = (adx <= 1) & (ady <= 1)
    t1 = (adx <= 8) & (ady <= 8)
    band = torch.abs(c0q + nxq * dx + nyq * dy) <= BAND_HALF_WIDTH_Q
    t2 = band & (adx <= ru) & (ady <= rv)
    big = torch.full_like(d_last, _BIG_K)
    s0 = torch.where(t0 & (d_last <= cutoff_s1) & ref_ok,
                     d_last + TIER_BIAS[0], big)
    ok2 = (d_last <= cutoff_s2) & ref_ok
    s1 = torch.where(t1 & ok2, d_last + TIER_BIAS[1], big)
    s2 = torch.where(t2 & ok2, d_last + TIER_BIAS[2], big)
    return torch.minimum(s0, torch.minimum(s1, s2))


def window_origin(uv_pred: torch.Tensor, h: int, w: int):
    """Rounded prediction pixel and clamped window origin, all ``[L]`` int32.
    Non-finite predictions score the window at pixel (0, 0), as the JAX
    package does (``nan_to_num`` first), then :func:`round_pixel` (the
    kernel restates both)."""
    u_r, v_r = round_pixel(
        torch.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0), h, w)
    x0 = torch.clamp(u_r - REACH_X, 0, w - WIN_W)
    y0 = torch.clamp(v_r - REACH_Y, 0, h - WIN_H)
    return u_r, v_r, x0, y0


def tier_row_intervals(u_r, v_r, x0, y0, band):
    """The window pixels a tier can accept, row by row — the listing that
    ``csrc/track_scores.cu`` restates.

    ``u_r, v_r, x0, y0`` are :func:`window_origin`'s ``[L]`` outputs and
    ``band`` the ``(nxq, nyq, c0q, ru, rv)`` parameters (``[5, L]`` or five
    ``[L]``). Returns ``(lo, hi)``, each ``[L, WIN_H, 2]`` int32: per window
    row at most two column intervals ``[lo, hi]`` (window columns, empty
    where ``hi < lo``) that do not touch. Their union is exactly the set of
    pixels of the row in the tier-1 box (``|dx|, |dy| <= 8``, which holds
    tier 0) or on the tier-2 band within the reach
    (``|c0q + nxq*dx + nyq*dy| <= 640``, ``|dx| <= ru``, ``|dy| <= rv``),
    for band parameters in the range ``epipolar_band_params`` makes. Every
    other pixel's key is ``4096 * 4096 + position``, so the min over the
    window is the min over these pixels and ``4096 * 4096 + 0``.
    """
    nxq, nyq, c0q, ru, rv = (b[:, None] for b in band)
    dev = u_r.device
    row = torch.arange(WIN_H, dtype=torch.int32, device=dev)
    dy = (y0[:, None] + row[None, :]) - v_r[:, None]                # [L, WIN_H]
    off = (u_r - x0)[:, None]                                       # column of dx = 0
    one, zero = torch.ones_like(dy), torch.zeros_like(dy)
    box = torch.abs(dy) <= 8
    lo0 = torch.where(box, -8 * one, one)
    hi0 = torch.where(box, 8 * one, zero)

    # the band: |s + nxq*dx| <= 640 with s = c0q + nyq*dy, solved for dx
    # with floor and ceiling division (both signs of nxq; nxq = 0 apart)
    s = c0q + nyq * dy
    q = BAND_HALF_WIDTH_Q
    nx = torch.where(nxq == 0, torch.ones_like(nxq), nxq).expand_as(s)

    def floor_div(a):
        return torch.div(a, nx, rounding_mode="floor")

    def ceil_div(a):
        return -torch.div(-a, nx, rounding_mode="floor")

    flat = torch.abs(s) <= q
    lo1 = torch.where(nxq > 0, ceil_div(-q - s),
                      torch.where(nxq < 0, ceil_div(q - s),
                                  torch.where(flat, -ru.expand_as(s), one)))
    hi1 = torch.where(nxq > 0, floor_div(q - s),
                      torch.where(nxq < 0, floor_div(-q - s),
                                  torch.where(flat, ru.expand_as(s), zero)))
    lo1 = torch.maximum(lo1, -ru)
    hi1 = torch.minimum(hi1, ru)
    rows = torch.abs(dy) <= rv
    lo1 = torch.where(rows, lo1, one)
    hi1 = torch.where(rows, hi1, zero)

    # dx -> window column, clipped to the window
    last = WIN_W - 1
    lo0, hi0 = torch.clamp(lo0 + off, min=0), torch.clamp(hi0 + off, max=last)
    lo1, hi1 = torch.clamp(lo1 + off, min=0), torch.clamp(hi1 + off, max=last)
    # an empty first interval takes the second's place; two that touch merge
    empty0 = hi0 < lo0
    lo0, hi0 = torch.where(empty0, lo1, lo0), torch.where(empty0, hi1, hi0)
    lo1, hi1 = torch.where(empty0, one, lo1), torch.where(empty0, zero, hi1)
    touch = (hi1 >= lo1) & (lo1 <= hi0 + 1) & (lo0 <= hi1 + 1)
    lo0, hi0 = torch.where(touch, torch.minimum(lo0, lo1), lo0), \
        torch.where(touch, torch.maximum(hi0, hi1), hi0)
    lo1, hi1 = torch.where(touch, one, lo1), torch.where(touch, zero, hi1)
    return (torch.stack([lo0, lo1], -1).to(torch.int32),
            torch.stack([hi0, hi1], -1).to(torch.int32))


def listed_mask(lo, hi):
    """``[L, WIN_H, WIN_W]`` bool: the pixels of :func:`tier_row_intervals`."""
    col = torch.arange(WIN_W, dtype=torch.int32, device=lo.device)
    return ((col >= lo[..., :1]) & (col <= hi[..., :1])) | \
        ((col >= lo[..., 1:]) & (col <= hi[..., 1:]))


def window_scores(
    dense: torch.Tensor,          # [H, W, 8] int32 dense BRIEF field
    uv_pred: torch.Tensor,        # [L, 2] float predictions
    desc_last: torch.Tensor,      # [L, 8] int32
    desc_ref: torch.Tensor,       # [L, 8] int32
    band,                         # (nxq, nyq, c0q, ru, rv): [5, L] or five [L] int32
    *,
    cutoff_s1: int,
    cutoff_s2: int,
    cutoff_ref: int,
):
    """Plain PyTorch dense window scorer (the kernel's plain version).

    Returns ``(score [L], x [L], y [L], dist [L])`` int32 — the biased best
    score (``>= 1<<20`` if no acceptance), the winning pixel, and its
    Hamming distance to the last descriptor.
    """
    h, w, _ = dense.shape
    nxq, nyq, c0q, ru, rv = band
    dev = dense.device
    u_r, v_r, x0, y0 = window_origin(uv_pred, h, w)

    col = torch.arange(WIN_W, dtype=torch.int32, device=dev)
    row = torch.arange(WIN_H, dtype=torch.int32, device=dev)
    ys = (y0[:, None, None] + row[None, :, None]).to(torch.int64)
    xs = (x0[:, None, None] + col[None, None, :]).to(torch.int64)
    win = dense[ys, xs]                                    # [L, WH, WW, 8]

    d_last = hamming_words(win, desc_last[:, None, None, :])   # [L, WH, WW]
    d_ref = hamming_words(win, desc_ref[:, None, None, :])

    dx = (x0[:, None, None] + col[None, None, :]) - u_r[:, None, None]
    dy = (y0[:, None, None] + row[None, :, None]) - v_r[:, None, None]

    score = tier_scores(
        dx, dy, d_last, d_ref <= cutoff_ref,
        nxq[:, None, None], nyq[:, None, None], c0q[:, None, None],
        ru[:, None, None], rv[:, None, None],
        cutoff_s1, cutoff_s2,
    )

    pos = row[None, :, None] * WIN_W + col[None, None, :]
    key = torch.amin((score * _BIG_K + pos).reshape(score.shape[0], -1), dim=1)
    return _decode_key(key, x0, y0)


def _decode_key(key, x0, y0):
    best_score = key // _BIG_K
    rel = key % _BIG_K
    x = x0 + rel % WIN_W
    y = y0 + rel // WIN_W
    best_score = torch.where(best_score >= _BIG_K,
                             torch.full_like(best_score, BIG), best_score)
    dist = best_score % 1000
    return best_score, x, y, dist


track_scores_launches = 0


def track_scores(
    dense_left: torch.Tensor,     # [H, W, 8] int32 dense BRIEF field
    uv_pred: torch.Tensor,        # [L, 2] float32 predicted reprojections
    desc_last: torch.Tensor,      # [L, 8] int32
    desc_ref: torch.Tensor,       # [L, 8] int32
    band,                         # [5, L] int32: nxq, nyq, c0q, ru, rv
    *,
    cutoff_s1: int = 25,
    cutoff_s2: int = 50,
    cutoff_ref: int = 50,
):
    """Window scoring for every landmark; same contract and, for EVERY
    landmark (in view or not, ties included), the same integers as
    :func:`window_scores`.

    A CUDA field goes through the hand-written kernel, which also rounds
    the predictions; every input must then be a contiguous CUDA tensor of
    the stated type and shape (``band`` one ``[5, L]`` tensor), or this
    raises. Only a CPU field takes the plain version (``band`` may then
    also be five ``[L]`` tensors).
    """
    if not dense_left.is_cuda:
        return window_scores(
            dense_left, uv_pred, desc_last, desc_ref, band,
            cutoff_s1=cutoff_s1, cutoff_s2=cutoff_s2, cutoff_ref=cutoff_ref)
    check_track_inputs(dense_left, uv_pred, desc_last, desc_ref, band)
    return launch_track_scores(cuda_build.load_library(), dense_left, uv_pred,
                               band, desc_last, desc_ref,
                               int(cutoff_s1), int(cutoff_s2), int(cutoff_ref))


def check_track_inputs(dense_left, uv_pred, desc_last, desc_ref, band) -> None:
    """What the kernel takes: types, shapes, contiguity, alignment and one
    device (raises ``ValueError`` on anything else)."""
    h, w = dense_left.shape[:2]
    if h < WIN_H or w < WIN_W:
        raise ValueError(f"field {h}x{w} is smaller than the {WIN_H}x{WIN_W} window")
    cuda_build.require_int32_contiguous(dense_left, "dense_left", (DESCRIPTOR_WORDS,))
    L = uv_pred.shape[0]
    if not (isinstance(band, torch.Tensor) and band.shape == (5, L)):
        raise ValueError("track_scores: band must be one [5, L] int32 tensor")
    cuda_build.require_int32_contiguous(band, "band")
    for name, t in (("desc_last", desc_last), ("desc_ref", desc_ref)):
        cuda_build.require_int32_contiguous(t, name, (DESCRIPTOR_WORDS,))
        if t.shape != (L, DESCRIPTOR_WORDS) or t.data_ptr() % 16:
            raise ValueError(f"track_scores: {name} must be [L, 8], 16-byte aligned")
    if (uv_pred.dtype != torch.float32 or uv_pred.shape != (L, 2)
            or not uv_pred.is_contiguous() or uv_pred.data_ptr() % 8):
        raise ValueError("track_scores: uv_pred must be a contiguous [L, 2] float32 tensor")
    if dense_left.data_ptr() % 16:
        raise ValueError("track_scores: dense_left must be 16-byte aligned")
    if len({t.device for t in (dense_left, uv_pred, desc_last, desc_ref, band)}) != 1:
        raise ValueError("track_scores: inputs on more than one device")


def launch_track_scores(lib, dense_left, uv_pred, band, desc_last, desc_ref,
                        cutoff_s1: int, cutoff_s2: int, cutoff_ref: int):
    """Allocate the ``[4, L]`` output and launch the kernel on checked CUDA
    inputs; returns ``(score, x, y, dist)``, rows of that output."""
    h, w, _ = dense_left.shape
    L = uv_pred.shape[0]
    out = torch.empty((4, L), dtype=torch.int32, device=dense_left.device)
    if L > 0:
        with torch.cuda.device(dense_left.device):
            err = lib.svi_track_scores(
                dense_left.data_ptr(), uv_pred.data_ptr(), band.data_ptr(),
                desc_last.data_ptr(), desc_ref.data_ptr(), out.data_ptr(),
                L, h, w, cutoff_s1, cutoff_s2, cutoff_ref,
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_track_scores")
        paths.count_launch(__name__, "track_scores")
    return tuple(out)
