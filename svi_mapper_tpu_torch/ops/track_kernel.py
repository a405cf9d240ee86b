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

Bound on the card (L = 1024, 376x1248 field): the inputs are the 15 MB
field plus ~0.1 MB of per-landmark data, read once; the work is
L * 2337 pixels * ~90 integer operations (16 XOR, 16 popcount, 14 adds, the
tier tests) = ~0.2 G operations. Bytes bound it. Design: one block per
landmark; threads stride over the window, each pixel is two 16-byte loads;
descriptors and band parameters sit in registers; the block reduces the
min key by warp shuffles.
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops import cuda_build
from svi_mapper_tpu_torch.ops.descriptors import DESCRIPTOR_WORDS, hamming_words

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
    package does (``nan_to_num`` first)."""
    uvs = torch.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    u_r = torch.clamp(torch.round(uvs[:, 0]).to(torch.int32), 0, w - 1)
    v_r = torch.clamp(torch.round(uvs[:, 1]).to(torch.int32), 0, h - 1)
    x0 = torch.clamp(u_r - REACH_X, 0, w - WIN_W)
    y0 = torch.clamp(v_r - REACH_Y, 0, h - WIN_H)
    return u_r, v_r, x0, y0


def window_scores(
    dense: torch.Tensor,          # [H, W, 8] int32 dense BRIEF field
    uv_pred: torch.Tensor,        # [L, 2] float predictions
    desc_last: torch.Tensor,      # [L, 8] int32
    desc_ref: torch.Tensor,       # [L, 8] int32
    band: tuple,                  # (nxq, nyq, c0q, ru, rv), each [L] int32
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
    uv_pred: torch.Tensor,        # [L, 2] float predicted reprojections
    desc_last: torch.Tensor,      # [L, 8] int32
    desc_ref: torch.Tensor,       # [L, 8] int32
    band: tuple,
    *,
    cutoff_s1: int = 25,
    cutoff_s2: int = 50,
    cutoff_ref: int = 50,
):
    """Window scoring for every landmark; same contract and, for EVERY
    landmark (in view or not, ties included), the same integers as
    :func:`window_scores`.

    A CUDA field goes through the hand-written kernel (or raises); only a
    CPU field takes the plain version.
    """
    if not dense_left.is_cuda:
        return window_scores(
            dense_left, uv_pred, desc_last, desc_ref, band,
            cutoff_s1=cutoff_s1, cutoff_s2=cutoff_s2, cutoff_ref=cutoff_ref)

    lib = cuda_build.load_library()
    h, w, _ = dense_left.shape
    L = uv_pred.shape[0]
    if h < WIN_H or w < WIN_W:
        raise ValueError(f"field {h}x{w} is smaller than the {WIN_H}x{WIN_W} window")
    cuda_build.require_int32_contiguous(dense_left, "dense_left", (DESCRIPTOR_WORDS,))
    dev = dense_left.device
    # rounding and clamping stay in PyTorch so both versions share them
    origin = [t.contiguous() for t in window_origin(uv_pred.to(dev), h, w)]
    params = [t.to(device=dev, dtype=torch.int32).contiguous() for t in band]
    dl = desc_last.contiguous()
    dr = desc_ref.contiguous()
    cuda_build.require_int32_contiguous(dl, "desc_last", (DESCRIPTOR_WORDS,))
    cuda_build.require_int32_contiguous(dr, "desc_ref", (DESCRIPTOR_WORDS,))
    if not (dl.is_cuda and dr.is_cuda and dl.shape[0] == L and dr.shape[0] == L
            and all(p.shape == (L,) for p in params)):
        raise ValueError("track_scores: per-landmark inputs must be CUDA [L, ...]")
    return launch_track_scores(lib, dense_left, origin, params, dl, dr,
                               int(cutoff_s1), int(cutoff_s2), int(cutoff_ref))


def launch_track_scores(lib, dense_left, origin, params, desc_last, desc_ref,
                        cutoff_s1: int, cutoff_s2: int, cutoff_ref: int):
    """Allocate the outputs and launch the kernel on checked, contiguous
    CUDA inputs (``origin`` = (u, v, x0, y0), ``params`` = the band)."""
    global track_scores_launches
    h, w, _ = dense_left.shape
    L = desc_last.shape[0]
    dev = dense_left.device
    outs = [torch.empty((L,), dtype=torch.int32, device=dev) for _ in range(4)]
    if L > 0:
        with torch.cuda.device(dev):
            err = lib.svi_track_scores(
                dense_left.data_ptr(),
                *[t.data_ptr() for t in origin],
                *[t.data_ptr() for t in params],
                desc_last.data_ptr(), desc_ref.data_ptr(),
                *[t.data_ptr() for t in outs],
                L, h, w, cutoff_s1, cutoff_s2, cutoff_ref,
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_track_scores")
        track_scores_launches += 1
    return tuple(outs)

