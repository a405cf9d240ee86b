"""BRIEF-style binary descriptors: the dense per-pixel field and its users.

Replaces OpenCV's ``BriefDescriptorExtractor`` and the reference's 256-bit
``CDescriptorBRIEF`` (CDescriptorBRIEF.h:16-37). Descriptors are 256 Boolean
intensity comparisons on a 5x5-box-smoothed image, packed little-endian into
8 words per descriptor.

Storage type: packed words are **int32 holding the bits of the uint32** the
JAX package stores (PyTorch's uint32 lacks shifts and reductions on the
CPU). Bit 31 is the sign bit; every consumer treats words as bit patterns
(XOR, popcount, shift-and-mask), never as numbers.

The dense field ``[H, W, 8]`` (the packed descriptor of EVERY pixel) is
produced once per image; all later matching is gathers into it. On a CUDA
tensor it is produced by the hand-written kernel :func:`brief_dense_fused`
(``csrc/brief_dense.cu``); :func:`brief_dense` after
:func:`~svi_mapper_tpu_torch.ops.image.box_blur` is its plain version.

The sample pattern is a fixed Gaussian pattern generated from a constant
seed with numpy — identical to the JAX package's, so both describe alike.
"""

from __future__ import annotations

import numpy as np
import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths
from svi_mapper_tpu_torch.ops.image import _pad, box_blur

DESCRIPTOR_BITS = 256          # ref Types.h:6
DESCRIPTOR_WORDS = 8           # 256 bits packed into 8 x 32-bit words
PATCH_SIZE = 32
PATCH_HALF = PATCH_SIZE // 2
BLUR_SIZE = 5                  # the smoothing window of the dense field


def _make_pattern(seed: int = 17) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian sample-pair pattern, clipped to the patch interior."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    a = rng.normal(0.0, sigma, size=(DESCRIPTOR_BITS, 2))
    b = rng.normal(0.0, sigma, size=(DESCRIPTOR_BITS, 2))
    lim = PATCH_HALF - 1
    a = np.clip(np.round(a), -lim, lim).astype(np.int32) + PATCH_HALF
    b = np.clip(np.round(b), -lim, lim).astype(np.int32) + PATCH_HALF
    # avoid degenerate identical pairs
    same = np.all(a == b, axis=-1)
    b[same, 0] = (b[same, 0] + 3) % PATCH_SIZE
    return a, b


_PATTERN_A, _PATTERN_B = _make_pattern()
# per-bit offsets from the pixel: [256, 4] = (ay, ax, by, bx), each in [-15, 15]
PATTERN_OFFSETS = np.stack(
    [_PATTERN_A[:, 1] - PATCH_HALF, _PATTERN_A[:, 0] - PATCH_HALF,
     _PATTERN_B[:, 1] - PATCH_HALF, _PATTERN_B[:, 0] - PATCH_HALF],
    axis=1).astype(np.int32)

# value of bit ``bi`` of a word in int32 two's complement
_BIT_VALUES = [(1 << bi) if bi < 31 else -(1 << 31) for bi in range(32)]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 (little-endian bit order)."""
    words = bits.reshape(bits.shape[:-1] + (DESCRIPTOR_WORDS, 32))
    weights = torch.tensor(_BIT_VALUES, dtype=torch.int32, device=bits.device)
    # distinct powers of two: the wrapping int32 sum equals the bitwise OR
    return torch.sum(words.to(torch.int32) * weights, dim=-1, dtype=torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    # the arithmetic shift's sign extension is masked off by ``& 1``
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (DESCRIPTOR_BITS,)).to(torch.bool)


def words_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """uint32 (or int32) packed words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"packed words must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of packed words -> uint32 numpy with the same bits."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def words_u32(a) -> np.ndarray:
    """Packed words in numpy, uint32 or int32 bit patterns -> uint32 with the
    same bits (the files' and the JAX package's dtype)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 bit patterns (SWAR; PyTorch has
    no popcount op). Every arithmetic right shift is followed by a mask
    that clears the sign-extended bits, so the result equals the unsigned
    count."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance over the last (word) axis of broadcastable packed
    descriptors -> int32."""
    return torch.sum(popcount32(a ^ b), dim=-1, dtype=torch.int32)


def brief_dense(img_smooth: torch.Tensor) -> torch.Tensor:
    """Dense BRIEF: the packed descriptor of EVERY pixel of a smoothed image.

    Bit i of pixel (y, x) is ``img[y+ay, x+ax] < img[y+by, x+bx]`` on the
    edge-extended image. Returns ``[H, W, 8]`` int32. (Replaces the
    reference's per-candidate extraction along epipolar scanlines,
    CTriangulator.cpp:65-117.)
    """
    h, w = img_smooth.shape
    pad = PATCH_HALF
    padded = _pad(img_smooth, pad, pad, pad, pad, "edge")

    def shifted(dy, dx):
        return padded[pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    words = []
    for wi in range(DESCRIPTOR_WORDS):
        acc = torch.zeros((h, w), dtype=torch.int32, device=img_smooth.device)
        for bi in range(32):
            ay, ax, by, bx = (int(v) for v in PATTERN_OFFSETS[wi * 32 + bi])
            bit = shifted(ay, ax) < shifted(by, bx)
            acc = acc | (bit.to(torch.int32) * _BIT_VALUES[bi])
        words.append(acc)
    return torch.stack(words, dim=-1)


def smooth_brief_dense_plain(img: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`brief_dense_fused`."""
    return brief_dense(box_blur(img, BLUR_SIZE))


# ---------------------------------------------------------------------------
# K3: fused blur + dense BRIEF (csrc/brief_dense.cu)
# ---------------------------------------------------------------------------
# Replaces the TPU kernel ``svi_mapper_tpu/ops/descriptors.py``
# ``brief_dense_fused`` (``_brief_dense_kernel``).
#
# Bound on the card: the function reads the image once (H*W*4 bytes) and
# writes the field once (H*W*32 bytes); per pixel it does 256 comparisons
# plus ~10 blur flops. At 376x1248 that is 16.9 MB against ~0.13 G simple
# operations: bytes bound it. What limits the kernel is the issue of
# shared-memory loads (one warp-wide load per clock and SM). Design: one
# block per BRIEF_TILE_H x BRIEF_TILE_W output tile; the raw tile with its
# 17 px halo (15 pattern + 2 blur) is staged edge-clamped in shared memory,
# the separable blur runs there (rows axis first, then columns, taps in the
# reference's order with separately rounded multiply and add). Each thread
# then owns BRIEF_ROWS pixels stacked in one column. The pattern is a
# compile-time table (csrc/brief_pattern.cuh), so every sample read is a
# shared load at an immediate offset from one base address; a sample that
# several bits or several of the thread's pixels need is loaded once. The
# comparisons are made in the order of :func:`brief_schedule`, which keeps
# few samples waiting for their last use, so that the compiler can hold each
# in a register. Blurred values outside the image are the blurred values at
# the clamped coordinate (not the blur of a clamped raw image), so the
# result equals the plain version bit for bit on the border too.

BRIEF_TILE_H, BRIEF_TILE_W = 32, 64     # output tile of one block
BRIEF_ROWS = 4                          # pixels a thread owns, in one column
_REACH = PATCH_HALF - 1                 # 15: the pattern's reach


def brief_schedule(rows: int) -> list[int]:
    """The order in which a thread that owns ``rows`` stacked pixels makes
    its ``rows * 256`` comparisons, as entries ``bit * rows + row``.

    A sample is a (row, column) offset from the thread's first pixel; it is
    loaded at its first use and held until its last. Greedy: the next
    comparison is one that touches a held sample, needs the fewest new
    loads and then frees the most held samples (lowest entry on a tie).
    Deterministic; the first pick is entry 0."""
    pend: dict[tuple, set] = {}
    ends = []
    for e in range(rows * DESCRIPTOR_BITS):
        ay, ax, by, bx = (int(v) for v in PATTERN_OFFSETS[e // rows])
        j = e % rows
        a, b = (ay + j, ax), (by + j, bx)
        ends.append((a, b))
        pend.setdefault(a, set()).add(e)
        pend.setdefault(b, set()).add(e)
    held: set = set()
    remaining = set(range(len(ends)))
    order = []
    while remaining:
        cand = set().union(*(pend[n] for n in held)) if held else {min(remaining)}
        best = min(cand, key=lambda e: (
            sum(n not in held for n in ends[e]),
            -sum(len(pend[n]) == 1 for n in set(ends[e])), e))
        order.append(best)
        remaining.discard(best)
        for n in ends[best]:
            pend[n].discard(best)
            if pend[n]:
                held.add(n)
            else:
                held.discard(n)
    return order


def brief_schedule_stats(rows: int) -> dict:
    """Shared loads per pixel of the comparison stage (distinct samples of a
    thread over its ``rows`` pixels), the most samples held at once along
    :func:`brief_schedule`, and the blur stage's loads per pixel at the
    tile size."""
    first, last = {}, {}
    for k, e in enumerate(brief_schedule(rows)):
        ay, ax, by, bx = (int(v) for v in PATTERN_OFFSETS[e // rows])
        j = e % rows
        for n in ((ay + j, ax), (by + j, bx)):
            first.setdefault(n, k)
            last[n] = k
    live = np.zeros(rows * DESCRIPTOR_BITS + 1, np.int64)
    for n, k in first.items():
        live[k] += 1
        live[last[n] + 1] -= 1
    bl_h, bl_w = BRIEF_TILE_H + 2 * _REACH, BRIEF_TILE_W + 2 * _REACH
    raw_w = bl_w + 4
    blur_loads = (bl_h * raw_w + bl_h * bl_w) * BLUR_SIZE
    return {"rows": rows, "compare_loads_per_pixel": len(first) / rows,
            "samples_held_max": int(np.cumsum(live).max()),
            "blur_loads_per_pixel": blur_loads / (BRIEF_TILE_H * BRIEF_TILE_W)}


def brief_pattern_header(rows: int = BRIEF_ROWS) -> str:
    """The text of ``csrc/brief_pattern.cuh``: tile size, ``rows``, the
    pattern (seed 17, as ``PATTERN_OFFSETS``) and the comparison order."""
    order = brief_schedule(rows)
    lines = [
        "// K3's tile, sample pattern and comparison order, generated from",
        "// svi_mapper_tpu_torch.ops.descriptors (the pattern of seed 17):",
        "//     python3 -m svi_mapper_tpu_torch.ops.descriptors \\",
        "//         > svi_mapper_tpu_torch/csrc/brief_pattern.cuh",
        "// Do not edit by hand; tests/test_torch_brief_dense.py holds it to",
        "// the generator and to the JAX package's pattern.",
        "#pragma once",
        "",
        "namespace brief {",
        "",
        f"constexpr int TILE_H = {BRIEF_TILE_H};   // output tile of one block",
        f"constexpr int TILE_W = {BRIEF_TILE_W};",
        f"constexpr int ROWS = {rows};      // pixels a thread owns, stacked in one column",
        "",
        "// (ay, ax, by, bx) of bit i: bit i of pixel (y, x) is",
        "// blur[y + ay][x + ax] < blur[y + by][x + bx]",
        f"constexpr signed char PATTERN[{DESCRIPTOR_BITS}][4] = {{",
    ]
    for i, (ay, ax, by, bx) in enumerate(PATTERN_OFFSETS):
        lines.append(f"    {{{int(ay):3d}, {int(ax):3d}, {int(by):3d}, {int(bx):3d}}},  // {i}")
    lines += ["};", "",
              "// the ROWS * 256 comparisons in the order the kernel makes them:",
              "// entry bit * ROWS + row",
              f"constexpr short ORDER[{len(order)}] = {{"]
    for k in range(0, len(order), 12):
        lines.append("    " + ", ".join(f"{e:4d}" for e in order[k:k + 12]) + ",")
    lines += ["};", "",
              "__host__ __device__ constexpr int pattern(int bit, int k) { return PATTERN[bit][k]; }",
              "__host__ __device__ constexpr int order(int k) { return ORDER[k]; }",
              "",
              "}  // namespace brief", ""]
    return "\n".join(lines)


brief_dense_fused_launches = 0


def brief_dense_fused(img: torch.Tensor) -> torch.Tensor:
    """Fused smooth+describe: raw image ``[H, W]`` float32 -> dense packed
    BRIEF field ``[H, W, 8]`` int32, equal bit for bit to
    ``brief_dense(box_blur(img, 5))``.

    A CUDA tensor goes through the hand-written kernel (or raises); only a
    CPU tensor takes the plain version.
    """
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("brief_dense_fused takes a [H, W] float32 image")
    if not img.is_cuda:
        return smooth_brief_dense_plain(img)
    if not img.is_contiguous():
        raise ValueError("brief_dense_fused takes a contiguous image")
    lib = cuda_build.load_library()
    h, w = img.shape
    out = torch.empty((h, w, DESCRIPTOR_WORDS), dtype=torch.int32,
                      device=img.device)
    with torch.cuda.device(img.device):
        err = lib.svi_brief_dense_fused(
            img.data_ptr(), out.data_ptr(), h, w,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "svi_brief_dense_fused")
    paths.count_launch(__name__, "brief_dense_fused")
    return out


def smooth_brief_dense(img: torch.Tensor) -> torch.Tensor:
    """Canonical smooth+describe: the dense field producer of the frame
    step (the kernel on the card, its plain version on the CPU)."""
    return brief_dense_fused(img)


def round_pixel(uv: torch.Tensor, h: int, w: int, dtype=torch.int32):
    """Nearest pixel ``(x, y)`` of ``uv [..., 2]`` in an ``h x w`` image:
    rounded half to even, then clamped in float before the cast. For every
    input without NaN (map those first) that is the JAX package's round ->
    saturating cast -> clip, on the CPU and on the card alike;
    ``csrc/track_scores.cu`` restates it."""
    x = torch.clamp(torch.round(uv[..., 0]), 0, w - 1).to(dtype)
    y = torch.clamp(torch.round(uv[..., 1]), 0, h - 1).to(dtype)
    return x, y


# flattened indices of the pattern's pairs into a 32*32 patch (row-major [v, u])
_IDX_A = _PATTERN_A[:, 1] * PATCH_SIZE + _PATTERN_A[:, 0]
_IDX_B = _PATTERN_B[:, 1] * PATCH_SIZE + _PATTERN_B[:, 0]


def extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Cut a 32x32 patch around each keypoint (clamped inside the image).

    Args:
      img: [H, W] float32 (already smoothed).
      uv: [K, 2] float32 keypoint centers (u=x, v=y); rounded half to even,
        a NaN coordinate taken as 0.

    Returns: [K, 32, 32] float32 patches.
    """
    h, w = img.shape
    uv = torch.nan_to_num(uv, nan=0.0)
    top = torch.clamp(torch.round(uv[:, 1]) - PATCH_HALF, 0, h - PATCH_SIZE).to(torch.int64)
    left = torch.clamp(torch.round(uv[:, 0]) - PATCH_HALF, 0, w - PATCH_SIZE).to(torch.int64)
    r = torch.arange(PATCH_SIZE, device=img.device)
    return img[(top[:, None] + r)[:, :, None], (left[:, None] + r)[:, None, :]]


def brief_descriptors(img_smooth: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Extract packed BRIEF descriptors for a keypoint batch.

    Args:
      img_smooth: [H, W] float32 smoothed image.
      uv: [K, 2] float32 keypoints.

    Returns: [K, 8] int32 packed 256-bit descriptors (the JAX package's
    uint32 bits).
    """
    patches = extract_patches(img_smooth, uv)            # [K, 32, 32]
    flat = patches.reshape(patches.shape[0], -1)         # [K, 1024]
    dev = img_smooth.device
    pa = flat[:, torch.from_numpy(_IDX_A).to(dev)]       # [K, 256]
    pb = flat[:, torch.from_numpy(_IDX_B).to(dev)]
    return pack_bits(pa < pb)                            # BRIEF test


def brief_descriptors_at_offsets(
    img_smooth: torch.Tensor, uv: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Descriptors at ``uv[k] + offsets[c]`` for every (keypoint, candidate)
    — all K x C candidate locations described in one batch (the reference
    extracts BRIEF along sampled curve points,
    CFundamentalMatcher.cpp:2142-2397).

    Args:
      img_smooth: [H, W]; uv: [K, 2]; offsets: [C, 2].

    Returns: [K, C, 8] int32.
    """
    k, c = uv.shape[0], offsets.shape[0]
    all_uv = (uv[:, None, :] + offsets[None, :, :]).reshape(k * c, 2)
    return brief_descriptors(img_smooth, all_uv).reshape(k, c, DESCRIPTOR_WORDS)


def brief_at(dense: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Gather packed descriptors from a dense field at (possibly fractional)
    pixel locations (nearest pixel, round-half-even, clamped to the image;
    a NaN coordinate reads index 0)."""
    h, w = dense.shape[:2]
    x, y = round_pixel(torch.nan_to_num(uv, nan=0.0), h, w, torch.int64)
    return dense[y, x]


if __name__ == "__main__":
    print(brief_pattern_header(), end="")
