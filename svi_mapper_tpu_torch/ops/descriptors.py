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

from svi_mapper_tpu_torch.ops import cuda_build
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
# writes the field once (H*W*32 bytes); per pixel it does 256 comparisons of
# two shared-memory loads plus ~10 blur flops. At 376x1248 that is 16.9 MB
# against ~0.37 G simple operations: bytes bound it. The plain version
# instead makes ~512 full-image passes through device memory.
# Design: one block per 16x64 output tile; the raw tile with its 17 px halo
# (15 pattern + 2 blur) is staged edge-clamped in shared memory, the
# separable blur runs there (rows axis first, then columns, taps in the
# reference's order with separately rounded multiply and add), then each
# thread compares its pixels' 256 pairs from shared memory and writes 8
# words with two 16-byte stores. Blurred values outside the image are the
# blurred values at the clamped coordinate (not the blur of a clamped raw
# image), so the result equals the plain version bit for bit on the border
# too.

brief_dense_fused_launches = 0
_pattern_cache: dict = {}


def _pattern_on(device: torch.device) -> torch.Tensor:
    key = (device.type, device.index)
    if key not in _pattern_cache:
        _pattern_cache[key] = torch.from_numpy(
            np.ascontiguousarray(PATTERN_OFFSETS)).to(device)
    return _pattern_cache[key]


def brief_dense_fused(img: torch.Tensor) -> torch.Tensor:
    """Fused smooth+describe: raw image ``[H, W]`` float32 -> dense packed
    BRIEF field ``[H, W, 8]`` int32, equal bit for bit to
    ``brief_dense(box_blur(img, 5))``.

    A CUDA tensor goes through the hand-written kernel (or raises); only a
    CPU tensor takes the plain version.
    """
    global brief_dense_fused_launches
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("brief_dense_fused takes a [H, W] float32 image")
    if not img.is_cuda:
        return smooth_brief_dense_plain(img)
    lib = cuda_build.load_library()
    img = img.contiguous()
    h, w = img.shape
    out = torch.empty((h, w, DESCRIPTOR_WORDS), dtype=torch.int32,
                      device=img.device)
    pattern = _pattern_on(img.device)
    with torch.cuda.device(img.device):
        err = lib.svi_brief_dense_fused(
            img.data_ptr(), pattern.data_ptr(), out.data_ptr(), h, w,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "svi_brief_dense_fused")
    brief_dense_fused_launches += 1
    return out


def smooth_brief_dense(img: torch.Tensor) -> torch.Tensor:
    """Canonical smooth+describe: the dense field producer of the frame
    step (the kernel on the card, its plain version on the CPU)."""
    return brief_dense_fused(img)


def brief_at(dense: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Gather packed descriptors from a dense field at (possibly fractional)
    pixel locations (nearest pixel, round-half-even, clamped to the image)."""
    h, w = dense.shape[:2]
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, h - 1)
    return dense[y, x]
