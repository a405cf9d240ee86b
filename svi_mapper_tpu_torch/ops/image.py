"""Image-plane ops of the front-end: box blur, Sobel gradients, max filter.

All ops take float32 single-channel images ``[H, W]``. Separable filters are
written as shift-multiply-accumulate over the (small, static) tap count,
in a fixed order — ``0 + tap0*k0`` first, then ``+ tap1*k1`` … — with the
multiply and the add rounded separately. The dense BRIEF field compares
blurred intensities, so the order of this sum decides descriptor bits; a
library convolution (which may reorder the sum or run in TF32 on the card)
is deliberately not used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
         mode: str, value: float = 0.0) -> torch.Tensor:
    x = img[None, None]
    if mode == "edge":
        x = F.pad(x, (left, right, top, bottom), mode="replicate")
    else:
        x = F.pad(x, (left, right, top, bottom), mode="constant", value=value)
    return x[0, 0]


def _conv1d(img: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable 1D convolution along an axis with SAME edge padding.

    ``kernel`` is a 1-D float32 tensor on any device or a list of floats;
    each tap multiplies as a float32 scalar.
    """
    taps = [float(t) for t in kernel]
    k = len(taps)
    pad = k // 2
    h, w = img.shape
    if axis == 0:
        padded = _pad(img, pad, pad, 0, 0, "edge")
    else:
        padded = _pad(img, 0, 0, pad, pad, "edge")
    out = torch.zeros_like(img)
    for i in range(k):
        tap = padded[i:i + h, :] if axis == 0 else padded[:, i:i + w]
        out = out + tap * taps[i]
    return out


def _maxpool_separable(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 max filter as two separable shifted-max passes."""
    h, w = img.shape

    def pass_axis(x, axis):
        if axis == 0:
            padded = _pad(x, radius, radius, 0, 0, "constant", float("-inf"))
        else:
            padded = _pad(x, 0, 0, radius, radius, "constant", float("-inf"))
        out = x
        for i in range(2 * radius + 1):
            if i == radius:
                continue
            tap = padded[i:i + h, :] if axis == 0 else padded[:, i:i + w]
            out = torch.maximum(out, tap)
        return out

    return pass_axis(pass_axis(img, 0), 1)


def _box_taps(size: int) -> list[float]:
    # the float32 value of 1/size, as the reference builds its kernel
    return [float(np.float32(1.0 / size))] * size


def box_blur(img: torch.Tensor, size: int = 9) -> torch.Tensor:
    """Separable box blur (the BRIEF smoothing window): rows axis first,
    then columns."""
    k = _box_taps(size)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y gradients (separable [1 2 1] x [-1 0 1])."""
    smooth = [1.0, 2.0, 1.0]
    diff = [-1.0, 0.0, 1.0]
    ix = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    iy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return ix, iy
