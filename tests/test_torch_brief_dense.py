"""K3's compile-time table (``csrc/brief_pattern.cuh``) against the port's
generator and the JAX package's pattern, and the comparison order the
kernel follows.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit for
bit against ``smooth_brief_dense_plain``); here the header's numbers and
the order's arithmetic are checked: the order visits every (bit, stacked
pixel) once, and comparisons made in that order with the kernel's offsets
from a thread's base address give the plain version's field.
"""

import re

import numpy as np
import pytest
import torch

from svi_mapper_tpu.ops import descriptors as jdesc
from svi_mapper_tpu_torch.ops import cuda_build, descriptors
from svi_mapper_tpu_torch.ops.image import box_blur

HEADER = cuda_build.CSRC_DIR / "brief_pattern.cuh"


def _header_table(name: str) -> np.ndarray:
    text = HEADER.read_text()
    m = re.search(name + r"\[[^\]]*\](?:\[4\])? = \{(.*?)\n\};", text, re.S)
    assert m, name
    body = re.sub(r"//[^\n]*", "", m.group(1))
    return np.array([int(v) for v in re.findall(r"-?\d+", body)], np.int64)


def _header_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text()).group(1))


def test_header_is_the_generators_output():
    assert HEADER.read_text() == descriptors.brief_pattern_header()


def test_header_pattern_equals_pattern_offsets_and_jax():
    got = _header_table("PATTERN").reshape(256, 4)
    np.testing.assert_array_equal(got, descriptors.PATTERN_OFFSETS)
    half = jdesc.PATCH_HALF
    want = np.stack([jdesc._PATTERN_A[:, 1] - half, jdesc._PATTERN_A[:, 0] - half,
                     jdesc._PATTERN_B[:, 1] - half, jdesc._PATTERN_B[:, 0] - half], 1)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 15


def test_header_order_visits_every_comparison_once():
    rows = _header_constant("ROWS")
    assert rows == descriptors.BRIEF_ROWS
    assert (_header_constant("TILE_H"), _header_constant("TILE_W")) == (
        descriptors.BRIEF_TILE_H, descriptors.BRIEF_TILE_W)
    order = _header_table("ORDER")
    assert sorted(order.tolist()) == list(range(rows * 256))


@pytest.mark.parametrize("rows,loads,held_at_most", [
    (1, 344.0, 8), (2, 258.0, 32), (4, 172.75, 96), (8, 108.625, 224)])
def test_schedule_loads_and_held_samples(rows, loads, held_at_most):
    """Distinct samples per pixel (the shared loads of the comparison stage)
    and the most samples the order keeps waiting for a later use."""
    stats = descriptors.brief_schedule_stats(rows)
    assert stats["compare_loads_per_pixel"] == loads
    assert stats["samples_held_max"] <= held_at_most
    # the blur stage: two passes of five taps over the tile and its halo
    assert stats["blur_loads_per_pixel"] == pytest.approx(29.0625)


def test_ordered_comparisons_at_the_kernels_offsets_give_the_field(rng):
    """The kernel's arithmetic in numpy: a thread's ROWS stacked pixels at
    (y, x) .. (y + ROWS - 1, x); comparison e = bit * ROWS + j reads the
    blurred tile at ``(pattern(bit, 0) + j) * BL_W + pattern(bit, 1)``
    from the thread's base (its first pixel). Edge-extended blur, ragged
    last stack."""
    h, w = 37, 70
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))
    blur = box_blur(img, descriptors.BLUR_SIZE).numpy()
    rows = descriptors.BRIEF_ROWS
    reach = 15
    hs = -(-h // rows) * rows                       # whole stacks
    pad = np.pad(blur, ((reach, reach + hs - h), (reach, reach)), mode="edge")
    bl_w = pad.shape[1]
    flat = pad.reshape(-1)
    ys, xs = np.meshgrid(np.arange(0, hs, rows), np.arange(w), indexing="ij")
    base = (ys + reach) * bl_w + (xs + reach)       # each thread's base address
    words = np.zeros((rows, 8) + base.shape, np.uint32)
    P = descriptors.PATTERN_OFFSETS
    for e in _header_table("ORDER"):
        bit, j = divmod(int(e), rows)
        oa = (P[bit, 0] + j) * bl_w + P[bit, 1]
        ob = (P[bit, 2] + j) * bl_w + P[bit, 3]
        words[j, bit >> 5] |= (flat[base + oa] < flat[base + ob]).astype(np.uint32) << np.uint32(bit & 31)
    # [rows, 8, stacks, w] -> [stacks * rows, w, 8]
    field = words.transpose(2, 0, 3, 1).reshape(hs, w, 8)[:h]
    want = descriptors.brief_dense(torch.from_numpy(blur)).numpy().view(np.uint32)
    np.testing.assert_array_equal(field, want)
