"""Port vs JAX package: image ops, descriptors, corners, Hamming.

Everything that feeds descriptor bits or integer decisions is compared
EXACTLY: the blur keeps the JAX tap order with separately rounded multiply
and add, so the blurred floats — and with them every BRIEF bit — are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.ops import corners as jcorners
from svi_mapper_tpu.ops import descriptors as jdesc
from svi_mapper_tpu.ops import hamming as jham
from svi_mapper_tpu.ops import image as jimage
from svi_mapper_tpu_torch.ops import corners, descriptors, hamming, image

from torch_parity import t32, tbool, unwords, words


def _image(rng, h=128, w=256):
    """Smooth random texture plus hard blobs, 0..255 float32."""
    base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2))
    img = np.kron(base, np.ones((8, 8)))[:h, :w]
    img = img + rng.normal(0, 6, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("size", [3, 5, 9])
def test_box_blur_exact(rng, size):
    """Exact against the JAX function evaluated op by op (every multiply
    and add rounded separately, which is also what the CUDA kernel does).
    Under ``jit`` XLA's CPU compiler contracts multiply-add pairs, which
    moves the last bit of about a third of the pixels: that compiled form
    is held to 1e-4 on 0..255 values (a few units in the last place)."""
    img = _image(rng)
    got = image.box_blur(t32(img), size).numpy()
    # the undecorated function: each jnp operation dispatched on its own
    want = np.asarray(jimage.box_blur.__wrapped__(jnp.asarray(img), size))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.asarray(jimage.box_blur(jnp.asarray(img), size)),
        atol=1e-4, rtol=0)


def test_sobel_and_maxpool_exact(rng):
    img = _image(rng)
    for a, b in zip(image.sobel_gradients(t32(img)),
                    jimage.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r in (1, 7):
        np.testing.assert_array_equal(
            image._maxpool_separable(t32(img), r).numpy(),
            np.asarray(jimage._maxpool_separable(jnp.asarray(img), r)))


def test_pattern_identical():
    a, b = descriptors._make_pattern()
    np.testing.assert_array_equal(a, jdesc._PATTERN_A)
    np.testing.assert_array_equal(b, jdesc._PATTERN_B)
    assert descriptors.PATTERN_OFFSETS.min() >= -15
    assert descriptors.PATTERN_OFFSETS.max() <= 15


def test_pack_unpack_roundtrip_and_parity(rng):
    bits = rng.integers(0, 2, (40, 256)).astype(bool)
    bits[0] = True          # all-ones words: the int32 sign bit is set
    packed = descriptors.pack_bits(tbool(bits))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(
        unwords(packed), np.asarray(jdesc.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        descriptors.unpack_bits(packed).numpy(), bits)


def test_popcount32_all_patterns(rng):
    w = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(x)).count("1") for x in w], np.int32)
    np.testing.assert_array_equal(
        descriptors.popcount32(words(w)).numpy(), want)


def _bit_mismatch_share(a, b):
    x = np.bitwise_xor(a, b)
    return np.unpackbits(x.view(np.uint8)).mean()


def test_smooth_brief_dense_bit_exact(rng):
    """The dense field, every pixel, bit for bit against the JAX
    ``brief_dense`` of the op-by-op JAX blur (the arithmetic the port and its
    CUDA kernel implement). Against the fully compiled JAX path the blurred
    values differ in the last bit where XLA contracted a multiply-add, which
    can flip a comparison of two nearly equal intensities: at most 1e-5 of
    the bits (found: 0)."""
    img = _image(rng, 96, 160)
    got = unwords(descriptors.smooth_brief_dense(t32(img)))
    blur = jimage.box_blur.__wrapped__(jnp.asarray(img), 5)
    want = np.asarray(jdesc.brief_dense(blur))
    assert got.shape == want.shape == (96, 160, 8)
    np.testing.assert_array_equal(got, want)
    compiled = np.asarray(jdesc.smooth_brief_dense(jnp.asarray(img)))
    assert _bit_mismatch_share(got, compiled) <= 1e-5


def test_smooth_brief_dense_vs_pallas_interior(rng):
    """Against the Pallas kernel in interpret mode, away from the border:
    that kernel pads the RAW image, the canonical path pads the BLURRED
    one, so rows/columns whose pattern reach (15) + blur reach (2) touches
    the edge differ by construction. Its blur is compiled, hence the same
    1e-5 bound on flipped bits (found: 0)."""
    img = _image(rng, 64, 128)
    got = unwords(descriptors.brief_dense_fused(t32(img)))
    want = np.asarray(jdesc.brief_dense_fused(jnp.asarray(img), interpret=True))
    m = 17
    assert _bit_mismatch_share(
        np.ascontiguousarray(got[m:-m, m:-m]),
        np.ascontiguousarray(want[m:-m, m:-m])) <= 1e-5


def test_brief_at_rounding_and_clamp(rng):
    img = _image(rng, 64, 96)
    jdense = jdesc.smooth_brief_dense(jnp.asarray(img))
    dense = words(jdense)
    uv = rng.uniform(-5, 100, (200, 2)).astype(np.float32)
    uv[:6] = [[0.5, 1.5], [2.5, 3.5], [95.5, 63.5], [-0.5, -3.0],
              [10.49999, 7.50001], [200.0, 200.0]]   # half-to-even + clamps
    np.testing.assert_array_equal(
        unwords(descriptors.brief_at(dense, t32(uv))),
        np.asarray(jdesc.brief_at(jdense, jnp.asarray(uv))))


def test_min_eig_response_close(rng):
    img = _image(rng)
    got = corners.min_eig_response(t32(img)).numpy()
    scale = float(np.abs(got).max())
    # the response is a difference of two large terms, so the contracted
    # multiply-adds of the compiled JAX blur show up at 1e-3 of the scale
    # (found: 1.6e-4)
    np.testing.assert_allclose(
        got, np.asarray(jcorners.min_eig_response(jnp.asarray(img))),
        rtol=0, atol=1e-3 * scale)


def _planted_response(rng, h, w):
    """A response surface with EXACT ties planted: equal maxima inside one
    cell (cell argmax must take the first), equal cell winners across cells
    (top-k must take the lower index), a plateau for the 3x3 peak test."""
    resp = rng.uniform(0.0, 50.0, (h, w)).astype(np.float32)
    peaks = [(40, 40), (40, 44), (43, 41),       # one 16-cell, same value
             (40, 72), (56, 40), (72, 200),      # other cells, same value
             (90, 100), (90, 101)]               # a two-pixel plateau
    for y, x in peaks:
        resp[y, x] = 400.0
    for i in range(12):                          # distinct strong peaks
        resp[35 + 5 * i, 120 + 7 * i] = 300.0 - i
    return resp


@pytest.mark.parametrize("cell,k,use_mask", [(16, 64, False), (4, 256, False),
                                             (16, 512, True)])
def test_detect_corners_same_order_with_ties(rng, monkeypatch, cell, k, use_mask):
    """NMS, cell argmax and top-k on the SAME response surface (both
    packages' ``min_eig_response`` replaced by a planted one), so the order
    checks the lower-index tie rules exactly, whatever the float noise of
    the response itself."""
    h, w = 128, 256
    resp = _planted_response(rng, h, w)
    monkeypatch.setattr(corners, "min_eig_response", lambda img: t32(resp))
    monkeypatch.setattr(jcorners, "min_eig_response", lambda img: jnp.asarray(resp))
    mask = None
    if use_mask:
        mask = np.ones((h, w), bool)
        mask[:, 100:140] = False
    img = np.zeros((h, w), np.float32)
    uv_t, sc_t, ok_t = corners.detect_corners(
        t32(img), k=k, cell=cell, border=28,
        mask=None if mask is None else tbool(mask))
    # the undecorated JAX function, so no compiled trace keeps the planted
    # response
    uv_j, sc_j, ok_j = jcorners.detect_corners.__wrapped__(
        jnp.asarray(img), k=k, cell=cell, border=28,
        mask=None if mask is None else jnp.asarray(mask))
    assert int(ok_t.sum()) > 8
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    if cell == 16 and not use_mask:
        # the tied cell keeps its first maximum; tied cells come in index order
        top = uv_t.numpy()[:4].tolist()
        assert top == [[40.0, 40.0], [72.0, 40.0], [40.0, 56.0], [200.0, 72.0]]


def test_detect_corners_textured_same_points(rng):
    """On a real image each package computes its own response; the compiled
    JAX response differs from the port's by ~1e-4 of its scale, which can
    swap two nearly equal scores or move a cell's winner by a pixel. So:
    the same number of detections (+-1), and at least 98 % of the points equal
    (found: all)."""
    img = _image(rng, 128, 256)
    uv_t, _, ok_t = corners.detect_corners(t32(img), k=128, cell=16)
    uv_j, _, ok_j = jcorners.detect_corners(jnp.asarray(img), k=128, cell=16)
    ok_j = np.asarray(ok_j)
    assert abs(int(ok_t.sum()) - int(ok_j.sum())) <= 1 and int(ok_j.sum()) > 30
    pts_t = {tuple(p) for p in uv_t.numpy()[ok_t.numpy()].tolist()}
    pts_j = {tuple(p) for p in np.asarray(uv_j)[ok_j].tolist()}
    assert len(pts_t & pts_j) >= 0.98 * len(pts_j)


def test_detect_corners_flat_image_all_invalid():
    uv, score, ok = corners.detect_corners(torch.full((96, 128), 7.0), k=32)
    assert not bool(ok.any())
    assert float(uv.abs().max()) == 0.0 and float(score.abs().max()) == 0.0


def test_occupancy_mask_exact(rng):
    uv = rng.uniform(0, 255, (50, 2)).astype(np.float32)
    uv[:, 1] *= 0.5
    valid = rng.integers(0, 2, 50).astype(bool)
    np.testing.assert_array_equal(
        corners.occupancy_mask((128, 256), t32(uv), tbool(valid), radius=7).numpy(),
        np.asarray(jcorners.occupancy_mask((128, 256), jnp.asarray(uv),
                                           jnp.asarray(valid), radius=7)))


def test_hamming_packed_and_mxu_exact(rng):
    a = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (53, 8), dtype=np.uint64).astype(np.uint32)
    b[0] = a[0]
    b[1] = ~a[1]
    want = np.asarray(jham.hamming_packed(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        hamming.hamming_packed(words(a), words(b)).numpy(), want)
    np.testing.assert_array_equal(
        hamming.hamming_mxu(words(a), words(b)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jham.hamming_mxu(jnp.asarray(a), jnp.asarray(b))), want)
    assert want[0, 0] == 0 and want[1, 1] == 256
