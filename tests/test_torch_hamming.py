"""The Hamming distance matrix and its matchers against the JAX package.

Everything here is integer arithmetic, so every comparison is exact. On the
CPU ``hamming_distance_matrix`` takes the plain version of kernel K6
(``hamming_packed``); that plain version is held against the TPU kernel run
in interpret mode. Ties are planted: duplicated descriptors on both sides,
so that several references (and several queries) sit at the same distance
and the first index must win, as ``jnp.argmin`` picks it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.ops import hamming as jham
from svi_mapper_tpu_torch.ops import hamming as tham

from torch_parity import flip_bits, random_descs, tbool, unwords, words


def planted(rng, n, m):
    """Descriptors with planted rows: equal pairs (distance 0), complements
    (256), all-zero and all-one words, words with only the sign bit set,
    and duplicated rows on both sides (ties)."""
    a, b = random_descs(rng, n), random_descs(rng, m)
    if n >= 6 and m >= 8:
        b[0] = a[0]
        b[1] = ~a[1]
        a[2] = 0
        b[2] = 0xFFFFFFFF
        a[3] = 0x80000000
        b[3] = 0
        b[4] = flip_bits(rng, a[4:5], 3)[0]
        b[5] = b[4]                  # two references equally near a[4]
        a[5] = a[4]                  # two queries equally near b[4]
        b[7] = a[0]                  # a second exact copy of a[0]
    return a, b


@pytest.mark.parametrize("n,m", [(130, 200), (37, 203), (1, 1), (64, 64)])
def test_distance_matrix_exact(rng, n, m):
    a, b = planted(rng, n, m)
    want = np.asarray(jham.hamming_packed(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_distance_matrix(words(a), words(b))
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tham.hamming_packed(words(a), words(b)).numpy(), want)
    np.testing.assert_array_equal(tham.hamming_mxu(words(a), words(b)).numpy(), want)
    if n >= 6 and m >= 8:
        assert got[0, 0] == 0 and got[1, 1] == 256 and got[2, 2] == 256
        assert got[3, 3] == 8       # eight sign bits


def test_plain_version_equals_the_tpu_kernel_interpreted(rng):
    """The plain version of K6 against ``hamming_pallas(interpret=True)`` at
    a ragged shape."""
    a, b = planted(rng, 130, 200)
    want = np.asarray(jham.hamming_pallas(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    np.testing.assert_array_equal(tham.hamming_packed(words(a), words(b)).numpy(), want)


def test_batched_distance_matrix(rng):
    a = np.stack([random_descs(rng, 9) for _ in range(3)])
    b = np.stack([random_descs(rng, 14) for _ in range(3)])
    got = tham.hamming_distance_matrix(words(a), words(b))
    assert got.shape == (3, 9, 14)
    for i in range(3):
        want = np.asarray(jham.hamming_packed(jnp.asarray(a[i]), jnp.asarray(b[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
    # any leading dimensions, the same on both sides
    two = tham.hamming_distance_matrix(words(np.stack([a, a[::-1]])),
                                       words(np.stack([b, b[::-1]])))
    assert two.shape == (2, 3, 9, 14)
    assert torch.equal(two[0], got) and torch.equal(two[1], got.flip(0))
    with pytest.raises(ValueError):
        tham.hamming_distance_matrix(words(a), words(b[0]))
    with pytest.raises(ValueError):
        tham.hamming_distance_matrix(words(a), words(b[:2]))


def test_words_round_trip(rng):
    a = random_descs(rng, 5)
    a[0] = 0x80000000
    np.testing.assert_array_equal(unwords(words(a)), a)


def _masks(rng, n, m, which):
    qv = rng.random(n) > 0.2 if which in ("query", "both") else None
    rv = rng.random(m) > 0.2 if which in ("ref", "both") else None
    return qv, rv


@pytest.mark.parametrize("which", ["none", "query", "ref", "both"])
@pytest.mark.parametrize("fn", ["match_nearest", "match_mutual"])
def test_matchers_exact_with_ties(rng, fn, which):
    a, b = planted(rng, 60, 75)
    # near pairs so that the cutoff decides both ways
    b[10:30] = flip_bits(rng, a[10:30], 10)
    b[30:40] = flip_bits(rng, a[30:40], 40)
    qv, rv = _masks(rng, 60, 75, which)
    if rv is not None:
        rv[4] = False               # the first of the tied references is masked
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else tbool(x)        # noqa: E731
    want = getattr(jham, fn)(jnp.asarray(a), jnp.asarray(b), 25, j(qv), j(rv))
    got = getattr(tham, fn)(words(a), words(b), 25, t(qv), t(rv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    ok = got[2].numpy()
    assert ok.any() and not ok.all()
    if rv is None:
        assert int(got[0][4]) == 4          # first of b[4] == b[5]
    else:
        assert int(got[0][4]) == 5


@pytest.mark.parametrize("which", ["none", "both"])
def test_count_matches_exact(rng, which):
    a, b = planted(rng, 50, 40)
    b[10:30] = flip_bits(rng, a[10:30], 12)
    qv, rv = _masks(rng, 50, 40, which)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else tbool(x)        # noqa: E731
    want = int(jham.count_matches(jnp.asarray(a), jnp.asarray(b), 25, j(qv), j(rv)))
    got = int(tham.count_matches(words(a), words(b), 25, t(qv), t(rv)))
    assert got == want and 10 <= got <= 50


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing(rng):
    a, b = planted(rng, 12, 9)
    n0 = tham.hamming_matrix_launches
    got = tham.hamming_distance_matrix(words(a), words(b))
    assert torch.equal(got, tham.hamming_packed(words(a), words(b)))
    assert tham.hamming_matrix_launches == n0


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = planted(rng, 300, 129)
    n0 = tham.hamming_matrix_launches
    got = tham.hamming_distance_matrix(words(a).cuda(), words(b).cuda())
    assert tham.hamming_matrix_launches == n0 + 1
    assert torch.equal(got.cpu(), tham.hamming_packed(words(a), words(b)))
