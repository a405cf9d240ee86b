"""K6's two entries on the CPU: a PyTorch restatement of what the CUDA
kernels (``csrc/hamming_matrix.cu``) compute in their tiling, and the plain
pool count ``ops.hamming.pool_nn_counts_plain`` behind
``mapping.closure._pool_nn_counts``, against the JAX package's
``mapping/closure.py:_pool_nn_counts`` and ``ops/hamming.py:hamming_packed``,
exactly, on the same numpy-seeded inputs.

The restatement forms ``|a| + |b| - 2 a.b`` with the norms by popcount and
``a.b`` as the binary tensor-core product computes it (each quad lane's
words ``t`` and ``t + 4``, AND, popcount, summed over the quad); the pool
count pads the
queries to tiles of 16 and each pool to tiles of 32 references (zeros,
invalid), takes the minimum over a pool with invalid references at
``1 << 20``, and counts. Cases: planted distances at the cutoff and one
over it, invalid queries, invalid references, a wholly invalid pool,
ragged P and Pr, B = 1 and B = 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.mapping import closure as jclosure
from svi_mapper_tpu.ops import hamming as jham
from svi_mapper_tpu_torch.mapping import closure as tclosure
from svi_mapper_tpu_torch.ops import hamming as tham

from torch_parity import tbool, words

_BIG = 1 << 20
CUTOFF = 25
QUERY_TILE, REF_TILE = 16, 32       # csrc/hamming_matrix.cu: a warp's rows, 8 NT columns


def norms(desc: torch.Tensor) -> torch.Tensor:
    return popcount32(desc.to(torch.int64) & 0xFFFFFFFF).sum(-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (the SWAR count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def binary_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.b`` as m16n8k256 b1 AND-popc forms it: quad lane ``t`` holds words
    ``t`` and ``t + 4`` of a row and of a column; the popcounts of the ANDs
    are summed over the lanes."""
    wa = a.to(torch.int64)[..., :, None, :] & 0xFFFFFFFF
    wb = b.to(torch.int64)[..., None, :, :] & 0xFFFFFFFF
    dot = torch.zeros(a.shape[:-2] + (a.shape[-2], b.shape[-2]), dtype=torch.int64)
    for t in range(4):
        for w in (t, t + 4):
            dot += popcount32(wa[..., w] & wb[..., w])
    return dot


def identity_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a| + |b| - 2 a.b`` of ``a [..., N, 8]`` and ``b [..., M, 8]``."""
    dot = binary_dot(a, b)
    return (norms(a)[..., :, None] + norms(b)[..., None, :] - 2 * dot).to(torch.int32)


def pool_counts_by_tiles(desc_q, valid_q, desc_r, valid_r, cutoff):
    """What ``pool_nn_counts_kernel`` computes, restated in its tiling:
    ``[B, P, 8]``, ``[B, C, Pr, 8]`` -> ``[B, C]``."""
    B, P = desc_q.shape[:2]
    C, Pr = desc_r.shape[1:3]
    Pp = -(-P // QUERY_TILE) * QUERY_TILE
    Rp = -(-Pr // REF_TILE) * REF_TILE
    q = torch.zeros((B, Pp, 8), dtype=torch.int32)
    q[:, :P] = desc_q
    vq = torch.zeros((B, Pp), dtype=torch.bool)
    vq[:, :P] = valid_q
    r = torch.zeros((B, C, Rp, 8), dtype=torch.int32)
    r[:, :, :Pr] = desc_r
    vr = torch.zeros((B, C, Rp), dtype=torch.bool)
    vr[:, :, :Pr] = valid_r
    counts = torch.zeros((B, C), dtype=torch.int32)
    for z in range(B):
        for c in range(C):
            d = identity_distances(q[z], r[z, c])                 # [Pp, Rp]
            d = torch.where(vr[z, c][None, :], d, torch.full_like(d, _BIG))
            dmin = torch.full((Pp,), _BIG, dtype=torch.int32)
            for t0 in range(0, Rp, REF_TILE):                     # a warp's passes
                dmin = torch.minimum(dmin, d[:, t0:t0 + REF_TILE].amin(1))
            counts[z, c] = int(((dmin <= cutoff) & vq[z]).sum())
    return counts


def pool_inputs(rng, B, P, C, Pr):
    """Random pools; 10 % of queries and references invalid, the second pool
    wholly invalid; for every other query k a reference of pool 0 planted
    from the end of the pool backwards: CUTOFF bits away with both valid
    (k % 8 == 0, it counts), CUTOFF + 1 bits away (k % 8 == 2), CUTOFF bits
    away with the query (k % 8 == 4) or the reference (k % 8 == 6)
    invalid. Returns the pools and the number of queries that count."""
    q = rng.integers(0, 2 ** 32, (B, P, 8), dtype=np.uint64).astype(np.uint32)
    r = rng.integers(0, 2 ** 32, (B, C, Pr, 8), dtype=np.uint64).astype(np.uint32)
    vq = rng.random((B, P)) > 0.1
    vr = rng.random((B, C, Pr)) > 0.1
    if C > 1:
        vr[:, 1] = False
    for k in range(0, min(P, Pr), 2):
        kind = k % 8
        bits = rng.choice(256, CUTOFF + (kind == 2), replace=False)
        flip = np.zeros(8, np.uint32)
        for b in bits:
            flip[b // 32] |= np.uint32(1 << (b % 32))
        r[:, 0, Pr - 1 - k] = q[:, k] ^ flip
        if kind != 2:
            vq[:, k] = kind != 4
            vr[:, 0, Pr - 1 - k] = kind != 6
    return q, vq, r, vr, len(range(0, min(P, Pr), 8))


SHAPES = [(1, 37, 3, 203), (8, 64, 5, 48), (1, 300, 2, 129), (8, 256, 2, 256),
          (1, 1, 1, 1), (2, 17, 4, 300)]


@pytest.mark.parametrize("B,P,C,Pr", SHAPES)
def test_pool_counts_restated_and_plain_equal_jax(B, P, C, Pr):
    rng = np.random.default_rng(B * 1000 + P + Pr)
    q, vq, r, vr, hits = pool_inputs(rng, B, P, C, Pr)
    want = np.stack([np.asarray(jclosure._pool_nn_counts(
        jnp.asarray(q[z]), jnp.asarray(vq[z]), jnp.asarray(r[z]), jnp.asarray(vr[z]),
        CUTOFF)) for z in range(B)])
    plain = tham.pool_nn_counts_plain(words(q), tbool(vq), words(r), tbool(vr), CUTOFF)
    tiles = pool_counts_by_tiles(words(q), tbool(vq), words(r), tbool(vr), CUTOFF)
    n0 = tham.pool_nn_counts_launches
    port = tclosure._pool_nn_counts(words(q), tbool(vq), words(r), tbool(vr), CUTOFF)
    assert tham.pool_nn_counts_launches == n0          # the CPU takes the plain version
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(tiles.numpy(), want)
    np.testing.assert_array_equal(port.numpy(), want)
    assert plain.dtype == torch.int32 and plain.shape == (B, C)
    if C > 1:
        assert (want[:, 1] == 0).all()                 # the wholly invalid pool
    assert (want[:, 0] == hits).all()                  # exactly the planted ones count


def test_planted_cutoff_decides_exactly():
    """A query whose only near reference lies CUTOFF bits away counts, one
    CUTOFF + 1 away does not; an invalid query or reference never counts."""
    rng = np.random.default_rng(5)
    q, vq, r, vr, hits = pool_inputs(rng, 1, 64, 2, 64)
    k = np.arange(0, 64, 2)
    at_cut, over = k[k % 8 != 2], k[k % 8 == 2]
    for valid_q, valid_r, want in (
            (vq, vr, hits),                                   # as planted
            (np.ones_like(vq), np.ones_like(vr), len(at_cut)),  # every mask on
            (np.isin(np.arange(64), over)[None], np.ones_like(vr), 0)):
        args = (words(q), tbool(valid_q), words(r), tbool(valid_r), CUTOFF)
        got = tham.pool_nn_counts_plain(*args)
        tiles = pool_counts_by_tiles(*args)
        assert int(got[0, 0]) == int(tiles[0, 0]) == want
        assert int(got[0, 1]) == int(tiles[0, 1]) == 0       # nothing planted there


@pytest.mark.parametrize("N,M", [(37, 203), (256, 300), (1, 1), (16, 33)])
def test_matrix_restated_equals_jax(N, M):
    """The matrix entry's identity with the binary product equals the JAX
    package's XOR-popcount distances, planted extremes included."""
    rng = np.random.default_rng(N + M)
    a = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    if min(N, M) >= 4:
        b[0], b[1] = a[0], ~a[1]
        a[2], b[2] = 0, 0xFFFFFFFF
        a[3], b[3] = 0x80000000, 0
    want = np.asarray(jham.hamming_packed(jnp.asarray(a), jnp.asarray(b)))
    got = identity_distances(words(a), words(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tham.hamming_packed(words(a), words(b)).numpy(), want)
    if min(N, M) >= 4:
        assert [int(want[i, i]) for i in range(4)] == [0, 256, 256, 8]


def test_pool_counts_wrapper_shapes_and_leading_dimensions():
    """Leading dimensions pass through; mismatched shapes raise."""
    rng = np.random.default_rng(9)
    q, vq, r, vr, _ = pool_inputs(rng, 6, 20, 3, 30)
    flat = tham.pool_nn_counts(words(q), tbool(vq), words(r), tbool(vr), CUTOFF)
    lead = tham.pool_nn_counts(words(q).reshape(2, 3, 20, 8), tbool(vq).reshape(2, 3, 20),
                               words(r).reshape(2, 3, 3, 30, 8), tbool(vr).reshape(2, 3, 3, 30),
                               CUTOFF)
    assert torch.equal(lead.reshape(6, 3), flat)
    one = tham.pool_nn_counts(words(q[0]), tbool(vq[0]), words(r[0]), tbool(vr[0]), CUTOFF)
    assert torch.equal(one, flat[0])
    with pytest.raises(ValueError):
        tham.pool_nn_counts(words(q), tbool(vq[:, :5]), words(r), tbool(vr), CUTOFF)


@pytest.mark.gpu
def test_pool_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    q, vq, r, vr, _ = pool_inputs(rng, 8, 256, 4, 256)
    args = [t.cuda() for t in (words(q), tbool(vq), words(r), tbool(vr))]
    n0 = tham.pool_nn_counts_launches
    got = tham.pool_nn_counts(*args, CUTOFF)
    assert tham.pool_nn_counts_launches == n0 + 1
    want = tham.pool_nn_counts_plain(words(q), tbool(vq), words(r), tbool(vr), CUTOFF)
    assert torch.equal(got.cpu(), want)
