"""The tiling of the Schur kernels K4 / K5 (``csrc/schur_assemble.cu``) on
the CPU: ``ops.ba_kernel.schur_tiling`` by hypothesis, and a plain
restatement of what the three kernels compute in that tiling (split
keyframe sums, the upper block triangle by tiles and landmark chunks with
the rhs column, landmark tiles skipped by their flags, the fixed-order
reduction and the mirror) against the plain version and against the JAX
package's Pallas kernel in interpret mode. The kernels themselves run only
on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from svi_mapper_tpu.ops import ba_kernel as j_bk
from svi_mapper_tpu_torch.ops import ba_kernel as bk
from tests import torch_parity as tp
from tests.test_torch_ba import (
    TOL,
    TOL_HINV_BLOCK,
    _errors,
    _hard_window,
    _intr_kw,
    _torch_args,
)


def _flags(ow: torch.Tensor, tiling) -> torch.Tensor:
    """flags[t, k]: does any weight of landmark tile t differ from 0 for
    keyframe k (the assembly's ballot)."""
    K, L = ow.shape
    pad = torch.zeros((K, tiling.nlt * bk.LANDMARK_TILE), dtype=ow.dtype)
    pad[:, :L] = ow
    return (pad.reshape(K, tiling.nlt, bk.LANDMARK_TILE) != 0).any(-1).T


def schur_by_tiles(T, X, obs, ow, lam, *, fx, fy, cx, cy, bq, kernel_px2=10.0,
                   point_damping=1e-6, sms=bk.H100_SMS, skip=True):
    """What the kernels compute, restated in PyTorch in their tiling and
    order (``skip=False``: every landmark tile taken as live). Returns
    ``(S, rhs, Hll_inv, b_l, W)`` and the number of (tile, chunk) products
    that found no live landmark tile."""
    K, L = ow.shape
    t = bk.schur_tiling(K, L, sms)
    g = t.g
    # 1. assembly, one keyframe split at a time
    parts = [bk._accumulate_block(T[k0:k0 + t.ks], X, obs[k0:k0 + t.ks],
                                  ow[k0:k0 + t.ks], fx, fy, cx, cy, bq, kernel_px2)
             for k0 in range(0, K, t.ks)]
    hl = torch.zeros_like(parts[0][0])
    for p in parts:                                  # split order
        hl = hl + p[0]
    W = torch.cat([p[3] for p in parts], dim=1)
    flags = _flags(ow if skip else torch.ones_like(ow), t)
    Hinv = bk._damped_inverse(hl[:6], bk._damping(lam, point_damping, hl))
    b_l = hl[6:9].T.contiguous()

    # 2. product: per chunk, per tile (I <= J), over the live landmark tiles
    part = torch.zeros((t.nc, t.pairs, 6, 6), dtype=W.dtype)
    rhs_part = torch.zeros((t.nc, K, 6), dtype=W.dtype)
    idle = 0
    pair = {(i, j): n for n, (i, j) in enumerate(
        (i, j) for i in range(K) for j in range(i, K))}
    for c, (l0, l1) in enumerate(t.chunks()):
        for I, J in t.tiles():
            rows_i = slice(6 * I * g, 6 * min(K, (I + 1) * g))
            rows_j = slice(6 * J * g, 6 * min(K, (J + 1) * g))
            live = [sl for sl in range(l0 // 16, -(-l1 // 16))
                    if flags[sl // 2, I * g:(I + 1) * g].any()
                    and (I == J or flags[sl // 2, J * g:(J + 1) * g].any())]
            idx = torch.tensor([l for sl in live
                                for l in range(16 * sl, min(L, 16 * sl + 16))],
                               dtype=torch.long)
            idle += not live
            C = torch.einsum("bql,lbc->cql", W[:, rows_i][:, :, idx], Hinv[idx])
            blk = torch.einsum("cql,cpl->qp", C, W[:, rows_j][:, :, idx])
            for i, j in t.blocks((I, J)):
                qi, qj = 6 * (i - I * g), 6 * (j - J * g)
                part[c, pair[i, j]] = blk[qi:qi + 6, qj:qj + 6]
            if I == J:
                col = torch.einsum("cql,lc->q", C, b_l[idx]).reshape(-1, 6)
                rhs_part[c, I * g:I * g + col.shape[0]] = col
        # the diagonal blocks' partials carry -H_pp and -b_p of the landmark
        # tiles whose first slab lies in this chunk
        t_lo, t_hi = -(-l0 // 32), -(-l1 // 32)
        lm = slice(32 * t_lo, min(L, 32 * t_hi))
        if lm.start < lm.stop:
            _, hp, bp, _ = bk._accumulate_block(T, X[lm], obs[:, lm], ow[:, lm],
                                                fx, fy, cx, cy, bq, kernel_px2)
            for i in range(K):
                part[c, pair[i, i]] -= hp[i]
            rhs_part[c] -= bp

    # 3. reduction in chunk order, negated and mirrored
    S = torch.zeros((K, 6, K, 6), dtype=W.dtype)
    ww = torch.zeros_like(part[0])
    rs = torch.zeros_like(rhs_part[0])
    for c in range(t.nc):
        ww = ww + part[c]
        rs = rs + rhs_part[c]
    for (i, j), n in pair.items():
        S[i, :, j, :] = -ww[n]
        S[j, :, i, :] = -ww[n].T
    return (S, -rs, Hinv, b_l, W), idle


# ---------------------------------------------------------------------------
# the tiling
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(K=st.integers(1, 128), L=st.integers(1, 5000),
       sms=st.sampled_from([bk.H100_SMS, 114, 16]))
def test_tiling_covers_the_upper_triangle_and_every_landmark_once(K, L, sms):
    t = bk.schur_tiling(K, L, sms)
    assert t.g in (8, 16) and (t.g == 8) == (K <= 8)
    assert 1 <= t.sc <= bk.MAX_CHUNK_SLABS and 1 <= t.ks and t.nc <= bk.MAX_CHUNKS
    # every 6x6 block (i, j >= i) of the upper triangle in exactly one tile
    blocks = [b for tile in t.tiles() for b in t.blocks(tile)]
    assert len(blocks) == t.pairs == len(set(blocks))
    assert set(blocks) == {(i, j) for i in range(K) for j in range(i, K)}
    assert all(I <= J for I, J in t.tiles())
    # every landmark in exactly one chunk, chunks of whole slabs
    chunks = t.chunks()
    assert len(chunks) == t.nc
    assert [l for l0, l1 in chunks for l in range(l0, l1)] == list(range(L))
    assert all(l0 % bk.PRODUCT_SLAB == 0 for l0, _ in chunks)
    # every keyframe in exactly one assembly split
    assert (t.nks - 1) * t.ks < K <= t.nks * t.ks
    # the partials are no larger than the W planes, but where one chunk's
    # partial alone is (L < K + 2)
    if t.nc > 1:
        assert t.partial_floats() <= 18 * K * L
    else:
        assert t.partial_floats() <= 18 * K * L or L < K + 2
    # the scratch regions do not overlap; the partials are 16-byte aligned
    lay = t.layout()
    spans = sorted(v for k, v in lay.items() if k != "total")
    assert lay["part"][0] % 4 == 0
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n <= b
    assert spans[-1][0] + spans[-1][1] <= lay["total"][1]


@pytest.mark.parametrize("K,L,g,nc", [(8, 1024, 8, 64), (32, 4096, 16, 86),
                                      (64, 1024, 16, 13), (128, 4096, 16, 7)])
def test_tiling_at_the_paths_shapes(K, L, g, nc):
    """The shapes of the map optimisation and of the loop's windows: the
    assembly gives every SM of an H100 (132) a block at least, where the
    window has that many (landmark tile, 8 keyframes) pairs."""
    t = bk.schur_tiling(K, L)
    assert (t.g, t.nc) == (g, nc)
    assert t.nlt * t.nks >= min(bk.H100_SMS, t.nlt * -(-K // (2 * bk.ASSEMBLY_WARPS)))


# ---------------------------------------------------------------------------
# the restatement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,L,seed", [(1, 40, 0), (5, 203, 1), (8, 300, 2),
                                      (13, 100, 3), (20, 97, 4), (32, 64, 5)])
def test_restatement_equals_the_plain_version(K, L, seed):
    """In float64, so that what is compared is the decomposition, not the
    float32 order of the sums: within 1e-5 of the largest entry."""
    w = _hard_window(K, L, seed=seed) if K >= 2 else tp.ba_window(K=K, L=L, seed=seed)
    args = [a.double() for a in _torch_args(w)]
    got, _ = schur_by_tiles(*args, 1e-3, **_intr_kw(w))
    want = bk.schur_assemble_plain(*args, 1e-3, **_intr_kw(w))
    for nm, err in _errors([g.numpy() for g in got], [x.numpy() for x in want]).items():
        assert err < 1e-5, f"{nm}: {err:.2e}"


def test_restatement_equals_the_pallas_kernel_interpreted():
    """Float32, against the JAX package's K4 in interpret mode at K = 4,
    L = 512, to ``tests/test_torch_ba.py``'s tolerances."""
    w = _hard_window(4, 512, seed=1)
    want = j_bk.schur_assemble(
        jnp.asarray(w["T"]), jnp.asarray(w["X"]), jnp.asarray(w["obs"]),
        jnp.asarray(w["mask"], jnp.float32), jnp.float32(1e-3),
        **_intr_kw(w), interpret=True)
    got, _ = schur_by_tiles(*_torch_args(w), 1e-3, **_intr_kw(w))
    errs = _errors([g.numpy() for g in got], [np.asarray(a, np.float64) for a in want])
    for nm, err in errs.items():
        assert err < dict(TOL, Hinv_block=TOL_HINV_BLOCK)[nm], f"{nm}: {err:.2e}"


def _padded_window(K0=8, K=16, L0=30, L=64, seed=7):
    """A window padded as ``models.slam`` pads one: K0 real keyframes
    bucketed to K (the rest identity poses without observations), L0 real
    landmarks padded to L (at the origin, never observed)."""
    w = tp.ba_window(K=K0, L=L0, seed=seed)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:K0] = w["T"]
    X = np.zeros((L, 3), np.float32)
    X[:L0] = w["X"]
    obs = np.zeros((K, L, 4), np.float32)
    obs[:K0, :L0] = w["obs"]
    mask = np.zeros((K, L), bool)
    mask[:K0, :L0] = w["mask"]
    return dict(w, T=T, X=X, obs=obs, mask=mask)


def test_padded_rows_and_columns_are_exact_zeros():
    w = _padded_window()
    args = _torch_args(w)
    got, idle = schur_by_tiles(*args, 1e-3, **_intr_kw(w))
    plain = bk.schur_assemble_plain(*args, 1e-3, **_intr_kw(w))
    for S, W in ((got[0], got[4]), (plain[0], plain[4])):
        assert torch.count_nonzero(S[8:]) == 0 and torch.count_nonzero(S[:, :, 8:]) == 0
        assert torch.count_nonzero(W[:, 48:]) == 0 and torch.count_nonzero(W[:, :, 30:]) == 0
        assert torch.count_nonzero(S[:8, :, :8]) > 0
    # the padded landmarks' inverse is 1 / damping, their b_l 0
    np.testing.assert_allclose(got[2][30:].numpy(), np.broadcast_to(
        np.eye(3) / np.float32(1e-3 + 1e-6), (34, 3, 3)), rtol=1e-6)
    assert torch.count_nonzero(got[3][30:]) == 0
    # the padded landmarks' tile is skipped: with K = 16 one tile, two
    # chunks of one landmark tile each, the second all padding
    t = bk.schur_tiling(16, 64)
    assert t.nc == 2 and idle == 1
    for nm, err in _errors([g.numpy() for g in got],
                           [p.double().numpy() for p in plain]).items():
        assert err < dict(TOL, Hinv_block=TOL_HINV_BLOCK)[nm], f"{nm}: {err:.2e}"


def test_skipping_takes_only_zeros():
    """The landmark tiles skipped by their flags hold only zeros: in float64
    the restatement gives the same numbers with every tile live."""
    w = _padded_window(K0=12, K=32, L0=70, L=128, seed=8)
    args = [a.double() for a in _torch_args(w)]
    got, idle = schur_by_tiles(*args, 1e-3, **_intr_kw(w))
    every, idle_none = schur_by_tiles(*args, 1e-3, **_intr_kw(w), skip=False)
    assert idle > 0 and idle_none == 0
    for nm, err in _errors([g.numpy() for g in got], [e.numpy() for e in every]).items():
        assert err < 1e-12, f"{nm}: {err:.2e}"
    # the flags: the padded keyframes and landmark tiles observe nothing
    flags = _flags(args[3], bk.schur_tiling(32, 128))
    assert not flags[:, 12:].any() and not flags[3:].any() and flags[:2, :12].any()
