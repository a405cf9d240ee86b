"""The tiling of the Schur kernels K4 / K5 (``csrc/schur_assemble.cu``) on
the CPU: ``ops.ba_kernel.schur_tiling``, the product's schedule
(``schur_schedule``) and the landmark order (``landmark_order``) by
hypothesis, and a plain restatement of what the three kernels compute in
that tiling (split keyframe sums, the upper block triangle by the
schedule's items of live slabs with the rhs column, each tile's items
added in a fixed order, the mirror)
against the plain versions and against the JAX package's Pallas kernel in
interpret mode; ``bundle_adjust`` unmoved by the landmarks' order. The
kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_ba_graphs.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from svi_mapper_tpu.ops import ba_kernel as j_bk
from svi_mapper_tpu_torch.ops import ba_kernel as bk
from svi_mapper_tpu_torch.solvers import ba
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
    keyframe k."""
    K, L = ow.shape
    pad = torch.zeros((K, tiling.nlt * bk.LANDMARK_TILE), dtype=ow.dtype)
    pad[:, :L] = ow
    return (pad.reshape(K, tiling.nlt, bk.LANDMARK_TILE) != 0).any(-1).T


def _items(sched) -> list[tuple[int, list[int]]]:
    """The schedule's items in item order: ``(tile index, listed slabs)``."""
    n = int(sched.region("tile_items")[-1])
    tile, first, count, slabs = (sched.region(r).tolist() for r in
                                 ("item_tile", "item_first", "item_count", "slabs"))
    return [(tile[i], slabs[first[i]:first[i] + count[i]]) for i in range(n)]


def schur_by_tiles(T, X, obs, ow, lam, *, fx, fy, cx, cy, bq, kernel_px2=10.0,
                   point_damping=1e-6, sms=bk.H100_SMS, skip=True, order=False):
    """What the kernels compute, restated in PyTorch in their tiling,
    schedule and order (``skip=False``: every (tile, slab) product taken as
    live; ``order``: the landmarks put in ``landmark_order``'s order first
    and the outputs back in the caller's, as ``solvers.ba`` does on the
    card). Returns ``(S, rhs, Hll_inv, b_l, W)`` and the number of (tile,
    slab) products the schedule lists."""
    if order:
        perm, inv = bk.landmark_order(ow)
        (S, rhs, Hinv, b_l, W), live = schur_by_tiles(
            T, X[perm], obs[:, perm], ow[:, perm], lam, fx=fx, fy=fy, cx=cx, cy=cy, bq=bq,
            kernel_px2=kernel_px2, point_damping=point_damping, sms=sms, skip=skip)
        return (S, rhs, Hinv[inv], b_l[inv], W[:, :, inv]), live
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
    sched = bk.schur_schedule(ow if skip else torch.ones_like(ow), sms)
    Hinv = bk._damped_inverse(hl[:6], bk._damping(lam, point_damping, hl))
    b_l = hl[6:9].T.contiguous()

    # 2. product: per item, over its listed slabs
    part = torch.zeros((t.max_items, g * g, 6, 6), dtype=W.dtype)
    rhs_part = torch.zeros((t.max_items, g, 6), dtype=W.dtype)
    tiles = t.tiles()
    for n, (tile, listed) in enumerate(_items(sched)):
        I, J = tiles[tile]
        rows_i = slice(6 * I * g, 6 * min(K, (I + 1) * g))
        rows_j = slice(6 * J * g, 6 * min(K, (J + 1) * g))
        idx = torch.tensor([l for sl in listed for l in range(16 * sl, min(L, 16 * sl + 16))],
                           dtype=torch.long)
        C = torch.einsum("bql,lbc->cql", W[:, rows_i][:, :, idx], Hinv[idx])
        blk = torch.einsum("cql,cpl->qp", C, W[:, rows_j][:, :, idx])
        for i, j in t.blocks((I, J)):
            qi, qj = 6 * (i - I * g), 6 * (j - J * g)
            part[n, (i - I * g) * g + j - J * g] = blk[qi:qi + 6, qj:qj + 6]
        if I == J:
            col = torch.einsum("cql,lc->q", C, b_l[idx]).reshape(-1, 6)
            rhs_part[n, :col.shape[0]] = col
            # the diagonal blocks' partials carry -H_pp and -b_p of the
            # landmark tiles whose first slab the item lists
            lm = torch.tensor([l for sl in listed if sl % 2 == 0
                               for l in range(16 * sl, min(L, 16 * sl + 32))],
                              dtype=torch.long)
            ks = slice(I * g, min(K, (I + 1) * g))
            _, hp, bp, _ = bk._accumulate_block(T[ks], X[lm], obs[ks][:, lm], ow[ks][:, lm],
                                                fx, fy, cx, cy, bq, kernel_px2)
            for k in range(hp.shape[0]):
                part[n, k * g + k] -= hp[k]
            rhs_part[n, :bp.shape[0]] -= bp

    # 3. reduction: each tile's items in item order, negated and mirrored
    S = torch.zeros((K, 6, K, 6), dtype=W.dtype)
    rs = torch.zeros((K, 6), dtype=W.dtype)
    tile_items = sched.region("tile_items").tolist()
    for tile, (I, J) in enumerate(tiles):
        acc = torch.zeros_like(part[0])
        col = torch.zeros_like(rhs_part[0])
        for n in range(tile_items[tile], tile_items[tile + 1]):
            acc = acc + part[n]
            col = col + rhs_part[n]
        for i, j in t.blocks((I, J)):
            blk = -acc[(i - I * g) * g + j - J * g]
            S[i, :, j, :] = blk
            S[j, :, i, :] = blk.T
        if I == J:
            rs[I * g:min(K, (I + 1) * g)] = -col[:min(K, (I + 1) * g) - I * g]
    return (S, rs, Hinv, b_l, W), int(sched.live)


def _banded_mask(K: int, L: int, rng, span=(3, 15)) -> np.ndarray:
    """A map segment's visibility: each landmark observed by a run of
    ``span`` keyframes from a random first one, the landmarks in random
    order (as ``portbench/segments.py`` draws them)."""
    first = rng.integers(0, K, L)
    n = rng.integers(*span, L)
    k = np.arange(K)[:, None]
    return (k >= first) & (k < first + n)


def _banded_window(K: int, L: int, seed: int) -> dict:
    w = tp.ba_window(K=K, L=L, seed=seed, noise=0.5)
    return dict(w, mask=w["mask"] & _banded_mask(K, L, np.random.default_rng(seed + 50)))


# ---------------------------------------------------------------------------
# the tiling, the schedule and the order
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(K=st.integers(1, 128), L=st.integers(1, 5000),
       sms=st.sampled_from([bk.H100_SMS, 114, 16]))
def test_tiling_covers_the_upper_triangle_and_every_landmark_once(K, L, sms):
    t = bk.schur_tiling(K, L, sms)
    assert t.g in (8, 16) and (t.g == 8) == (K <= 8)
    assert t.slots == sms * (4 if t.g == 8 else 2) and 1 <= t.ks
    # every 6x6 block (i, j >= i) of the upper triangle in exactly one tile
    blocks = [b for tile in t.tiles() for b in t.blocks(tile)]
    assert len(blocks) == t.pairs == len(set(blocks))
    assert set(blocks) == {(i, j) for i in range(K) for j in range(i, K)}
    assert all(I <= J for I, J in t.tiles()) and len(t.tiles()) == t.n_tiles
    # every landmark in exactly one slab, every slab in one landmark tile
    assert (t.n_slabs - 1) * bk.PRODUCT_SLAB < L <= t.n_slabs * bk.PRODUCT_SLAB
    assert -(-t.n_slabs // 2) == t.nlt
    # every keyframe in exactly one assembly split
    assert (t.nks - 1) * t.ks < K <= t.nks * t.ks
    # the item slots hold a schedule of one slab an item where the products
    # are fewer than ITEMS_PER_SLOT a slot, and of one item a tile
    products = t.n_tiles * t.n_slabs
    assert t.max_items >= min(products, bk.ITEMS_PER_SLOT * t.slots)
    assert t.max_items >= t.n_tiles
    assert 1 <= t.product_blocks <= min(t.slots, t.max_items)
    # the scratch regions do not overlap; the partials are 16-byte aligned
    for lay in (t.layout(), t.schedule_layout()):
        spans = sorted(v for k, v in lay.items() if k != "total")
        for (a, n), (b, _) in zip(spans, spans[1:]):
            assert a + n <= b
        assert spans[-1][0] + spans[-1][1] <= lay["total"][1]
    assert t.layout()["part"][0] % 4 == 0


@pytest.mark.parametrize("K,L,g,max_items,blocks", [
    (8, 1024, 8, 64, 64), (32, 4096, 16, 528, 264), (64, 1024, 16, 528, 264),
    (128, 4096, 16, 528, 264), (128, 65536, 16, 528, 264)])
def test_tiling_at_the_paths_shapes(K, L, g, max_items, blocks):
    """The shapes of the map optimisation, of the loop's windows and of
    the segment BA: the assembly gives every SM of an H100 (132) a block at
    least, where the window has that many (landmark tile, 8 keyframes)
    pairs; the product's grid fills the card's slots where the window has
    products enough."""
    t = bk.schur_tiling(K, L)
    assert (t.g, t.max_items, t.product_blocks) == (g, max_items, blocks)
    assert t.nlt * t.nks >= min(bk.H100_SMS, t.nlt * -(-K // (2 * bk.ASSEMBLY_WARPS)))


@settings(max_examples=60, deadline=None)
@given(K=st.integers(1, 80), L=st.integers(1, 700), density=st.sampled_from([0.0, 0.02, 0.3, 1.0]),
       banded=st.booleans(), ordered=st.booleans(), sms=st.sampled_from([bk.H100_SMS, 3]),
       seed=st.integers(0, 2**31))
def test_schedule_lists_every_live_product_once(K, L, density, banded, ordered, sms, seed):
    """The items cover every (tile, slab) whose landmark tile both groups
    of the tile observe, each exactly once, in tile order and slab order,
    in no more than ``max_items`` items cut by the grid's walk; nothing else
    is listed (its terms are exact zeros)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((K, L)) < density
    if banded:
        mask &= _banded_mask(K, L, rng)
    mask = torch.from_numpy(mask)
    if ordered:
        mask = mask[:, bk.landmark_order(mask)[0]]
    sched = bk.schur_schedule(mask.to(torch.float32), sms)
    t = sched.tiling
    assert sched.table.dtype == torch.int32
    assert sched.table.shape == (t.schedule_layout()["total"][1],)
    flags = _flags(mask.to(torch.float32), t)
    groups = torch.zeros((t.n_groups, t.nlt), dtype=torch.bool)
    for I in range(t.n_groups):
        groups[I] = flags[:, I * t.g:(I + 1) * t.g].any(1)
    want = [(n, sl) for n, (I, J) in enumerate(t.tiles()) for sl in range(t.n_slabs)
            if groups[I, sl // 2] and groups[J, sl // 2]]
    items = _items(sched)
    got = [(tile, sl) for tile, listed in items for sl in listed]
    assert got == want                       # once each, in tile and slab order
    assert int(sched.live) == len(want)
    assert len(items) <= t.max_items
    assert all(len(listed) >= 1 for _, listed in items)
    ends = sched.region("tile_items").tolist()
    assert ends[0] == 0 and ends[-1] == len(items)
    assert all(tile == next(u for u in range(t.n_tiles) if ends[u] <= n < ends[u + 1])
               for n, (tile, _) in enumerate(items))
    assert not sched.region("item_count")[len(items):].any()
    # items of c slabs (a tile's last fewer), c the largest of those whose
    # walk per block of the grid, items a block x c, is the least
    per_tile = [sum(tile == u for tile, _ in want) for u in range(t.n_tiles)]

    def walk(c):
        n = sum(-(-m // c) for m in per_tile)
        return -(-n // t.product_blocks) * c if n <= t.max_items else None

    walks = {c: walk(c) for c in range(1, t.n_slabs + 1) if walk(c) is not None}
    c = max(c for c, v in walks.items() if v == min(walks.values()))
    assert len(items) == sum(-(-m // c) for m in per_tile)
    assert all(len(listed) == c for n, (_, listed) in enumerate(items)
               if n + 1 < len(items) and items[n + 1][0] == items[n][0])


@settings(max_examples=60, deadline=None)
@given(K=st.integers(1, 40), L=st.integers(1, 400), banded=st.booleans(),
       seed=st.integers(0, 2**31))
def test_landmark_order_round_trips_with_stable_ties_and_unobserved_last(K, L, banded, seed):
    rng = np.random.default_rng(seed)
    mask = _banded_mask(K, L, rng) if banded else rng.random((K, L)) < 0.1
    perm, inv = bk.landmark_order(torch.from_numpy(mask))
    perm, inv = perm.numpy(), inv.numpy()
    assert sorted(perm) == list(range(L))
    assert (perm[inv] == np.arange(L)).all() and (inv[perm] == np.arange(L)).all()
    first = np.where(mask.any(0), mask.argmax(0), K)
    key = first[perm]
    assert (np.diff(key) >= 0).all()                       # by first observer
    assert (np.diff(perm)[np.diff(key) == 0] > 0).all()    # ties: the caller's order
    assert (key[mask.any(0).sum():] == K).all()            # the unobserved last


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
    got, listed = schur_by_tiles(*args, 1e-3, **_intr_kw(w))
    plain = bk.schur_assemble_plain(*args, 1e-3, **_intr_kw(w))
    for S, W in ((got[0], got[4]), (plain[0], plain[4])):
        assert torch.count_nonzero(S[8:]) == 0 and torch.count_nonzero(S[:, :, 8:]) == 0
        assert torch.count_nonzero(W[:, 48:]) == 0 and torch.count_nonzero(W[:, :, 30:]) == 0
        assert torch.count_nonzero(S[:8, :, :8]) > 0
    # the padded landmarks' inverse is 1 / damping, their b_l 0
    np.testing.assert_allclose(got[2][30:].numpy(), np.broadcast_to(
        np.eye(3) / np.float32(1e-3 + 1e-6), (34, 3, 3)), rtol=1e-6)
    assert torch.count_nonzero(got[3][30:]) == 0
    # the padded landmarks' tile is not listed: with K = 16 one tile, four
    # slabs of two landmark tiles, the second all padding
    t = bk.schur_tiling(16, 64)
    assert t.n_tiles * t.n_slabs == 4 and listed == 2
    for nm, err in _errors([g.numpy() for g in got],
                           [p.double().numpy() for p in plain]).items():
        assert err < dict(TOL, Hinv_block=TOL_HINV_BLOCK)[nm], f"{nm}: {err:.2e}"


def test_skipping_takes_only_zeros():
    """The products the schedule leaves out hold only zeros: in float64
    the restatement gives the same numbers with every product live."""
    w = _padded_window(K0=12, K=32, L0=70, L=128, seed=8)
    args = [a.double() for a in _torch_args(w)]
    got, listed = schur_by_tiles(*args, 1e-3, **_intr_kw(w))
    every, listed_all = schur_by_tiles(*args, 1e-3, **_intr_kw(w), skip=False)
    assert listed == 6 and listed_all == 3 * 8
    for nm, err in _errors([g.numpy() for g in got], [e.numpy() for e in every]).items():
        assert err < 1e-12, f"{nm}: {err:.2e}"
    # what each keyframe observes: the padded keyframes and landmark tiles nothing
    flags = _flags(args[3], bk.schur_tiling(32, 128))
    assert not flags[:, 12:].any() and not flags[3:].any() and flags[:2, :12].any()


@pytest.mark.parametrize("K,L,seed", [(32, 300, 21), (64, 517, 22)])
def test_restatement_in_the_landmark_order_equals_the_tiled_plain_version(K, L, seed):
    """A map segment's banded visibility with its landmarks in random order,
    in float64: the restatement in the caller's order and in
    ``landmark_order``'s (outputs put back) both within 1e-5 of the tiled
    plain version, the ordered one listing a fraction of the products."""
    w = _banded_window(K, L, seed)
    args = [a.double() for a in _torch_args(w)]
    want = bk.schur_assemble_tiled_plain(*args, 1e-3, **_intr_kw(w))
    listed = {}
    for order in (False, True):
        got, listed[order] = schur_by_tiles(*args, 1e-3, **_intr_kw(w), order=order)
        for nm, err in _errors([g.numpy() for g in got], [x.numpy() for x in want]).items():
            assert err < 1e-5, f"order={order} {nm}: {err:.2e}"
    assert 0 < listed[True] < 0.6 * listed[False]


@pytest.mark.parametrize("kernel_route", [False, True])
def test_bundle_adjust_is_invariant_to_the_landmark_order(kernel_route):
    """What ordering a solve's landmarks relies on, on the CPU's routes (the
    materialised one, and the kernels' plain versions, which keep the
    caller's order there): in float64, a banded window and the same window
    with its landmarks shuffled give the same poses and chi^2, and the same
    landmarks under the permutation."""
    from svi_mapper_tpu_torch.io.synthetic import default_camera

    K, L = 32, 240
    w = _banded_window(K, L, 31)
    rng = np.random.default_rng(32)
    perm = torch.from_numpy(rng.permutation(L))
    T, X, obs = (torch.from_numpy(w[k]).double() for k in ("T", "X", "obs"))
    mask, fix = torch.from_numpy(w["mask"]), torch.from_numpy(w["fix"])
    ow = torch.from_numpy(rng.uniform(0.5, 2.0, (K, L)))
    cam = default_camera(640, 480, device="cpu")
    kw = dict(max_iterations=6, min_rel_improvement=0.0, device="cpu",
              use_schur_kernel=kernel_route)
    before = ba.schur_schedule_counts()["solves_ordered"]
    a = ba.bundle_adjust(T, X, obs, mask, cam, fix, obs_w=ow, **kw)
    b = ba.bundle_adjust(T, X[perm], obs[:, perm], mask[:, perm], cam, fix,
                         obs_w=ow[:, perm], **kw)
    assert ba.schur_schedule_counts()["solves_ordered"] == before
    assert int(a.iterations) == int(b.iterations) == 6
    assert float(a.chi2_final) < 0.5 * float(a.chi2_initial)
    assert float(b.chi2_final) == pytest.approx(float(a.chi2_final), rel=1e-10)
    np.testing.assert_allclose(b.T_wc.numpy(), a.T_wc.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.points_w.numpy(), a.points_w[perm].numpy(), rtol=0, atol=1e-8)
