"""The observation-list route of ``solvers/ba.py`` (windows of more than 128
keyframes): its lists against a brute-force listing, its solves against
the materialised route and against the plain whole-map reference
(``portbench/reference/map_ba.py``, float64) on a circuit that closes on
itself, its buffer sets, and the sharded BA's hook over two shards. On the
CPU; no JAX here."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from portbench import manifest
from portbench.circuit import make_ring
from portbench.drivers.segment_ba import settings
from portbench.reference import compare, lm_ba, map_ba
from portbench.reference.compare import over_limits
from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection
from svi_mapper_tpu_torch.solvers import ba

CELL = "kitti00-sv-fullmap.global-ba"
FIELDS = ("T_wc", "points_w", "chi2_initial", "chi2_final", "iterations")

# float32 against the float64 reference over 10 LM iterations on a 136 x 3000
# circuit: the route rounds to ~1e-4 m (centres), ~3e-4 m (landmarks) and a
# few 1e-6 of chi^2 (the materialised route alike); the bounds leave 10x
# room, and the TF32 control misses them by 100-10,000x
TOL = {"iterations_gap": 0, "centre_gap_m": 1e-3, "rotation_gap_rad": 1e-5,
       "landmark_gap_m": 3e-3, "chi2_gap": 1e-4}


def _config(K=136, L=3000):
    c = manifest.cell(manifest.load(), CELL)
    cfg = {**c["config"], "map": {**c["config"]["map"], "keyframes": K, "landmarks": L}}
    return cfg, c["traffic"]


def _camera(cfg):
    c = cfg["camera"]
    return StereoCamera(
        left=pinhole_from_projection(c["left_projection"], c["width"], c["height"], device="cpu"),
        right=pinhole_from_projection(c["right_projection"], c["width"], c["height"],
                                      device="cpu"))


def _program(p, cam, s, **kw):
    kw = {**dict(kernel_px2=s.kernel_px2, max_iterations=s.max_iterations,
                 lm_lambda0=s.lm_lambda0, point_damping=s.point_damping,
                 min_rel_improvement=s.min_rel_improvement, odo_M=p.odo_M, odo_w=p.odo_w,
                 grav_d=p.grav_d, grav_w=p.grav_w, device="cpu"), **kw}
    return ba.bundle_adjust(p.T, p.X, p.obs, p.mask, cam, p.fix, **kw)


def _numbers(res, ref):
    ans = dict(T=res.T_wc.numpy(), X=res.points_w.numpy(), chi2=float(res.chi2_final),
               iterations=int(res.iterations))
    return compare.numbers(ans, dict(T=ref.T.numpy(), X=ref.X.numpy(), chi2=ref.chi2_final,
                                     iterations=ref.iterations))


@pytest.fixture(scope="module")
def circuit():
    cfg, traffic = _config()
    p = make_ring(traffic, cfg, 2**33 + 181, "cpu")[0]
    return p, _camera(cfg), settings(cfg, traffic), map_ba.solve(p, settings(cfg, traffic))


# ---------------------------------------------------------------------------
# the lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,L,density", [(5, 40, 0.5), (9, 300, 0.2), (3, 7, 0.0)])
def test_lists_hold_every_observation_and_co_visible_pair_once(K, L, density):
    g = torch.Generator().manual_seed(K * L)
    mask = torch.rand(K, L, generator=g) < density
    lists = ba._observation_lists(mask)
    obs = list(zip(lists.k.tolist(), lists.l.tolist()))
    assert obs == sorted(((k, l) for k, l in mask.nonzero().tolist()), key=lambda kl: kl[::-1])
    for table, rows, col in ((lists.lm_slots, L, lists.l), (lists.kf_slots, K, lists.k)):
        got = sorted(i for i in table.reshape(-1).tolist() if i >= 0)
        assert got == list(range(len(obs)))
        for r in range(rows):
            assert all(int(col[i]) == r for i in table[r].tolist() if i >= 0)
    want = sorted((a, b) for a in range(len(obs)) for b in range(a, len(obs))
                  if obs[a][1] == obs[b][1])
    a, b = lists.pair_a.tolist(), lists.pair_b.tolist()
    assert sorted((x, y) for x, y in zip(a, b) if x >= 0) == want
    assert lists.pairs == len(want)
    # each keyframe pair's chunks hold its pairs alone, in order of its row
    for row, row_t, chunks in zip(lists.seg_rows.tolist(), lists.seg_rows_t.tolist(),
                                  lists.seg_chunks.tolist()):
        ka, kb = divmod(row, K)
        assert ka <= kb and row_t == (kb * K + ka if ka != kb else -1)
        got = [(a[i], b[i]) for c in chunks if c >= 0
               for i in range(c * ba.PAIR_CHUNK, (c + 1) * ba.PAIR_CHUNK) if a[i] >= 0]
        assert got and all((obs[x][0], obs[y][0]) == (ka, kb) for x, y in got)
    assert lists.seg_rows.tolist() == sorted(set(lists.seg_rows.tolist()))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1000, 1_490_000])
def test_capacity_is_strictly_above_and_within_an_eighth(n):
    c = ba._capacity(n)
    assert n < c <= max(n * 1.125 + 1, 16)


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------

def test_route_by_shape_on_the_cpu(circuit):
    """K > 128 with ``use_schur_kernel=None`` takes the list route; ``False``
    keeps the materialised route; K <= 128 never lists."""
    p, cam, s, _ = circuit
    ba.reset_obs_route_counts()
    _program(p, cam, s, use_schur_kernel=None)
    counts = ba.obs_route_counts()
    assert counts["solves"] == 1 and counts["observations"] == int(p.mask.sum())
    n_l = p.mask.sum(0)
    assert counts["pairs"] == int((n_l * (n_l + 1) // 2).sum())
    small = lm_ba.Problem(T=p.T[:128], X=p.X[:300], obs=p.obs[:128, :300],
                          mask=p.mask[:128, :300], fix=p.fix[:128], odo_M=p.odo_M[:128],
                          odo_w=p.odo_w[:128])
    _program(small, cam, s, use_schur_kernel=None, max_iterations=1)
    _program(p, cam, s, use_schur_kernel=False, max_iterations=1)
    assert ba.obs_route_counts()["solves"] == 1


def test_list_route_matches_the_whole_map_reference(circuit):
    """The circuit's loop closes (its last keyframes see its first
    keyframes' landmarks); the answer holds to the float64 reference."""
    p, cam, s, ref = circuit
    assert bool((p.mask[:8].any(0) & p.mask[-8:].any(0)).any())
    nums = _numbers(_program(p, cam, s), ref)
    assert not over_limits(nums, TOL), nums


def test_list_route_matches_the_materialised_route_with_every_term(circuit):
    """The pose chain, the gravity unaries and per-observation weights on:
    the two float32 routes agree to float32 rounding of the solve (the same
    10 iterations; 1e-3 m / 1e-5 rad / 3e-3 m / 1e-4 of chi^2, as TOL)."""
    p, cam, s, _ = circuit
    g = torch.Generator().manual_seed(7)
    K, L = p.mask.shape
    d = -p.T[:, :3, 1] + 0.01 * torch.randn(K, 3, generator=g)   # R (0, -1, 0), measured
    kw = dict(grav_d=d / d.norm(dim=-1, keepdim=True), grav_w=torch.full((K,), 100.0),
              obs_w=0.3 + 1.7 * torch.rand(K, L, generator=g))
    q = lm_ba.Problem(**{**p.__dict__, "grav_d": kw["grav_d"], "grav_w": kw["grav_w"]})
    listed = _program(q, cam, s, obs_w=kw["obs_w"])
    dense = _program(q, cam, s, obs_w=kw["obs_w"], use_schur_kernel=False)
    as_ref = lm_ba.Solution(T=dense.T_wc.double(), X=dense.points_w.double(),
                            chi2_final=float(dense.chi2_final),
                            iterations=int(dense.iterations))
    nums = _numbers(listed, as_ref)
    assert not over_limits(nums, TOL), nums
    assert float(listed.chi2_final) < 0.5 * float(listed.chi2_initial)


def test_dropping_the_loop_closing_observations_fails_the_bounds(circuit):
    """A planted fault: the route loses the observations that tie the last
    keyframes to the first keyframes' landmarks (the loop's closure); its
    answer then fails the bounds the correct route meets."""
    p, cam, s, ref = circuit
    K = p.mask.shape[0]
    first = p.mask[:K // 4].any(0)
    cut = p.mask.clone()
    cut[K // 2:, first] = False
    assert int(p.mask.sum() - cut.sum()) > 0
    broken = lm_ba.Problem(**{**p.__dict__, "mask": cut})
    nums = _numbers(_program(broken, cam, s), ref)
    assert over_limits(nums, TOL), nums


def test_dropping_the_loop_closing_pairs_fails_the_bounds(circuit, monkeypatch):
    """A planted fault in the route: its lists lose the co-visible pairs of
    keyframes more than half the circuit apart (those that close the loop),
    so ``S`` lacks their blocks; the answer then fails the bounds."""
    import dataclasses

    p, cam, s, ref = circuit
    real = ba._observation_lists

    def without_loop_pairs(mask):
        lists = real(mask)
        K = mask.shape[0]
        far = lists.seg_rows % K - lists.seg_rows // K > K // 2
        assert bool(far.any())
        return dataclasses.replace(lists, seg_chunks=torch.where(
            far[:, None], -1, lists.seg_chunks))

    monkeypatch.setattr(ba, "_observation_lists", without_loop_pairs)
    nums = _numbers(_program(p, cam, s), ref)
    assert over_limits(nums, TOL), nums


def test_one_buffer_set_serves_two_problems_of_one_shape(circuit):
    """Two circuits of one shape whose observation counts differ share one
    buffer set; a later solve leaves an earlier one's results as they were,
    and each solve gives the bits of the same problem solved alone in a
    fresh set (on the CPU, where the padding's zeros close each sum). A
    set too small for a problem's lists is replaced by one that holds both,
    so a ring of problems settles on one set."""
    p, cam, s, _ = circuit
    cfg, traffic = _config()
    q = make_ring(traffic, cfg, 2**33 + 182, "cpu")[0]
    assert int(q.mask.sum()) != int(p.mask.sum())
    ba._buffer_sets.clear()
    ba.reset_obs_route_counts()
    need = [ba._observation_lists(x.mask).capacities for x in (p, q)]
    big = tuple(map(max, *need))
    [_program(x, cam, s) for x in (p, q)]
    made = ba.obs_route_counts()["buffer_sets"]
    assert made == (1 if need[0] == big else 2)
    got = [_program(x, cam, s) for x in (p, q)]
    assert ba.obs_route_counts()["buffer_sets"] == made       # settled on one set
    (lm,) = [v for v in ba._buffer_sets.values() if isinstance(v, ba._ObsBuffers)]
    assert lm.capacities == big
    kept = got[0].points_w.clone()
    _program(q, cam, s)
    assert torch.equal(got[0].points_w, kept)
    alone = []
    for x in (p, q):
        ba._buffer_sets.clear()
        alone.append(_program(x, cam, s))
    for a, b in zip(got, alone):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_landmark_sum_over_two_shards_gives_the_unsharded_answer(circuit):
    """The sharded BA's hook at K = 136: two shards of the landmarks, each
    solved in its own thread, their chi^2 and undamped systems summed
    through the hook, give the unsharded solve in float64 (to 1e-9 of the
    positions: only the order of two partial sums differs)."""
    p, cam, s, _ = circuit
    L = p.mask.shape[1]
    cut = [slice(0, L // 2), slice(L // 2, L)]
    slots: list = [None, None]
    barrier = threading.Barrier(2, timeout=120)

    def hook_for(rank):
        def hook(*tensors):
            slots[rank] = tensors
            barrier.wait()
            out = [a + b for a, b in zip(*slots)]
            barrier.wait()
            return out
        return hook

    def f64(x):
        return lm_ba.Problem(**{k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                                    else v) for k, v in x.__dict__.items()})

    whole = _program(f64(p), cam, s)
    results: list = [None, None]

    def shard(rank):
        sl = cut[rank]
        part = lm_ba.Problem(**{**f64(p).__dict__, "X": f64(p).X[sl], "obs": p.obs[:, sl].double(),
                                "mask": p.mask[:, sl]})
        results[rank] = _program(part, cam, s, _landmark_sum=hook_for(rank))

    threads = [threading.Thread(target=shard, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    assert int(results[0].iterations) == int(whole.iterations) == s.max_iterations
    np.testing.assert_allclose(results[0].T_wc, results[1].T_wc, rtol=0, atol=0)
    np.testing.assert_allclose(results[0].T_wc, whole.T_wc, rtol=0, atol=1e-9)
    X = torch.cat([results[0].points_w, results[1].points_w])
    np.testing.assert_allclose(X, whole.points_w, rtol=0, atol=1e-9)
    assert float(results[0].chi2_final) == pytest.approx(float(whole.chi2_final), rel=1e-12)


def test_map_reference_gives_the_segment_reference(circuit):
    """``map_ba.py`` (S a block of landmarks at a time) against ``lm_ba.py``
    (one dense product) on a 40 x 600 circuit: float64 rounding apart."""
    cfg, traffic = _config(K=40, L=600)
    p = make_ring(traffic, cfg, 2**33 + 183, "cpu")[0]
    s = settings(cfg, traffic)
    a, b = lm_ba.solve(p, s), map_ba.solve(p, s)
    assert a.iterations == b.iterations == s.max_iterations
    assert abs(a.chi2_final - b.chi2_final) <= 1e-12 * a.chi2_final
    torch.testing.assert_close(a.T, b.T, rtol=0, atol=1e-10)
    torch.testing.assert_close(a.X, b.X, rtol=0, atol=1e-10)
