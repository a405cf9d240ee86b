"""The loop-closure subsystem of the port against the JAX package.

The same numpy-made keyframe pools (``torch_parity.keyframe_pools``: planted
revisits, decoys whose points are scrambled, exact twins) go into both
databases. Tolerances:

* everything discrete is exact: match counts, ``ok`` and ``fwd`` of
  ``match_pools``, database arrays, the trained vocabulary, the candidates,
  ``ok``, ``n_matches``, ``inliers`` and ``pairs`` of the queries;
* ``_prob_distance``: 1e-3 absolute on distances of 0..256 (two float32
  matrix products of depth 256, summed in another order);
* the probabilistic branch of ``match_pools`` compares a float distance with
  the cutoff 50.0: a pair within 1e-3 of the cutoff may flip. The planted
  pools put no pair there, and the test asserts that (no row may differ);
* ``T_qr``: 1e-4 absolute (a float32 Gauss-Newton of up to 20 iterations);
* ``consensus_matrix_np`` is numpy float64 in both packages: 1e-12.

Ties: twins give equal BoW scores and equal match counts, where the lower
index must come first, as ``jax.lax.top_k`` orders them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.mapping import closure as jclosure
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.mapping import closure as tclosure

import torch_parity as tp
from torch_parity import flip_bits, random_descs, t32, tbool, words

KW = dict(min_matches=20, exclude_recent=10, min_relative=0.25)
REVISITS = {30: 3, 31: 4, 36: 10, 38: 11}
PLAN = dict(seed=1, n_kf=40, revisits=REVISITS, decoys={33: 6}, twins={12: 11})


@pytest.fixture(scope="module")
def filled():
    pools, T_true = tp.keyframe_pools(**PLAN)
    jdb, tdb = tp.fill_databases(pools)
    return pools, T_true, jdb, tdb


def _pool_pair(rng, P=48, C=5):
    """A query pool and C reference pools, some sharing descriptors with the
    query at distances on both sides of the cutoff; masks on both sides."""
    dq = random_descs(rng, P)
    dr = np.stack([random_descs(rng, P) for _ in range(C)])
    dr[1, :20] = flip_bits(rng, dq[:20], 10)
    dr[2, 5:30] = flip_bits(rng, dq[10:35], 25)      # at the cutoff
    dr[2, 30:40] = flip_bits(rng, dq[35:45], 26)     # one past it
    dr[3] = dr[1]                                    # tied counts
    vq = rng.random(P) > 0.15
    vr = rng.random((C, P)) > 0.15
    return dq, vq, dr, vr


def test_pool_counts_exact(rng):
    dq, vq, dr, vr = _pool_pair(rng)
    want = np.asarray(jclosure.score_pools(jnp.asarray(dq), jnp.asarray(vq),
                                           jnp.asarray(dr), jnp.asarray(vr), cutoff=25))
    got = tclosure.score_pools(words(dq), tbool(vq), words(dr), tbool(vr), cutoff=25)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1] > 5 and want[2] > 5 and want[0] == 0
    one = tclosure.count_pool_matches(words(dq), tbool(vq), words(dr[2]), tbool(vr[2]))
    assert int(one) == int(jclosure.count_pool_matches(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dr[2]), jnp.asarray(vr[2])))
    # a leading batch of queries gives each query's own counts
    dq2 = np.stack([dq, dr[1]])
    vq2 = np.stack([vq, vr[1]])
    both = tclosure._pool_nn_counts(words(dq2), tbool(vq2), words(np.stack([dr, dr])),
                                    tbool(np.stack([vr, vr])), 25)
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(),
        np.asarray(jclosure.score_pools(jnp.asarray(dr[1]), jnp.asarray(vr[1]),
                                        jnp.asarray(dr), jnp.asarray(vr), cutoff=25)))


def _prob_pools(rng, P=48):
    dq = random_descs(rng, P)
    dr = random_descs(rng, P)
    dr[:30] = flip_bits(rng, dq[rng.permutation(P)[:30]], 12)
    return dq, tp.bit_prob_of(rng, dq, 60), dr, tp.bit_prob_of(rng, dr, 60)


def test_prob_distance(rng):
    dq, pq, dr, pr = _prob_pools(rng)
    want = np.asarray(jclosure._prob_distance(jnp.asarray(dq), jnp.asarray(pq),
                                              jnp.asarray(dr), jnp.asarray(pr)))
    got = tclosure._prob_distance(words(dq), torch.from_numpy(pq), words(dr),
                                  torch.from_numpy(pr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert want.min() < 50.0 < want.max()


@pytest.mark.parametrize("branch", ["exact", "exact_nodes", "prob", "prob_nodes"])
def test_match_pools(rng, branch):
    dq, pq, dr, pr = _prob_pools(rng)
    P = len(dq)
    dr[40] = dr[3]                       # two references equally near one query
    pr[40] = pr[3]
    dq[41] = dq[5]                       # and two queries equally near a reference
    pq[41] = pq[5]
    xq = rng.normal(size=(P, 3)).astype(np.float32)
    xr = rng.normal(size=(P, 3)).astype(np.float32)
    vq, vr = rng.random(P) > 0.1, rng.random(P) > 0.1
    jkw, tkw = {}, {}
    if branch.startswith("prob"):
        jkw.update(prob_q=jnp.asarray(pq), prob_r=jnp.asarray(pr))
        tkw.update(prob_q=torch.from_numpy(pq), prob_r=torch.from_numpy(pr))
    if branch.endswith("nodes"):
        nq, nr = rng.integers(0, 2, P), rng.integers(0, 2, P)
        jkw.update(node_q=jnp.asarray(nq, jnp.int32), node_r=jnp.asarray(nr, jnp.int32))
        tkw.update(node_q=torch.from_numpy(nq), node_r=torch.from_numpy(nr))
    want = jclosure.match_pools(jnp.asarray(dq), jnp.asarray(xq), jnp.asarray(vq),
                                jnp.asarray(dr), jnp.asarray(xr), jnp.asarray(vr),
                                cutoff=25, **jkw)
    got = tclosure.match_pools(words(dq), t32(xq), tbool(vq), words(dr), t32(xr),
                               tbool(vr), cutoff=25, **tkw)
    if branch.startswith("prob"):
        # no pair sits within the float tolerance of the cutoff, so no row
        # may differ
        d = np.asarray(jclosure._prob_distance(jnp.asarray(dq), jnp.asarray(pq),
                                               jnp.asarray(dr), jnp.asarray(pr)))
        assert np.abs(d - 50.0).min() > 1e-3
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))     # ok
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))     # fwd
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))     # matched points
    assert 3 < int(got[2].sum()) < P
    # a leading batch dimension gives the same rows
    stack = lambda t: torch.stack([t, t])  # noqa: E731
    twice = tclosure.match_pools(
        stack(words(dq)), stack(t32(xq)), stack(tbool(vq)), stack(words(dr)),
        stack(t32(xr)), stack(tbool(vr)), cutoff=25,
        **{k: stack(v) for k, v in tkw.items()})
    for a, b in zip(twice, got):
        assert torch.equal(a[1], b)


def test_database_arrays_and_vocabulary_equal(filled):
    pools, _, jdb, tdb = filled
    want, got = tp.keyframe_db_dict(jdb), convert.keyframe_db_to_numpy(tdb)
    n = want["n"]
    assert got["n"] == n == 40 and got["capacity"] == want["capacity"] == 64   # grown twice
    assert got["count_host"] == want["count_host"]
    for name in ("desc", "p_cam", "valid", "count", "T_wc", "prob"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(tdb.poses_host(), jdb.poses_host())
    # the in-run vocabulary, trained at the 8th keyframe from the same pools
    jv, tv = want["bow"]["vocab"], got["bow"]["vocab"]
    assert (jv["k"], jv["levels"]) == (tv["k"], tv["levels"]) == (8, 3)
    for a, b in zip(jv["centroids"] + jv["child_valid"], tv["centroids"] + tv["child_valid"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tv["weights"], jv["weights"], atol=1e-6)
    assert got["bow"]["n"] == want["bow"]["n"] == n
    np.testing.assert_allclose(got["bow"]["vectors"][:n], want["bow"]["vectors"][:n],
                               atol=1e-6)


@pytest.mark.parametrize("store_prob", [True, False])
def test_add_many_equals_add(store_prob):
    """``add_many`` == repeated ``add`` == the JAX database, with the pool
    rows of the probability plane gathered from a ``[B, L, 256]`` stack."""
    pools, _ = tp.keyframe_pools(seed=3, n_kf=13, pool=40)
    rng = np.random.default_rng(5)
    Ltab = 96
    jdb = jclosure.KeyframeDatabase.create(4, 40, store_prob=store_prob)
    one = tclosure.KeyframeDatabase.create(4, 40, store_prob=store_prob, device="cpu")
    many = tclosure.KeyframeDatabase.create(4, 40, store_prob=store_prob, device="cpu")
    for chunk in (pools[:1], pools[1:6], pools[6:13]):
        plane = rng.integers(0, 256, (len(chunk), Ltab, 256), dtype=np.uint8)
        tuples = []
        for b, kf in enumerate(chunk):
            sel = np.sort(rng.choice(Ltab, len(kf["desc"]), replace=False))
            tuples.append((kf["desc"], kf["p_cam"], kf["T_wc"], sel))
            one.add(kf["desc"], kf["p_cam"], kf["T_wc"],
                    prob_device=(torch.from_numpy(plane[b]), sel))
        assert many.add_many(tuples, torch.from_numpy(plane)) == jdb.add_many(
            tuples, jnp.asarray(plane))
    a, b, want = (convert.keyframe_db_to_numpy(one), convert.keyframe_db_to_numpy(many),
                  tp.keyframe_db_dict(jdb))
    n = 13
    assert a["n"] == b["n"] == want["n"] == n
    for name in ("desc", "p_cam", "valid", "count", "T_wc") + (("prob",) if store_prob else ()):
        np.testing.assert_array_equal(a[name][:n], want[name][:n], err_msg=name)
        np.testing.assert_array_equal(b[name][:n], want[name][:n], err_msg=name)
    assert b["count_host"] == want["count_host"]
    # the vocabulary trains when a write leaves >= 8 keyframes behind: after
    # the second chunk (6 pools) in the chunked databases, at the 8th
    # keyframe in the one filled by single adds, which so has another tree
    np.testing.assert_allclose(b["bow"]["vectors"][:n], want["bow"]["vectors"][:n], atol=1e-6)
    assert a["bow"]["n"] == n
    # without a plane, a database that stores probabilities keeps 0/255
    if store_prob:
        jdb.add(pools[0]["desc"], pools[0]["p_cam"], pools[0]["T_wc"])
        many.add_many([(pools[0]["desc"], pools[0]["p_cam"], pools[0]["T_wc"], None)])
        np.testing.assert_array_equal(many.prob[n].numpy(), np.asarray(jdb.prob[n]))
        assert set(np.unique(many.prob[n].numpy())) == {0, 255}


def test_update_poses_and_converter_round_trip(filled):
    pools, _, jdb, _ = filled
    db = convert.keyframe_db_from_numpy(tp.keyframe_db_dict(jdb), device="cpu")
    again = convert.keyframe_db_to_numpy(db)
    for name, want in tp.keyframe_db_dict(jdb).items():
        if name == "bow":
            np.testing.assert_array_equal(again["bow"]["vectors"], want["vectors"])
        elif isinstance(want, np.ndarray):
            np.testing.assert_array_equal(again[name], want, err_msg=name)
    T_new = np.stack([kf["T_wc"] for kf in pools[:5]]).copy()
    T_new[:, 0, 3] += 0.25
    db.update_poses(T_new)
    np.testing.assert_array_equal(db.T_wc[:5].numpy(), T_new)
    np.testing.assert_array_equal(db.poses_host()[:5], T_new)
    np.testing.assert_array_equal(db.T_wc[5].numpy(), pools[5]["T_wc"])
    assert db.count_of(3) == len(pools[3]["desc"])


def _same_candidates(got, want, T_true=None, q=None):
    assert [c.ref_kf for c in got] == [c.ref_kf for c in want]
    for g, w in zip(got, want):
        assert (g.query_kf, g.matches, g.inliers) == (w.query_kf, w.matches, w.inliers)
        np.testing.assert_array_equal(g.pairs, w.pairs)
        np.testing.assert_allclose(g.T_qr, w.T_qr, atol=1e-4, rtol=0)
        if T_true is not None and q in T_true:
            np.testing.assert_allclose(g.T_qr, T_true[q], atol=0.05)


@pytest.mark.parametrize("probabilistic", [True, False])
def test_find_closures_equal(filled, probabilistic):
    _, T_true, jdb, tdb = filled
    found = {}
    for q in (0, 5, 30, 31, 33, 36, 38, 39):
        want = jclosure.find_closures(jdb, q, probabilistic=probabilistic, **KW)
        got = tclosure.find_closures(tdb, q, probabilistic=probabilistic, **KW)
        _same_candidates(got, want, T_true, q)
        found[q] = [c.ref_kf for c in got]
    # planted revisits found, the decoy (its points scrambled) and the
    # keyframes that revisit nothing refused
    assert found[30] == [3] and found[31] == [4] and found[36] == [10]
    assert found[33] == [] and found[39] == [] and found[5] == []
    # keyframe 38 revisits 11, whose exact twin is keyframe 12: equal BoW
    # scores and equal counts, and both pass; the lower index comes first
    assert found[38] == [11, 12]


def test_fused_query_raw_outputs_equal(filled):
    """Every array of ``closure_query_fused``, for a query with candidates
    (tied ones included) and for one with none (the skip values)."""
    _, _, jdb, tdb = filled
    C, Cm = 16, 4
    for q, entry in ((38, 20), (39, 20), (30, 20), (31, 10_000)):
        lo = max(0, q - 10)
        jv = jdb.bow.vocab
        want = jclosure.closure_query_fused(
            jv.centroids, jv.child_valid, jv.weights, jdb.bow.vectors, jnp.int32(q),
            jdb.desc, jdb.p_cam, jdb.valid, jdb.T_wc, jnp.int32(lo), jnp.float32(25.0),
            jnp.int32(entry), jv.k, C, Cm, 25, prob_db=jdb.prob)
        tv = tdb.bow.vocab
        got = tclosure.closure_query_fused(
            tv.centroids, tv.child_valid, tv.weights, tdb.bow.vectors, q, tdb.desc,
            tdb.p_cam, tdb.valid, tdb.T_wc, lo, 25.0, entry, tv.k, C, Cm, 25,
            prob_db=tdb.prob)
        names = ("cand", "ok", "n_matches", "T_qr", "icp_ok", "inliers", "inl", "fwd")
        for name, g, w in zip(names, got, want):
            if name == "T_qr":
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                           err_msg=f"{name} q={q}")
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{name} q={q}")
        if q in (39, 31):                 # no candidate past the entry floor
            assert not got[1].any() and not got[2].any() and not got[6].any()
            np.testing.assert_array_equal(got[3].numpy(), np.tile(np.eye(4), (Cm, 1, 1)))
        if q == 38:                       # the twins tie; the lower index first
            assert got[0][:2].tolist() == [11, 12] and got[1][:2].all()


@pytest.mark.parametrize("di_levels", [0, 2])
def test_find_closures_batch_equal(filled, di_levels):
    _, T_true, jdb, tdb = filled
    qs = [30, 31, 33, 36, 38, 39]
    want = jclosure.find_closures_batch(jdb, qs, direct_index_levels=di_levels, **KW)
    got = tclosure.find_closures_batch(tdb, qs, direct_index_levels=di_levels, **KW)
    assert len(got) == len(qs)
    for q, g, w in zip(qs, got, want):
        _same_candidates(g, w, T_true, q)
        # the batch gives what each query gives alone
        _same_candidates(g, tclosure.find_closures(tdb, q, direct_index_levels=di_levels,
                                                   **KW), None)
    assert [[c.ref_kf for c in g] for g in got][:4] == [[3], [4], [], [10]]


def test_batch_longer_than_the_exclusion_falls_back(filled, monkeypatch):
    """``find_closures_batch`` batches only while the chunk's keyframes
    number at most ``exclude_recent``; past that it queries one by one."""
    _, _, jdb, tdb = filled
    calls = []
    real = tclosure.closure_query_fused

    def spy(*a, **k):
        calls.append(torch.is_tensor(a[4]) and a[4].dim() == 1)
        return real(*a, **k)

    monkeypatch.setattr(tclosure, "closure_query_fused", spy)
    qs = [30, 31, 36, 38]
    batched = tclosure.find_closures_batch(tdb, qs, **KW)
    assert calls == [True]
    calls.clear()
    kw = dict(KW, exclude_recent=3)
    one_by_one = tclosure.find_closures_batch(tdb, qs, **kw)
    assert calls == [False] * 4
    want = jclosure.find_closures_batch(jdb, qs, **kw)
    for g, w, b in zip(one_by_one, want, batched):
        _same_candidates(g, w)
        assert [c.ref_kf for c in g] == [c.ref_kf for c in b]


def test_vocabulary_less_database():
    """The first keyframes, before the vocabulary has trained, and a database
    with ``auto_vocab`` off: the ``score_pools`` route of ``find_closures``."""
    pools, T_true = tp.keyframe_pools(seed=2, n_kf=7, revisits={5: 1, 6: 2}, decoys={4: 0})
    jdb, tdb = tp.fill_databases(pools)
    assert jdb.bow is None and tdb.bow is None
    kw = dict(KW, exclude_recent=2)
    for probabilistic in (True, False):
        for q in (3, 4, 5, 6):
            want = jclosure.find_closures(jdb, q, probabilistic=probabilistic, **kw)
            got = tclosure.find_closures(tdb, q, probabilistic=probabilistic, **kw)
            _same_candidates(got, want, T_true, q)
            if q >= 5:
                assert [c.ref_kf for c in got] == [q - 4]
            else:
                assert got == []
    batch = tclosure.find_closures_batch(tdb, [5, 6], **kw)
    assert [[c.ref_kf for c in g] for g in batch] == [[1], [2]]


def test_radius_gate_refuses_a_far_revisit():
    pools, _ = tp.keyframe_pools(seed=4, n_kf=30, revisits={25: 2})
    pools[25]["T_wc"][:3, 3] += [40.0, 0.0, 0.0]        # 40 m from keyframe 2
    jdb, tdb = tp.fill_databases(pools)
    assert tclosure.find_closures(tdb, 25, **KW) == jclosure.find_closures(jdb, 25, **KW) == []
    got = tclosure.find_closures(tdb, 25, search_radius_m2=np.inf, **KW)
    _same_candidates(got, jclosure.find_closures(jdb, 25, search_radius_m2=np.inf, **KW))
    assert [c.ref_kf for c in got] == [2]


def test_consensus(rng):
    C = 6
    T_i = np.stack([tp.exp_se3_np(rng.normal(0, 0.3, 6)) for _ in range(C)])
    T_j = np.stack([tp.exp_se3_np(rng.normal(0, 0.3, 6)) for _ in range(C)])
    D = tp.exp_se3_np(rng.normal(0, 0.2, 6))
    M = np.stack([D @ T_j[c] @ np.linalg.inv(T_i[c]) for c in range(C)])
    M[4] = tp.exp_se3_np(rng.normal(0, 0.5, 6)) @ M[4]          # an outlier
    np.testing.assert_allclose(tclosure.consensus_matrix_np(M, T_i, T_j),
                               jclosure.consensus_matrix_np(M, T_i, T_j), atol=1e-12)
    np.testing.assert_allclose(tclosure._log_se3_np(M), jclosure._log_se3_np(M), atol=1e-12)
    valid = np.ones(C, bool)
    valid[5] = False
    want = np.asarray(jclosure.consensus_matrix(jnp.asarray(M, jnp.float32),
                                                jnp.asarray(T_i, jnp.float32),
                                                jnp.asarray(T_j, jnp.float32),
                                                jnp.asarray(valid)))
    got = tclosure.consensus_matrix(t32(M), t32(T_i), t32(T_j), tbool(valid))
    # rotations of 0.2 .. 1 rad: clear of the small-angle range where the two
    # packages' float32 log_se3 differ
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=1e-3, rtol=1e-3)
    acc_j, n_j = jclosure.consensus_filter(jnp.asarray(want), jnp.asarray(valid))
    acc_t, n_t = tclosure.consensus_filter(got, tbool(valid))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert int(n_t) == int(n_j) == 4


def test_left_out_options_raise():
    """The native index and the snapshot of the closure worker exist; a
    native database trains no vocabulary in-run; a snapshot keeps the poses
    and pool counts it was taken with while the database grows and its poses
    are updated; only a database without a device raises."""
    dbn = tclosure.KeyframeDatabase.create(4, 8, native_index=True, device="cpu")
    assert dbn.index is not None and dbn.auto_vocab
    rng = np.random.default_rng(4)
    for k in range(10):                       # past vocab_train_at and a growth
        dbn.add(rng.integers(0, 2**32, (6, 8), dtype=np.uint32),
                rng.normal(size=(6, 3)).astype(np.float32),
                np.eye(4, dtype=np.float32))
    assert dbn.bow is None and dbn.index.size == 60 and dbn.capacity == 16
    db = tclosure.KeyframeDatabase.create(4, 8, device="cpu")
    db.add(rng.integers(0, 2**32, (5, 8), dtype=np.uint32),
           rng.normal(size=(5, 3)).astype(np.float32), np.eye(4, dtype=np.float32))
    snap = db.snapshot()
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 2.0
    db.update_poses(T[None])
    db.add(rng.integers(0, 2**32, (3, 8), dtype=np.uint32),
           rng.normal(size=(3, 3)).astype(np.float32), T)
    assert snap.n == 1 and snap.count_of(0) == 5 and db.n == 2 and db.count_of(1) == 3
    assert float(snap.T_wc[0, 0, 3]) == 0.0 and snap.poses_host()[0, 0, 3] == 0.0
    assert float(db.T_wc[0, 0, 3]) == 2.0 and db.poses_host()[0, 0, 3] == 2.0
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            tclosure.KeyframeDatabase.create(4, 8)
        else:
            raise RuntimeError("CUDA present")
