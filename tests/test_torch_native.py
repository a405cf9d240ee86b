"""The port's native host runtime (``svi_mapper_tpu_torch.native``) against
the JAX package's (``svi_mapper_tpu.native``) and against brute force.

Mirrors ``tests/test_native.py``. The two packages build their own
libraries from their own copies of the C++ sources, so both load in this
process: the port's votes, cloud files and dumps are held to the JAX
package's library on the same inputs, byte for byte where they are files.
Nothing here skips: g++ must build the port's library.
"""

import numpy as np
import pytest
import torch

from svi_mapper_tpu import native as jnative
from svi_mapper_tpu.io import cloud as jcloud
from svi_mapper_tpu.mapping import closure as jclosure
from svi_mapper_tpu_torch import native
from svi_mapper_tpu_torch.io import cloud as tcloud
from svi_mapper_tpu_torch.mapping import closure as tclosure
from svi_mapper_tpu_torch.native import build


def _rand_pools(rng, n_kf=8, n_desc=64):
    return [rng.integers(0, 2**32, size=(n_desc, 8), dtype=np.uint32)
            for _ in range(n_kf)]


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


def _brute_votes(query, pools, cutoff, max_keyframe=-1):
    """Oracle for DescriptorIndex.query: each query descriptor votes for the
    keyframe owning its single global nearest neighbour among the keyframes
    below ``max_keyframe`` (ties: first)."""
    keep = [k for k in range(len(pools)) if max_keyframe < 0 or k < max_keyframe]
    votes = np.zeros(len(pools), np.int32)
    if not keep:
        return votes
    allw = np.concatenate([pools[k] for k in keep])
    owner = np.concatenate([[k] * len(pools[k]) for k in keep])
    for q in query:
        d = _popcount_rows(np.bitwise_xor(allw, q[None, :]))
        best = int(np.argmin(d))
        if d[best] <= cutoff:
            votes[owner[best]] += 1
    return votes


def _flip(rng, q, n_bits):
    q = q.copy()
    for i in range(len(q)):
        for bit in rng.choice(256, n_bits, replace=False):
            q[i, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    return q


def test_library_is_the_ports_own():
    """Built from native/src into _build under its own name; the JAX
    package's library is a different file."""
    assert native.available(), native.load_error()
    assert native.load_error() is None
    path = build.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "svi_mapper_tpu_torch"
    assert path.exists() and path.name != "libsvi_native.so"
    assert native._lib._name == str(path)
    assert jnative.available()
    assert native._lib._name != jnative._lib._name


class TestDescriptorIndex:
    def test_exact_self_query(self):
        rng = np.random.default_rng(0)
        pools = _rand_pools(rng)
        idx = native.DescriptorIndex(max_leaf_size=16)
        for k, p in enumerate(pools):
            idx.add(p if k % 2 else p.view(np.int32), k)   # int32 bit patterns too
        assert idx.size == sum(len(p) for p in pools)
        for k in (0, 3, 7):
            votes = idx.query(pools[k], cutoff=0)
            assert votes[k] == len(pools[k])

    def test_votes_match_brute_force_and_the_jax_library(self):
        """Separated pools and queries a few bits off: the tree's descent
        follows single bits, so a flipped split bit can miss a match brute
        force finds, but it never votes where brute force does not, and it
        recalls >= 90 % (the JAX test's bound). On any pools its votes are the
        JAX package's library's, vote for vote, at every cutoff and exclusion
        bound."""
        rng = np.random.default_rng(1)
        pools = _rand_pools(rng, n_kf=6, n_desc=40)
        t_idx = native.DescriptorIndex(max_leaf_size=8)
        j_idx = jnative.DescriptorIndex(max_leaf_size=8)
        for k, p in enumerate(pools):
            t_idx.add(p, k)
            j_idx.add(p, k)
        q = _flip(rng, pools[2], 3)
        votes = t_idx.query(q, cutoff=25)
        brute = _brute_votes(q, pools, 25)
        assert brute[2] == len(q) and brute.sum() == len(q)
        assert votes[2] >= 0.9 * len(q) and (votes <= brute).all()
        # mixed queries: near copies of several pools plus noise
        q_mix = np.concatenate([_flip(rng, pools[k][:10], 5) for k in range(6)]
                               + [rng.integers(0, 2**32, (20, 8), dtype=np.uint32)])
        for cutoff in (0, 10, 25, 60):
            for max_kf in (-1, 0, 3, 6):
                tv = t_idx.query(q_mix, cutoff=cutoff, max_keyframe=max_kf)
                jv = j_idx.query(q_mix, cutoff=cutoff, max_keyframe=max_kf)
                np.testing.assert_array_equal(tv, jv, err_msg=f"{cutoff} {max_kf}")
                brute = _brute_votes(q_mix, pools, cutoff, max_kf)
                assert (tv <= brute).all(), (cutoff, max_kf, tv, brute)
                if max_kf in (-1, 6) and cutoff >= 10:
                    assert tv.sum() >= 0.9 * brute.sum()

    def test_empty_query_and_empty_index(self):
        idx = native.DescriptorIndex()
        assert idx.query(np.zeros((0, 8), np.uint32)).shape == (0,)
        assert idx.size == 0
        idx.add(np.ones((4, 8), np.uint32), 0)
        assert idx.query(np.zeros((0, 8), np.uint32), cutoff=10).tolist() == [0]
        with pytest.raises(ValueError):
            idx.add(np.ones((4, 7), np.uint32), 1)

    def test_identical_descriptors_unsplittable(self):
        # 1000 identical descriptors exceed any leaf size but cannot split:
        # the index must stay functional
        idx = native.DescriptorIndex(max_leaf_size=8)
        d = np.full((1000, 8), 7, np.uint32)
        idx.add(d, 0)
        votes = idx.query(d[:5], cutoff=0)
        assert votes[0] == 5
        assert idx.size == 1000


def _cloud(mod, rng, n=33):
    return mod.KeyframeCloud(
        keyframe_id=9, frame_idx=456,
        T_wc=np.asarray(np.diag([1., 1, 1, 1]), np.float32),
        uids=rng.integers(0, 1000, n).astype(np.int64),
        points_w=rng.normal(size=(n, 3)).astype(np.float32),
        points_cam=rng.normal(size=(n, 3)).astype(np.float32),
        uv_left=rng.random((n, 2)).astype(np.float32),
        uv_right=rng.random((n, 2)).astype(np.float32),
        descriptors=rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32),
    )


class TestCloudCodec:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_svic_written_by_either_reads_in_the_other(self, tmp_path, writer):
        rng = np.random.default_rng(2)
        c = _cloud(tcloud, rng)
        a, b = tmp_path / "a.svic", tmp_path / "b.svic"
        if writer == "port":
            tcloud.save_cloud(a, c)
            back = jcloud.load_cloud(a)
        else:
            jcloud.save_cloud(a, jcloud.KeyframeCloud(**vars(c)))
            back = tcloud.load_cloud(a)
        assert back.keyframe_id == 9 and back.frame_idx == 456
        for f in ("T_wc", "uids", "points_w", "points_cam", "uv_left", "uv_right"):
            np.testing.assert_array_equal(getattr(back, f), getattr(c, f), err_msg=f)
        np.testing.assert_array_equal(np.ascontiguousarray(back.descriptors),
                                      c.descriptors)
        # the other package writes the same bytes
        (jcloud if writer == "port" else tcloud).save_cloud(
            b, (jcloud.KeyframeCloud if writer == "port" else tcloud.KeyframeCloud)(**vars(c)))
        assert a.read_bytes() == b.read_bytes()

    def test_int32_descriptors_and_empty_cloud(self, tmp_path):
        rng = np.random.default_rng(3)
        c = _cloud(tcloud, rng)
        words = c.descriptors.copy()
        c.descriptors = words.view(np.int32)
        tcloud.save_cloud(tmp_path / "i.svic", c)
        np.testing.assert_array_equal(tcloud.load_cloud(tmp_path / "i.svic").descriptors,
                                      words)
        e = _cloud(tcloud, rng, n=0)
        tcloud.save_cloud(tmp_path / "e.svic", e)
        assert len(tcloud.load_cloud(tmp_path / "e.svic").uids) == 0

    def test_bad_file(self, tmp_path):
        p = tmp_path / "junk.svic"
        p.write_bytes(b"not a cloud file")
        with pytest.raises(IOError):
            native.read_cloud_native(p)


def _frames(rng, n, h, w):
    return [(i, i * 0.05, rng.integers(0, 255, (h, w), dtype=np.uint8),
             rng.integers(0, 255, (h, w), dtype=np.uint8)) for i in range(n)]


class TestDumpLoader:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_svid_written_by_either_reads_in_the_other(self, tmp_path, writer):
        rng = np.random.default_rng(3)
        frames = _frames(rng, 12, 32, 48)
        paths = {"port": tmp_path / "t.svid", "jax": tmp_path / "j.svid"}
        for name, mod in (("port", native), ("jax", jnative)):
            with mod.DumpWriter(paths[name], 32, 48) as w:
                for fid, ts, L, R in frames:
                    w.append(fid, ts, L, R)
        assert paths["port"].read_bytes() == paths["jax"].read_bytes()
        reader = native if writer == "jax" else jnative
        assert reader.validate_dump(paths[writer]) == 12
        with reader.DumpReader(paths[writer], prefetch=3) as r:
            assert (r.n_frames, r.height, r.width) == (12, 32, 48)
            got = list(r)
        assert len(got) == 12
        for (fid, ts, L, R), (gf, gt, gL, gR) in zip(frames, got):
            assert fid == gf and ts == gt
            np.testing.assert_array_equal(L, gL)
            np.testing.assert_array_equal(R, gR)

    @pytest.mark.parametrize("prefetch", [1, 4])
    def test_roundtrip_with_prefetch(self, tmp_path, prefetch):
        rng = np.random.default_rng(5)
        frames = _frames(rng, 9, 16, 24)
        with native.DumpWriter(tmp_path / "s.svid", 16, 24) as w:
            for f in frames:
                w.append(*f)
        with native.DumpReader(tmp_path / "s.svid", prefetch=prefetch) as r:
            got = list(r)
            assert next(iter(r), None) is None        # ended, stays ended
        assert [g[0] for g in got] == list(range(9))
        np.testing.assert_array_equal(got[8][3], frames[8][3])

    def test_early_close_no_hang(self, tmp_path):
        rng = np.random.default_rng(4)
        path = tmp_path / "seq.svid"
        with native.DumpWriter(path, 16, 16) as w:
            for i in range(50):
                img = rng.integers(0, 255, (16, 16), dtype=np.uint8)
                w.append(i, float(i), img, img)
        r = native.DumpReader(path, prefetch=2)
        next(iter(r))
        r.close()  # must join the prefetch thread cleanly mid-stream
        r.close()
        with pytest.raises(StopIteration):
            next(r)

    def test_validate_rejects_corruption(self, tmp_path):
        path = tmp_path / "seq.svid"
        img = np.zeros((8, 8), np.uint8)
        with native.DumpWriter(path, 8, 8) as w:
            w.append(0, 0.0, img, img)
            w.append(1, 1.0, img, img)
        data = bytearray(path.read_bytes())
        path.write_bytes(bytes(data[:-10]))          # truncate image payload
        with pytest.raises(ValueError, match="truncated"):
            native.validate_dump(path)
        (tmp_path / "junk.svid").write_bytes(b"nope")
        with pytest.raises(ValueError):
            native.validate_dump(tmp_path / "junk.svid")
        with pytest.raises(IOError):
            native.DumpReader(tmp_path / "missing.svid")

    def test_shape_mismatch_raises(self, tmp_path):
        with native.DumpWriter(tmp_path / "x.svid", 8, 8) as w:
            with pytest.raises(ValueError):
                w.append(0, 0.0, np.zeros((4, 4), np.uint8), np.zeros((8, 8), np.uint8))


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    """Where the library cannot be built, asking for the native index
    raises with the build's reason; nothing runs without it."""
    def broken(force=False):
        raise RuntimeError("g++ failed: planted")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(build, "build", broken)
    assert not native.available()
    assert "planted" in native.load_error()
    with pytest.raises(RuntimeError, match="planted"):
        tclosure.KeyframeDatabase.create(4, 8, native_index=True, device="cpu")
    with pytest.raises(RuntimeError, match="planted"):
        tcloud.save_cloud("/nonexistent/x.svic", _cloud(tcloud, np.random.default_rng(0)))
    # without the index nothing needs the library
    assert tclosure.KeyframeDatabase.create(4, 8, device="cpu").index is None


# ---------------------------------------------------------------------------
# the closure database with the native index
# ---------------------------------------------------------------------------

N_DESC = 64


def _revisit_pools():
    """Keyframes 0..11 with distinct pools, then keyframe 12 revisiting 0."""
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 2**32, size=(N_DESC, 8), dtype=np.uint32)
    pts = rng.normal(scale=2.0, size=(N_DESC, 3)).astype(np.float32) + [0, 0, 5]
    pools = [desc] + [rng.integers(0, 2**32, size=(N_DESC, 8), dtype=np.uint32)
                      for _ in range(11)] + [desc]
    return pools, pts


def _db(mod, pools, pts, **kw):
    extra = {"device": "cpu"} if mod is tclosure else {}
    db = mod.KeyframeDatabase.create(32, 128, **kw, **extra)
    for d in pools:
        db.add(d, pts, np.eye(4, dtype=np.float32))
    return db


def test_find_closures_with_native_index_as_jax():
    """KeyframeDatabase(native_index=True) finds the revisit through the
    tree, as the JAX package's does: the same candidates, matches and
    inliers, T_qr within 1e-4."""
    pools, pts = _revisit_pools()
    dbs = {"t": _db(tclosure, pools, pts, native_index=True),
           "j": _db(jclosure, pools, pts, native_index=True)}
    assert dbs["t"].index is not None and dbs["j"].index is not None
    assert dbs["t"].bow is None and dbs["j"].bow is None      # no in-run vocabulary
    found = {k: (tclosure if k == "t" else jclosure).find_closures(db, 12, min_matches=25)
             for k, db in dbs.items()}
    assert [(c.ref_kf, c.matches, c.inliers) for c in found["t"]] == [
        (c.ref_kf, c.matches, c.inliers) for c in found["j"]]
    assert len(found["t"]) == 1 and found["t"][0].ref_kf == 0
    np.testing.assert_allclose(found["t"][0].T_qr, found["j"][0].T_qr, atol=1e-4)
    np.testing.assert_allclose(found["t"][0].T_qr, np.eye(4), atol=1e-3)
    np.testing.assert_array_equal(found["t"][0].pairs, found["j"][0].pairs)


def test_routing_as_the_jax_code_routes(monkeypatch):
    """The tree shortlists only without a trained vocabulary: with a given
    vocabulary the BoW query runs, in find_closures and batched in
    find_closures_batch, index or not; without one, find_closures_batch goes
    sequential and each query takes the tree."""
    from svi_mapper_tpu_torch.mapping.vocabulary import build_vocabulary

    pools, pts = _revisit_pools()
    calls = {"tree": 0, "fused": 0}
    real_fused = tclosure.closure_query_fused

    def fused(*a, **k):
        calls["fused"] += 1
        return real_fused(*a, **k)

    monkeypatch.setattr(tclosure, "closure_query_fused", fused)
    db_tree = _db(tclosure, pools, pts, native_index=True)
    real_query = db_tree.index.query

    def tree_query(*a, **k):
        calls["tree"] += 1
        return real_query(*a, **k)

    monkeypatch.setattr(db_tree.index, "query", tree_query)
    out = tclosure.find_closures_batch(db_tree, [11, 12], min_matches=25,
                                       exclude_recent=10)
    assert calls == {"tree": 2, "fused": 0}
    assert [c.ref_kf for c in out[1]] == [0]

    vocab = build_vocabulary(np.concatenate(pools), k=4, levels=2, iters=2,
                             device="cpu")
    db_bow = _db(tclosure, pools, pts, native_index=True, vocabulary=vocab)
    assert db_bow.index is not None and db_bow.bow.n == len(pools)
    monkeypatch.setattr(db_bow.index, "query", tree_query)
    calls.update(tree=0, fused=0)
    out = tclosure.find_closures_batch(db_bow, [11, 12], min_matches=25,
                                       exclude_recent=10)
    assert calls == {"tree": 0, "fused": 1}                # one batched query
    tclosure.find_closures(db_bow, 12, min_matches=25)
    assert calls == {"tree": 0, "fused": 2}
    assert [c.ref_kf for c in out[1]] == [0]


def test_snapshot_query_while_the_database_grows():
    """A search over a snapshot gives the same candidates as over the live
    database at the time of the snapshot, after the live one has taken more
    keyframes (the shared index bounds votes below the exclusion) and
    updated its poses."""
    pools, pts = _revisit_pools()
    db = _db(tclosure, pools, pts, native_index=True)
    before = tclosure.find_closures(db, 12, min_matches=25)
    snap = db.snapshot()
    rng = np.random.default_rng(9)
    for _ in range(25):                                # grows past capacity 32
        db.add(rng.integers(0, 2**32, size=(N_DESC, 8), dtype=np.uint32), pts,
               np.eye(4, dtype=np.float32))
    T = np.tile(np.eye(4, dtype=np.float32), (db.n, 1, 1))
    T[:, 0, 3] = 100.0                                 # everything moved away
    db.update_poses(T)
    after = tclosure.find_closures(snap, 12, min_matches=25)
    assert db.capacity == 64 and snap.capacity == 32
    assert [(c.ref_kf, c.matches, c.inliers) for c in after] == [
        (c.ref_kf, c.matches, c.inliers) for c in before]
    assert torch.equal(snap.T_wc[:13], torch.eye(4).repeat(13, 1, 1))
