"""The port's binary vocabulary against the JAX package: the same seed and
descriptors give the same tree and word ids bit for bit; BoW vectors and
scores to 1e-6; files cross between the packages. On the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_mapper_tpu.mapping import vocabulary as j_voc
from svi_mapper_tpu_torch import convert
from svi_mapper_tpu_torch.mapping import vocabulary as t_voc
from tests import torch_parity as tp


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(3)
    desc, labels, _ = tp.clustered_descs(rng, 16, 40)
    kw = dict(k=4, levels=3, iters=6, seed=0, doc_ids=labels % 8)
    return (j_voc.build_vocabulary(desc, **kw),
            t_voc.build_vocabulary(desc, device="cpu", **kw), desc, labels)


def _assert_same_tree(jv, tv):
    assert (tv.k, tv.levels, tv.num_words) == (jv.k, jv.levels, jv.num_words)
    for l in range(jv.levels):
        np.testing.assert_array_equal(tp.unwords(tv.centroids[l]),
                                      np.asarray(jv.centroids[l]), f"centroids {l}")
        np.testing.assert_array_equal(tv.child_valid[l].numpy(),
                                      np.asarray(jv.child_valid[l]), f"valid {l}")
        assert tv.centroids[l].dtype == torch.int32
    np.testing.assert_allclose(tv.weights.numpy(), np.asarray(jv.weights), atol=1e-7)


def test_tree_is_bit_exact(trained):
    jv, tv, _, _ = trained
    _assert_same_tree(jv, tv)
    assert not all(v.all() for v in tv.child_valid) or tv.num_words == 64


@pytest.mark.parametrize("doc_ids", [False, True])
def test_tree_on_random_descriptors_is_bit_exact(doc_ids):
    """Random (unclustered) descriptors leave empty children and ties."""
    rng = np.random.default_rng(11)
    desc = tp.random_descs(rng, 600)
    kw = dict(k=4, levels=3, iters=3, seed=5,
              doc_ids=rng.integers(0, 6, 600) if doc_ids else None)
    jv = j_voc.build_vocabulary(desc, **kw)
    tv = t_voc.build_vocabulary(desc.view(np.int32), device="cpu", **kw)
    _assert_same_tree(jv, tv)
    q = tp.random_descs(rng, 200)
    np.testing.assert_array_equal(t_voc.word_ids(tv, q).numpy(),
                                  np.asarray(j_voc.word_ids(jv, jnp.asarray(q))))
    with pytest.raises(ValueError):
        t_voc.build_vocabulary(desc[:3], k=4, device="cpu")


def test_word_and_node_ids_are_exact(trained):
    jv, tv, desc, labels = trained
    words = t_voc.word_ids(tv, tp.words(desc)).numpy()
    np.testing.assert_array_equal(words, np.asarray(j_voc.word_ids(jv, jnp.asarray(desc))))
    assert words.dtype == np.int32 and words.min() >= 0 and words.max() < tv.num_words
    purity = [np.bincount(words[labels == c]).max() / (labels == c).sum()
              for c in range(16)]
    assert np.mean(purity) > 0.7
    # node_ids counts levels DOWN FROM THE ROOT, as the JAX package does:
    # level L is the word id's prefix; clamped at the depth
    for L in (1, 2, 99):
        nodes = t_voc.node_ids(tv, tp.words(desc), L).numpy()
        np.testing.assert_array_equal(
            nodes, np.asarray(j_voc.node_ids(jv, jnp.asarray(desc), L)))
        np.testing.assert_array_equal(nodes, words // tv.k ** (tv.levels - min(L, 3)))


def test_bow_vectors_and_scores(trained):
    jv, tv, desc, labels = trained
    for c, valid in ((0, None), (2, np.arange(40) % 3 != 0)):
        d = desc[labels == c]
        jvalid = None if valid is None else jnp.asarray(valid)
        want = np.asarray(j_voc.bow_vector(jv, jnp.asarray(d), jvalid))
        got = t_voc.bow_vector(tv, d, valid).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert abs(got.sum() - 1.0) < 1e-5
    v0 = t_voc.bow_vector(tv, desc[labels == 0])
    v0b = t_voc.bow_vector(tv, desc[labels == 0][::-1].copy())
    v1 = t_voc.bow_vector(tv, desc[labels == 1])
    s_same = float(t_voc.score_l1(v0, v0b[None])[0])
    s_diff = float(t_voc.score_l1(v0, v1[None])[0])
    assert s_same > 0.99 and s_same > s_diff + 0.2
    stack = torch.stack([v0b, v1])
    np.testing.assert_allclose(
        t_voc.score_l1(v0, stack).numpy(),
        np.asarray(j_voc.score_l1(jnp.asarray(v0.numpy()), jnp.asarray(stack.numpy()))),
        atol=1e-6)
    # a masked pool equals the pool of its valid half alone
    both = np.concatenate([desc[labels == 2][:20], desc[labels == 3][:20]])
    mask = np.array([True] * 20 + [False] * 20)
    np.testing.assert_allclose(t_voc.bow_vector(tv, both, mask).numpy(),
                               t_voc.bow_vector(tv, both[:20]).numpy(), atol=1e-6)


def test_database_add_many_equals_repeated_add(trained):
    jv, tv, desc, labels = trained
    rng = np.random.default_rng(1)
    pools = np.stack([desc[labels == c] for c in range(6)])          # [6, 40, 8]
    valids = rng.random((6, 40)) > 0.2
    one, many, jdb = (t_voc.BowDatabase(tv, capacity=2),
                      t_voc.BowDatabase(tv, capacity=2),
                      j_voc.BowDatabase(jv, capacity=2))
    for p, v in zip(pools, valids):
        one.add(p, v)
        jdb.add(p, v)
    assert many.add_many(pools[:4], valids[:4]) == 0
    # a padded batch: two real rows, two padding rows that the next add
    # overwrites
    padded = np.concatenate([pools[4:], np.zeros((2, 40, 8), np.uint32)])
    pad_valid = np.concatenate([valids[4:], np.zeros((2, 40), bool)])
    assert many.add_many(padded, pad_valid, count=2) == 4
    assert one.n == many.n == jdb.n == 6
    assert many.add_many(pools[:0]) == 6
    np.testing.assert_allclose(many.vectors[:6].numpy(), one.vectors[:6].numpy(), atol=0)
    np.testing.assert_allclose(one.vectors[:6].numpy(), np.asarray(jdb.vectors[:6]),
                               atol=1e-6)
    q = desc[labels == 2].copy()
    q[:, 1] ^= 0b101
    scores = one.query(q)
    np.testing.assert_allclose(scores, jdb.query(q), atol=1e-6)
    np.testing.assert_allclose(many.query(q), scores, atol=0)
    assert scores.shape == (6,) and int(np.argmax(scores)) == 2
    assert t_voc.BowDatabase(tv).query(q).shape == (0,)


def test_files_cross_between_the_packages(tmp_path, trained):
    jv, tv, desc, _ = trained
    t_voc.save_vocabulary(tmp_path / "from_torch.npz", tv)
    j_voc.save_vocabulary(tmp_path / "from_jax.npz", jv)
    _assert_same_tree(j_voc.load_vocabulary(tmp_path / "from_torch.npz"), tv)
    loaded = t_voc.load_vocabulary(tmp_path / "from_jax.npz", device="cpu")
    _assert_same_tree(jv, loaded)
    np.testing.assert_array_equal(t_voc.word_ids(loaded, desc[:64]).numpy(),
                                  t_voc.word_ids(tv, desc[:64]).numpy())
    # and through numpy dictionaries
    d = convert.vocabulary_to_numpy(tv)
    assert d["centroids"][0].dtype == np.uint32
    _assert_same_tree(jv, convert.vocabulary_from_numpy(d, device="cpu"))
