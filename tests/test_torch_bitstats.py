"""The port's per-bit descriptor statistics and probabilistic matching
against the JAX package on seeded descriptors, on the CPU."""

import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.mapping import bitstats as j_bs
from svi_mapper_tpu_torch.mapping import bitstats as t_bs
from svi_mapper_tpu_torch.ops.descriptors import pack_bits
from tests import torch_parity as tp


def _rand_desc(rng, n):
    bits = rng.integers(0, 2, size=(n, 256)).astype(bool)
    return tp.unwords(pack_bits(tp.tbool(bits))), bits


def _assert_stats_equal(js, ts):
    # sums of 0/1 values: exact in float32
    for f in ("bit_sum", "stable_sum", "count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    np.testing.assert_allclose(ts.prob.numpy(), np.asarray(js.prob), atol=1e-7)
    np.testing.assert_allclose(ts.permanence.numpy(), np.asarray(js.permanence), atol=1e-7)


def test_bit_stats_accumulate_like_jax(rng):
    n = 6
    d0, b0 = _rand_desc(rng, n)
    js, ts = j_bs.init_bit_stats(jnp.asarray(d0)), t_bs.init_bit_stats(tp.words(d0))
    _assert_stats_equal(js, ts)
    np.testing.assert_array_equal(ts.prob.numpy(), b0)
    prev = d0
    for _ in range(5):
        d, _ = _rand_desc(rng, n)
        mask = rng.integers(0, 2, size=n).astype(bool)
        js = j_bs.update_bit_stats(js, jnp.asarray(d), jnp.asarray(prev), jnp.asarray(mask))
        ts = t_bs.update_bit_stats(ts, tp.words(d), tp.words(prev), tp.tbool(mask))
        _assert_stats_equal(js, ts)
        prev = np.where(mask[:, None], d, prev)
    fresh, _ = _rand_desc(rng, n)
    rows = np.array([True, False, True, False, False, True])
    js = j_bs.reset_rows(js, jnp.asarray(fresh), jnp.asarray(rows))
    ts = t_bs.reset_rows(ts, tp.words(fresh), tp.tbool(rows))
    _assert_stats_equal(js, ts)
    assert (ts.count.numpy()[rows] == 1).all()


def test_permanence_counts_bit_stability(rng):
    d0, b0 = _rand_desc(rng, 1)
    ts = t_bs.init_bit_stats(tp.words(d0))
    ts = t_bs.update_bit_stats(ts, tp.words(d0), tp.words(d0), tp.tbool([True]))
    assert np.allclose(ts.permanence.numpy(), 1.0)
    dinv = tp.unwords(pack_bits(tp.tbool(~b0)))
    ts = t_bs.update_bit_stats(ts, tp.words(dinv), tp.words(d0), tp.tbool([True]))
    assert np.allclose(ts.permanence.numpy(), 0.5)


def test_expected_hamming_like_jax_and_exact_on_binary_pools(rng):
    q_packed, q_bits = _rand_desc(rng, 6)
    _, t_bits = _rand_desc(rng, 9)
    d = t_bs.expected_hamming(tp.words(q_packed), tp.t32(t_bits)).numpy()
    exact = (q_bits[:, None, :] != t_bits[None, :, :]).sum(-1)
    np.testing.assert_array_equal(d, exact)            # 0/1 means: integers
    p = rng.uniform(0, 1, size=(7, 256)).astype(np.float32)
    got = t_bs.expected_hamming(tp.words(q_packed), tp.t32(p)).numpy()
    want = np.asarray(j_bs.expected_hamming(jnp.asarray(q_packed), jnp.asarray(p)))
    # a 256-long float32 dot product in another order
    np.testing.assert_allclose(got, want, atol=1e-3)
    oracle = (q_bits[:, None, :] * (1 - p[None]) + (1 - q_bits[:, None, :]) * p[None]).sum(-1)
    np.testing.assert_allclose(got, oracle, atol=1e-2)


def test_match_probabilistic_like_jax(rng):
    _, t_bits = _rand_desc(rng, 8)
    pools = t_bits.astype(np.float32)
    # queries 0, 1 both equal train 3 (a tie: the stable sort gives it to the
    # first); query 2 = train 5 with 4 bits flipped; query 3 is far from all
    q_bits = np.stack([t_bits[3], t_bits[3], t_bits[5].copy(),
                       rng.integers(0, 2, 256).astype(bool)])
    q_bits[2, :4] = ~q_bits[2, :4]
    q = tp.unwords(pack_bits(tp.tbool(q_bits)))
    valid = np.ones(8, bool)
    valid[6] = False
    want = [np.asarray(a) for a in j_bs.match_probabilistic(
        jnp.asarray(q), jnp.asarray(pools), jnp.asarray(valid), cutoff=25.0)]
    got = [a.numpy() for a in t_bs.match_probabilistic(
        tp.words(q), tp.t32(pools), tp.tbool(valid), cutoff=25.0)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    np.testing.assert_array_equal(got[2], want[2])
    idx, dist, ok = got
    assert ok.tolist() == [True, False, True, False]
    assert idx[2] == 5 and abs(dist[2] - 4) < 0.1
    assert t_bs.MAX_DISTANCE_HAMMING_PROBABILITY == j_bs.MAX_DISTANCE_HAMMING_PROBABILITY


def test_match_probabilistic_random_pools_like_jax(rng):
    """Many queries against noisy mean-bit pools, default cutoff: the same
    one-to-one award in both packages."""
    _, t_bits = _rand_desc(rng, 40)
    pools = np.clip(t_bits + rng.normal(0, 0.1, t_bits.shape), 0, 1).astype(np.float32)
    src = rng.integers(0, 40, 64)
    q_bits = t_bits[src] ^ (rng.random((64, 256)) < 0.05)
    q = tp.unwords(pack_bits(tp.tbool(q_bits)))
    valid = rng.random(40) > 0.1
    want = [np.asarray(a) for a in j_bs.match_probabilistic(
        jnp.asarray(q), jnp.asarray(pools), jnp.asarray(valid))]
    got = [a.numpy() for a in t_bs.match_probabilistic(
        tp.words(q), tp.t32(pools), tp.tbool(valid))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].sum() > 10 and len(set(got[0][got[2]])) == got[2].sum()
