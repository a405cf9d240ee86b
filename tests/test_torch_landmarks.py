"""Port vs JAX package: the landmark table lifecycle.

Integer, bool and descriptor fields are compared exactly; float fields to
``1e-6`` (they are copies and exact sums of small integers, so they are in
fact equal; the tolerance only allows for -0.0 vs 0.0 style differences).
"""

import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.config import DEFAULT_PARAMS as JPARAMS
from svi_mapper_tpu.mapping import landmarks as jlm
from svi_mapper_tpu_torch.mapping import landmarks as lm

from torch_parity import (
    assert_tables_equal,
    t32,
    tbool,
    tint,
    torch_table,
    unwords,
    words,
)


def _candidates(rng, n):
    return dict(
        valid=rng.integers(0, 4, n) > 0,
        pos=rng.normal(size=(n, 3)).astype(np.float32) * 10,
        uv=rng.uniform(0, 500, (n, 2)).astype(np.float32),
        disp=rng.uniform(1, 90, n).astype(np.float32),
        dl=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
        dr=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
        uv4=rng.uniform(0, 500, (n, 4)).astype(np.float32),
    )


def _insert_both(jt, tt, c, T, uid):
    jt, juid = jlm.insert_landmarks(
        jt, jnp.asarray(c["valid"]), jnp.asarray(c["pos"]), jnp.asarray(c["uv"]),
        jnp.asarray(c["disp"]), jnp.asarray(c["dl"]), jnp.asarray(c["dr"]),
        jnp.asarray(c["uv4"]), jnp.asarray(T), jnp.int32(uid))
    tt, tuid = lm.insert_landmarks(
        tt, tbool(c["valid"]), t32(c["pos"]), t32(c["uv"]), t32(c["disp"]),
        words(c["dl"]), words(c["dr"]), t32(c["uv4"]), t32(T),
        tint(uid))
    assert int(juid) == int(tuid)
    return jt, tt, int(juid)


def _pose(rng):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(size=3)
    return T


def test_make_table_matches():
    jt = jlm.make_table(32, 6, history_slots=3)
    tt = lm.make_table(32, 6, history_slots=3, device="cpu")
    assert_tables_equal(jt, tt)
    assert tt.capacity == 32 and tt.max_measurements == 6
    assert_tables_equal(jt, torch_table(jt))      # convert round trip


def test_insert_into_free_slots_and_overflow(rng):
    L = 48
    jt = jlm.make_table(L, 4)
    tt = lm.make_table(L, 4, device="cpu")
    uid = 0
    c = _candidates(rng, 40)
    jt, tt, uid = _insert_both(jt, tt, c, _pose(rng), uid)
    assert_tables_equal(jt, tt)
    # free some rows in the middle, then overflow the remaining capacity
    kill = np.zeros(L, bool)
    kill[[3, 4, 17, 29]] = True
    jt = jt.replace(active=jt.active & ~jnp.asarray(kill))
    tt = tt.replace(active=tt.active & ~tbool(kill))
    c2 = _candidates(rng, 64)
    jt, tt, uid2 = _insert_both(jt, tt, c2, _pose(rng), uid)
    assert int(tt.num_active) == L
    assert uid2 - uid == L - int(np.sum(np.asarray(jt.uid) < uid))
    assert_tables_equal(jt, tt)


def test_insert_nothing_valid(rng):
    jt = jlm.make_table(16, 4)
    tt = lm.make_table(16, 4, device="cpu")
    c = _candidates(rng, 8)
    c["valid"][:] = False
    jt, tt, uid = _insert_both(jt, tt, c, _pose(rng), 5)
    assert uid == 5
    assert_tables_equal(jt, tt)


def test_add_measurements_ring_history_and_failures(rng):
    L, M = 40, 4
    jt = jlm.make_table(L, M, history_slots=2)
    tt = lm.make_table(L, M, history_slots=2, device="cpu")
    jt, tt, _ = _insert_both(jt, tt, _candidates(rng, 36), _pose(rng), 0)
    for step in range(11):          # wraps both rings, trips the 5-fail rule
        tracked = rng.integers(0, 3, L) > 0
        tracked[:6] = step % 7 == 0
        uv4 = rng.uniform(0, 500, (L, 4)).astype(np.float32)
        d = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
        T = _pose(rng)
        jt = jlm.add_measurements(jt, jnp.asarray(tracked), jnp.asarray(uv4),
                                  jnp.asarray(d), jnp.asarray(T), hist_every=2)
        tt = lm.add_measurements(tt, tbool(tracked), t32(uv4), words(d),
                                 t32(T), hist_every=2)
        assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(
            lm.measurement_mask(tt).numpy(), np.asarray(jlm.measurement_mask(jt)))
        jt = jlm.retire_landmarks(jt, JPARAMS)
        tt = lm.retire_landmarks(tt, JPARAMS)
        assert_tables_equal(jt, tt)
    assert int(tt.num_active) < 36          # some rows did retire
    np.testing.assert_array_equal(
        unwords(lm.anchor_descriptors(tt)), np.asarray(jlm.anchor_descriptors(jt)))
    np.testing.assert_array_equal(
        lm.bit_prob_u8(tt).numpy(), np.asarray(jlm.bit_prob_u8(jt)))


def test_retire_stale_unless_in_keyframe(rng):
    jt = jlm.make_table(8, 4)
    jt, _ = jlm.insert_landmarks(
        jt, jnp.ones(8, bool), jnp.zeros((8, 3)), jnp.zeros((8, 2)),
        jnp.ones(8), jnp.zeros((8, 8), jnp.uint32), jnp.zeros((8, 8), jnp.uint32),
        jnp.zeros((8, 4)), jnp.eye(4), jnp.int32(0))
    jt = jt.replace(age=jnp.asarray([0, 50, 101, 200, 101, 5, 150, 100], jnp.int32),
                    keyframe_presences=jnp.asarray([0, 0, 0, 1, 2, 0, 0, 0], jnp.int32),
                    failed=jnp.asarray([0, 6, 0, 0, 0, 5, 0, 0], jnp.int32))
    tt = torch_table(jt)
    jr = jlm.retire_landmarks(jt, JPARAMS)
    tr = lm.retire_landmarks(tt, JPARAMS)
    assert_tables_equal(jr, tr)
    np.testing.assert_array_equal(
        tr.active.numpy(), [True, False, False, True, True, True, False, True])
