"""Two-run materialize path (merge_join.sorted_position as the payload
probe + merge_join.two_run_materialize).

Oracle: brute-force numpy first-match join.  Contract under test:
- pos = 1 + LOWEST sorted-A position whose key matches (0 = miss)
- pay = that position's payload
- two_run_materialize output is key-sorted, compacted, zero tail
- the all-match fast path and the compaction path agree with the oracle
"""

import numpy as np
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.ops.merge_join import (
    sorted_position,
    two_run_materialize,
)


def ranged_merge_payload_prepared(a_sorted, a_payloads, b_sorted):
    """(pay, pos) per probe row: pos = 1 + the lowest matching sorted-A
    position (0 = miss), pay = that row's payload (0 on a miss)."""
    hit, idx = sorted_position(a_sorted, b_sorted)
    pay = jnp.where(hit, a_payloads[idx], 0)
    return pay, jnp.where(hit, idx + 1, 0)


def _oracle(a_keys, a_pay, b_keys):
    """(pay, pos) per sorted-b row against sorted-a, first match."""
    order = np.argsort(a_keys, kind="stable")
    a_keys = a_keys[order]
    a_pay = a_pay[order]
    bs = np.sort(b_keys)
    idx = np.searchsorted(a_keys, bs, side="left")
    idx_c = np.clip(idx, 0, len(a_keys) - 1)
    hit = (idx < len(a_keys)) & (a_keys[idx_c] == bs)
    pos = np.where(hit, idx + 1, 0).astype(np.int32)
    pay = np.where(hit, a_pay[idx_c], 0).astype(np.int32)
    return pay, pos, bs


class TestPayloadProbe:
    @pytest.mark.parametrize("n_a,n_b,key_range", [
        (100, 257, 300), (5000, 20000, 2000), (2048, 8192, 2**31 - 1),
    ])
    def test_matches_oracle(self, n_a, n_b, key_range):
        rng = np.random.default_rng(n_a + n_b)
        a_keys = rng.integers(-key_range, key_range, n_a).astype(np.int32)
        a_pay = rng.integers(1, 2**31, n_a).astype(np.int32)
        b_keys = rng.integers(-key_range, key_range, n_b).astype(np.int32)
        want_pay, want_pos, _ = _oracle(a_keys, a_pay, b_keys)
        a_s = np.sort(a_keys)
        srt = np.argsort(a_keys, kind="stable")
        pay, pos = ranged_merge_payload_prepared(
            jnp.asarray(a_s), jnp.asarray(a_pay[srt]),
            jnp.asarray(np.sort(b_keys)),
        )
        np.testing.assert_array_equal(np.asarray(pos), want_pos)
        np.testing.assert_array_equal(np.asarray(pay), want_pay)

    def test_duplicate_build_keys_first_position_wins(self):
        # key 7 appears at sorted positions 1,2,3 — pos must report 1+1=2
        a_keys = np.array([3, 7, 7, 7, 9], np.int32)
        a_pay = np.array([30, 71, 72, 73, 90], np.int32)
        b_keys = np.array([7, 7, 9, 4], np.int32)
        pay, pos = ranged_merge_payload_prepared(
            jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(np.sort(b_keys)),
        )
        # sorted b = [4, 7, 7, 9]
        np.testing.assert_array_equal(np.asarray(pos), [0, 2, 2, 5])
        np.testing.assert_array_equal(np.asarray(pay), [0, 71, 71, 90])

    def test_duplicates_straddling_tile_boundary(self):
        # a run of one key spanning several 2048-key tiles: every probe of
        # that key must land on the run START tile's first position
        n_a = 3 * 2048 + 100
        a_keys = np.full(n_a, 5, np.int32)
        a_keys[:10] = np.arange(-20, -10, dtype=np.int32)
        a_keys = np.sort(a_keys)
        a_pay = np.arange(n_a, dtype=np.int32)
        b_keys = np.array([5] * 100 + [-15] * 3, np.int32)
        pay, pos = ranged_merge_payload_prepared(
            jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(np.sort(b_keys)),
        )
        first5 = int(np.searchsorted(a_keys, 5))
        bs = np.sort(b_keys)
        want_pos = np.where(
            bs == 5, first5 + 1, np.searchsorted(a_keys, bs) + 1
        )
        np.testing.assert_array_equal(np.asarray(pos), want_pos)
        np.testing.assert_array_equal(np.asarray(pay), np.asarray(pos) - 1)


class TestTwoRunMaterialize:
    def test_all_match_fast_path(self):
        rng = np.random.default_rng(5)
        n_a, n_b = 4096, 16384
        a_keys = np.arange(1, n_a + 1, dtype=np.int32)
        a_pay = rng.integers(0, 1000, n_a).astype(np.int32)
        b_keys = rng.integers(1, n_a + 1, n_b).astype(np.int32)
        b_pay = rng.integers(0, 1000, n_b).astype(np.int32)
        keys, pa, pb, count = two_run_materialize(
            jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(b_keys), jnp.asarray(b_pay),
        )
        assert int(count) == n_b
        bs_order = np.argsort(b_keys, kind="stable")
        np.testing.assert_array_equal(np.asarray(keys), b_keys[bs_order])
        # unique build keys: pay_a is determined by the key
        np.testing.assert_array_equal(
            np.asarray(pa), a_pay[b_keys[bs_order] - 1]
        )
        # pay_b multiset per key must match (order within ties is unstable)
        got_pb = np.asarray(pb)
        for k in np.unique(b_keys)[:20]:
            sel = b_keys[bs_order] == k
            assert sorted(got_pb[sel]) == sorted(b_pay[b_keys == k])

    def test_partial_match_compaction_and_zero_tail(self):
        rng = np.random.default_rng(6)
        n_a, n_b = 1000, 9000
        a_keys = (np.arange(n_a, dtype=np.int32) * 2)  # evens only
        a_pay = np.arange(n_a, dtype=np.int32) + 7
        b_keys = rng.integers(0, 2 * n_a, n_b).astype(np.int32)
        b_pay = np.arange(n_b, dtype=np.int32)
        keys, pa, pb, count = two_run_materialize(
            jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(b_keys), jnp.asarray(b_pay),
        )
        c = int(count)
        want = int((b_keys % 2 == 0).sum())
        assert c == want
        got_keys = np.asarray(keys)
        sel = b_keys % 2 == 0
        np.testing.assert_array_equal(got_keys[:c], np.sort(b_keys[sel]))
        np.testing.assert_array_equal(
            np.asarray(pa)[:c], got_keys[:c] // 2 + 7
        )
        # zero tail on all columns
        assert not got_keys[c:].any()
        assert not np.asarray(pa)[c:].any()
        assert not np.asarray(pb)[c:].any()

    def test_int64_refused(self):
        import jax

        with jax.enable_x64(True):
            k = jnp.asarray(np.array([1, 2], np.int64))
            p = jnp.asarray(np.array([1, 2], np.int32))
            with pytest.raises(TypeError):
                two_run_materialize(k, p, k, p)

    def test_empty_inputs(self):
        z = jnp.zeros((0,), jnp.int32)
        some = jnp.asarray(np.arange(5, dtype=np.int32))
        keys, pa, pb, count = two_run_materialize(z, z, some, some,
                                                  )
        assert int(count) == 0 and keys.shape[0] == 5
        keys, pa, pb, count = two_run_materialize(some, some, z, z,
                                                  )
        assert int(count) == 0 and keys.shape[0] == 0


def test_two_run_materialize_probe_payload_sorted_agrees():
    """probe_payload_sorted=True (payload as the second sort key): same
    count, same key column, same per-key payload multisets, and pay_b
    ascending within each key run."""
    rng = np.random.default_rng(7)
    n_a, n_b = 3000, 20000
    a_keys = rng.integers(0, 4000, n_a).astype(np.int32)
    a_pay = rng.integers(0, 10**6, n_a).astype(np.int32)
    b_keys = rng.integers(0, 5000, n_b).astype(np.int32)
    b_pay = rng.integers(0, 10**6, n_b).astype(np.int32)
    args = (jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(b_keys), jnp.asarray(b_pay))
    keys0, pa0, pb0, c0 = two_run_materialize(*args)
    keys1, pa1, pb1, c1 = two_run_materialize(
        *args, probe_payload_sorted=True
    )
    assert int(c0) == int(c1)
    np.testing.assert_array_equal(np.asarray(keys0), np.asarray(keys1))
    np.testing.assert_array_equal(np.asarray(pa0), np.asarray(pa1))
    c = int(c0)
    k1 = np.asarray(keys1)[:c]
    p1 = np.asarray(pb1)[:c]
    same_key = k1[1:] == k1[:-1]
    assert (p1[1:][same_key] >= p1[:-1][same_key]).all()
    assert sorted(np.asarray(pb0)[:c].tolist()) == sorted(p1.tolist())


def test_payload_kernel_multiple_probe_blocks():
    """A probe of more than 64K sorted rows with duplicates throughout."""
    rng = np.random.default_rng(8)
    n_a, n_b = 3000, 65536 + 1777
    a_keys = np.sort(rng.integers(0, 2500, n_a).astype(np.int32))
    a_pay = (np.arange(n_a) + 11).astype(np.int32)
    b_keys = np.sort(rng.integers(0, 3000, n_b).astype(np.int32))
    pay, pos = ranged_merge_payload_prepared(
        jnp.asarray(a_keys), jnp.asarray(a_pay), jnp.asarray(b_keys),
    )
    pos = np.asarray(pos)
    pay = np.asarray(pay)
    first_idx = np.searchsorted(a_keys, b_keys, side="left")
    hit = (first_idx < n_a) & (a_keys[np.minimum(first_idx, n_a - 1)] == b_keys)
    np.testing.assert_array_equal(pos > 0, hit)
    np.testing.assert_array_equal(
        pos[hit], first_idx[hit] + 1
    )
    np.testing.assert_array_equal(pay[hit], a_pay[first_idx[hit]])
