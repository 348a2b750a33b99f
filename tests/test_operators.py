"""Extended operator suite tests: filter, hash aggregate, sorts.

These operators have no reference counterpart (they are the db_exec_kernel
extension, BASELINE.json north star / configs[3]); oracles are numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.data.table import make_table
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.ops.aggregate import hash_aggregate
from partitionedhashjoin_tpu.ops.filter import compact, filter_table
from partitionedhashjoin_tpu.ops.generators import zipf_table
from partitionedhashjoin_tpu.ops.sort import (
    radix_sort,
    radix_sort_table,
    sort_table,
)


class TestFilter:
    def test_compact_is_stable_and_exact(self):
        rng = np.random.default_rng(0)
        mask = rng.random(2000) < 0.3
        vals = rng.integers(-1000, 1000, 2000).astype(np.int32)
        count, out = compact(jnp.asarray(mask), jnp.asarray(vals))
        c = int(count)
        assert c == mask.sum()
        np.testing.assert_array_equal(np.asarray(out)[:c], vals[mask])

    def test_compact_sort_is_stable_partition(self):
        from partitionedhashjoin_tpu.ops.filter import compact_sort

        rng = np.random.default_rng(7)
        mask = rng.random(2000) < 0.3
        vals = rng.integers(-1000, 1000, 2000).astype(np.int32)
        pays = rng.integers(0, 9, 2000).astype(np.int32)
        count, out, out_p = compact_sort(
            jnp.asarray(mask), jnp.asarray(vals), jnp.asarray(pays)
        )
        c = int(count)
        assert c == mask.sum()
        np.testing.assert_array_equal(np.asarray(out)[:c], vals[mask])
        np.testing.assert_array_equal(np.asarray(out_p)[:c], pays[mask])
        # stable partition: the tail is the REJECTED rows, original order
        np.testing.assert_array_equal(np.asarray(out)[c:], vals[~mask])

    def test_filter_table_predicate(self):
        rng = np.random.default_rng(1)
        keys = rng.integers(0, 100, 5000).astype(np.int32)
        pay = rng.integers(-50, 50, 5000).astype(np.int32)
        t = make_table(keys, pay)
        ft, count = filter_table(t, lambda k, p: (k % 2 == 0) & (p > 0))
        sel = (keys % 2 == 0) & (pay > 0)
        c = int(count)
        assert c == sel.sum()
        np.testing.assert_array_equal(np.asarray(ft.keys)[:c], keys[sel])
        np.testing.assert_array_equal(np.asarray(ft.payloads)[:c], pay[sel])

    def test_filter_table_zero_tail(self):
        t = make_table(
            np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32) + 1
        )
        ft, count = filter_table(t, lambda k, p: k % 2 == 0, zero_tail=True)
        assert int(count) == 4
        # zero-padded tail: full-column reductions see only selected rows
        assert int(np.asarray(ft.payloads).sum()) == 1 + 3 + 5 + 7
        assert not np.asarray(ft.keys)[4:].any()

    def test_all_and_none_selected(self):
        t = make_table(
            np.arange(100, dtype=np.int32), np.arange(100, dtype=np.int32)
        )
        _, count_all = filter_table(t, lambda k, p: k >= 0)
        _, count_none = filter_table(t, lambda k, p: k < 0)
        assert int(count_all) == 100 and int(count_none) == 0


class TestHashAggregate:
    def _check(self, keys, pay, seed=5):
        g = hash_aggregate(make_table(keys, pay), seed=seed)
        num = int(g.num_groups)
        assert num == len(np.unique(keys))
        gk = np.asarray(g.keys)[:num]
        assert sorted(gk.tolist()) == np.unique(keys).tolist()
        for i, k in enumerate(gk):
            sel = keys == k
            assert int(g.count[i]) == sel.sum()
            assert int(g.sum[i]) == pay[sel].sum()
            assert int(g.min[i]) == pay[sel].min()
            assert int(g.max[i]) == pay[sel].max()
        gid = np.asarray(g.group_of_row)
        np.testing.assert_array_equal(gk[gid], keys)

    def test_random_groups(self):
        rng = np.random.default_rng(2)
        keys = rng.integers(0, 37, 4000).astype(np.int32)
        pay = rng.integers(-100, 100, 4000).astype(np.int32)
        self._check(keys, pay)

    def test_all_unique_and_all_same(self):
        n = 500
        self._check(np.arange(n, dtype=np.int32), np.ones(n, np.int32))
        self._check(np.full(n, 7, np.int32), np.arange(n, dtype=np.int32))

    def test_zipf_skew_does_not_explode_chains(self):
        # the dedup claim loop must be O(distinct chain), not O(duplication):
        # heavily skewed input with a hot key covering ~25% of rows.
        b = zipf_table(20_000, alpha=1.25, key_range=(1, 500), seed=4)
        keys = np.asarray(b.keys)
        pay = np.asarray(b.payloads)
        self._check(keys, pay)

    def test_dedup_table_rep_rows_share_key(self):
        rng = np.random.default_rng(3)
        keys = rng.integers(0, 20, 1000).astype(np.int32)
        _, rep = ht.build_dedup_hash_table(
            jnp.asarray(keys), jnp.uint32(9), ht.table_size_for(1000)
        )
        rep = np.asarray(rep)
        # same key -> same representative; rep's key == own key
        np.testing.assert_array_equal(keys[rep], keys)
        for k in np.unique(keys):
            assert len(np.unique(rep[keys == k])) == 1


class TestSort:
    def test_sort_table_matches_numpy(self):
        rng = np.random.default_rng(4)
        keys = rng.integers(-(2**31), 2**31 - 1, 3000, dtype=np.int32)
        t = sort_table(make_table(keys, np.arange(3000, dtype=np.int32)))
        np.testing.assert_array_equal(np.asarray(t.keys), np.sort(keys))

    @pytest.mark.parametrize("bits", [4, 8, 16])
    def test_radix_sort_signed_full_range(self, bits):
        rng = np.random.default_rng(bits)
        keys = rng.integers(-(2**31), 2**31 - 1, 2048, dtype=np.int32)
        out_keys, perm = radix_sort(
            jnp.asarray(keys),
            jnp.arange(2048, dtype=jnp.int32),
            bits_per_pass=bits,
        )
        np.testing.assert_array_equal(np.asarray(out_keys), np.sort(keys))
        # payload permutation consistent with key order
        np.testing.assert_array_equal(keys[np.asarray(perm)], np.asarray(out_keys))

    def test_radix_sort_stability(self):
        # duplicate keys keep original relative payload order
        keys = np.array([3, 1, 3, 1, 3, 2], np.int32)
        out_keys, pay = radix_sort(
            jnp.asarray(keys), jnp.arange(6, dtype=jnp.int32)
        )
        np.testing.assert_array_equal(np.asarray(out_keys), [1, 1, 2, 3, 3, 3])
        np.testing.assert_array_equal(np.asarray(pay), [1, 3, 5, 0, 2, 4])

    def test_radix_sort_table_roundtrip(self):
        rng = np.random.default_rng(6)
        keys = rng.integers(-500, 500, 1000).astype(np.int32)
        t = radix_sort_table(make_table(keys, np.arange(1000, dtype=np.int32)))
        np.testing.assert_array_equal(np.asarray(t.keys), np.sort(keys))

    def test_radix_sort_rejects_bad_bits(self):
        with pytest.raises(ValueError):
            radix_sort(jnp.arange(4, dtype=jnp.int32), bits_per_pass=5)


class TestFilterAggregate:
    """Fused filter -> GROUP BY pipeline (BASELINE configs[3])."""

    def test_matches_numpy_pipeline(self):
        from partitionedhashjoin_tpu.ops.aggregate import filter_aggregate

        rng = np.random.default_rng(8)
        keys = rng.integers(0, 40, 3000).astype(np.int32)
        pay = rng.integers(-50, 50, 3000).astype(np.int32)
        t = make_table(keys, pay)
        g, count = filter_aggregate(t, lambda k, p: p > 0, seed=3)
        sel = pay > 0
        assert int(count) == sel.sum()
        num = int(g.num_groups)
        assert num == len(np.unique(keys[sel]))
        gk = np.asarray(g.keys)[:num]
        assert sorted(gk.tolist()) == np.unique(keys[sel]).tolist()
        for i, k in enumerate(gk):
            m = sel & (keys == k)
            assert int(g.count[i]) == m.sum()
            assert int(g.sum[i]) == pay[m].sum()
            assert int(g.min[i]) == pay[m].min()
            assert int(g.max[i]) == pay[m].max()
        gid = np.asarray(g.group_of_row)
        assert (gid[~sel] == -1).all()
        assert (gid[sel] >= 0).all()
        np.testing.assert_array_equal(gk[gid[sel]], keys[sel])

    def test_filter_key_collision_with_excluded_rows(self):
        # an excluded row whose key equals an included row's key must not
        # contaminate the group (regression for a pseudo-key remap design)
        from partitionedhashjoin_tpu.ops.aggregate import filter_aggregate

        keys = np.array([7, 7, 7], np.int32)
        pay = np.array([1, -1, 2], np.int32)
        t = make_table(keys, pay)
        g, count = filter_aggregate(t, lambda k, p: p > 0, seed=1)
        assert int(count) == 2 and int(g.num_groups) == 1
        assert int(g.count[0]) == 2 and int(g.sum[0]) == 3

    def test_all_rows_filtered_out(self):
        from partitionedhashjoin_tpu.ops.aggregate import filter_aggregate

        t = make_table(
            np.arange(100, dtype=np.int32), np.arange(100, dtype=np.int32)
        )
        g, count = filter_aggregate(t, lambda k, p: k < 0, seed=2)
        assert int(count) == 0 and int(g.num_groups) == 0
        assert (np.asarray(g.group_of_row) == -1).all()


class TestSortAggregate:
    """Sort-based GROUP BY (the at-scale path) vs numpy and the hash path."""

    def _oracle_check(self, g, keys, pay, sel=None):
        sel = np.ones(len(keys), bool) if sel is None else sel
        num = int(g.num_groups)
        uniq = np.unique(keys[sel])
        assert num == len(uniq)
        gk = np.asarray(g.keys)[:num]
        # sort path emits groups in ascending key order
        np.testing.assert_array_equal(gk, uniq)
        for i, k in enumerate(gk):
            m = sel & (keys == k)
            assert int(g.count[i]) == m.sum()
            assert int(g.sum[i]) == pay[m].sum()
            assert int(g.min[i]) == pay[m].min()
            assert int(g.max[i]) == pay[m].max()

    def test_matches_numpy(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        rng = np.random.default_rng(11)
        keys = rng.integers(0, 37, 4000).astype(np.int32)
        pay = rng.integers(-100, 100, 4000).astype(np.int32)
        g = sort_aggregate(make_table(keys, pay))
        self._oracle_check(g, keys, pay)

    def test_matches_hash_path_bit_exact_sums(self):
        # int32 sums must be bit-identical to scatter-add accumulation,
        # including wraparound-heavy groups (both are sums mod 2^32)
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        rng = np.random.default_rng(12)
        keys = rng.integers(0, 5, 3000).astype(np.int32)
        pay = rng.integers(2**30, 2**31 - 1, 3000).astype(np.int32)
        gs = sort_aggregate(make_table(keys, pay))
        gh = hash_aggregate(make_table(keys, pay), seed=3)
        ns, nh = int(gs.num_groups), int(gh.num_groups)
        assert ns == nh
        hk = np.asarray(gh.keys)[:nh]
        order = np.argsort(hk, kind="stable")
        np.testing.assert_array_equal(np.asarray(gs.keys)[:ns], hk[order])
        np.testing.assert_array_equal(
            np.asarray(gs.sum)[:ns], np.asarray(gh.sum)[:nh][order]
        )

    def test_kernel_compaction_agrees_with_sort_path(self):
        # the scatter pass-2 compaction must produce identical
        # GroupByResults to the 2-key value-carrying sort, across
        # densities incl. nearly-all-distinct and heavy-duplicate
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
            sort_aggregate,
        )

        rng = np.random.default_rng(15)
        for n, hi in ((8192, 37), (8192, 3), (9000, 8000)):
            keys = rng.integers(0, hi, n).astype(np.int32)
            pay = rng.integers(-100, 100, n).astype(np.int32)
            t = make_table(keys, pay)
            gs = sort_aggregate(t, compaction="sort")
            gk = sort_aggregate(t, compaction="scatter")
            num = int(gs.num_groups)
            assert num == int(gk.num_groups)
            for field in ("keys", "count", "sum", "min", "max"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(gs, field))[:num],
                    np.asarray(getattr(gk, field))[:num],
                    err_msg=f"{field} n={n} hi={hi}",
                )
        # filtered variant with a capacity bound (one shape, one compile)
        n, hi = 8192, 200
        keys = rng.integers(0, hi, n).astype(np.int32)
        pay = rng.integers(-100, 100, n).astype(np.int32)
        t = make_table(keys, pay)
        fs, cs = filter_sort_aggregate(
            t, lambda k, p: p > 0, group_capacity=hi + 10,
            compaction="sort",
        )
        fk, ck = filter_sort_aggregate(
            t, lambda k, p: p > 0, group_capacity=hi + 10,
            compaction="scatter",
        )
        assert int(cs) == int(ck)
        num = int(fs.num_groups)
        assert num == int(fk.num_groups)
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(getattr(fs, field))[:num],
                np.asarray(getattr(fk, field))[:num],
            )

    def test_group_capacity_truncates_but_num_groups_exact(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        keys = np.arange(100, dtype=np.int32)
        g = sort_aggregate(
            make_table(keys, keys), group_capacity=10
        )
        assert int(g.num_groups) == 100  # exact despite truncation
        assert g.keys.shape[0] == 10

    def test_group_of_row(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        rng = np.random.default_rng(13)
        keys = rng.integers(0, 9, 500).astype(np.int32)
        g = sort_aggregate(
            make_table(keys, keys), with_group_of_row=True
        )
        num = int(g.num_groups)
        gk = np.asarray(g.keys)[:num]
        gid = np.asarray(g.group_of_row)
        assert (gid >= 0).all()
        np.testing.assert_array_equal(gk[gid], keys)

    def test_filter_fused(self):
        from partitionedhashjoin_tpu.ops.aggregate import filter_sort_aggregate

        rng = np.random.default_rng(14)
        keys = rng.integers(0, 40, 3000).astype(np.int32)
        pay = rng.integers(-50, 50, 3000).astype(np.int32)
        g, count = filter_sort_aggregate(
            make_table(keys, pay), lambda k, p: p > 0,
            with_group_of_row=True,
        )
        sel = pay > 0
        assert int(count) == sel.sum()
        self._oracle_check(g, keys, pay, sel)
        gid = np.asarray(g.group_of_row)
        assert (gid[~sel] == -1).all()
        gk = np.asarray(g.keys)[: int(g.num_groups)]
        np.testing.assert_array_equal(gk[gid[sel]], keys[sel])

    def test_all_filtered_and_empty(self):
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
            sort_aggregate,
        )

        t = make_table(
            np.arange(64, dtype=np.int32), np.arange(64, dtype=np.int32)
        )
        g, count = filter_sort_aggregate(t, lambda k, p: k < 0)
        assert int(count) == 0 and int(g.num_groups) == 0
        t0 = make_table(
            np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
        )
        g0 = sort_aggregate(t0)
        assert int(g0.num_groups) == 0

    def test_zipf_heavy_groups(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        b = zipf_table(20_000, alpha=1.25, key_range=(1, 500), seed=4)
        keys = np.asarray(b.keys)
        pay = np.asarray(b.payloads)
        g = sort_aggregate(make_table(keys, pay))
        self._oracle_check(g, keys, pay)


def test_sort_aggregate_zero_capacity_reports_exact_num_groups():
    """Round-2 review: group_capacity=0 on a non-empty table must still
    report the exact group count so the capacity-retry contract holds."""
    import jax.numpy as jnp
    from partitionedhashjoin_tpu.data.table import Table
    from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

    t = Table(
        keys=jnp.asarray([5, 5, 9, 2, 2, 2], jnp.int32),
        payloads=jnp.asarray([1, 2, 3, 4, 5, 6], jnp.int32),
    )
    res = sort_aggregate(t, group_capacity=0)
    assert int(res.num_groups) == 3
    assert res.keys.shape[0] == 0


def test_sort_aggregate_sums_stay_int32_under_x64():
    """Regression (round-2 review): under x64 a bare reduction promotes
    int32 to int64, silently changing GroupByResult.sum's dtype and breaking
    the mod-2^32 parity with the hash path for the LAST group (whose sum
    closes against the total rather than the next group's prefix)."""
    import jax

    from partitionedhashjoin_tpu.ops.aggregate import (
        hash_aggregate,
        sort_aggregate,
    )

    rng = np.random.default_rng(13)
    keys = rng.integers(0, 4, 2000).astype(np.int32)
    pay = rng.integers(2**30, 2**31 - 1, 2000).astype(np.int32)
    with jax.enable_x64(True):
        gs = sort_aggregate(make_table(keys, pay))
        gh = hash_aggregate(make_table(keys, pay), seed=5)
        assert gs.sum.dtype == np.int32
        ns, nh = int(gs.num_groups), int(gh.num_groups)
        assert ns == nh
        hk = np.asarray(gh.keys)[:nh]
        order = np.argsort(hk, kind="stable")
        np.testing.assert_array_equal(
            np.asarray(gs.sum)[:ns], np.asarray(gh.sum)[:nh][order]
        )
        # host oracle: wrapped int32 sums per key
        for i, k in enumerate(np.asarray(gs.keys)[:ns]):
            want = np.int32(pay[keys == k].astype(np.int64).sum() & 0xFFFFFFFF)
            assert np.asarray(gs.sum)[i] == want


class TestSortAggregatePallasSorter:
    def test_pass1_pallas_sorter_agrees(self):
        """GROUP BY pass 1 over the filtered relation: both pass-2
        compactions give identical GroupByResults (group order is
        key-ascending either way), and agree with numpy."""
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
        )

        rng = np.random.default_rng(16)
        n = 3000
        keys = rng.integers(-50, 50, n).astype(np.int32)
        pay = rng.integers(-100, 100, n).astype(np.int32)
        t = make_table(keys, pay)
        fp, cp = filter_sort_aggregate(
            t, lambda k, p: p > 0, compaction="scatter"
        )
        fs, cs = filter_sort_aggregate(
            t, lambda k, p: p > 0, compaction="sort"
        )
        assert int(cs) == int(cp) == int((pay > 0).sum())
        num = int(fs.num_groups)
        assert num == int(fp.num_groups) == len(np.unique(keys[pay > 0]))
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(getattr(fs, field))[:num],
                np.asarray(getattr(fp, field))[:num],
            )


def test_forced_kernel_compaction_refuses_wide_columns():
    """Both pass-2 compactions stay exact with int64 payloads beyond 2^32
    (the carried cumsum must never be truncated), and an unknown
    compaction name is refused."""
    import jax
    import pytest as _pytest
    from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

    with jax.enable_x64(True):
        keys = jnp.asarray(np.arange(100) % 5, jnp.int32)
        pay = jnp.asarray(np.full(100, 2**33), jnp.int64)
        t = make_table(np.asarray(keys), np.zeros(100, np.int32))
        t = type(t)(keys=keys, payloads=pay)
        for compaction in ("scatter", "sort"):
            g = sort_aggregate(t, compaction=compaction)
            assert int(g.num_groups) == 5
            assert (np.asarray(g.sum)[:5] == 20 * 2**33).all()
        with _pytest.raises(ValueError, match="compaction"):
            sort_aggregate(t, compaction="kernel")


class TestStagedFilterAggregate:
    """filter_sort_aggregate_staged (round 4): the two-dispatch filter-first
    pipeline must agree exactly with the fused path — the compacted tail
    rides the validity machinery, never the aggregates."""

    def _compare(self, t, pred, cap):
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
            filter_sort_aggregate_staged,
        )

        gf, cf = filter_sort_aggregate(t, pred, group_capacity=cap)
        gs, cs = filter_sort_aggregate_staged(
            t, pred, group_capacity=cap
        )
        assert int(cf) == int(cs)
        num = int(gf.num_groups)
        assert num == int(gs.num_groups)
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(getattr(gf, field))[:num],
                np.asarray(getattr(gs, field))[:num],
                err_msg=field,
            )
        # staged drops row->group tracking but keeps the documented shape
        assert gs.group_of_row.shape[0] == t.size
        assert (np.asarray(gs.group_of_row) == -1).all()

    def test_agrees_with_fused_across_selectivities(self):
        rng = np.random.default_rng(21)
        # one size that no bucket divides evenly (9000)
        for n, hi, keep in (
            (8192, 37, 0.5),     # one block, mixed selectivity
            (9000, 4000, 0.1),   # uneven buckets, sparse
            (8192, 5, 0.95),     # heavy duplicates, nearly all kept
        ):
            keys = rng.integers(0, hi, n).astype(np.int32)
            pay = rng.integers(-100, 100, n).astype(np.int32)
            t = make_table(keys, pay)
            lo = int(np.quantile(pay, 1 - keep))
            self._compare(t, lambda k, p: p > lo, hi + 10)

    def test_all_kept_and_all_dropped(self):
        rng = np.random.default_rng(22)
        keys = rng.integers(0, 50, 8192).astype(np.int32)
        pay = rng.integers(-100, 100, 8192).astype(np.int32)
        t = make_table(keys, pay)
        self._compare(t, lambda k, p: p > -1000, 60)  # all kept
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate_staged,
        )

        g, count = filter_sort_aggregate_staged(
            t, lambda k, p: p > 1000, group_capacity=60
        )
        assert int(count) == 0 and int(g.num_groups) == 0

    def test_genuine_zero_key_rows_survive(self):
        # compaction zero-fills with key 0: genuine key-0 groups must be
        # exact regardless (validity comes from the count, not key values)
        keys = np.zeros(8192, np.int32)
        pay = np.arange(8192, dtype=np.int32) - 4096
        t = make_table(keys, pay)
        self._compare(t, lambda k, p: p % 3 == 0, 10)

    def test_rejects_wide_columns(self):
        import jax as _jax
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate_staged,
        )

        with _jax.enable_x64(True):
            keys = jnp.asarray(np.arange(100) % 5, jnp.int32)
            pay = jnp.asarray(np.full(100, 2**33), jnp.int64)
            t = make_table(np.zeros(100, np.int32), np.zeros(100, np.int32))
            t = type(t)(keys=keys, payloads=pay)
            with pytest.raises(TypeError, match="int32-only"):
                filter_sort_aggregate_staged(
                    t, lambda k, p: p > 0
                )

    def test_capacity_truncates_but_num_groups_exact(self):
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate_staged,
        )

        keys = np.arange(8192, dtype=np.int32)
        t = make_table(keys, keys)
        g, count = filter_sort_aggregate_staged(
            t, lambda k, p: p >= 0, group_capacity=10
        )
        assert int(count) == 8192
        assert int(g.num_groups) == 8192  # exact despite truncation
        assert g.keys.shape[0] == 10


class TestDistinctAndMean:
    """COUNT(DISTINCT payload) + AVG on the sort aggregate (round 4)."""

    def _oracle(self, g, keys, pay, sel=None):
        sel = np.ones(len(keys), bool) if sel is None else sel
        num = int(g.num_groups)
        gk = np.asarray(g.keys)[:num]
        np.testing.assert_array_equal(gk, np.unique(keys[sel]))
        dist = np.asarray(g.distinct)[:num]
        for i, k in enumerate(gk):
            m = sel & (keys == k)
            assert dist[i] == len(np.unique(pay[m])), (k, dist[i])

    def test_matches_numpy_both_compactions(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        rng = np.random.default_rng(31)
        keys = rng.integers(0, 21, 8192).astype(np.int32)
        pay = rng.integers(-7, 7, 8192).astype(np.int32)
        t = make_table(keys, pay)
        gs = sort_aggregate(t, compaction="sort", with_distinct=True)
        self._oracle(gs, keys, pay)
        gk = sort_aggregate(t, compaction="scatter", with_distinct=True)
        num = int(gs.num_groups)
        assert num == int(gk.num_groups)
        np.testing.assert_array_equal(
            np.asarray(gs.distinct)[:num], np.asarray(gk.distinct)[:num]
        )

    def test_with_filter_and_staged(self):
        from partitionedhashjoin_tpu.ops.aggregate import (
            filter_sort_aggregate,
            filter_sort_aggregate_staged,
        )

        rng = np.random.default_rng(32)
        keys = rng.integers(0, 15, 8192).astype(np.int32)
        pay = rng.integers(0, 9, 8192).astype(np.int32)
        t = make_table(keys, pay)
        pred = lambda k, p: (p & 1) == 1  # noqa: E731
        sel = (pay & 1) == 1
        gf, cf = filter_sort_aggregate(t, pred, with_distinct=True)
        self._oracle(gf, keys, pay, sel)
        gs, cs = filter_sort_aggregate_staged(
            t, pred, with_distinct=True
        )
        assert int(cf) == int(cs)
        num = int(gf.num_groups)
        assert num == int(gs.num_groups)
        np.testing.assert_array_equal(
            np.asarray(gf.distinct)[:num], np.asarray(gs.distinct)[:num]
        )

    def test_single_distinct_heavy_duplicates(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        keys = np.repeat(np.arange(4, dtype=np.int32), 100)
        pay = np.full(400, 5, np.int32)
        g = sort_aggregate(make_table(keys, pay), with_distinct=True)
        np.testing.assert_array_equal(np.asarray(g.distinct)[:4], [1] * 4)

    def test_default_has_no_distinct(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        g = sort_aggregate(
            make_table(np.arange(10, dtype=np.int32),
                       np.arange(10, dtype=np.int32))
        )
        assert g.distinct is None

    def test_mean(self):
        from partitionedhashjoin_tpu.ops.aggregate import sort_aggregate

        rng = np.random.default_rng(33)
        keys = rng.integers(0, 9, 1000).astype(np.int32)
        pay = rng.integers(-100, 100, 1000).astype(np.int32)
        g = sort_aggregate(make_table(keys, pay), group_capacity=20)
        num = int(g.num_groups)
        means = np.asarray(g.mean())[:num]
        gk = np.asarray(g.keys)[:num]
        for i, k in enumerate(gk):
            np.testing.assert_allclose(
                means[i], pay[keys == k].mean(), rtol=1e-6
            )
        # capacity tail (count == 0) must be 0, not NaN
        assert not np.isnan(np.asarray(g.mean())).any()


class TestOrderBy:
    """ORDER BY / LIMIT operators (round 4)."""

    def test_order_by_key_and_payload(self):
        from partitionedhashjoin_tpu.ops.order_by import order_by

        rng = np.random.default_rng(41)
        keys = rng.integers(-1000, 1000, 3000).astype(np.int32)
        pay = rng.integers(-1000, 1000, 3000).astype(np.int32)
        t = make_table(keys, pay)
        for by, desc in (("key", False), ("key", True),
                         ("payload", False), ("payload", True)):
            out = order_by(t, by=by, descending=desc)
            ok, op = np.asarray(out.keys), np.asarray(out.payloads)
            col = ok if by == "key" else op
            exp = np.sort(col)[::-1] if desc else np.sort(col)
            np.testing.assert_array_equal(col, exp)
            # row integrity: (key, payload) multiset unchanged
            got = sorted(zip(ok.tolist(), op.tolist()))
            want = sorted(zip(keys.tolist(), pay.tolist()))
            assert got == want

    def test_order_by_tiebreak_is_row_stable(self):
        from partitionedhashjoin_tpu.ops.order_by import order_by

        keys = np.array([5, 5, 5, 1, 1], np.int32)
        pay = np.arange(5, dtype=np.int32)
        out = order_by(make_table(keys, pay), by="key")
        np.testing.assert_array_equal(np.asarray(out.payloads), [3, 4, 0, 1, 2])

    def test_order_by_int_min_descending(self):
        # ~x (not -x) handles INT32_MIN: descending must place it last
        from partitionedhashjoin_tpu.ops.order_by import order_by

        keys = np.array([0, -2**31, 2**31 - 1, -1], np.int32)
        out = order_by(make_table(keys, keys.copy()), by="key",
                       descending=True)
        np.testing.assert_array_equal(
            np.asarray(out.keys), [2**31 - 1, 0, -1, -2**31]
        )

    def test_top_k(self):
        from partitionedhashjoin_tpu.ops.order_by import top_k

        rng = np.random.default_rng(42)
        keys = rng.permutation(5000).astype(np.int32) - 2500
        pay = keys * 3
        t = make_table(keys, pay)
        hi = top_k(t, 10, by="key", descending=True)
        np.testing.assert_array_equal(
            np.asarray(hi.keys), np.sort(keys)[::-1][:10]
        )
        np.testing.assert_array_equal(
            np.asarray(hi.payloads), np.asarray(hi.keys) * 3
        )
        lo = top_k(t, 7, by="payload", descending=False)
        np.testing.assert_array_equal(
            np.asarray(lo.payloads), np.sort(pay)[:7]
        )
        np.testing.assert_array_equal(
            np.asarray(lo.keys), np.asarray(lo.payloads) // 3
        )

    def test_top_k_validation(self):
        from partitionedhashjoin_tpu.ops.order_by import top_k

        t = make_table(np.arange(5, dtype=np.int32),
                       np.arange(5, dtype=np.int32))
        with pytest.raises(ValueError, match="exceeds"):
            top_k(t, 6)
        with pytest.raises(ValueError, match="positive"):
            top_k(t, 0)


class TestAggregateSorted:
    """Order-propagating GROUP BY (round 4): aggregate_sorted must equal
    sort_aggregate on key-sorted input without paying the pass-1 sort."""

    def _compare(self, keys_sorted, pay, cap=None, **kw):
        from partitionedhashjoin_tpu.ops.aggregate import (
            aggregate_sorted,
            sort_aggregate,
        )

        t = make_table(keys_sorted, pay)
        gs = sort_aggregate(t, group_capacity=cap, compaction="sort")
        ga = aggregate_sorted(t, group_capacity=cap, **kw)
        num = int(gs.num_groups)
        assert num == int(ga.num_groups)
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(getattr(gs, field))[:num],
                np.asarray(getattr(ga, field))[:num],
                err_msg=field,
            )

    def test_matches_sort_aggregate(self):
        rng = np.random.default_rng(51)
        keys = np.sort(rng.integers(0, 40, 4000)).astype(np.int32)
        pay = rng.integers(-100, 100, 4000).astype(np.int32)
        self._compare(keys, pay, compaction="sort")
        self._compare(keys, pay, cap=10, compaction="sort")  # truncation
        # single group / all-distinct extremes
        self._compare(np.zeros(100, np.int32),
                      rng.integers(-5, 5, 100).astype(np.int32),
                      compaction="sort")
        self._compare(np.arange(100, dtype=np.int32),
                      rng.integers(-5, 5, 100).astype(np.int32),
                      compaction="sort")

    def test_kernel_compaction_path(self):
        rng = np.random.default_rng(52)
        keys = np.sort(rng.integers(0, 37, 8192)).astype(np.int32)
        pay = rng.integers(-100, 100, 8192).astype(np.int32)
        self._compare(keys, pay, compaction="scatter")

    def test_n_valid_ignores_tail(self):
        from partitionedhashjoin_tpu.ops.aggregate import (
            aggregate_sorted,
            sort_aggregate,
        )

        rng = np.random.default_rng(53)
        head = np.sort(rng.integers(0, 9, 700)).astype(np.int32)
        pay = rng.integers(-50, 50, 1000).astype(np.int32)
        # tail is DESCENDING junk incl. duplicates of valid keys — must be
        # entirely invisible to every aggregate
        keys = np.concatenate([head, np.arange(300, 0, -1, dtype=np.int32)])
        ga = aggregate_sorted(
            make_table(keys, pay), n_valid=700, compaction="sort"
        )
        gs = sort_aggregate(
            make_table(head, pay[:700]), compaction="sort"
        )
        num = int(gs.num_groups)
        assert num == int(ga.num_groups)
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(getattr(gs, field))[:num],
                np.asarray(getattr(ga, field))[:num],
                err_msg=field,
            )

    def test_check_raises_on_unsorted(self):
        from partitionedhashjoin_tpu.ops.aggregate import aggregate_sorted

        keys = np.array([3, 1, 2], np.int32)
        with pytest.raises(ValueError, match="not ascending"):
            aggregate_sorted(
                make_table(keys, keys), check=True, compaction="sort"
            )
        # unsorted content past n_valid is fine
        aggregate_sorted(
            make_table(np.array([1, 2, 0], np.int32),
                       np.zeros(3, np.int32)),
            n_valid=2, check=True, compaction="sort",
        )

    def test_join_then_groupby_pipeline(self):
        # the composed query the operator exists for: materialized join
        # output (key-ordered, zero tail) -> aggregate_sorted, vs numpy
        from partitionedhashjoin_tpu.ops.aggregate import aggregate_sorted
        from partitionedhashjoin_tpu.ops.merge_join import (
            two_run_materialize,
        )

        rng = np.random.default_rng(54)
        a_keys = np.arange(1, 201, dtype=np.int32)
        a_pay = (a_keys * 7 + 3).astype(np.int32)
        b_keys = rng.integers(1, 251, 4000).astype(np.int32)  # some miss
        b_pay = rng.integers(-100, 100, 4000).astype(np.int32)
        keys, pa, pb, count = two_run_materialize(
            jnp.asarray(a_keys), jnp.asarray(a_pay),
            jnp.asarray(b_keys), jnp.asarray(b_pay),
        )
        c = int(count)
        g = aggregate_sorted(
            make_table(keys, pb), n_valid=count, check=True,
            compaction="sort",
        )
        sel = np.isin(b_keys, a_keys)
        num = int(g.num_groups)
        np.testing.assert_array_equal(
            np.asarray(g.keys)[:num], np.unique(b_keys[sel])
        )
        for i, k in enumerate(np.asarray(g.keys)[:num]):
            m = sel & (b_keys == k)
            assert int(g.count[i]) == m.sum()
            assert int(g.sum[i]) == b_pay[m].sum()
            assert int(g.min[i]) == b_pay[m].min()
            assert int(g.max[i]) == b_pay[m].max()
        assert c == sel.sum()

    def test_two_level_segmented_scan_oracle(self):
        # n > 8192 exercises the blocked formulation (the flat
        # associative_scan OOM-killed the remote compile at 200M)
        from partitionedhashjoin_tpu.ops.aggregate import _seg_suffix_scan

        rng = np.random.default_rng(55)
        for n in (20000, 16384, 8193, 300):
            vals = rng.integers(-1000, 1000, n).astype(np.int32)
            is_end = rng.random(n) < 0.01
            is_end[-1] = True
            got_min = np.asarray(
                _seg_suffix_scan(jnp.asarray(vals), jnp.asarray(is_end),
                                 jnp.minimum)
            )
            got_max = np.asarray(
                _seg_suffix_scan(jnp.asarray(vals), jnp.asarray(is_end),
                                 jnp.maximum)
            )
            # numpy oracle: suffix fold up to the next is_end inclusive
            exp_min = np.empty(n, np.int32)
            exp_max = np.empty(n, np.int32)
            cur_min = cur_max = None
            for i in range(n - 1, -1, -1):
                if is_end[i] or cur_min is None:
                    cur_min = cur_max = vals[i]
                else:
                    cur_min = min(cur_min, vals[i])
                    cur_max = max(cur_max, vals[i])
                exp_min[i] = cur_min
                exp_max[i] = cur_max
            np.testing.assert_array_equal(got_min, exp_min, err_msg=str(n))
            np.testing.assert_array_equal(got_max, exp_max, err_msg=str(n))

    def test_matches_sort_aggregate_multiblock(self):
        # > _SEG_L rows so MIN/MAX ride the two-level scan inside the
        # full aggregate program
        rng = np.random.default_rng(56)
        keys = np.sort(rng.integers(0, 500, 20000)).astype(np.int32)
        pay = rng.integers(-1000, 1000, 20000).astype(np.int32)
        self._compare(keys, pay, compaction="sort")

    def test_payload_sorted_path_and_distinct(self):
        # payload-ascending runs: min/max/distinct via run boundaries, no
        # segmented scans (the at-scale route — docs/PERFORMANCE.md r4)
        from partitionedhashjoin_tpu.ops.aggregate import (
            aggregate_sorted,
            sort_aggregate,
        )

        rng = np.random.default_rng(57)
        keys = np.sort(rng.integers(0, 40, 5000)).astype(np.int32)
        pay = rng.integers(-9, 9, 5000).astype(np.int32)
        order = np.lexsort((pay, keys))
        t = make_table(keys[order], pay[order])
        gs = sort_aggregate(
            make_table(keys, pay), compaction="sort", with_distinct=True
        )
        ga = aggregate_sorted(
            t, payload_sorted=True, with_distinct=True, check=True,
            compaction="sort",
        )
        num = int(gs.num_groups)
        assert num == int(ga.num_groups)
        for field in ("keys", "count", "sum", "min", "max", "distinct"):
            np.testing.assert_array_equal(
                np.asarray(getattr(gs, field))[:num],
                np.asarray(getattr(ga, field))[:num],
                err_msg=field,
            )
        # check=True must reject key-sorted-only input
        bad = make_table(
            np.array([1, 1, 2], np.int32), np.array([5, 3, 1], np.int32)
        )
        with pytest.raises(ValueError, match="not ascending"):
            aggregate_sorted(
                bad, payload_sorted=True, check=True, compaction="sort"
            )
        # distinct without payload order must refuse, not miscount
        with pytest.raises(ValueError, match="payload_sorted"):
            aggregate_sorted(t, with_distinct=True, compaction="sort")

    def test_materializer_payload_sorted_feeds_it(self):
        from partitionedhashjoin_tpu.ops.aggregate import aggregate_sorted
        from partitionedhashjoin_tpu.ops.merge_join import (
            two_run_materialize,
        )

        rng = np.random.default_rng(58)
        a_keys = np.arange(1, 101, dtype=np.int32)
        b_keys = rng.integers(1, 131, 3000).astype(np.int32)
        b_pay = rng.integers(-50, 50, 3000).astype(np.int32)
        keys, pa, pb, count = two_run_materialize(
            jnp.asarray(a_keys), jnp.asarray(a_keys * 2),
            jnp.asarray(b_keys), jnp.asarray(b_pay),
            probe_payload_sorted=True,
        )
        g = aggregate_sorted(
            make_table(keys, pb), n_valid=count, payload_sorted=True,
            check=True, with_distinct=True, compaction="sort",
        )
        sel = b_keys <= 100
        num = int(g.num_groups)
        np.testing.assert_array_equal(
            np.asarray(g.keys)[:num], np.unique(b_keys[sel])
        )
        for i, k in enumerate(np.asarray(g.keys)[:num]):
            m = sel & (b_keys == k)
            assert int(g.count[i]) == m.sum()
            assert int(g.min[i]) == b_pay[m].min()
            assert int(g.max[i]) == b_pay[m].max()
            assert int(g.distinct[i]) == len(np.unique(b_pay[m]))
