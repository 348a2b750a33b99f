"""Sorted-run probe (merge_join.sorted_runs_count) + two-run join wrapper.

These tests pin the probe's exactness properties: full int32 domain
(INT32_MAX is load-bearing: it is also the validity sentinel),
duplicate-heavy runs, long ranges, validity masks, and agreement with the
hash and sort-merge paths.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.ops import merge_join
from partitionedhashjoin_tpu.ops.merge_join import (
    sorted_runs_count,
    two_run_count,
)

# block and tile sizes of the former tiled probe, kept as adversarial shapes
BLOCK = 65536
CAP = 2048

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _count(a, b, **kw):
    a = np.sort(np.asarray(a, np.int32))
    b = np.sort(np.asarray(b, np.int32))
    return int(sorted_runs_count(jnp.asarray(a), jnp.asarray(b), **kw))


def test_sorted_position_lowest_match():
    # sorted_position reports the LOWEST position of a duplicated key and
    # clamps misses past the end in bounds
    a = jnp.asarray([-3, 0, 0, 0, 5, I32_MAX], jnp.int32)
    q = jnp.asarray([0, 5, I32_MAX, 7, -9, 4], jnp.int32)
    hit, idx = merge_join.sorted_position(a, q)
    np.testing.assert_array_equal(
        np.asarray(hit), [True, True, True, False, False, False]
    )
    np.testing.assert_array_equal(np.asarray(idx)[:3], [1, 4, 5])
    assert (np.asarray(idx) < 6).all()


@pytest.mark.parametrize("dom", [50, 8000, 2**31 - 1])
def test_random_counts_match_numpy(dom):
    rng = np.random.default_rng(dom)
    a = rng.integers(-dom, dom, 4000).astype(np.int32)
    b = rng.integers(-dom, dom, 70000).astype(np.int32)
    assert _count(a, b) == int(np.isin(b, a).sum())


def test_multi_tile_ranges():
    # a large build run against a probe wider than one former block
    rng = np.random.default_rng(5)
    a = rng.integers(0, 3_000_000, 1_000_000).astype(np.int32)
    b = rng.integers(0, 3_000_000, BLOCK + 17).astype(np.int32)
    assert _count(a, b) == int(np.isin(b, a).sum())


def test_full_domain_edges():
    a = [I32_MAX, I32_MAX, 5, I32_MIN, -7]
    b = [I32_MAX, 5, 6, I32_MAX, -7, I32_MIN, I32_MIN]
    assert _count(a, b) == 6
    assert _count([5, -7], [I32_MAX, 5]) == 1  # INT32_MAX absent: no match
    assert _count([I32_MAX], [I32_MAX] * 3) == 3


def test_empty_inputs():
    assert _count([], [1, 2]) == 0
    assert _count([1, 2], []) == 0


def test_two_run_count_agrees_with_sort_merge():
    from partitionedhashjoin_tpu.ops.sort_merge import sort_merge_count

    rng = np.random.default_rng(11)
    a = rng.integers(-(2**31), 2**31 - 1, 3000, dtype=np.int64).astype(np.int32)
    b = rng.integers(-(2**31), 2**31 - 1, 66000, dtype=np.int64).astype(np.int32)
    b[:30000] = rng.choice(a, 30000)
    got = int(two_run_count(jnp.asarray(a), jnp.asarray(b)))
    want = int(sort_merge_count(jnp.asarray(a), jnp.asarray(b)))
    assert got == want == int(np.isin(b, a).sum())


def test_two_run_count_validity_masks_with_int32_max():
    a = np.asarray([I32_MAX, 5, 9, I32_MAX, 77], np.int32)
    av = np.asarray([True, True, False, False, True])
    b = np.tile(np.asarray([I32_MAX, 9, 5, 77, I32_MAX, 3], np.int32), 11000)
    bv = np.tile(np.asarray([True, True, False, True, False, True]), 11000)
    # valid build keys {I32_MAX, 5, 77}; per repeated group the counted rows
    # are I32_MAX (valid+present) and 77 -> 2 of 6
    got = int(
        two_run_count(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(av), jnp.asarray(bv),
        )
    )
    assert got == 22000


def test_radix_vmem_mode_joiner():
    from partitionedhashjoin_tpu.config import RadixClusteringConfiguration
    from partitionedhashjoin_tpu.data.table import make_table
    from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

    # "auto", "vmem" and "chained" all answer exactly
    rng = np.random.default_rng(2)
    a_keys = rng.integers(0, 5000, 2500).astype(np.int32)
    b_keys = rng.integers(0, 5000, 9000).astype(np.int32)
    a = make_table(a_keys, np.arange(2500, dtype=np.int32))
    b = make_table(b_keys, np.arange(9000, dtype=np.int32))
    want = int(np.isin(b_keys, a_keys).sum())
    chained = RadixHashJoiner(
        RadixClusteringConfiguration(number_of_partitions=8, mode="chained"),
        seed=3,
    )
    assert chained.run(a, b) == want
    vmem = RadixHashJoiner(
        RadixClusteringConfiguration(number_of_partitions=8, mode="vmem"),
        seed=3,
    )
    assert vmem.run(a, b) == want
    auto = RadixHashJoiner(
        RadixClusteringConfiguration(number_of_partitions=8), seed=3
    )
    assert auto.run(a, b) == want


def test_int64_kernel_interpret():
    import jax
    from partitionedhashjoin_tpu.ops.merge_join import two_run_count_i64
    from partitionedhashjoin_tpu.ops.multi_key import split_i64

    with jax.enable_x64(True):
        # split_i64 preserves order lexicographically
        vals = jnp.asarray(
            [np.iinfo(np.int64).min, -(2**40), -1, 0, 1, 2**33, 2**40 + 5,
             np.iinfo(np.int64).max],
            jnp.int64,
        )
        h, l = split_i64(vals)
        pairs = list(zip(np.asarray(h).tolist(), np.asarray(l).tolist()))
        assert pairs == sorted(pairs)

        rng = np.random.default_rng(17)
        a = rng.integers(-(2**62), 2**62, 3000).astype(np.int64)
        b = rng.integers(-(2**62), 2**62, 66000).astype(np.int64)
        b[:20000] = rng.choice(a, 20000)
        got = int(two_run_count_i64(jnp.asarray(a), jnp.asarray(b)))
        assert got == int(np.isin(b, a).sum())

        # edges: INT64_MAX present and absent
        M = np.iinfo(np.int64).max
        a2 = np.asarray([M, 5, -(2**50)], np.int64)
        b2 = np.asarray([M, M, 5, 7, -(2**50)], np.int64)
        assert int(two_run_count_i64(jnp.asarray(a2), jnp.asarray(b2))) == 4
        a3 = np.asarray([5], np.int64)
        b3 = np.asarray([M, 5], np.int64)
        assert int(two_run_count_i64(jnp.asarray(a3), jnp.asarray(b3))) == 1


def test_duplicate_run_spanning_tiles_work_list_capacity():
    """A duplicate run spanning several former tiles, probed by several
    former blocks of the hot key: every probe row counts exactly once."""
    # build: one key duplicated across 4 full tiles, then a second key
    a = np.concatenate(
        [np.full(4 * CAP, 10, np.int32), np.full(100, 20, np.int32)]
    )
    # probe: 5 blocks of the hot key (each block's range spans all 4+ dup
    # tiles under the old enumeration), then a block of key 20
    b = np.concatenate(
        [np.full(5 * BLOCK, 10, np.int32), np.full(BLOCK, 20, np.int32)]
    )
    assert _count(a, b) == b.size  # every probe row matches


def test_many_hot_runs_heavy_duplication():
    # dozens of multi-tile runs + unique tail; agreement with numpy
    rng = np.random.default_rng(11)
    hot = np.repeat(
        rng.choice(10_000, 24, replace=False).astype(np.int32),
        rng.integers(CAP, 3 * CAP, 24),
    )
    a = np.concatenate([hot, rng.integers(0, 10_000, 5_000).astype(np.int32)])
    b = rng.integers(-100, 10_100, 2 * BLOCK + 333).astype(np.int32)
    assert _count(a, b) == int(np.isin(b, a).sum())


def test_single_giant_run():
    # the entire build side is ONE key spanning many tiles
    a = np.full(10 * CAP + 7, 42, np.int32)
    b = np.asarray([41, 42, 43] * 1000, np.int32)
    assert _count(a, b) == 1000


def test_two_run_count_validity_masks_random():
    """Random validity masks on both sides with genuine INT32_MAX keys: the
    sentinel rewriting and the closed-form correction stay exact."""
    rng = np.random.default_rng(23)
    a = rng.integers(-50, 50, 9000, dtype=np.int64).astype(np.int32)
    b = rng.integers(-80, 80, 40000, dtype=np.int64).astype(np.int32)
    av = rng.random(9000) < 0.9
    bv = rng.random(40000) < 0.8
    a[::701] = I32_MAX
    b[::997] = I32_MAX
    got = int(
        two_run_count(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(av), jnp.asarray(bv),
        )
    )
    valid_build = set(a[av].tolist())
    oracle = int(sum(1 for k, v in zip(b.tolist(), bv.tolist())
                     if v and k in valid_build))
    assert got == oracle


def test_int64_full_domain_edges():
    """int64 two-run count across the domain edges, INT64_MIN/MAX in both
    relations."""
    import jax
    from partitionedhashjoin_tpu.ops.merge_join import two_run_count_i64

    with jax.enable_x64(True):
        rng = np.random.default_rng(41)
        a = rng.integers(-(2**62), 2**62, 5000).astype(np.int64)
        b = rng.integers(-(2**62), 2**62, 30000).astype(np.int64)
        b[:9000] = rng.choice(a, 9000)
        M = np.iinfo(np.int64).max
        m = np.iinfo(np.int64).min
        a[::97] = M
        b[::89] = M
        a[5] = m
        b[::101] = m
        got = int(two_run_count_i64(jnp.asarray(a), jnp.asarray(b)))
        assert got == int(np.isin(b, a).sum())


def test_search_method_is_valid_for_searchsorted():
    """The module's search method is one jnp.searchsorted accepts, and it
    answers like numpy."""
    a = np.sort(np.random.default_rng(3).integers(0, 100, 500)).astype(
        np.int32
    )
    q = np.arange(-5, 105, dtype=np.int32)
    got = jnp.searchsorted(
        jnp.asarray(a), jnp.asarray(q), method=merge_join.SEARCH_METHOD
    )
    np.testing.assert_array_equal(np.asarray(got), np.searchsorted(a, q))
