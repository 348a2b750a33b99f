"""End-to-end no-partitioning join tests.

The reference validates full joins only manually via logged counts
(src/NoPartitioning/HashJoin.hpp:184); these tests make the oracle explicit
(SURVEY.md §4): brute-force numpy joins on random tables, plus the benchmark
invariant — sequential primary keys {1..n} ⋈ Zipf secondary over [1, n] means
*every* probe row matches, so count == |secondary| (src/main.cpp:35-79).
"""

import numpy as np
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import make_table
from partitionedhashjoin_tpu.ops.generators import sequential_table, zipf_table
from partitionedhashjoin_tpu.ops.no_partitioning import NoPartitioningHashJoiner
from partitionedhashjoin_tpu.utils.results import HashJoinTimer, Parameters


def _np_tables(rng, n_a=1500, n_b=6000, key_lo=1, key_hi=3000):
    a_keys = rng.choice(
        np.arange(key_lo, key_hi, dtype=np.int32), n_a, replace=False
    )
    b_keys = rng.integers(key_lo, key_hi, n_b).astype(np.int32)
    a = make_table(a_keys, np.arange(n_a, dtype=np.int32))
    b = make_table(b_keys, np.arange(n_b, dtype=np.int32))
    return a, b, a_keys, b_keys


def test_count_matches_numpy_oracle():
    rng = np.random.default_rng(42)
    a, b, a_keys, b_keys = _np_tables(rng)
    joiner = NoPartitioningHashJoiner(seed=1)
    assert joiner.run(a, b) == int(np.isin(b_keys, a_keys).sum())


def test_benchmark_invariant_all_probe_rows_match():
    # The reference's generated workload: primary = {1..n} sequential,
    # secondary = Zipf over [1, n] -> match count == |secondary| exactly.
    n = 2000
    a = sequential_table(n)
    b = zipf_table(10_000, alpha=1.05, key_range=(1, n), seed=9)
    joiner = NoPartitioningHashJoiner(seed=2)
    assert joiner.run(a, b) == 10_000


def test_materialized_join_payloads():
    rng = np.random.default_rng(3)
    a, b, a_keys, b_keys = _np_tables(rng, n_a=400, n_b=900, key_hi=800)
    joiner = NoPartitioningHashJoiner(seed=4)
    out = joiner.run_materialize(a, b)
    count = int(out.count)
    assert count == int(np.isin(b_keys, a_keys).sum())
    keys = np.asarray(out.keys)[:count]
    pay_a = np.asarray(out.payloads_a)[:count]
    pay_b = np.asarray(out.payloads_b)[:count]
    # keys come in probe order, compacted
    np.testing.assert_array_equal(keys, b_keys[np.isin(b_keys, a_keys)])
    # payload_a is the build row payload of the matching key (payload == row
    # index here, and primary keys are unique, so the mapping is exact)
    key_to_row = {int(k): i for i, k in enumerate(a_keys)}
    np.testing.assert_array_equal(
        pay_a, np.array([key_to_row[int(k)] for k in keys], np.int32)
    )
    np.testing.assert_array_equal(pay_b, np.where(np.isin(b_keys, a_keys))[0])


def test_empty_probe_side_matches_nothing():
    a = sequential_table(100)
    b = make_table(
        np.full(50, 10_000, np.int32), np.arange(50, dtype=np.int32)
    )
    assert NoPartitioningHashJoiner(seed=5).run(a, b) == 0


def test_timer_records_build_and_probe_phases():
    a = sequential_table(1000)
    b = zipf_table(2000, alpha=1.25, key_range=(1, 1000), seed=1)
    timer = HashJoinTimer(Parameters())
    NoPartitioningHashJoiner(seed=6).run(a, b, timer)
    result = timer.get_result()
    assert result.get_build_phase_duration() > 0
    assert result.get_probe_phase_duration() > 0
    assert result.get_partitioning_phase_duration() == 0


def test_duplicate_build_keys_first_match_semantics():
    # Get-based count semantics (HashJoin.hpp:144-157): each probe row counts
    # once even when the build side has duplicates.
    a = make_table(
        np.array([1, 1, 1, 2], np.int32), np.arange(4, dtype=np.int32)
    )
    b = make_table(
        np.array([1, 2, 3], np.int32), np.arange(3, dtype=np.int32)
    )
    assert NoPartitioningHashJoiner(seed=7).run(a, b) == 2


def test_vmem_mode_agrees_with_chained_and_oracle():
    from partitionedhashjoin_tpu.config import NoPartitioningConfiguration

    rng = np.random.default_rng(11)
    a, b, a_keys, b_keys = _np_tables(rng, n_a=800, n_b=4000, key_hi=1200)
    oracle = int(np.isin(b_keys, a_keys).sum())
    chained = NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="chained"), seed=8
    )
    vmem = NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="vmem"), seed=8
    )
    assert chained.run(a, b) == oracle
    assert vmem.run(a, b) == oracle


def test_vmem_mode_timer_and_duplicates():
    from partitionedhashjoin_tpu.config import NoPartitioningConfiguration

    # Get-based count semantics survive the sorted-run layout: duplicated
    # build keys count each matching probe row once.
    a = make_table(
        np.array([1, 1, 1, 2], np.int32), np.arange(4, dtype=np.int32)
    )
    b = make_table(
        np.array([1, 2, 3, 1], np.int32), np.arange(4, dtype=np.int32)
    )
    joiner = NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="vmem"), seed=9
    )
    timer = HashJoinTimer(Parameters())
    assert joiner.run(a, b, timer) == 3
    result = timer.get_result()
    assert result.get_build_phase_duration() >= 0
    assert result.get_probe_phase_duration() >= 0
    assert result.get_partitioning_phase_duration() == 0


def test_vmem_mode_auto_resolution_and_empty_sides():
    from partitionedhashjoin_tpu.config import NoPartitioningConfiguration

    # auto resolves to the module's measured choice on every backend
    from partitionedhashjoin_tpu.ops import no_partitioning

    joiner = NoPartitioningHashJoiner(seed=10)
    assert joiner._resolve_mode() == no_partitioning.AUTO_MODE
    empty = make_table(
        np.empty(0, np.int32), np.empty(0, np.int32)
    )
    some = sequential_table(64)
    assert joiner.run(empty, some) == 0
    assert joiner.run(some, empty) == 0
    assert joiner.run(empty, empty) == 0


def test_vmem_mode_chunked_probe_matches_oracle():
    """vmem_probe_chunk_rows bounds single-program size: a probe larger than the chunk target must split into
    fixed-size overlap-masked windows whose counts sum to the exact
    oracle — including prime-sized probes that divide nothing."""
    from partitionedhashjoin_tpu.config import NoPartitioningConfiguration

    rng = np.random.default_rng(11)
    n_b = 6007  # prime: forces the overlap-masked last window
    a, b, a_keys, b_keys = _np_tables(rng, n_a=900, n_b=n_b, key_hi=2500)
    oracle = int(np.isin(b_keys, a_keys).sum())
    chunked = NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="vmem", vmem_probe_chunk_rows=1000),
        seed=12,
    )
    timer = HashJoinTimer(Parameters())
    assert chunked.run(a, b, timer) == oracle
    assert timer.get_result().get_probe_phase_duration() >= 0
