"""Multi-device shuffle-join tests on the 8-device virtual CPU mesh.

The reference has no distributed backend (SURVEY.md §2); these validate the
mesh scale-out design: hash-sharded all_to_all exchange, per-shard
local joins, psum counts, heavy-hitter replication for Zipf skew, and the
overflow-retry exactness guarantee.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.data.table import make_table
from partitionedhashjoin_tpu.ops.generators import sequential_table, zipf_table
from partitionedhashjoin_tpu.parallel.mesh import (
    make_mesh,
    pad_to_multiple,
    shard_array,
    shard_table,
)
from partitionedhashjoin_tpu.parallel.shuffle import (
    DistributedShuffleJoiner,
    plan_hot_keys,
)
from partitionedhashjoin_tpu.utils.results import HashJoinTimer, Parameters


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_mesh_and_sharding(mesh8):
    t = shard_table(sequential_table(800), mesh8)
    assert t.size == 800
    np.testing.assert_array_equal(np.asarray(t.keys), np.arange(1, 801))


def test_shard_table_rejects_indivisible(mesh8):
    with pytest.raises(ValueError):
        shard_table(sequential_table(801), mesh8)


def test_pad_to_multiple():
    arr, n = pad_to_multiple(jnp.arange(10, dtype=jnp.int32), 8, -1)
    assert arr.shape[0] == 16 and n == 10
    assert np.asarray(arr)[-1] == -1


def test_uniform_join_matches_oracle(mesh8):
    rng = np.random.default_rng(1)
    n_a, n_b = 4096, 16384
    a_keys = rng.choice(np.arange(1, 10000, dtype=np.int32), n_a, replace=False)
    b_keys = rng.integers(1, 10000, n_b).astype(np.int32)
    a = shard_table(make_table(a_keys, np.arange(n_a, dtype=np.int32)), mesh8)
    b = shard_table(make_table(b_keys, np.arange(n_b, dtype=np.int32)), mesh8)
    count = DistributedShuffleJoiner(mesh8, seed=3).run(a, b)
    assert count == int(np.isin(b_keys, a_keys).sum())


def test_matches_single_chip_joiner(mesh8):
    from partitionedhashjoin_tpu.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )

    rng = np.random.default_rng(2)
    a_keys = rng.integers(0, 5000, 2048).astype(np.int32)  # with duplicates
    b_keys = rng.integers(0, 5000, 8192).astype(np.int32)
    a = make_table(a_keys, np.arange(2048, dtype=np.int32))
    b = make_table(b_keys, np.arange(8192, dtype=np.int32))
    c_single = NoPartitioningHashJoiner(seed=1).run(a, b)
    c_dist = DistributedShuffleJoiner(mesh8, seed=4).run(
        shard_table(a, mesh8), shard_table(b, mesh8)
    )
    assert c_single == c_dist


@pytest.mark.parametrize("alpha", [1.05, 1.25])
def test_zipf_skew_exact_count_with_hot_keys(mesh8, alpha):
    n = 4096
    a = shard_table(sequential_table(n), mesh8)
    b = zipf_table(32768, alpha=alpha, key_range=(1, n), seed=11)
    count = DistributedShuffleJoiner(mesh8, seed=5).run(
        a, shard_table(b, mesh8)
    )
    assert count == 32768


def test_zipf_skew_exact_without_hot_handling_via_retry(mesh8):
    # with skew handling off, the hot shard's buckets overflow at default
    # slack; the driver must retry with doubled slack and still be exact.
    n = 4096
    a = shard_table(sequential_table(n), mesh8)
    b = zipf_table(32768, alpha=1.25, key_range=(1, n), seed=13)
    joiner = DistributedShuffleJoiner(mesh8, seed=6, handle_skew=False)
    assert joiner.run(a, shard_table(b, mesh8)) == 32768


def test_plan_hot_keys_finds_the_zipf_head(mesh8):
    b = zipf_table(32768, alpha=1.25, key_range=(1, 4096), seed=17)
    hot_keys, hot_valid = plan_hot_keys(
        b.keys, sample_size=8192, capacity=16, min_frac=0.01, seed=1
    )
    hot = set(np.asarray(hot_keys)[np.asarray(hot_valid)].tolist())
    # key 1 holds ~21% of a Zipf(1.25) relation; it must be detected
    assert 1 in hot
    # and everything flagged hot must actually be frequent
    keys = np.asarray(b.keys)
    for k in hot:
        assert (keys == k).sum() > 32768 * 0.005


def test_plan_hot_keys_positionally_adversarial_input(mesh8):
    # A stride-from-0 sample is blind to this layout: the hot key fills
    # half of EVERY stride window but never sits at a multiple of the
    # stride.  sample_size=256 over n=65536 -> stride=256; key 7 occupies
    # positions [i*256+1, i*256+129) for every window i (50% of all rows).
    n = 65536
    stride = 256
    keys = np.arange(n, dtype=np.int32) % 50_000 + 1000
    off = np.arange(n) % stride
    keys[(off >= 1) & (off < 129)] = 7
    assert keys[::stride].tolist().count(7) == 0  # the old sampler's view
    hot_keys, hot_valid = plan_hot_keys(
        jnp.asarray(keys), sample_size=256, capacity=16,
        min_frac=0.05, seed=3,
    )
    hot = set(np.asarray(hot_keys)[np.asarray(hot_valid)].tolist())
    assert 7 in hot


def test_timer_phases_recorded_hash_local_join(mesh8):
    a = shard_table(sequential_table(2048), mesh8)
    b = shard_table(
        zipf_table(8192, alpha=1.05, key_range=(1, 2048), seed=19), mesh8
    )
    timer = HashJoinTimer(Parameters())
    DistributedShuffleJoiner(mesh8, seed=7, local_join="hash").run(a, b, timer)
    r = timer.get_result()
    assert r.get_partitioning_phase_duration() > 0
    assert r.get_build_phase_duration() > 0
    assert r.get_probe_phase_duration() > 0


def test_local_join_strategies_agree(mesh8):
    rng = np.random.default_rng(23)
    a_keys = rng.integers(0, 6000, 2048).astype(np.int32)
    b_keys = rng.integers(0, 6000, 8192).astype(np.int32)
    a = shard_table(make_table(a_keys, np.arange(2048, dtype=np.int32)), mesh8)
    b = shard_table(make_table(b_keys, np.arange(8192, dtype=np.int32)), mesh8)
    c_sm = DistributedShuffleJoiner(mesh8, seed=9, local_join="sort-merge").run(a, b)
    c_h = DistributedShuffleJoiner(mesh8, seed=9, local_join="hash").run(a, b)
    assert c_sm == c_h == int(np.isin(b_keys, a_keys).sum())


def test_small_mesh_sizes():
    for s in (1, 2, 4):
        mesh = make_mesh(s)
        rng = np.random.default_rng(s)
        a_keys = rng.integers(0, 3000, 1024).astype(np.int32)
        b_keys = rng.integers(0, 3000, 4096).astype(np.int32)
        a = make_table(a_keys, np.arange(1024, dtype=np.int32))
        b = make_table(b_keys, np.arange(4096, dtype=np.int32))
        count = DistributedShuffleJoiner(mesh, seed=8).run(
            shard_table(a, mesh), shard_table(b, mesh)
        )
        assert count == int(np.isin(b_keys, a_keys).sum())


@pytest.mark.parametrize("chunks", [2, 4])
def test_pipelined_exchange_matches_unpipelined(mesh8, chunks):
    # chunked all_to_all overlapped with per-chunk local joins must count
    # identically to the one-shot exchange
    rng = np.random.default_rng(chunks)
    a_keys = rng.integers(0, 9000, 4096).astype(np.int32)
    b_keys = rng.integers(0, 9000, 16384).astype(np.int32)
    a = shard_table(make_table(a_keys, np.arange(4096, dtype=np.int32)), mesh8)
    b = shard_table(make_table(b_keys, np.arange(16384, dtype=np.int32)), mesh8)
    c_pipe = DistributedShuffleJoiner(
        mesh8, seed=3, pipeline_chunks=chunks
    ).run(a, b)
    c_flat = DistributedShuffleJoiner(mesh8, seed=3).run(a, b)
    assert c_pipe == c_flat == int(np.isin(b_keys, a_keys).sum())


def test_pipelined_with_zipf_skew(mesh8):
    a = shard_table(sequential_table(4096), mesh8)
    b = shard_table(
        zipf_table(32768, alpha=1.25, key_range=(1, 4096), seed=7), mesh8
    )
    count = DistributedShuffleJoiner(mesh8, seed=5, pipeline_chunks=4).run(a, b)
    assert count == 32768


def test_hot_capacity_overflow_grows_hot_cap(mesh8):
    # >hot_capacity duplicate build rows of one hot key: doubling slack can
    # never fix the hot-replication overflow; the retry must grow hot_cap
    rng = np.random.default_rng(55)
    n_a, n_b = 2048, 8192
    a_keys = rng.integers(100, 5000, n_a).astype(np.int32)
    a_keys[:512] = 7  # 512 duplicate build rows of the hot key
    b_keys = rng.integers(100, 5000, n_b).astype(np.int32)
    b_keys[:4096] = 7  # hot probe side ensures key 7 is planned hot
    a = shard_table(make_table(a_keys, np.arange(n_a, dtype=np.int32)), mesh8)
    b = shard_table(make_table(b_keys, np.arange(n_b, dtype=np.int32)), mesh8)
    joiner = DistributedShuffleJoiner(mesh8, seed=3, hot_capacity=16)
    count = joiner.run(a, b)
    assert count == int(np.isin(b_keys, a_keys).sum())


def test_tiny_relations_hot_planning(mesh8):
    # fewer sampled keys than hot_capacity must not crash top_k
    rng = np.random.default_rng(77)
    a_keys = rng.integers(0, 100, 32).astype(np.int32)
    b_keys = rng.integers(0, 100, 32).astype(np.int32)
    a = shard_table(make_table(a_keys, np.arange(32, dtype=np.int32)), mesh8)
    b = shard_table(make_table(b_keys, np.arange(32, dtype=np.int32)), mesh8)
    count = DistributedShuffleJoiner(mesh8, seed=1, hot_capacity=64).run(a, b)
    assert count == int(np.isin(b_keys, a_keys).sum())


def test_single_shard_fast_path_matches_general():
    """S=1 shuffle elision: a 1-shard exchange is the identity, so the
    fast path must return the same count as the full exchange machinery."""
    mesh1 = make_mesh(1)
    rng = np.random.default_rng(17)
    a = make_table(
        rng.integers(0, 4000, 2048).astype(np.int32),
        np.arange(2048, dtype=np.int32),
    )
    b = make_table(
        rng.integers(0, 4000, 8192).astype(np.int32),
        np.arange(8192, dtype=np.int32),
    )
    want = int(
        np.isin(np.asarray(b.keys), np.asarray(a.keys)).sum()
    )
    fast = DistributedShuffleJoiner(mesh1, seed=1)
    assert fast.run(a, b) == want
    slow = DistributedShuffleJoiner(mesh1, seed=1, single_shard_fast_path=False)
    timer = HashJoinTimer(Parameters())
    assert slow.run(a, b, timer) == want
    # the general path actually exchanged: the partition phase ran (the fast
    # path never starts it, leaving the duration at exactly 0.0)
    assert timer.get_result().get_partitioning_phase_duration() > 0


def _masked_oracle(a_keys, b_keys, va, vb):
    # engine count semantics: matched (valid) probe rows — the build side
    # is the key set (duplicates deduped, reference primary-key semantics)
    ak = np.unique(np.asarray(a_keys)[np.asarray(va)])
    return int((np.asarray(vb) & np.isin(np.asarray(b_keys), ak)).sum())


def test_validity_masks_push_into_exchange(mesh8):
    """Pushed-down filters (query.py R2/R6): invalid rows are dropped at
    the bucketizer — the masked distributed count equals the pair oracle
    over valid rows only, with duplicate build keys in play."""
    rng = np.random.default_rng(19)
    a_keys = rng.integers(0, 800, 2048).astype(np.int32)  # duplicates
    b_keys = rng.integers(0, 1000, 8192).astype(np.int32)
    a = make_table(a_keys, np.arange(2048, dtype=np.int32))
    b = make_table(b_keys, np.arange(8192, dtype=np.int32))
    va = (np.asarray(a.payloads) % 3 != 0)
    vb = (np.asarray(b.payloads) % 2 == 0)
    want = _masked_oracle(a_keys, b_keys, va, vb)
    got = DistributedShuffleJoiner(mesh8, seed=23).run(
        shard_table(a, mesh8),
        shard_table(b, mesh8),
        valid_a=shard_array(jnp.asarray(va), mesh8),
        valid_b=shard_array(jnp.asarray(vb), mesh8),
    )
    assert got == want
    # one-sided masks too (None on the other side)
    got_a = DistributedShuffleJoiner(mesh8, seed=29).run(
        shard_table(a, mesh8), shard_table(b, mesh8),
        valid_a=shard_array(jnp.asarray(va), mesh8),
    )
    assert got_a == _masked_oracle(
        a_keys, b_keys, va, np.ones(len(b_keys), bool)
    )


def test_validity_masks_with_zipf_hot_keys(mesh8):
    """A filtered hot key: masked rows must neither replicate (build) nor
    count locally (probe), even when the skew plan marks the key hot."""
    n = 2048
    a = sequential_table(n)
    b = zipf_table(16384, alpha=1.25, key_range=(1, n), seed=31)
    # filter out ~half the probe rows of every key, incl. the Zipf head
    vb = (np.arange(16384) % 2 == 0)
    want = int(vb.sum())  # a is a 1..n primary key: every valid b row matches
    got = DistributedShuffleJoiner(mesh8, seed=37).run(
        shard_table(a, mesh8),
        shard_table(b, mesh8),
        valid_b=shard_array(jnp.asarray(vb), mesh8),
    )
    assert got == want


def test_validity_masks_single_shard_fast_path():
    mesh1 = make_mesh(1)
    rng = np.random.default_rng(41)
    a = make_table(
        rng.integers(0, 500, 1024).astype(np.int32),
        np.arange(1024, dtype=np.int32),
    )
    b = make_table(
        rng.integers(0, 600, 4096).astype(np.int32),
        np.arange(4096, dtype=np.int32),
    )
    va = (np.asarray(a.payloads) % 5 != 0)
    vb = (np.asarray(b.payloads) % 3 != 0)
    want = _masked_oracle(a.keys, b.keys, va, vb)
    fast = DistributedShuffleJoiner(mesh1, seed=2)
    got = fast.run(a, b, valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb))
    assert got == want
    slow = DistributedShuffleJoiner(mesh1, seed=2, single_shard_fast_path=False)
    assert slow.run(
        a, b, valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb)
    ) == want


class TestDistributedMaterialize:
    """Mesh materializing join (parallel/materialize_shuffle.py): per-shard
    union joins are exact under the exchange's cold/hot routing."""

    def _check(self, mesh, a, b, jt, seed=71, **knobs):
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )
        from partitionedhashjoin_tpu.parallel.materialize_shuffle import (
            DistributedMaterializeJoiner,
        )

        ref = sort_merge_materialize_typed(
            a.keys, a.payloads, b.keys, b.payloads, jt
        )
        got = DistributedMaterializeJoiner(mesh, seed=seed, **knobs).run(
            shard_table(a, mesh), shard_table(b, mesh), jt
        )
        n = int(ref[4])
        assert int(got.count) == n

        def rows(k, p, m, c):
            return sorted(
                zip(
                    np.asarray(k)[:c].tolist(),
                    np.asarray(p)[:c].tolist(),
                    np.asarray(m)[:c].tolist(),
                )
            )

        assert rows(got.keys, got.payloads_b, got.matched, n) == rows(
            ref[0], ref[2], ref[3], n
        )
        return got

    def test_zipf_hot_keys_inner(self, mesh8):
        # Zipf head goes hot: replicated build rows + local probe rows
        # must materialize each hot probe row exactly once
        n = 2048
        a = sequential_table(n)
        b = zipf_table(16384, alpha=1.25, key_range=(1, n), seed=73)
        got = self._check(mesh8, a, b, "inner")
        assert int(got.count) == 16384  # primary-key build: all rows match

    @pytest.mark.parametrize("jt", ["anti", "left"])
    def test_zipf_hot_keys_outer_variants(self, mesh8, jt):
        # keys beyond the build range exercise unmatched hot/cold rows
        n = 1024
        a = sequential_table(n)
        b = zipf_table(8192, alpha=1.25, key_range=(1, 2 * n), seed=79)
        self._check(mesh8, a, b, jt)

    def test_hot_overflow_grows_and_retries(self, mesh8):
        # hot_capacity=1 forces a hot replication overflow on the skewed
        # head; the retry must grow hot_cap and stay exact
        n = 512
        a = sequential_table(n)
        b = zipf_table(4096, alpha=1.25, key_range=(1, n), seed=83)
        got = self._check(
            mesh8, a, b, "inner", hot_capacity=1, hot_min_frac=0.0
        )
        assert int(got.count) == 4096

    def test_duplicate_build_payload_consistency(self, mesh8):
        # unique build keys: payload_a must match the single-device
        # materializer exactly (no impl-defined first-match ambiguity)
        from partitionedhashjoin_tpu.ops.sort_merge import (
            sort_merge_materialize_typed,
        )
        from partitionedhashjoin_tpu.parallel.materialize_shuffle import (
            DistributedMaterializeJoiner,
        )

        rng = np.random.default_rng(89)
        ak = rng.choice(np.arange(2000, dtype=np.int32), 512, replace=False)
        a = make_table(ak, rng.integers(0, 100, 512).astype(np.int32))
        b = make_table(
            rng.integers(0, 2500, 4096).astype(np.int32),
            np.arange(4096, dtype=np.int32),
        )
        ref = sort_merge_materialize_typed(
            a.keys, a.payloads, b.keys, b.payloads, "inner"
        )
        got = DistributedMaterializeJoiner(mesh8, seed=97).run(
            shard_table(a, mesh8), shard_table(b, mesh8), "inner"
        )
        n = int(ref[4])
        assert int(got.count) == n
        want = sorted(
            zip(
                np.asarray(ref[0])[:n].tolist(),
                np.asarray(ref[1])[:n].tolist(),
                np.asarray(ref[2])[:n].tolist(),
            )
        )
        have = sorted(
            zip(
                np.asarray(got.keys)[:n].tolist(),
                np.asarray(got.payloads_a)[:n].tolist(),
                np.asarray(got.payloads_b)[:n].tolist(),
            )
        )
        assert want == have

    def test_rejects_full_and_wrong_dtypes(self, mesh8):
        from partitionedhashjoin_tpu.parallel.materialize_shuffle import (
            DistributedMaterializeJoiner,
        )

        a = shard_table(sequential_table(64), mesh8)
        op = DistributedMaterializeJoiner(mesh8, seed=1)
        with pytest.raises(ValueError):
            op.run(a, a, "full")
