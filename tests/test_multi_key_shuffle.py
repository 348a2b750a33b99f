"""Distributed composite-key join on the 8-device virtual mesh.

Exactness oracles: host tuple-set counting and single-device
multi_key_count agreement; the overflow-retry path is forced with a
skewed hot tuple plus a tiny starting slack.
"""

import numpy as np
import pytest

from partitionedhashjoin_tpu.ops import multi_key
from partitionedhashjoin_tpu.parallel.mesh import make_mesh
from partitionedhashjoin_tpu.parallel.multi_key_shuffle import (
    MultiKeyShuffleJoiner,
)


def _oracle(build_cols, probe_cols):
    build = set(zip(*[np.asarray(c).tolist() for c in build_cols]))
    probe = zip(*[np.asarray(c).tolist() for c in probe_cols])
    return sum(1 for t in probe if t in build)


def _random_cols(rng, k, n, lo=-40, hi=40):
    return [rng.integers(lo, hi, size=n).astype(np.int32) for _ in range(k)]


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_count_matches_oracle_and_local(k):
    mesh = make_mesh(8)
    rng = np.random.default_rng(500 + k)
    a = _random_cols(rng, k, 4096)
    b = _random_cols(rng, k, 8192)
    got = MultiKeyShuffleJoiner(mesh, seed=11).run(a, b)
    assert got == _oracle(a, b)
    assert got == int(multi_key.multi_key_count(a, b))


def test_rows_not_divisible_by_shards():
    mesh = make_mesh(8)
    rng = np.random.default_rng(9)
    a = _random_cols(rng, 2, 1001)  # neither divides 8
    b = _random_cols(rng, 2, 2030)
    got = MultiKeyShuffleJoiner(mesh, seed=3).run(a, b)
    assert got == _oracle(a, b)


def test_skewed_hot_tuple_overflow_retry_stays_exact():
    # one tuple is ~60% of the probe side: its owner shard receives far
    # more than the average bucket, forcing drops at slack 1.01 and
    # exercising the doubled-slack retry loop
    mesh = make_mesh(8)
    rng = np.random.default_rng(13)
    a = [np.arange(512, dtype=np.int32), np.arange(512, dtype=np.int32) % 7]
    hot = np.full(3000, 17, np.int32)
    cold = rng.integers(0, 512, 2000).astype(np.int32)
    b1 = np.concatenate([hot, cold])
    b = [b1, b1 % 7]
    joiner = MultiKeyShuffleJoiner(mesh, seed=5, slack=1.01, max_retries=6)
    got = joiner.run(a, b)
    assert got == _oracle(a, b)


def test_single_shard_mesh():
    mesh = make_mesh(1)
    rng = np.random.default_rng(21)
    a = _random_cols(rng, 2, 256)
    b = _random_cols(rng, 2, 512)
    assert MultiKeyShuffleJoiner(mesh, seed=1).run(a, b) == _oracle(a, b)


def test_empty_and_validation():
    mesh = make_mesh(8)
    a1 = np.array([1, 2], np.int32)
    e = [np.array([], np.int32)] * 2
    assert MultiKeyShuffleJoiner(mesh).run(e, [a1, a1]) == 0
    assert MultiKeyShuffleJoiner(mesh).run([a1, a1], e) == 0
    with pytest.raises(ValueError):
        MultiKeyShuffleJoiner(mesh).run([a1], [a1, a1])


def test_boundary_values_travel_exactly():
    # INT32_MAX/MIN tuples must shuffle and count exactly: live rows keep
    # tag 0 whatever their values; only dead bucket slots get nonzero tags
    mesh = make_mesh(8)
    M, m = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    a = [np.array([M, M, m, 0] * 4, np.int32),
         np.array([M, 5, m, 0] * 4, np.int32)]
    b = [np.array([M, M, m, 1, M] * 3, np.int32),
         np.array([M, M, m, 1, 5] * 3, np.int32)]
    got = MultiKeyShuffleJoiner(mesh, seed=2).run(a, b)
    assert got == _oracle(a, b)


def test_run_i64_plane_recipe():
    import jax

    mesh = make_mesh(8)
    rng = np.random.default_rng(31)
    a64 = rng.integers(-(2**40), 2**40, 1000).astype(np.int64)
    b64 = np.concatenate(
        [a64[:300], rng.integers(-(2**40), 2**40, 700).astype(np.int64)]
    )
    with jax.enable_x64(True):
        got = MultiKeyShuffleJoiner(mesh, seed=4).run_i64(
            jax.numpy.asarray(a64), jax.numpy.asarray(b64)
        )
    want = sum(1 for x in b64.tolist() if x in set(a64.tolist()))
    assert got == want
