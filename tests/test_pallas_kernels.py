"""The scan half of the concatenated sort-merge count
(ops/sort_merge.py::sort_merge_count: where → cummax → compare → sum), on
the cases that once pinned its fused streaming-pass form: long equal-key
runs, probe-only runs after a smaller build key, and INT32_MAX rows.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.ops.sort_merge import sort_merge_count

#: rows of one block of the former fused pass; runs longer than it cross
#: what used to be a carried boundary
BLOCK = 512 * 128


def _oracle_inputs(rng, n_a, n_b, lo=-500, hi=500):
    a = rng.integers(lo, hi, n_a).astype(np.int32)
    b = rng.integers(lo - 100, hi + 100, n_b).astype(np.int32)
    return a, b, int(np.isin(b, a).sum())


def _count(a, b):
    return int(sort_merge_count(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize(
    "n_a,n_b", [(100, 400), (5000, 20000), (1, 1), (0, 100)]
)
def test_merge_count_matches_oracle(n_a, n_b):
    rng = np.random.default_rng(n_a + n_b)
    a, b, expected = _oracle_inputs(rng, n_a, n_b)
    assert _count(a, b) == expected


def test_merge_count_multi_block_carry():
    # one build key, then a probe run of it longer than several blocks
    n = 3 * BLOCK + 17
    assert _count(np.zeros(1, np.int32), np.zeros(n - 1, np.int32)) == n - 1


def test_merge_count_run_spanning_blocks_without_build():
    # a probe-only run spanning blocks must not match a smaller earlier build
    n = 2 * BLOCK
    assert _count(np.array([5], np.int32), np.full(n - 1, 7, np.int32)) == 0


def test_merge_count_int_max_probe_rows_unaffected_by_padding():
    # INT32_MAX probe rows match only when INT32_MAX is a real build key
    m = np.iinfo(np.int32).max
    assert _count(np.array([1], np.int32), np.array([m, m], np.int32)) == 0
    assert _count(np.array([1, m], np.int32), np.array([m, m], np.int32)) == 2
