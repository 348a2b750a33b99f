"""Stream compaction (ops/filter.py::compact: exclusive prefix sum +
scatter), the pass-2 and staged-filter compaction of the aggregate.

Oracle: numpy boolean indexing (stable front compaction).  Covers all-kept /
none-kept / dense / sparse patterns, multi-column carry, the zero tail and
the capacity bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from partitionedhashjoin_tpu.ops.filter import compact

#: rows of one block of the former block-compaction kernel; the shapes
#: below keep its multi-block cases
BLK = 8192


def _run(keep, *cols, **kw):
    out = compact(jnp.asarray(keep), *map(jnp.asarray, cols), **kw)
    return (int(out[0]),) + tuple(np.asarray(o) for o in out[1:])


class TestBlockCompact:
    @pytest.mark.parametrize("density,seed", [
        (0.05, 0), (0.5, 1), (0.95, 2), (1.0, 3), (0.0, 4),
    ])
    def test_aligned_gap_contract(self, density, seed):
        n = 3 * BLK
        rng = np.random.default_rng(seed)
        keep = rng.random(n) < density
        vals = rng.integers(1, 2**31, n).astype(np.int32)
        pos = np.arange(n, dtype=np.int32)
        total, pos_c, out = _run(keep, pos, vals)
        # the kept records, in original order, with no gaps
        assert total == keep.sum()
        np.testing.assert_array_equal(pos_c[:total], np.where(keep)[0])
        np.testing.assert_array_equal(out[:total], vals[keep])

    def test_multi_column_carry(self):
        n = 2 * BLK
        rng = np.random.default_rng(7)
        keep = rng.random(n) < 0.3
        cols = [rng.integers(0, 1000, n).astype(np.int32) for _ in range(4)]
        total, *outs = _run(keep, *cols)
        for c, o in zip(cols, outs):
            np.testing.assert_array_equal(o[:total], c[keep])


class TestCompactColumns:
    @pytest.mark.parametrize("density,n_blocks,seed", [
        (0.01, 4, 10), (0.4, 3, 11), (1.0, 2, 12), (0.0, 2, 13),
    ])
    def test_exact_front_compaction(self, density, n_blocks, seed):
        n = n_blocks * BLK
        rng = np.random.default_rng(seed)
        keep = rng.random(n) < density
        a = rng.integers(-(2**31), 2**31, n).astype(np.int32)
        b = np.arange(n, dtype=np.int32)
        c, ca, cb = _run(keep, a, b)
        assert c == int(keep.sum())
        np.testing.assert_array_equal(ca[:c], a[keep])
        np.testing.assert_array_equal(cb[:c], b[keep])
        # zero tail
        assert not ca[c:].any() and not cb[c:].any()

    def test_capacity_overflow_flag(self):
        n = 2 * BLK
        keep = np.ones(n, bool)  # everything kept
        vals = np.arange(n, dtype=np.int32)
        count, cv = _run(keep, vals, capacity=100)
        assert count == n  # exact even past the capacity
        assert cv.shape == (100,)
        np.testing.assert_array_equal(cv, vals[:100])

    def test_capacity_bound_respected_with_slack(self):
        # sparse keeps within capacity: exact, zero tail to the bound
        n = 4 * BLK
        rng = np.random.default_rng(21)
        keep = rng.random(n) < 0.02
        vals = rng.integers(1, 99, n).astype(np.int32)
        count, cv = _run(keep, vals, capacity=2048)
        assert count == int(keep.sum()) and cv.shape == (2048,)
        np.testing.assert_array_equal(cv[:count], vals[keep])
        assert not cv[count:].any()
