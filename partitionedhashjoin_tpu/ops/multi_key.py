"""Composite-key (multi-column) joins — engine extension.

The reference joins on a single int64 ``Tuple::id``
(src/Common/Table.hpp:20-25); real query engines join on composite keys
(ON a.k1 = b.k1 AND a.k2 = b.k2 ...).  This module generalizes the
engine's join count to k int32 key columns:

* ``k == 1`` is the single-key two-run join (ops/merge_join.py).
* any other ``k`` takes the generalized sort-merge path: ONE unstable
  (k+1)-operand lexicographic sort of the concatenated relations with a
  build-before-probe tie tag, then the same run-snapshot multiplicity
  scan as ops/sort_merge.py::_merged_multiplicity — tuple runs are
  delimited by "any column differs from the previous row".

Exactness notes (the engine's non-negotiable): no column combination is
ever hashed or packed, so there are no collisions by construction.  64-bit
columns are refused with a TypeError (never silently truncated) — split
them into (hi, lo) planes with ``split_i64`` and pass both planes as
columns: lexicographic plane order preserves exact equality.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def split_i64(x: jax.Array):
    """(hi, lo_cmp) int32 planes of an int64 array (order-preserving):
    hi = key >> 32 (signed), lo_cmp = (key & 0xFFFFFFFF) - 2^31, so the
    int32 compare of lo_cmp is the unsigned compare of the low word and
    (hi, lo_cmp) in lexicographic order is int64 order."""
    hi = (x >> jnp.int64(32)).astype(jnp.int32)
    lo_cmp = ((x & jnp.int64(0xFFFFFFFF)) - jnp.int64(1 << 31)).astype(
        jnp.int32
    )
    return hi, lo_cmp


def _check_columns(name: str, cols: Sequence[jax.Array]):
    """Validate one side's key columns; returns them as a tuple."""
    cols = tuple(cols)
    if not cols:
        raise ValueError(f"{name}: at least one key column is required")
    n = jnp.asarray(cols[0]).shape[0]
    out = []
    for i, c in enumerate(cols):
        # inspect the ORIGINAL dtype: under x64-off jnp.asarray silently
        # downcasts a 64-bit numpy array to int32 before any guard could see
        dt = getattr(c, "dtype", None)
        c = jnp.asarray(c)
        if str(dt) in ("int64", "uint64") or c.dtype in (jnp.int64, jnp.uint64):
            # never silently truncate 64-bit columns (distinct keys would
            # collide) — same contract as merge_join.two_run_count; pass
            # split_i64 planes instead
            raise TypeError(
                f"{name}[{i}] is {c.dtype}: 64-bit columns are refused; "
                "split into (hi, lo_cmp) int32 planes via "
                "ops.multi_key.split_i64 and pass both planes"
            )
        if c.ndim != 1 or c.shape[0] != n:
            raise ValueError(
                f"{name}[{i}] shape {c.shape} != expected ({n},)"
            )
        out.append(c.astype(jnp.int32))
    return tuple(out)


def _merged_multiplicity_multi(build_cols, probe_cols):
    """Generalized ops/sort_merge.py::_merged_multiplicity over k columns:
    returns (is_probe_row, mult) in lexicographically sorted order, where
    mult = number of build rows sharing this row's full key tuple."""
    k = len(build_cols)
    n_a = build_cols[0].shape[0]
    n_b = probe_cols[0].shape[0]
    merged = tuple(
        jnp.concatenate([a, b]) for a, b in zip(build_cols, probe_cols)
    )
    is_probe_tag = jnp.concatenate(
        [jnp.zeros((n_a,), jnp.bool_), jnp.ones((n_b,), jnp.bool_)]
    )
    # unstable (k+1)-key sort: builds order before equal-tuple probes via
    # the tag operand, exactly the sort_merge_count fast-path trick
    sorted_ops = jax.lax.sort(
        merged + (is_probe_tag,), num_keys=k + 1, is_stable=False
    )
    cols_s = sorted_ops[:k]
    is_build_s = ~sorted_ops[k]
    # each column's `differs` is True at row 0, so the OR starts the first run
    new_run = jnp.zeros((n_a + n_b,), jnp.bool_)
    for c in cols_s:
        new_run = new_run | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), c[1:] != c[:-1]]
        )
    counted = is_build_s.astype(jnp.int32)
    build_prefix = jnp.cumsum(counted)
    # exclusive prefix snapshotted at run starts; cummax propagates it
    # (snapshots never decrease along the sorted order)
    snapshot = jnp.where(new_run, build_prefix - counted, -1)
    run_start_prefix = jax.lax.cummax(snapshot)
    mult = build_prefix - run_start_prefix
    return ~is_build_s, mult


@jax.jit
def _multi_key_count_xla(build_cols, probe_cols) -> jax.Array:
    is_probe, mult = _merged_multiplicity_multi(build_cols, probe_cols)
    hit = is_probe & (mult > 0)
    return jnp.sum(hit.astype(jnp.int32))


@jax.jit
def _multi_key_count_all_xla(build_cols, probe_cols) -> jax.Array:
    from partitionedhashjoin_tpu.utils import widesum

    is_probe, mult = _merged_multiplicity_multi(build_cols, probe_cols)
    return widesum.exact_sum_u64(jnp.where(is_probe, mult, 0))


def multi_key_count(
    build_cols: Sequence[jax.Array],
    probe_cols: Sequence[jax.Array],
) -> jax.Array:
    """Get-semantics composite-key count: number of probe rows whose FULL
    key tuple (column-wise equality over all k columns) appears among the
    build rows.  ``k == 1`` is ops/merge_join.py::two_run_count; other k
    take the generalized lexicographic sort-merge path."""
    build_cols = _check_columns("build_cols", build_cols)
    probe_cols = _check_columns("probe_cols", probe_cols)
    if len(build_cols) != len(probe_cols):
        raise ValueError(
            f"column-count mismatch: build has {len(build_cols)}, "
            f"probe has {len(probe_cols)}"
        )
    if build_cols[0].shape[0] == 0 or probe_cols[0].shape[0] == 0:
        return jnp.asarray(0, jnp.int32)
    k = len(build_cols)
    if k == 1:
        from partitionedhashjoin_tpu.ops import merge_join

        return merge_join.two_run_count(build_cols[0], probe_cols[0])
    return _multi_key_count_xla(build_cols, probe_cols)


def multi_key_count_all(
    build_cols: Sequence[jax.Array],
    probe_cols: Sequence[jax.Array],
) -> jax.Array:
    """Full inner-join cardinality on a composite key (duplicates multiply,
    GetAll semantics).  Returns the engine's exact uint32[2] (hi, lo) pair
    — decode with utils.widesum.pair_to_int."""
    build_cols = _check_columns("build_cols", build_cols)
    probe_cols = _check_columns("probe_cols", probe_cols)
    if len(build_cols) != len(probe_cols):
        raise ValueError(
            f"column-count mismatch: build has {len(build_cols)}, "
            f"probe has {len(probe_cols)}"
        )
    if build_cols[0].shape[0] == 0 or probe_cols[0].shape[0] == 0:
        return jnp.zeros((2,), jnp.uint32)
    return _multi_key_count_all_xla(build_cols, probe_cols)
