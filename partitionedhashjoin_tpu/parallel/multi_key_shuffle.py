"""Distributed composite-key count join over the device mesh.

Extends the shuffle join (parallel/shuffle.py — the mesh scale-out form of
the reference's shared-memory radix scatter, src/RadixCluster/HashJoin.hpp:
394-412) to MULTI-COLUMN keys (ops/multi_key.py): rows are hash-sharded by
their FULL key tuple (all equal tuples land on one shard, so per-shard
counts are exact and sum globally), both sides' k columns ride the same
``all_to_all`` bucket exchange, and each shard runs the lexicographic
multi-key count locally with a ``psum`` total.

Only the hash routes rows; matching is always column-wise tuple equality,
so hash collisions cost balance, never correctness.  Overflowed buckets
are counted and retried with doubled slack exactly like the single-key
joiner.  Received-slot and host-padding invalidity is encoded as an extra
TAG key column (valid rows tag 0, invalid build rows 1, invalid probe rows
2): invalid rows can never equal any valid or opposite-side row, which
reuses the multi-key counter unchanged instead of growing a mask protocol.

No heavy-hitter replication here (the single-key joiner's hot plan keys on
scalar identity): a skewed hot TUPLE degrades balance but never
exactness — capacity retries absorb it.  Documented limitation.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from partitionedhashjoin_tpu.ops import hashing
from partitionedhashjoin_tpu.ops import multi_key
from partitionedhashjoin_tpu.parallel.mesh import SHARD_AXIS
from partitionedhashjoin_tpu.parallel.shuffle import _bucketize, _shard_map
from partitionedhashjoin_tpu.utils.logger import get_new_logger


def _hash_tuple(cols, seed):
    """Seeded uint32 hash of a key TUPLE: chain each column through the
    pair mixer (hashing.hash64_pair pattern — fmix32 rounds with distinct
    constants), so every column fully avalanches into the route."""
    h = hashing.hash32(cols[0], seed)
    for c in cols[1:]:
        h = hashing.fmix32(jnp.asarray(c).astype(jnp.uint32) ^ h)
        h = hashing.fmix32(h + hashing._GOLDEN)
    return h


@functools.partial(jax.jit, static_argnames=("mesh", "cap_a", "cap_b"))
def _mk_exchange_and_count(
    mesh: Mesh,
    a_cols,
    b_cols,
    a_valid,
    b_valid,
    shard_seed,
    cap_a: int,
    cap_b: int,
):
    """One program: tuple-hash routing, bucket exchange of every key
    column, local multi-key count with tag columns, psum.  Returns
    (count, dropped_a, dropped_b)."""

    def local(a_cols, b_cols, a_valid, b_valid, shard_seed):
        num_shards = jax.lax.axis_size(SHARD_AXIS)
        seed = shard_seed[0]
        dest_a = hashing.bucket(_hash_tuple(a_cols, seed), num_shards)
        dest_b = hashing.bucket(_hash_tuple(b_cols, seed), num_shards)
        *ba, bv_a, drop_a = _bucketize(
            dest_a, a_valid, cap_a, num_shards, *a_cols
        )
        *bb, bv_b, drop_b = _bucketize(
            dest_b, b_valid, cap_b, num_shards, *b_cols
        )

        def a2a(x):
            return jax.lax.all_to_all(
                x.reshape(num_shards, -1),
                SHARD_AXIS,
                split_axis=0,
                concat_axis=0,
            ).reshape(-1)

        ra = tuple(a2a(c) for c in ba)
        rb = tuple(a2a(c) for c in bb)
        rv_a = a2a(bv_a)
        rv_b = a2a(bv_b)
        # tag column: 0 = live row; 1/2 = dead build/probe slot (can never
        # equal anything live or opposite-side — see module docstring)
        tag_a = jnp.where(rv_a, 0, 1).astype(jnp.int32)
        tag_b = jnp.where(rv_b, 0, 2).astype(jnp.int32)
        count = multi_key._multi_key_count_xla(ra + (tag_a,), rb + (tag_b,))
        return (
            jax.lax.psum(count, SHARD_AXIS),
            jax.lax.psum(drop_a, SHARD_AXIS),
            jax.lax.psum(drop_b, SHARD_AXIS),
        )

    sh = P(SHARD_AXIS)
    rep = P()
    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )(a_cols, b_cols, a_valid, b_valid, jnp.reshape(shard_seed, (1,)))


class MultiKeyShuffleJoiner:
    """Mesh-parallel composite-key count join driver.

    ``run(build_cols, probe_cols)`` returns the exact Get-semantics count
    (probe rows whose full key tuple appears among build rows), identical
    to ops/multi_key.py::multi_key_count on one device.  Static bucket
    capacities retry with doubled slack on overflow (single-key joiner
    protocol, shuffle.py:791-802).
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        max_retries: int = 4,
    ) -> None:
        self._mesh = mesh
        self._num_shards = int(mesh.devices.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            import numpy as _np

            seed = int(_np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self._shard_seed = jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32)
        self._slack = slack
        self._max_retries = max_retries
        self._logger = get_new_logger("MultiKeyShuffleJoiner")

    def _pad(self, cols, n):
        """Pad each column (and build the validity mask) so rows divide the
        shard count; padded rows are dropped at bucketize (valid=False)."""
        s = self._num_shards
        padded = (n + s - 1) // s * s
        if padded != n:
            cols = tuple(
                jnp.concatenate([c, jnp.zeros((padded - n,), c.dtype)])
                for c in cols
            )
        valid = jnp.arange(padded, dtype=jnp.int32) < n
        return cols, valid, padded

    def _capacity(self, rows_per_shard: int, slack: float) -> int:
        per_dest = rows_per_shard / self._num_shards
        return max(16, min(int(per_dest * slack + 1), rows_per_shard))

    def run_i64(self, build_keys: jax.Array, probe_keys: jax.Array) -> int:
        """int64 single-key distributed count via the two-plane recipe
        (requires jax x64 to split): exact — lexicographic plane equality
        IS int64 equality (ops/multi_key.py::split_i64)."""
        from partitionedhashjoin_tpu.ops.multi_key import split_i64

        ah, al = split_i64(build_keys)
        bh, bl = split_i64(probe_keys)
        return self.run([ah, al], [bh, bl])

    def run(
        self,
        build_cols: Sequence[jax.Array],
        probe_cols: Sequence[jax.Array],
    ) -> int:
        build_cols = multi_key._check_columns("build_cols", build_cols)
        probe_cols = multi_key._check_columns("probe_cols", probe_cols)
        if len(build_cols) != len(probe_cols):
            raise ValueError(
                f"column-count mismatch: build has {len(build_cols)}, "
                f"probe has {len(probe_cols)}"
            )
        n_a = build_cols[0].shape[0]
        n_b = probe_cols[0].shape[0]
        if n_a == 0 or n_b == 0:
            return 0
        a_cols, a_valid, pad_a = self._pad(build_cols, n_a)
        b_cols, b_valid, pad_b = self._pad(probe_cols, n_b)

        slack = self._slack
        for attempt in range(self._max_retries):
            cap_a = self._capacity(pad_a // self._num_shards, slack)
            cap_b = self._capacity(pad_b // self._num_shards, slack)
            count, drop_a, drop_b = _mk_exchange_and_count(
                self._mesh, a_cols, b_cols, a_valid, b_valid,
                self._shard_seed, cap_a, cap_b,
            )
            drop_a, drop_b = int(jax.device_get(drop_a)), int(
                jax.device_get(drop_b)
            )
            if drop_a == 0 and drop_b == 0:
                count = int(jax.device_get(count))
                self._logger.info("Number of joined tuples: %d", count)
                return count
            self._logger.info(
                "bucket overflow (a=%d b=%d) at slack %.1f; retrying",
                drop_a, drop_b, slack,
            )
            slack *= 2
        raise RuntimeError(
            f"bucket overflow persisted after {self._max_retries} retries "
            f"(final slack {slack:.1f})"
        )
