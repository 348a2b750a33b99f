"""No-partitioning hash join (Blanas SIGMOD'11, algorithm 1).

Counterpart of src/NoPartitioning/HashJoin.hpp:14-187: one global
hash table built over the whole build relation, then the probe relation is
scanned against it, counting probe rows that find a match (``Get`` != null,
HashJoin.hpp:144-157).  The reference parallelizes with thread batches over a
shared latched table; here both phases are single fused XLA programs over the
vectorized conflict-free table (ops/hash_table.py) — lane parallelism replaces
thread parallelism, and multi-chip runs shard the probe relation over a mesh
(parallel/shuffle.py) instead of adding workers.

Matching the reference, the join result is **not materialized** by default:
``run`` returns the match count (HashJoin.hpp:184-186 logs the count and
returns an empty table).  ``run_materialize`` is the engine extension that
gathers the matched payload pairs.

Two global-structure layouts (config.NoPartitioningConfiguration.mode):

- ``"vmem"``: the global structure is the SORTED build run — an ordered
  dictionary instead of a hash table.  Build = one unstable sort of A;
  probe = sort B, then one vectorized binary search per row against the
  run (ops/merge_join.py), which a 10M-row build keeps resident in the
  H100's L2.  Still the Blanas shape: no partitioning phase, ONE structure
  over the whole build side, the probe streamed against it.  (The name is
  historical: the structure no longer lives in a scratchpad.)
- ``"chained"``: literal table analogue — chained-bucket hash table probed
  by gathers, kept for structure parity and as the materialize path.

``"auto"`` resolves to ``AUTO_MODE``, the faster of the two on the H100.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.config import NoPartitioningConfiguration
from partitionedhashjoin_tpu.data.table import JoinedTable, Table
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.utils.logger import get_new_logger
from partitionedhashjoin_tpu.utils.results import IHashJoinTimer, NoOpHashJoinTimer

#: Mode that "auto" resolves to: the faster of the two at 10M ⋈ 200M on
#: the H100 (PERF.md, path decisions).
AUTO_MODE = "vmem"


@jax.jit
def _probe_gather(
    table: ht.ChainedHashTable,
    probe_keys: jax.Array,
    build_payloads: jax.Array,
    probe_payloads: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Materialize first-match join output, compacted to the front."""
    found, build_row = ht.probe_chained_get(table, probe_keys)
    n = probe_keys.shape[0]
    # stable compaction: output position = exclusive prefix count of matches
    pos = jnp.cumsum(found.astype(jnp.int32)) - found.astype(jnp.int32)
    dst = jnp.where(found, pos, n)  # misses -> dump slot
    keys_out = jnp.zeros((n,), probe_keys.dtype).at[dst].set(
        probe_keys, mode="drop"
    )
    pay_a = jnp.zeros((n,), build_payloads.dtype).at[dst].set(
        build_payloads[jnp.maximum(build_row, 0)], mode="drop"
    )
    pay_b = jnp.zeros((n,), probe_payloads.dtype).at[dst].set(
        probe_payloads, mode="drop"
    )
    count = jnp.sum(found.astype(jnp.int32))
    return keys_out, pay_a, pay_b, count


class NoPartitioningHashJoiner:
    """Driver mirroring HashJoiner<Factory> (HashJoin.hpp:14-41).

    ``run(table_a, table_b, timer)`` builds over ``table_a`` and probes with
    ``table_b`` (HashJoin.hpp:54-74).  Phase boundaries are real device-work
    boundaries: each phase ends with ``block_until_ready`` before its timer
    stops, so build/probe attribution is exact (the reference's probe timer
    bug, Results.hpp:202, is documented in utils/results.py and not
    replicated).
    """

    def __init__(
        self,
        configuration: Optional[NoPartitioningConfiguration] = None,
        seed: Optional[int] = None,
        size_ratio: float = ht.DEFAULT_SIZE_RATIO,
    ) -> None:
        self._config = configuration or NoPartitioningConfiguration()
        self._size_ratio = size_ratio
        # Per-instance random hash seed (XXHasher.hpp:12-17 semantics), held
        # as a device scalar so seed changes never recompile the kernels.
        if seed is None:
            import numpy as _np

            seed = int(_np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self._seed = jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32)
        self._logger = get_new_logger("NoPartitioningHashJoiner")

    def build(self, table_a: Table) -> ht.ChainedHashTable:
        """One-sort chained-bucket build (replaces the reference's parallel
        latched insert loop, HashJoin.hpp:76-126)."""
        num_buckets = ht.chained_num_buckets(table_a.size)
        table = ht.build_chained(table_a.keys, self._seed, num_buckets)
        jax.block_until_ready(table.entry_rows)
        return table

    def _resolve_mode(self) -> str:
        mode = getattr(self._config, "mode", "auto")
        if mode == "auto":
            return AUTO_MODE
        if mode not in ("vmem", "chained"):
            raise ValueError(f"unknown no-partitioning mode {mode!r}")
        return mode

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Build over A, probe with B, return the match count."""
        timer = timer or NoOpHashJoinTimer()
        if self._resolve_mode() == "vmem":
            return self._run_vmem(table_a, table_b, timer)
        timer.set_build_phase_begin()
        hash_tbl = self.build(table_a)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        count = ht.probe_chained_count(
            hash_tbl, table_b.keys, num_chunks=ht.dispatch_chunks(
                table_b.size, target=self._config.probe_chunk_rows
            )
        )
        count = int(jax.device_get(count))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    def _run_vmem(
        self,
        table_a: Table,
        table_b: Table,
        timer: IHashJoinTimer,
    ) -> int:
        """Sorted-run global structure + binary-search probe.

        Phase mapping onto the reference timer (HashJoin.hpp:54-74): build
        = constructing the global lookup structure (here one unstable sort
        of A — merge_join.PreparedBuild); probe = streaming B against it
        (sort B + one binary search per row).  No
        partitioning phase, matching the algorithm's name and the
        reference's timer (partition stays 0).
        """
        from partitionedhashjoin_tpu.ops import merge_join

        timer.set_build_phase_begin()
        prepared = merge_join.PreparedBuild(table_a.keys)
        jax.block_until_ready(prepared.a_sorted)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        n = table_b.size
        num_chunks = ht.dispatch_chunks(
            n, target=self._config.vmem_probe_chunk_rows
        )
        if num_chunks == 1 or prepared.a_sorted.dtype != jnp.int32:
            # one program; int64 probes always take this branch (validity
            # masks are int32-path only — config.vmem_probe_chunk_rows doc)
            count = int(jax.device_get(prepared.count(table_b.keys)))
        else:
            # dispatch-level chunking (bounds one program's temporaries):
            # equal fixed-size windows so every chunk shares one compiled program;
            # the last window ends at n and masks its overlap with the
            # previous one invalid.  Get-semantics counts are additive over
            # probe partitions, so summing chunk counts is exact.
            w = -(-n // num_chunks)
            count = 0
            for c in range(num_chunks):
                start = min(c * w, n - w)
                skip = c * w - start  # rows already counted by window c-1
                chunk = jax.lax.dynamic_slice_in_dim(table_b.keys, start, w)
                valid = jnp.arange(w, dtype=jnp.int32) >= skip
                count += int(jax.device_get(prepared.count(chunk, valid)))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    def run_materialize(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> JoinedTable:
        """Engine extension: materialized first-match join output."""
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        hash_tbl = self.build(table_a)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        keys, pay_a, pay_b, count = _probe_gather(
            hash_tbl, table_b.keys, table_a.payloads, table_b.payloads
        )
        jax.block_until_ready(count)
        timer.set_probe_phase_end()
        return JoinedTable(
            keys=keys, payloads_a=pay_a, payloads_b=pay_b, count=count
        )
