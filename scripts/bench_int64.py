#!/usr/bin/env python
"""int64-key benchmark row: the reference's Tuple::id width (Table.hpp:20-25).

Runs the 10M ⋈ 200M workload with int64 keys through the flagship joiner
(the two-run join on int64 keys) and prints one JSON line, mirroring
bench.py.  Requires x64 mode, enabled here before jax initializes arrays.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from partitionedhashjoin_tpu.data.table import Table  # noqa: E402
from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner  # noqa: E402

BASELINE_ROWS_PER_S = 200e6 / 1.196


def log(m):
    print(m, file=sys.stderr, flush=True)




def main():
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    log(f"device: {jax.devices()[0]}; int64 workload {n_a} ⋈ {n_b}")

    t0 = time.perf_counter()
    # int64 keys spread across the full 64-bit range: key = zipf_id * 2^33
    # + offset - 2^62, so hi and lo planes both carry entropy and no int32
    # shortcut could answer.  Pure-XLA rejection sampler: caches reliably
    # across processes (Pallas custom-call fingerprints do not — bench.py).
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    ids32 = zipf_keys(jax.random.PRNGKey(20260817), n_b, skew, n_a)
    spread = jnp.int64(1) << jnp.int64(33)
    keys_b = ids32.astype(jnp.int64) * spread + jnp.int64(12345) - (
        jnp.int64(1) << jnp.int64(62)
    )
    keys_a = (
        jnp.arange(1, n_a + 1, dtype=jnp.int64) * spread
        + jnp.int64(12345)
        - (jnp.int64(1) << jnp.int64(62))
    )
    table_a = Table(keys=keys_a, payloads=jnp.zeros((n_a,), jnp.int32))
    table_b = Table(keys=keys_b, payloads=jnp.zeros((n_b,), jnp.int32))
    jax.block_until_ready((table_a.keys, table_b.keys))
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    joiner = SortMergeJoiner()
    count = joiner.run(table_a, table_b)
    assert count == n_b, count
    t0 = time.perf_counter()
    count = joiner.run(table_a, table_b)
    total_s = time.perf_counter() - t0
    assert count == n_b
    rows_per_s = n_b / total_s
    log(f"int64 flagship: {total_s * 1e3:.0f} ms -> {rows_per_s / 1e6:.0f}M rows/s")
    print(
        json.dumps(
            {
                "metric": f"join_rows_per_s_int64_{n_a}x{n_b}_skew{skew}",
                "value": round(rows_per_s),
                "unit": "rows/s",
                "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
