#!/usr/bin/env python
"""Materialized join at scale on the GPU.

Measures the key-order materialize path (merge_join.two_run_materialize:
two value-carrying sorts + a search and payload gather, compaction
dispatch skipped when every probe row matches) at the reference workload
10M ⋈ 200M, plus an at-scale output-correctness oracle:

  - count == |B| (every Zipf key over [1, n_a] matches the sequential A)
  - keys come back ascending (key-order contract)
  - pay_a oracle: A's payload is a function of its key (pay = key ^ SALT),
    so EVERY output row must satisfy pay_a == key ^ SALT — an exact
    200M-row check, not a sample
  - pay_b sum is preserved (multiset invariant under reordering)

Run on the GPU.  Prints one JSON line.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from partitionedhashjoin_tpu.ops.merge_join import two_run_materialize

N_A = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
N_B = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
SKEW = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
SALT = 0x5A17


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    log(f"device: {jax.devices()[0]}; {N_A} ⋈ {N_B} skew {SKEW}")
    t0 = time.perf_counter()
    a_keys = jnp.arange(1, N_A + 1, dtype=jnp.int32)
    a_pay = a_keys ^ SALT  # payload derivable from key -> exact oracle
    b_keys = zipf_keys(jax.random.PRNGKey(20260817), N_B, SKEW, N_A)
    b_pay = jax.random.randint(
        jax.random.PRNGKey(7), (N_B,), 0, 1 << 20, dtype=jnp.int32
    )
    jax.block_until_ready((a_keys, b_keys, b_pay))
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    # warmup/compile
    out = two_run_materialize(a_keys, a_pay, b_keys, b_pay)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        keys, pa, pb, count = two_run_materialize(
            a_keys, a_pay, b_keys, b_pay
        )
        jax.block_until_ready((keys, pa, pb))
        best = min(best, time.perf_counter() - t0)
    log(f"materialize: {best*1e3:.0f} ms ({N_B/best/1e6:.0f}M rows/s)")

    # at-scale oracle (device-side reductions)
    @jax.jit
    def checks(keys, pa, pb, b_pay_in):
        asc = jnp.all(keys[1:] >= keys[:-1])
        pay_ok = jnp.all(pa == (keys ^ SALT))
        pb_sum_ok = jnp.sum(pb.astype(jnp.uint32)) == jnp.sum(
            b_pay_in.astype(jnp.uint32)
        )
        return asc, pay_ok, pb_sum_ok

    asc, pay_ok, pb_ok = map(
        bool, jax.device_get(checks(keys, pa, pb, b_pay))
    )
    c = int(jax.device_get(count))
    log(f"count={c} ascending={asc} pay_a_oracle={pay_ok} pb_sum={pb_ok}")
    ok = (c == N_B) and asc and pay_ok and pb_ok
    print(json.dumps({
        "metric": f"materialize_rows_per_s_{N_A}x{N_B}_skew{SKEW}",
        "value": round(N_B / best),
        "unit": "rows/s",
        "seconds": round(best, 3),
        "oracle_ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
