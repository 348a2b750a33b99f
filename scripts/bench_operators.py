#!/usr/bin/env python
"""Filter + GROUP BY pipeline benchmark (BASELINE.json configs[3]).

Runs the extended-operator pipeline — predicate filter fused into the
sort-based hash-aggregate (ops/aggregate.py::filter_sort_aggregate) — on the
reference-scale table (200M Zipf(1.05) keys over a 10M domain, payload = row
index) and prints one JSON line like bench.py.  The reference has no
aggregate operator, so ``vs_baseline`` is reported as rows/s
against the reference's best JOIN throughput purely for scale context.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from partitionedhashjoin_tpu.data.table import Table  # noqa: E402
from partitionedhashjoin_tpu.ops.aggregate import (  # noqa: E402
    filter_sort_aggregate,
)

BASELINE_ROWS_PER_S = 200e6 / 1.196


def log(m):
    print(m, file=sys.stderr, flush=True)




def main():
    n = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    domain = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    log(f"device: {jax.devices()[0]}; GROUP BY over {n} rows, {domain} domain")

    t0 = time.perf_counter()
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    keys = zipf_keys(jax.random.PRNGKey(20260817), n, skew, domain)
    pay = jnp.arange(n, dtype=jnp.int32)
    table = Table(keys=keys, payloads=pay)
    jax.block_until_ready(table.keys)
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    cap = 1 << 24  # 16M group slots >= 10M domain
    pred = lambda k, p: (p & 1) == 0  # noqa: E731 - half the rows

    from partitionedhashjoin_tpu.ops.aggregate import (
        filter_sort_aggregate_staged,
    )

    pipelines = {"fused": filter_sort_aggregate}
    if os.environ.get("PHJ_BENCH_FUSED_ONLY", "") != "1":
        # staged: Pallas block-compaction filter first, then the sort
        # aggregate over the bucketed survivor slice (two dispatches)
        pipelines["staged"] = filter_sort_aggregate_staged

    results = {}
    nums = set()
    for name, fn in pipelines.items():
        g, count = fn(table, pred, group_capacity=cap)
        jax.block_until_ready(g.num_groups)  # warmup/compile
        num = int(jax.device_get(g.num_groups))
        assert num <= cap, f"{name}: group capacity overflow: {num}"
        nums.add(num)
        sel = int(jax.device_get(count))
        assert sel == n // 2, (name, sel)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            g, count = fn(table, pred, group_capacity=cap)
            jax.block_until_ready(g.num_groups)
            best = min(best, time.perf_counter() - t0)
        results[name] = best
        log(
            f"filter+group-by [{name}]: {best * 1e3:.0f} ms over {n} rows "
            f"({num} groups) -> {n / best / 1e6:.0f}M rows/s"
        )
    assert len(nums) == 1, f"pipeline group counts disagree: {nums}"
    winner = min(results, key=results.get)
    rows_per_s = n / results[winner]
    print(
        json.dumps(
            {
                "metric": f"filter_groupby_rows_per_s_{n}_skew{skew}",
                "value": round(rows_per_s),
                "unit": "rows/s",
                "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
                "pipeline": winner,
            }
        )
    )


if __name__ == "__main__":
    main()
