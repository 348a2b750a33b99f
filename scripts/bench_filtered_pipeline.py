#!/usr/bin/env python
"""Filtered composed query at reference scale, on the GPU (R7):

    SELECT b.key, COUNT(*), SUM(b.pay), MIN(b.pay), MAX(b.pay)
    FROM B JOIN A USING (key) WHERE b.pay % 2 = 0
    GROUP BY key ORDER BY COUNT(*) DESC LIMIT 10

The query layer's R7 rule (R5∘R3) must stage the filter: one Pallas
block-compaction pass shrinks the probe relation FIRST, invalid build
rows re-key to the opposite sentinel, and the two-run pipeline
(two_run_materialize + aggregate_sorted) runs on the survivors — so a
50 %-selectivity filter should cost roughly the compaction pass while
every relation-sized sort HALVES.  A/B'd against the unfiltered
pipeline (the round-4 headline composed query) for context.

Oracles: the group-COUNT total must equal the survivor count from an
independent masked count (two_run_count with probe_valid — a
different code path), and the query layer's EXPLAIN must pick R7.

Run on the GPU.  Env: PHJ_BENCH_PRIMARY/SECONDARY/SKEW (small sizes under
JAX_PLATFORMS=cpu smoke the script logic; CPU timings mean nothing).
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

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.query import scan

N_A = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
N_B = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
SKEW = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    log(f"device: {jax.devices()[0]}; query over {N_A} ⋈ {N_B}, skew {SKEW}")
    t0 = time.perf_counter()
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    a_keys = jnp.arange(1, N_A + 1, dtype=jnp.int32)
    a_pay = a_keys ^ 0x5A17
    b_keys = zipf_keys(jax.random.PRNGKey(20260820), N_B, SKEW, N_A)
    b_pay = jax.random.randint(
        jax.random.PRNGKey(9), (N_B,), 0, 1 << 20, dtype=jnp.int32
    )
    jax.block_until_ready((a_keys, b_keys, b_pay))
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    ta = Table(keys=a_keys, payloads=a_pay)
    tb = Table(keys=b_keys, payloads=b_pay)
    cap = 1 << 24
    pred = lambda k, p: p % 2 == 0

    plans = {
        "filtered-R7": (
            scan(tb).filter(pred).join(scan(ta))
            .group_by(group_capacity=cap)
            .order_by("count", descending=True).limit(10)
        ),
        "unfiltered": (
            scan(tb).join(scan(ta))
            .group_by(group_capacity=cap)
            .order_by("count", descending=True).limit(10)
        ),
    }
    plan_text = plans["filtered-R7"].explain()
    log("filtered plan:\n" + plan_text)
    assert "R7" in plan_text, "planner must pick the staged two-run path"

    results = {}
    for name, q in plans.items():
        g = q.execute()  # compile
        best = float("inf")
        for _ in range(2):
            t1 = time.perf_counter()
            g = q.execute()
            jax.block_until_ready((g.keys, g.count, g.sum))
            best = min(best, time.perf_counter() - t1)
        results[name] = (best, g)
        log(
            f"join+group-by+top10 [{name}]: {best*1e3:.0f} ms "
            f"-> {N_B/best/1e6:.0f}M rows/s (input rows)"
        )

    # oracle: independent masked two-run count must equal the filtered
    # plan's total group COUNT
    from partitionedhashjoin_tpu.ops.merge_join import two_run_count

    survivors = int(
        jax.device_get(
            two_run_count(
                a_keys, b_keys, probe_valid=pred(b_keys, b_pay),
            )
        )
    )
    g_f = results["filtered-R7"][1]
    # the top-10 result is group-stage; re-run the group_by alone for the
    # count-sum oracle (same staged plan, no tail)
    g_full = (
        scan(tb).filter(pred).join(scan(ta))
        .group_by(group_capacity=cap).execute()
    )
    total = int(jax.device_get(jnp.sum(g_full.count)))
    assert total == survivors, (total, survivors)
    log(f"oracle: group-count total {total} == masked two-run count")

    t_f, t_u = results["filtered-R7"][0], results["unfiltered"][0]
    print(json.dumps({
        "metric": f"filtered_pipeline_ms_{N_A}x{N_B}_skew{SKEW}",
        "filtered_R7_ms": round(t_f * 1e3),
        "unfiltered_ms": round(t_u * 1e3),
        "filter_overhead_ms": round((t_f - t_u) * 1e3),
        "survivors": survivors,
        "top1_count": int(jax.device_get(g_f.count)[0]),
    }))


if __name__ == "__main__":
    main()
