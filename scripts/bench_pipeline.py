#!/usr/bin/env python
"""Composed analytics query at reference scale, on the GPU:

    SELECT b.key, COUNT(*), SUM(b.pay), MIN(b.pay), MAX(b.pay)
    FROM B JOIN A USING (key) GROUP BY key          -- then ORDER BY count LIMIT 10

via the engine's order-propagation rule: the materialized two-run join
(merge_join.two_run_materialize) emits key-ORDERED output, so the GROUP BY
rides aggregate_sorted and never pays a second relation sort.  A/B'd
against the naive plan (materialize -> sort_aggregate, which re-sorts
200M rows) with full result-equality as the oracle.  Prints one JSON line.

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
from partitionedhashjoin_tpu.ops.aggregate import (
    aggregate_sorted,
    sort_aggregate,
)
from partitionedhashjoin_tpu.ops.merge_join import two_run_materialize
from partitionedhashjoin_tpu.ops.order_by import top_k

N_A = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
N_B = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
SKEW = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
BASELINE_ROWS_PER_S = 200e6 / 1.196  # reference best JOIN, scale context


def log(m):
    print(m, file=sys.stderr, flush=True)


def run_query(a_keys, a_pay, b_keys, b_pay, cap, ordered: bool):
    """materialize -> GROUP BY (order-propagating or naive) -> top-10.

    The ordered plan asks the materializer for payload-ascending runs
    (one extra sort key) so the GROUP BY needs NO relation sort and NO
    segmented scans."""
    keys, pa, pb, count = two_run_materialize(
        a_keys, a_pay, b_keys, b_pay,
        probe_payload_sorted=ordered,
    )
    t = Table(keys=keys, payloads=pb)
    if ordered:
        g = aggregate_sorted(
            t, group_capacity=cap, n_valid=count,
            payload_sorted=True,
        )
    else:
        g = sort_aggregate(t, group_capacity=cap)
    hot = top_k(
        Table(keys=g.count, payloads=g.keys), 10, by="key", descending=True
    )
    jax.block_until_ready((hot.keys, hot.payloads, g.sum))
    return g, hot, count


def main():
    log(f"device: {jax.devices()[0]}; query over {N_A} ⋈ {N_B}, skew {SKEW}")
    t0 = time.perf_counter()
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    a_keys = jnp.arange(1, N_A + 1, dtype=jnp.int32)
    a_pay = a_keys ^ 0x5A17
    b_keys = zipf_keys(jax.random.PRNGKey(20260819), N_B, SKEW, N_A)
    b_pay = jax.random.randint(
        jax.random.PRNGKey(9), (N_B,), 0, 1 << 20, dtype=jnp.int32
    )
    jax.block_until_ready((a_keys, b_keys, b_pay))
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    cap = 1 << 24
    results = {}
    for name, ordered in (("ordered", True), ("naive-resort", False)):
        g, hot, count = run_query(a_keys, a_pay, b_keys, b_pay, cap, ordered)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            g, hot, count = run_query(
                a_keys, a_pay, b_keys, b_pay, cap, ordered
            )
            best = min(best, time.perf_counter() - t0)
        results[name] = (best, g, hot, int(jax.device_get(count)))
        log(
            f"join+group-by+top10 [{name}]: {best*1e3:.0f} ms "
            f"-> {N_B/best/1e6:.0f}M rows/s"
        )

    # oracle: the two plans must agree on EVERYTHING
    (_, g1, hot1, c1), (_, g2, hot2, c2) = results.values()
    assert c1 == c2 == N_B, (c1, c2)
    n1 = int(jax.device_get(g1.num_groups))
    assert n1 == int(jax.device_get(g2.num_groups))
    eq = jax.jit(
        lambda a, b: jnp.all(
            jnp.array([jnp.all(x[:n1] == y[:n1]) for x, y in zip(a, b)])
        )
    )
    fields1 = (g1.keys, g1.count, g1.sum, g1.min, g1.max)
    fields2 = (g2.keys, g2.count, g2.sum, g2.min, g2.max)
    assert bool(jax.device_get(eq(fields1, fields2))), "plan results differ"
    assert jax.device_get(hot1.keys).tolist() == (
        jax.device_get(hot2.keys).tolist()
    )
    log(f"oracle: {n1} groups, plans identical, top-1 count "
        f"{int(jax.device_get(hot1.keys)[0])}")

    # the declarative layer must pick the ordered plan by itself (R3+R4)
    # and add zero measurable overhead — same programs, same results
    from partitionedhashjoin_tpu.query import scan

    ta = Table(keys=a_keys, payloads=a_pay)
    tb = Table(keys=b_keys, payloads=b_pay)
    q = (
        scan(tb).join(scan(ta))
        .group_by(group_capacity=cap)
        .order_by("count", descending=True).limit(10)
    )
    plan_text = q.explain()
    log("query-layer plan:\n" + plan_text)
    assert "R3" in plan_text, "planner must pick the ordered path"
    topq = q.execute()
    jax.block_until_ready((topq.keys, topq.count))
    best_q = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        topq = q.execute()
        jax.block_until_ready((topq.keys, topq.count))
        best_q = min(best_q, time.perf_counter() - t0)
    log(
        f"join+group-by+top10 [query-layer]: {best_q*1e3:.0f} ms "
        f"-> {N_B/best_q/1e6:.0f}M rows/s"
    )
    assert jax.device_get(topq.keys)[:10].tolist() == (
        jax.device_get(hot1.payloads)[:10].tolist()
    ), "query layer disagrees with the hand-built plan"
    assert jax.device_get(topq.count)[:10].tolist() == (
        jax.device_get(hot1.keys)[:10].tolist()
    )

    # the SQL surface must lower to the same plan (parse + analysis are
    # host-side; overhead must be noise) and agree on the result.
    # Free the A/B intermediates first: two kept aggregates + their
    # relation-sized group_of_row columns are ~2-3 GB of dead device memory
    # the extra execution below does not need.
    hot1_keys = jax.device_get(hot1.keys)[:10].tolist()
    hot1_pays = jax.device_get(hot1.payloads)[:10].tolist()
    best = results["ordered"][0]
    naive_ms = round(results["naive-resort"][0] * 1e3)
    # g/hot still alias the loop's last results and fields1/fields2 hold
    # g1/g2's five group columns — every reference must go or the HBM
    # stays pinned
    del results, g1, g2, hot1, hot2, topq, g, hot, fields1, fields2
    from partitionedhashjoin_tpu.sql import execute_sql, explain_sql

    sql = (
        "SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), "
        "MAX(b.payload) FROM b JOIN a USING (key) "
        "GROUP BY key ORDER BY count DESC LIMIT 10"
    )
    db = {"a": ta, "b": tb}
    assert "R3" in explain_sql(sql, db), (
        "SQL must lower to the ordered plan"
    )
    kw = dict(group_capacity=cap)
    rs = execute_sql(sql, db, **kw)  # warm
    best_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        rs = execute_sql(sql, db, **kw)
        best_s = min(best_s, time.perf_counter() - t0)
    log(
        f"join+group-by+top10 [sql]: {best_s*1e3:.0f} ms "
        f"-> {N_B/best_s/1e6:.0f}M rows/s"
    )
    assert rs.columns["key"].tolist() == hot1_pays, (
        "SQL disagrees with the hand-built plan"
    )
    assert rs.columns["count"].tolist() == hot1_keys

    print(json.dumps({
        "metric": f"query_join_groupby_rows_per_s_{N_A}x{N_B}_skew{SKEW}",
        "value": round(N_B / best),
        "unit": "rows/s",
        "vs_baseline": round(N_B / best / BASELINE_ROWS_PER_S, 3),
        "naive_resort_ms": naive_ms,
        "ordered_ms": round(best * 1e3),
        "query_layer_ms": round(best_q * 1e3),
        "sql_ms": round(best_s * 1e3),
    }))


if __name__ == "__main__":
    main()
