#!/usr/bin/env python3
"""Smoke test of the join engine on one NVIDIA GPU (``--multi``: four).

Runs the engine's main path once, in this one process, through the entry
points a user calls (``cli.main``, the joiners, ``Query``, ``execute_sql``)
at the reference workload: 10M sequential ⋈ 200M Zipf(1.05) int32 keys
(the reference's Readme.md:58 and the CLI defaults).  Every count and
aggregate is checked exactly against an oracle that is independent of the
code under test: the native multithreaded host join (``host_loader``) and
numpy, both run on host copies of the keys the GPU drew.

Phases (one summary line each, after the detail lines of its checks):

1. device      JAX sees a GPU; no CPU fallback.
2. cli         ``cli.main`` for each ``--join`` (and int64 keys), and the
               count of the joiner it builds on the same tables.
3. oracle      every join count equals the host oracle (and n_probe).
4. materialize ``SortMergeJoiner.run_materialize``, order "probe" and "key".
5. operators   staged filter + GROUP BY, the composed SQL query, and
               ``Query.aggregate()`` against numpy.
6. decisions   timings of the contenders that chose the engine's paths.

Each check line carries the card's name and power limit.  Times are the
first call (compilation included) and the median warm call.  The last line
of standard output is one JSON object naming the device; it is printed only
when every phase passed.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs: the shuffle join path only
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
SQL_TOP10 = (
    "SELECT key, COUNT(*), SUM(b.payload) FROM b JOIN a USING (key) "
    "WHERE b.payload % 2 = 0 GROUP BY key ORDER BY count DESC LIMIT 10"
)
#: the reference workload: 10M sequential build keys, 200M Zipf probe keys
PRIMARY, SECONDARY = 10_000_000, 200_000_000
#: Zipf skew of one card, and of four (heavy enough for hot-key replication)
SKEW, MULTI_SKEW = 1.05, 1.25
#: warm repetitions per timing; the median is reported
REPS = 3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=20260816)
    p.add_argument("--multi", action="store_true",
                   help="run only the four-GPU shuffle-join path")
    args = p.parse_args(argv)
    args.skew = MULTI_SKEW if args.multi else SKEW
    return args


def card_info() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi reports
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


class Report:
    """Collects check results and prints one line per check and phase."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list = []
        self._phase_checks: list = []

    def check(self, phase, name, got, want, first_s=None, warm_s=None):
        ok = got == want
        if not ok:
            self.failed.append(f"{phase}/{name}")
        self._phase_checks.append(ok)
        times = ""
        if first_s is not None:
            times = f" first_s={first_s:.3f} warm_s={warm_s:.4f}"
        print(f"[{phase}] {name}: got={got} oracle={want} "
              f"{'OK' if ok else 'MISMATCH'}{times} card=[{self.card}]",
              flush=True)
        return ok

    def fail(self, phase, name, err):
        self.failed.append(f"{phase}/{name}")
        self._phase_checks.append(False)
        print(f"[{phase}] {name}: FAILED {type(err).__name__}: {err} "
              f"card=[{self.card}]", flush=True)

    def timing(self, phase, name, first_s, warm_s):
        print(f"[{phase}] {name}: first_s={first_s:.3f} warm_s={warm_s:.4f} "
              f"card=[{self.card}]", flush=True)

    def phase_done(self, phase, seconds):
        n_ok = sum(self._phase_checks)
        n = len(self._phase_checks)
        status = "OK" if n_ok == n else "FAILED"
        print(f"PHASE {phase}: {status} {n_ok}/{n} checks equal their "
              f"oracle, {seconds:.1f} s card=[{self.card}]", flush=True)
        self._phase_checks = []


def timed(fn, reps: int):
    """(result, first_s, warm_median_s): the first call includes
    compilation; every call ends in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


# ---------------------------------------------------------------------------
# oracles (host side, independent of the engine)


def join_oracle(a_keys, b_keys) -> int:
    """Exact Get-semantics count by the native multithreaded host join."""
    import numpy as np

    from partitionedhashjoin_tpu.data import host_loader

    for k in (a_keys, b_keys):
        if k.size and (k.min() < np.iinfo(np.int32).min
                       or k.max() > np.iinfo(np.int32).max):
            raise ValueError("host oracle takes int32-range keys")
    return host_loader.host_join_count(
        np.asarray(a_keys, np.int32), np.asarray(b_keys, np.int32)
    )


def group_oracle(keys, pays):
    """{key: (count, sum mod 2^32 as int32, min, max)} for non-negative
    keys and strictly ascending payloads (so min/max are the first/last
    payload of each key — the engine's generators set payload = row)."""
    import numpy as np

    keys = np.asarray(keys, np.int64)
    pays = np.asarray(pays, np.int64)
    if pays.size > 1 and not (np.diff(pays) > 0).all():
        raise ValueError("group_oracle needs strictly ascending payloads")
    size = int(keys.max()) + 1 if keys.size else 1
    count = np.bincount(keys, minlength=size)
    # exact int64 sums from two float64 bincounts of 16-bit halves
    lo = np.bincount(keys, weights=(pays & 0xFFFF), minlength=size)
    hi = np.bincount(keys, weights=(pays >> 16), minlength=size)
    total = hi.astype(np.int64) * 65536 + lo.astype(np.int64)
    first = np.zeros(size, np.int64)
    last = np.zeros(size, np.int64)
    first[keys[::-1]] = pays[::-1]  # last write wins: the first payload
    last[keys] = pays
    present = np.nonzero(count)[0]
    return {
        "keys": present,
        "count": count[present],
        "sum": total[present].astype(np.int32),  # wraps mod 2^32
        "min": first[present],
        "max": last[present],
    }


def top_k_oracle(g: dict, k: int):
    """The k largest groups by count, with a flag saying whether the k-th
    count is tied past the cut (then only the counts are well defined)."""
    import numpy as np

    order = np.argsort(-g["count"], kind="stable")
    cut = order[:k]
    tied = len(order) > k and g["count"][order[k - 1]] == g["count"][order[k]]
    return cut, tied


# ---------------------------------------------------------------------------
# phases


def _tables(args):
    from partitionedhashjoin_tpu import cli
    from partitionedhashjoin_tpu.utils import logger as logging_utils

    config, _ = cli.parse_arguments(_cli_argv(args, "sort-merge"))
    return cli.generate_tables(config, logging_utils.get_new_logger("Smoke"))


def _cli_argv(args, join):
    return [
        "--primary", str(PRIMARY), "--secondary", str(SECONDARY),
        "--skew", str(args.skew), "--seed", str(args.seed), "--join", join,
        "--output", "stdout", "--log", "warning",
    ]


CLI_JOINS = (
    ("sort-merge", []),
    ("no-partitioning", []),
    ("radix-partitioning", ["--partitions", "256"]),
    ("planned", []),
    ("sort-merge", ["--key-dtype", "int64"]),
)


def phase_cli(args, rep: Report, oracle: int):
    """Phases 2 and 3: each CLI join end to end, then the joiner it builds
    on the same tables, its count checked against the host oracle."""
    import jax
    import numpy as np

    from partitionedhashjoin_tpu import cli
    from partitionedhashjoin_tpu.utils import logger as logging_utils

    log = logging_utils.get_new_logger("Smoke")
    counts = {}
    for join, extra in CLI_JOINS:
        name = join + ("-int64" if extra[:1] == ["--key-dtype"] else "")
        argv = _cli_argv(args, join) + extra
        try:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            print(f"[cli] cli.main({name}) rc={rc} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if rc != 0:
                raise RuntimeError(f"cli.main returned {rc}")
            config, ns = cli.parse_arguments(argv)
            a, b = cli.generate_tables(config, log)
            params = cli._base_parameters(config)
            joiner, ta, tb = cli.build_joiner(join, config, ns, params, a, b)
            count, first, warm = timed(lambda: joiner.run(ta, tb), REPS)
            want = oracle
            if name.endswith("int64"):
                # the int64 draws are their own; the oracle runs on them
                want = join_oracle(np.asarray(a.keys), np.asarray(b.keys))
            counts[name] = (count, want)
            rep.check("cli", f"{name} count", count, want, first, warm)
        except Exception as e:  # noqa: BLE001 - reported as a failed check
            rep.fail("cli", name, e)
        finally:
            jax.config.update("jax_enable_x64", False)
    return counts


def phase_materialize(args, rep: Report, a, b, oracle: int):
    import jax.numpy as jnp

    from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

    joiner = SortMergeJoiner()
    for order in ("probe", "key"):
        try:
            def run():
                jt = joiner.run_materialize(a, b, order=order)
                live = jnp.arange(jt.keys.shape[0]) < jt.count
                # sequential_table sets payload = row = key - 1
                pay_ok = jnp.all(
                    jnp.where(live, jt.payloads_a == jt.keys - 1, True)
                )
                return jt.count, pay_ok
            (count, pay_ok), first, warm = timed(run, REPS)
            rep.check("materialize", f"order={order} count", int(count),
                      oracle, first, warm)
            rep.check("materialize", f"order={order} pay_a == key - 1",
                      bool(pay_ok), True)
        except Exception as e:  # noqa: BLE001
            rep.fail("materialize", f"order={order}", e)


def phase_operators(args, rep: Report, a, b, b_keys_np, b_pay_np):
    import jax
    import numpy as np

    from partitionedhashjoin_tpu.ops.aggregate import (
        filter_sort_aggregate_staged,
    )
    from partitionedhashjoin_tpu.query import scan
    from partitionedhashjoin_tpu.sql import execute_sql

    even = (b_pay_np % 2) == 0
    g_want = group_oracle(b_keys_np[even], b_pay_np[even])

    try:
        def staged():
            g, n_sel = filter_sort_aggregate_staged(
                b, lambda k, p: p % 2 == 0
            )
            return g, n_sel
        (g, n_sel), first, warm = timed(staged, REPS)
        num = int(g.num_groups)
        rep.check("operators", "staged GROUP BY selected rows",
                  int(n_sel), int(even.sum()), first, warm)
        rep.check("operators", "staged GROUP BY groups", num,
                  len(g_want["keys"]))
        got = {f: np.asarray(jax.device_get(getattr(g, f)))[:num]
               for f in ("keys", "count", "sum", "min", "max")}
        for f in ("keys", "count", "sum", "min", "max"):
            rep.check("operators", f"staged GROUP BY {f} all equal",
                      bool(np.array_equal(got[f], g_want[f])), True)
        del g
    except Exception as e:  # noqa: BLE001
        rep.fail("operators", "staged GROUP BY", e)

    try:
        r, first, warm = timed(
            lambda: execute_sql(SQL_TOP10, tables={"a": a, "b": b}),
            REPS,
        )
        cut, tied = top_k_oracle(g_want, 10)
        cols = list(r.columns)
        got_count = np.asarray(r.columns[cols[1]])
        rep.check("operators", "SQL top-10 counts",
                  got_count.tolist(), g_want["count"][cut].tolist(),
                  first, warm)
        if not tied:
            rep.check("operators", "SQL top-10 keys",
                      np.asarray(r.columns[cols[0]]).tolist(),
                      g_want["keys"][cut].tolist())
            rep.check("operators", "SQL top-10 sums",
                      np.asarray(r.columns[cols[2]]).tolist(),
                      g_want["sum"][cut].tolist())
    except Exception as e:  # noqa: BLE001
        rep.fail("operators", "SQL top-10", e)

    try:
        def agg():
            s = scan(b).filter(lambda k, p: p % 2 == 0).aggregate()
            return s.count, s.sum, s.min, s.max
        (c, s, mn, mx), first, warm = timed(agg, REPS)
        sel = b_pay_np[even].astype(np.int64)
        rep.check("operators", "Query.aggregate count", int(c),
                  int(sel.size), first, warm)
        rep.check("operators", "Query.aggregate sum (mod 2^32)", int(s),
                  int(np.int64(sel.sum()).astype(np.int32)))
        rep.check("operators", "Query.aggregate min", int(mn), int(sel.min()))
        rep.check("operators", "Query.aggregate max", int(mx), int(sel.max()))
    except Exception as e:  # noqa: BLE001
        rep.fail("operators", "Query.aggregate", e)


def kernel_times(trace_dir: str):
    """(total_ns, top) over the GPU planes of the newest trace in
    ``trace_dir``: the device time of every kernel, and the ten costliest
    kernels by name."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    data = ProfileData.from_file(paths[-1])
    per_name: dict = {}
    total = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                dur = int(ev.duration_ns)
                total += dur
                per_name[ev.name] = per_name.get(ev.name, 0) + dur
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return total, top


def phase_decisions(args, rep: Report, a, b):
    """Phase 6: the contenders behind the engine's path choices, timed in
    this one process on this one card."""
    import jax
    import jax.numpy as jnp

    from partitionedhashjoin_tpu.config import (
        NoPartitioningConfiguration,
        RadixClusteringConfiguration,
    )
    from partitionedhashjoin_tpu.ops import merge_join
    from partitionedhashjoin_tpu.ops.aggregate import (
        filter_sort_aggregate,
        filter_sort_aggregate_staged,
        sort_aggregate,
    )
    from partitionedhashjoin_tpu.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )
    from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner
    from partitionedhashjoin_tpu.ops.sort_merge import sort_merge_count

    ak, bk = a.keys, b.keys
    sort1 = jax.jit(lambda x: jax.lax.sort((x,), num_keys=1,
                                           is_stable=False)[0])

    def search_count(a_s, q, method):
        idx = jnp.searchsorted(a_s, q, method=method)
        idx = jnp.minimum(idx, a_s.shape[0] - 1)
        return jnp.sum((a_s[idx] == q).astype(jnp.int32))

    def two_run(method, sort_probe=True):
        @jax.jit
        def f(x, y):
            a_s = jax.lax.sort((x,), num_keys=1, is_stable=False)[0]
            if sort_probe:
                y = jax.lax.sort((y,), num_keys=1, is_stable=False)[0]
            return search_count(a_s, y, method)
        return f

    def search_only(method):
        return jax.jit(lambda a_s, q: search_count(a_s, q, method))

    from partitionedhashjoin_tpu.ops import windowed_probe

    block = windowed_probe.BLOCK

    def plain_windowed(a_s, b_s, steps):
        # the same block-window search in plain XLA: per-row window
        # bounds from the per-block searches, then ``steps`` rounds
        n_a, n_b = a_s.shape[0], b_s.shape[0]
        nb = -(-n_b // block)
        last = jnp.minimum(jnp.arange(nb) * block + block - 1, n_b - 1)
        lo = jnp.searchsorted(a_s, b_s[::block]).astype(jnp.int32)
        hi = jnp.searchsorted(a_s, b_s[last], side="right").astype(jnp.int32)
        row_blk = jnp.arange(n_b, dtype=jnp.int32) // block
        left, right = lo[row_blk], hi[row_blk]
        for _ in range(steps):
            active = left < right
            mid = left + (right - left) // 2
            v = a_s[jnp.minimum(mid, n_a - 1)]
            go = active & (v < b_s)
            left, right = (jnp.where(go, mid + 1, left),
                           jnp.where(active & ~go, mid, right))
        hit = (left < hi[row_blk]) & (a_s[jnp.minimum(left, n_a - 1)] == b_s)
        return jnp.sum(hit.astype(jnp.int32))

    def window_steps(a_s, b_s):
        n_b = b_s.shape[0]
        nb = -(-n_b // block)
        last = jnp.minimum(jnp.arange(nb) * block + block - 1, n_b - 1)
        w = (jnp.searchsorted(a_s, b_s[last], side="right")
             - jnp.searchsorted(a_s, b_s[::block]))
        return int(jnp.max(w)).bit_length()

    from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

    contenders = [
        ("count flagship SortMergeJoiner.count",
         lambda: SortMergeJoiner.count(ak, bk)),
        ("count (a) concat 2-key sort + cummax",
         lambda: sort_merge_count(ak, bk)),
        ("sort 10M build (1-key)", lambda: sort1(ak)),
        ("sort 200M probe (1-key)", lambda: sort1(bk)),
    ]
    for m in ("scan", "scan_unrolled", "sort"):
        f = two_run(m)
        contenders.append((f"count (b) two-run, searchsorted {m}",
                           lambda f=f: f(ak, bk)))
    for m in ("scan_unrolled", "sort"):
        f = two_run(m, sort_probe=False)
        contenders.append((
            f"count (c) build sort only, unsorted probe, {m}",
            lambda f=f: f(ak, bk)))
    a_sorted, b_sorted = sort1(ak), sort1(bk)
    steps = window_steps(a_sorted, b_sorted)
    print(f"[decisions] widest {block}-row probe window needs {steps} "
          "rounds", flush=True)
    f = jax.jit(functools.partial(plain_windowed, steps=steps))
    contenders.append((f"search only, plain XLA windowed ({steps} rounds)",
                       lambda f=f: f(a_sorted, b_sorted)))
    contenders.append(("search only, Triton windowed probe",
                       lambda: windowed_probe.windowed_count(a_sorted,
                                                             b_sorted)))
    for m in ("scan", "scan_unrolled", "sort"):
        f = search_only(m)
        contenders.append((f"search only (sorted probe) {m}",
                           lambda f=f: f(a_sorted, b_sorted)))
    f = search_only(merge_join.SEARCH_METHOD)
    contenders.append(("search only (unsorted probe) "
                       f"{merge_join.SEARCH_METHOD}",
                       lambda f=f: f(a_sorted, bk)))
    for mode in ("vmem", "chained"):
        j = RadixHashJoiner(RadixClusteringConfiguration(
            number_of_partitions=256, mode=mode), seed=args.seed)
        contenders.append((f"radix P=256 mode={mode}",
                           lambda j=j: j.run(a, b)))
        j = NoPartitioningHashJoiner(
            NoPartitioningConfiguration(mode=mode), seed=args.seed)
        contenders.append((f"no-partitioning mode={mode}",
                           lambda j=j: j.run(a, b)))
    for comp in ("sort", "scatter"):
        contenders.append((f"GROUP BY 200M compaction={comp}",
                           lambda c=comp: sort_aggregate(b, compaction=c)))
    pred = lambda k, p: p % 2 == 0  # noqa: E731
    contenders.append(("filter+GROUP BY fused",
                       lambda: filter_sort_aggregate(b, pred)))
    contenders.append(("filter+GROUP BY staged",
                       lambda: filter_sort_aggregate_staged(b, pred)))

    for name, fn in contenders:
        try:
            _, first, warm = timed(fn, REPS)
            rep.timing("decisions", name, first, warm)
        except Exception as e:  # noqa: BLE001
            rep.fail("decisions", name, e)

    # traces: the plain two-run join (the search's share of its device
    # time decided whether a kernel was written) and the flagship count
    from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

    for name, fn in (
        ("plain two-run", two_run(merge_join.SEARCH_METHOD)),
        ("flagship SortMergeJoiner.count", SortMergeJoiner.count),
    ):
        try:
            jax.block_until_ready(fn(ak, bk))
            trace_dir = os.path.join(
                OUT_DIR, "trace_" + name.split()[0].replace("-", "_")
            )
            with jax.profiler.trace(trace_dir):
                for _ in range(REPS):
                    jax.block_until_ready(fn(ak, bk))
            total, top = kernel_times(trace_dir)
            print(f"[decisions] {name} trace: {REPS} runs, "
                  f"device_ns={total} card=[{rep.card}]", flush=True)
            for kname, ns in top:
                print(f"[decisions]   kernel share={ns / total:.4f} "
                      f"ns={ns} {kname[:90]}", flush=True)
        except Exception as e:  # noqa: BLE001
            rep.fail("decisions", f"{name} trace", e)


def run_single(args, rep: Report) -> None:
    import jax
    import numpy as np

    from partitionedhashjoin_tpu.ops import merge_join

    t0 = time.perf_counter()
    a, b = _tables(args)
    a_np = np.asarray(jax.device_get(a.keys))
    b_np = np.asarray(jax.device_get(b.keys))
    b_pay_np = np.asarray(jax.device_get(b.payloads))
    oracle = join_oracle(a_np, b_np)
    print(f"[oracle] host join count {oracle} in "
          f"{time.perf_counter() - t0:.1f} s (generation included)",
          flush=True)

    t0 = time.perf_counter()
    counts = phase_cli(args, rep, oracle)
    rep.phase_done("2 cli", time.perf_counter() - t0)

    t0 = time.perf_counter()
    rep.check("oracle", "host oracle == n_probe (keys drawn in [1, n_build])",
              oracle, SECONDARY)
    for name, (got, want) in counts.items():
        rep.check("oracle", f"{name} == host oracle", got, want)
    rep.phase_done("3 oracle", time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_materialize(args, rep, a, b, oracle)
    rep.phase_done("4 materialize", time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_operators(args, rep, a, b, b_np, b_pay_np)
    rep.phase_done("5 operators", time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_decisions(args, rep, a, b)
    rep.phase_done("6 decisions", time.perf_counter() - t0)

    # memory: the flagship probe program, and the window's peak
    a_sorted, max_in_a = merge_join._prepare_build_i32(a.keys)
    compiled = merge_join._probe_prepared_i32.lower(
        a_sorted, max_in_a, b.keys
    ).compile()
    print(f"[memory] two-run probe program: {compiled.memory_analysis()}",
          flush=True)


def run_multi(args, rep: Report) -> None:
    """The four-GPU path: the shuffle join one-shot and pipelined, the SQL
    COUNT over the mesh, and the distributed GROUP BY."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from partitionedhashjoin_tpu.parallel import shuffle as sh
    from partitionedhashjoin_tpu.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )
    from partitionedhashjoin_tpu.parallel.mesh import make_mesh, shard_table
    from partitionedhashjoin_tpu.sql import execute_sql

    t0 = time.perf_counter()
    mesh = make_mesh(4)
    print(f"[multi] mesh {mesh.devices.tolist()} axis {mesh.axis_names}",
          flush=True)
    a, b = _tables(args)
    a_np = np.asarray(jax.device_get(a.keys))
    b_np = np.asarray(jax.device_get(b.keys))
    oracle = join_oracle(a_np, b_np)
    rep.check("multi", "host oracle == n_probe", oracle, SECONDARY)
    a_sh, b_sh = shard_table(a, mesh), shard_table(b, mesh)
    del a, b

    for chunks in (1, 4):
        try:
            j = sh.DistributedShuffleJoiner(
                mesh, seed=args.seed, pipeline_chunks=chunks
            )
            count, first, warm = timed(lambda: j.run(a_sh, b_sh), REPS)
            rep.check("multi", f"shuffle join pipeline_chunks={chunks}",
                      count, oracle, first, warm)
        except Exception as e:  # noqa: BLE001
            rep.fail("multi", f"shuffle join pipeline_chunks={chunks}", e)

    try:
        j = sh.DistributedShuffleJoiner(mesh, seed=args.seed)
        hot_keys, hot_valid = sh.plan_hot_keys(
            b_sh.keys, 16_384, 64, 0.005, seed=int(j._hot_seed)
        )
        n_a, n_b = a_sh.size, b_sh.size
        lowered = sh._exchange.lower(
            mesh, a_sh.keys, a_sh.payloads, b_sh.keys, b_sh.payloads,
            j._shard_seed, hot_keys, hot_valid, j._hot_seed,
            j._capacity(n_a // 4, 2.0), j._capacity(n_b // 4, 2.0), 64, True,
        )
        print(f"[multi] shuffle exchange step: "
              f"{lowered.compile().memory_analysis()}", flush=True)
    except Exception as e:  # noqa: BLE001
        rep.fail("multi", "exchange memory_analysis", e)

    try:
        r, first, warm = timed(lambda: execute_sql(
            "SELECT COUNT(*) FROM b JOIN a USING (key)",
            tables={"a": a_sh, "b": b_sh}, mesh=mesh,
        ), REPS)
        rep.check("multi", "SQL COUNT over the mesh",
                  int(r.columns["count"][0]), oracle, first, warm)
    except Exception as e:  # noqa: BLE001
        rep.fail("multi", "SQL COUNT over the mesh", e)

    try:
        op = DistributedAggregateOperator(mesh, seed=args.seed)
        g, first, warm = timed(lambda: op.run(b_sh), REPS)
        counts = np.bincount(b_np)
        rep.check("multi", "distributed GROUP BY groups", int(g.num_groups),
                  int(np.count_nonzero(counts)), first, warm)
        rep.check("multi", "distributed GROUP BY total count",
                  int(jax.device_get(jnp.sum(g.count))), SECONDARY)
        num = int(g.num_groups)
        keys = np.asarray(jax.device_get(g.keys))[:num]
        cnt = np.asarray(jax.device_get(g.count))[:num]
        rep.check("multi", "distributed GROUP BY per-key counts",
                  bool(np.array_equal(cnt, counts[keys])), True)
    except Exception as e:  # noqa: BLE001
        rep.fail("multi", "distributed GROUP BY", e)
    rep.phase_done("multi", time.perf_counter() - t0)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    try:
        from partitionedhashjoin_tpu.utils.compile_cache import (
            enable_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: the engine is not importable here ({e})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    import jax

    t0 = time.perf_counter()
    devices = jax.devices()
    dev = devices[0]
    want = 4 if args.multi else 1
    if dev.platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX sees "
              f"{len(devices)} {dev.platform} device(s)", file=sys.stderr)
        return 1
    card = card_info()
    print(card, flush=True)
    rep = Report(card)
    print(f"[device] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)} jax={jax.__version__} card=[{card}]",
          flush=True)
    rep.phase_done("1 device", time.perf_counter() - t0)
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.multi:
        run_multi(args, rep)
    else:
        run_single(args, rep)
    stats = dev.memory_stats() or {}
    print(f"[memory] peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
          f"card=[{card}]", flush=True)
    if rep.failed:
        print(f"chip_smoke: failed checks: {rep.failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
