"""Benchmark: the reference workload (10M ⋈ 200M, Zipf skew) on one device.

Mirrors the reference driver's measurement (src/main.cpp:210-293: generate →
join → emit JSON) and prints ONE machine-readable JSON line:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

The headline metric is end-to-end join throughput (probe rows per second over
all join phases) for the fastest joiner on the reference's default workload
(10M sequential primary ⋈ 200M Zipf(1.05) secondary, Readme.md:58).
``vs_baseline`` compares against the reference's best end-to-end grid point:
radix join at P=2048, 820+17+359 = 1196 ms for 200M rows = 167.2M rows/s on
an 8C/16T Ryzen 3700X (BASELINE.md, results/1.05/).

Per-phase roofline accounting goes to stderr and the JSON line: achieved
GB/s against the device's memory peak (utils/profiling.HBM_PEAK_GBPS, keyed
by device kind; an unlisted device is an error) on a SINGLE-TOUCH traffic
basis — bytes every algorithm must move at least once (read+write each
relation per sort phase, read the probe + build per probe phase).  A
multi-pass sort therefore shows a low fraction-of-peak by construction.
The JSON line names the device it ran on (platform, kind, count).

Env knobs: PHJ_BENCH_PRIMARY, PHJ_BENCH_SECONDARY, PHJ_BENCH_SKEW,
PHJ_BENCH_ALGOS (comma list: sort-merge,radix,no-partitioning).
Details per phase go to stderr; stdout carries only the JSON line.
"""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from partitionedhashjoin_tpu.data.table import Table  # noqa: E402
from partitionedhashjoin_tpu.ops.generators import sequential_table  # noqa: E402
from partitionedhashjoin_tpu.utils import profiling  # noqa: E402
from partitionedhashjoin_tpu.utils.results import (  # noqa: E402
    HashJoinTimer,
    Parameters,
)

#: Reference best end-to-end throughput (rows/s): radix P=2048 at skew 1.05,
#: 1196 ms total for 200M probe rows (BASELINE.md grid).
BASELINE_ROWS_PER_S = 200e6 / 1.196


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


#: Best result seen so far, updated as each algo completes; the deadline
#: watchdog emits this if the run would otherwise overshoot the caller's
#: timeout (a cold-cache compile chain can exceed it).
_progress: dict = {"best": None, "done": False, "stage": "import"}
#: Exactly one emitter: main and the watchdog race near the deadline, and
#: two JSON lines (or a print truncated by os._exit) would corrupt the
#: driver's parse — claim before emitting.
_emit_lock = threading.Lock()


def _claim_emit() -> bool:
    with _emit_lock:
        if _progress["done"]:
            return False
        _progress["done"] = True
        return True


def _emit(best, extra) -> None:
    algo, rows_per_s = best
    payload = {
        "metric": f"join_rows_per_s_{algo}_{extra['n_a']}x{extra['n_b']}"
        f"_skew{extra['skew']}",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
        **{k: v for k, v in extra.items() if k not in ("n_a", "n_b", "skew")},
    }
    print(json.dumps(payload), flush=True)


def _watchdog(deadline_s: float) -> None:
    """Emit the best completed measurement if the run overshoots deadline_s.

    A fully cold compile cache can push the whole run past the caller's
    timeout; a partial-but-honest JSON line (first algo only) beats a
    killed process with no line at all.
    The thread never fires when main() finishes in time (done flag).
    """
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        time.sleep(5)
        if _progress["done"]:
            return
    best = _progress.get("best")
    if best is not None:
        if not _claim_emit():
            return  # main got there first
        log(f"DEADLINE hit at stage {_progress['stage']}; emitting best-so-far")
        _emit(best, _progress["extra"])
        os._exit(0)
    if _progress["done"]:
        return
    log(f"DEADLINE hit at stage {_progress['stage']}; nothing measured yet")
    os._exit(3)


def make_joiner(name: str, seed: int):
    if name == "sort-merge":
        from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

        return SortMergeJoiner()
    if name == "planned":
        # stats-driven planner (ops/planner.py).  NOT in the default algo
        # list: on this workload its dense-build interval plan collapses
        # the probe to one streaming pass, which measures the planner, not
        # the general join.  Run via PHJ_BENCH_ALGOS=planned.
        from partitionedhashjoin_tpu.ops.planner import PlannedJoiner

        return PlannedJoiner()
    if name == "no-partitioning":
        from partitionedhashjoin_tpu.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        return NoPartitioningHashJoiner(seed=seed)
    if name == "radix":
        from partitionedhashjoin_tpu.config import RadixClusteringConfiguration
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        return RadixHashJoiner(
            RadixClusteringConfiguration(number_of_partitions=256), seed=seed
        )
    if name == "radix-chained":
        from partitionedhashjoin_tpu.config import RadixClusteringConfiguration
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        return RadixHashJoiner(
            RadixClusteringConfiguration(
                number_of_partitions=256, mode="chained"
            ),
            seed=seed,
        )
    raise ValueError(f"unknown algo {name}")


def phase_rooflines(algo: str, n_a: int, n_b: int, r):
    """(phase, seconds, single-touch bytes) rows for the measured result.

    Single-touch accounting: bytes the phase must move at least once —
    partition/sort phases read+write each participating relation once;
    probe phases read the probe side once plus the build structure.
    """
    rows = []
    part_s = r.get_partitioning_phase_duration()
    build_s = r.get_build_phase_duration()
    probe_s = r.get_probe_phase_duration()
    if algo == "radix":  # vmem mode: partition = both sorts, probe = search
        if part_s:
            rows.append(("partition(sorts)", part_s, 2 * 4 * (n_a + n_b)))
        if probe_s:
            rows.append(("probe(search)", probe_s, 4 * (n_b + 2 * n_a)))
    elif algo == "sort-merge":  # one fused phase reported as probe
        if probe_s:
            rows.append(("total(sorts+search)", probe_s, 3 * 4 * (n_a + n_b)))
    else:
        if part_s:
            rows.append(("partition", part_s, 2 * 4 * (n_a + n_b)))
        if build_s:
            rows.append(("build", build_s, 2 * 4 * n_a))
        if probe_s:
            rows.append(("probe", probe_s, 4 * (n_b + n_a)))
    return rows


def main() -> None:
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    algos = os.environ.get("PHJ_BENCH_ALGOS", "sort-merge,radix").split(",")
    deadline_s = float(os.environ.get("PHJ_BENCH_DEADLINE_S", 2400))
    threading.Thread(
        target=_watchdog, args=(deadline_s,), daemon=True
    ).start()
    _progress["stage"] = "device-init"
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    log(f"device: {device}; workload {n_a} ⋈ {n_b}, skew {skew}")
    _progress["stage"] = "generate"

    t0 = time.perf_counter()
    table_a = sequential_table(n_a)
    # probe keys are sampled on the device (rejection sampler)
    from partitionedhashjoin_tpu.ops.generators import zipf_keys

    ids = zipf_keys(jax.random.PRNGKey(20260816), n_b, skew, n_a)
    table_b = Table(keys=ids, payloads=jnp.zeros((n_b,), jnp.int32))
    jax.block_until_ready((table_a.keys, table_b.keys))
    log(f"generate: {time.perf_counter() - t0:.1f}s")

    best = None
    roofline_json = {}
    for algo in algos:
        _progress["stage"] = f"{algo}-warmup"
        joiner = make_joiner(algo, seed=7)
        count = joiner.run(table_a, table_b)  # warmup/compile
        assert count == n_b, f"{algo}: count {count} != {n_b}"
        _progress["stage"] = f"{algo}-measure"
        timer = HashJoinTimer(Parameters())
        t0 = time.perf_counter()
        count = joiner.run(table_a, table_b, timer)
        total_s = time.perf_counter() - t0
        assert count == n_b
        r = timer.get_result()
        log(
            f"{algo}: total {total_s * 1e3:.0f} ms "
            f"(partition {r.get_partitioning_phase_duration() * 1e3:.0f} / "
            f"build {r.get_build_phase_duration() * 1e3:.0f} / "
            f"probe {r.get_probe_phase_duration() * 1e3:.0f} ms) -> "
            f"{n_b / total_s / 1e6:.0f}M rows/s"
        )
        for phase, secs, nbytes in phase_rooflines(algo, n_a, n_b, r):
            rep = profiling.roofline(secs, nbytes, dev.device_kind)
            log(f"  roofline {phase}: {rep}")
            roofline_json[f"{algo}.{phase}"] = round(
                rep.fraction_of_peak, 4
            )
        rows_per_s = n_b / total_s
        if best is None or rows_per_s > best[1]:
            best = (algo, rows_per_s)
        _progress["extra"] = {
            "n_a": n_a,
            "n_b": n_b,
            "skew": skew,
            "device": device,
            "roofline_fraction_single_touch": dict(roofline_json),
        }
        _progress["best"] = best

    algo, rows_per_s = best
    log(f"best: {algo}")
    if _claim_emit():
        _emit(best, _progress["extra"])


if __name__ == "__main__":
    main()
