#!/usr/bin/env python
"""Pipelined (exchange overlapped with probe) vs one-shot shuffle join on
the 8-device virtual mesh.

Real collective boundaries: ``all_to_all`` lowers and executes exactly as
on a device mesh; host threads stand in for links, so absolute link bandwidth is not
representative but the PROGRAM STRUCTURE (can XLA start chunk k+1's
exchange before chunk k's local count finishes?) is.  Measures, at fixed
total rows, the one-shot exchange (pipeline_chunks=1) against round-robin
chunked exchanges K in {2, 4, 8}.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_overlap.py [--build 2000000] [--probe 8000000]

Prints one row per configuration and a JSON tail for docs/SCALING.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

import numpy as np  # noqa: E402


def _best_of(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--build", type=int, default=2_000_000)
    p.add_argument("--probe", type=int, default=8_000_000)
    p.add_argument("--chunks", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--seed", type=int, default=20260817)
    args = p.parse_args()

    from partitionedhashjoin_tpu.data.table import make_table
    from partitionedhashjoin_tpu.ops.generators import (
        sequential_table,
        zipf_table,
    )
    from partitionedhashjoin_tpu.parallel.mesh import make_mesh, shard_table
    from partitionedhashjoin_tpu.parallel.shuffle import (
        DistributedShuffleJoiner,
    )

    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    print(f"devices: {ndev} ({jax.devices()[0].platform})", file=sys.stderr)

    a = sequential_table(args.build)
    b = zipf_table(
        args.probe, alpha=args.skew, key_range=(1, args.build),
        seed=args.seed,
    )
    a_sh = shard_table(a, mesh)
    b_sh = shard_table(b, mesh)

    rows = []
    for k in args.chunks:
        joiner = DistributedShuffleJoiner(
            mesh, seed=5, pipeline_chunks=k, single_shard_fast_path=False
        )
        count = joiner.run(a_sh, b_sh)  # warmup + compile + exactness
        assert count == args.probe, (k, count)
        t = _best_of(lambda: joiner.run(a_sh, b_sh), args.reps)
        label = "one-shot" if k == 1 else f"pipelined K={k}"
        print(
            f"{label:>14}: {t * 1e3:8.1f} ms"
            f"  ({args.probe / t / 1e6:6.1f}M rows/s)",
            file=sys.stderr,
        )
        rows.append({"chunks": k, "seconds": round(t, 4)})

    base = next(r["seconds"] for r in rows if r["chunks"] == 1)
    best = min(rows, key=lambda r: r["seconds"])
    print(json.dumps({
        "metric": f"overlap_pipelined_vs_oneshot_S{ndev}",
        "rows": rows,
        "best_chunks": best["chunks"],
        "best_speedup_vs_oneshot": round(base / best["seconds"], 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
