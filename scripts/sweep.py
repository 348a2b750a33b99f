#!/usr/bin/env python
"""Benchmark sweep driver — the reference's scripts/generate.sh equivalent.

Runs one no-partitioning (or sort-merge) configuration plus radix joins over
a partition-count sweep (generate.sh:70-79 sweeps P in 32..8192), collects
the per-run JSON results (the CLI's schema matches the reference's), and
assembles ``figure.dat`` in the same column-stacked layout the reference
feeds to gnuplot (phase rows x configuration columns, scripts/figure.plot).

Unlike generate.sh, the sweep honours the requested skew for every run — the
reference hard-codes ``--skew 1.05`` in its radix loop (generate.sh:78), so
its published results/1.25 radix grid is actually skew-1.05 data (SURVEY.md
appendix 3).

Usage:
    python scripts/sweep.py --outdir results/1.05 --skew 1.05 \
        --primary 10000000 --secondary 200000000 \
        --partitions 32 64 128 256 512 1024 2048 4096 8192
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(outfile: str, argv: list[str]) -> dict:
    cmd = [
        sys.executable,
        "-m",
        "partitionedhashjoin_tpu",
        "--output",
        "file",
        "--filename",
        outfile,
    ] + argv
    # PREPEND the repo to PYTHONPATH — replacing it would drop the
    # environment's own site hooks from the child process
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    with open(outfile) as f:
        return json.load(f)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", required=True)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--primary", type=int, default=10_000_000)
    p.add_argument("--secondary", type=int, default=200_000_000)
    p.add_argument(
        "--partitions",
        type=int,
        nargs="*",
        default=[32, 64, 128, 256, 512, 1024, 2048, 4096, 8192],
    )
    p.add_argument("--seed", type=int, default=20260816)
    p.add_argument(
        "--base-join",
        default="no-partitioning",
        choices=("no-partitioning", "sort-merge"),
        help="the non-radix comparison column (generate.sh runs one "
        "no-partitioning row, generate.sh:69)",
    )
    args = p.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    common = [
        "--primary", str(args.primary),
        "--secondary", str(args.secondary),
        "--skew", str(args.skew),
        "--seed", str(args.seed),
        "--log", "info",
    ]

    columns: list[tuple[str, dict]] = []
    doc = run_cli(
        os.path.join(args.outdir, "partitions_1.txt"),
        common + ["--join", args.base_join],
    )
    columns.append((doc["parameters"]["Type"], doc))

    for parts in args.partitions:
        doc = run_cli(
            os.path.join(args.outdir, f"partitions_{parts}.txt"),
            common + ["--join", "radix-partitioning", "--partitions", str(parts)],
        )
        columns.append((f"Radix_{parts}", doc))

    # figure.dat: header row of config names, then one row per phase
    # (column-stacked histogram layout, scripts/figure.plot:31)
    lines = ["Phase " + " ".join(name for name, _ in columns)]
    for phase in ("partition", "build", "probe"):
        lines.append(
            phase
            + " "
            + " ".join(doc["results"][phase] for _, doc in columns)
        )
    dat = os.path.join(args.outdir, "figure.dat")
    with open(dat, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {dat}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
