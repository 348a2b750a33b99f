#!/usr/bin/env python
"""Record a results grid on the current device, in the reference's schema.

Produces ``results/<tag>/partitions_*.txt`` JSON files plus ``figure.dat``
(same layout the reference commits under results/1.05 and results/1.25),
using the library directly in ONE process so compiles are paid once per
program instead of once per CLI invocation.

Usage:
    python scripts/record_results.py --outdir results/h100 --skew 1.05 \
        --primary 10000000 --secondary 200000000 --partitions 32 256 2048
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

# persistent compile cache: sweep points share programs
from partitionedhashjoin_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", required=True)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--primary", type=int, default=10_000_000)
    p.add_argument("--secondary", type=int, default=200_000_000)
    p.add_argument("--partitions", type=int, nargs="*", default=[32, 256, 2048])
    p.add_argument("--seed", type=int, default=20260816)
    p.add_argument(
        "--algos",
        nargs="*",
        default=["sort-merge", "no-partitioning", "radix"],
    )
    args = p.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    from partitionedhashjoin_tpu.config import (
        RadixClusteringConfiguration,
        ResultsFormatConfiguration,
    )
    from partitionedhashjoin_tpu.data.table import Table
    from partitionedhashjoin_tpu.ops.generators import sequential_table
    from partitionedhashjoin_tpu.utils.results import (
        HashJoinTimer,
        JSONResultsFormatter,
        Parameters,
    )
    import jax.numpy as jnp

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"device: {jax.devices()[0]}")
    t0 = time.perf_counter()
    table_a = sequential_table(args.primary)
    if args.skew == 0.0:
        # uniform-keys workload (BASELINE.json configs: "uniform keys"):
        # Zipf(0) = uniform; direct randint, no rejection machinery
        from partitionedhashjoin_tpu.ops.generators import uniform_keys

        ids = uniform_keys(
            jax.random.PRNGKey(args.seed), args.secondary, 1, args.primary
        )
    else:
        from partitionedhashjoin_tpu.ops.generators import zipf_keys

        ids = zipf_keys(
            jax.random.PRNGKey(args.seed), args.secondary, args.skew,
            args.primary,
        )
    table_b = Table(
        keys=ids, payloads=jnp.zeros((args.secondary,), jnp.int32)
    )
    jax.block_until_ready((table_a.keys, table_b.keys))
    log(f"generate: {time.perf_counter() - t0:.0f}s")

    formatter = JSONResultsFormatter(ResultsFormatConfiguration())

    def record(joiner, type_tag, filename, extra_params=()):
        params = Parameters()
        params.set_parameter("PrimaryRelationSize", str(args.primary))
        params.set_parameter("SecondaryRelationSize", str(args.secondary))
        params.set_parameter("Skew", f"{args.skew:.6f}")
        params.set_parameter("Type", type_tag)
        for k, v in extra_params:
            params.set_parameter(k, v)
        timer = HashJoinTimer(params)
        count = joiner.run(table_a, table_b)  # warmup/compile
        assert count == args.secondary, f"{type_tag}: {count}"
        t0 = time.perf_counter()
        joiner.run(table_a, table_b, timer)
        log(f"{filename}: {time.perf_counter() - t0:.2f}s total")
        path = os.path.join(args.outdir, filename)
        with open(path, "w") as f:
            formatter.format(f, timer.get_result())
        with open(path) as f:
            return json.load(f)

    columns = []
    if "sort-merge" in args.algos:
        from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

        doc = record(SortMergeJoiner(), "SortMerge", "sortmerge.txt")
        columns.append(("SortMerge", doc))
    if "no-partitioning" in args.algos:
        from partitionedhashjoin_tpu.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        doc = record(
            NoPartitioningHashJoiner(seed=7),
            "NoPartitioning",
            "partitions_1.txt",
        )
        columns.append(("NoPartitioning", doc))
    if "shuffle" in args.algos:
        from partitionedhashjoin_tpu.parallel.mesh import make_mesh, shard_table
        from partitionedhashjoin_tpu.parallel.shuffle import (
            DistributedShuffleJoiner,
        )

        mesh = make_mesh()  # all local devices
        a_sh = shard_table(table_a, mesh)
        b_sh = shard_table(table_b, mesh)
        # single_shard_fast_path=False: this artifact documents the exchange
        # machinery itself (bucketize + all_to_all + local join), so the
        # 1-shard recording must not elide it (shuffle.py fast path)
        joiner = DistributedShuffleJoiner(
            mesh, seed=7, single_shard_fast_path=False
        )
        saved = (table_a, table_b)
        table_a, table_b = a_sh, b_sh
        doc = record(
            joiner,
            "DistributedShuffle",
            "shuffle.txt",
            [("NumberOfShards", str(mesh.devices.size))],
        )
        columns.append((f"Shuffle_{mesh.devices.size}", doc))
        # pipelined exchange (pre-sorted merge primitive): chunked all_to_all
        # overlapped with per-chunk local joins
        piped = DistributedShuffleJoiner(
            mesh, seed=7, pipeline_chunks=4, single_shard_fast_path=False
        )
        doc = record(
            piped,
            "DistributedShufflePipelined",
            "shuffle_pipelined.txt",
            [("NumberOfShards", str(mesh.devices.size)),
             ("PipelineChunks", "4")],
        )
        columns.append((f"ShufflePiped_{mesh.devices.size}", doc))
        table_a, table_b = saved
    if "radix" in args.algos:
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        for parts in args.partitions:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(number_of_partitions=parts),
                seed=7,
            )
            doc = record(
                joiner,
                "RadixPartitioning",
                f"partitions_{parts}.txt",
                [("NumberOfPartitions", str(parts))],
            )
            columns.append((f"Radix_{parts}", doc))
    if "nopart-chained" in args.algos:
        # literal-table parity mode (chained-bucket probe), for the grid's
        # NoPartChained column
        from partitionedhashjoin_tpu.config import NoPartitioningConfiguration
        from partitionedhashjoin_tpu.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        doc = record(
            NoPartitioningHashJoiner(
                NoPartitioningConfiguration(mode="chained"), seed=7
            ),
            "NoPartitioning",
            "partitions_1_chained.txt",
            [("Mode", "chained")],
        )
        columns.append(("NoPartChained", doc))
    if "radix-2pass" in args.algos:
        # BASELINE configs[1]'s "two-pass radix cluster" point: chained
        # mode with partition_passes=2 — the Manegold multi-pass fan-out
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        for parts in args.partitions[:1]:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(
                    number_of_partitions=parts, mode="chained",
                    partition_passes=2,
                ),
                seed=7,
            )
            doc = record(
                joiner,
                "RadixPartitioning",
                f"partitions_{parts}_2pass.txt",
                [("NumberOfPartitions", str(parts)), ("Mode", "chained"),
                 ("PartitionPasses", "2")],
            )
            columns.append((f"Radix2Pass_{parts}", doc))
    if "radix-chained" in args.algos:
        # the reference-structured hash fan-out + chained tables mode, for
        # the parity record (the vmem mode above is the shipped default)
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        for parts in args.partitions[:1]:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(
                    number_of_partitions=parts, mode="chained"
                ),
                seed=7,
            )
            doc = record(
                joiner,
                "RadixPartitioning",
                f"partitions_{parts}_chained.txt",
                [("NumberOfPartitions", str(parts)), ("Mode", "chained")],
            )
            columns.append((f"RadixChained_{parts}", doc))

    lines = ["Phase " + " ".join(name for name, _ in columns)]
    for phase in ("partition", "build", "probe"):
        lines.append(
            phase + " " + " ".join(doc["results"][phase] for _, doc in columns)
        )
    with open(os.path.join(args.outdir, "figure.dat"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
