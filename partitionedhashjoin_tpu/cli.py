"""CLI driver with `phjoin` flag and output parity.

Counterpart of src/main.cpp:141-293: parse flags → init logger →
generate relations → run the selected join → render timing JSON.  Flags
mirror parseArguments (main.cpp:144-186):

    --primary --secondary --skew --join --partitions --log --format --unit
    --output --filename

Engine extensions: ``--join sort-merge`` (the flagship single-device joiner,
ops/sort_merge.py), ``--join planned`` (stats-driven plan selection,
ops/planner.py) and ``--join shuffle`` (the mesh-distributed joiner,
parallel/shuffle.py, with ``--shards``); ``--output stdout``; ``--seed`` for
reproducible data generation (the reference seeds from random_device,
src/Common/Random.cpp:32-41).

Output JSON schema matches the reference exactly
({id, parameters{...}, results{partition,build,probe}}, results/1.05/*.txt),
including ``Skew`` rendered with six decimals (C++ std::to_string).  The
``Type`` tag uses the corrected "RadixPartitioning" spelling — the reference
emits the typo "RadixParitioning" (main.cpp:127; SURVEY.md appendix 9).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from partitionedhashjoin_tpu.config import (
    Configuration,
    JoinAlgorithmType,
    OutputType,
    RadixClusteringConfiguration,
    validate_parsed_configuration,
)
from partitionedhashjoin_tpu.utils import logger as logging_utils
from partitionedhashjoin_tpu.utils.results import (
    HashJoinTimer,
    Parameters,
    select_results_formatter,
    select_results_renderer,
)

#: Extended join selector values (the reference knows only the first two,
#: src/Common/Configuration.cpp:4-40).
JOIN_CHOICES = (
    "no-partitioning",
    "radix-partitioning",
    "sort-merge",
    "shuffle",
    "planned",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phjoin-tpu",
        description="Partitioned hash join benchmark driver (JAX)",
    )
    # names/defaults per main.cpp:144-186
    p.add_argument("--primary", type=int, default=10_000_000,
                   help="primary (build) relation size")
    p.add_argument("--secondary", type=int, default=200_000_000,
                   help="secondary (probe) relation size")
    p.add_argument("--skew", type=float, default=1.05,
                   help="Zipf skew of the secondary relation (0 = uniform)")
    p.add_argument("--join", choices=JOIN_CHOICES, default="no-partitioning",
                   help="join algorithm")
    p.add_argument("--partitions", type=int, default=None,
                   help="radix partition count (radix-partitioning only)")
    p.add_argument("--log", default="info", help="log severity level")
    p.add_argument("--format", default="json", help="results format")
    p.add_argument("--unit", default="ms", choices=("ns", "us", "ms", "s"),
                   help="duration unit in results")
    p.add_argument("--output", default="file", choices=("file", "stdout"),
                   help="results sink")
    p.add_argument("--filename", default="hashjoin.txt",
                   help="results file name (when --output file)")
    # engine extensions
    p.add_argument("--shards", type=int, default=None,
                   help="device count for --join shuffle (default: all)")
    p.add_argument("--seed", type=int, default=None,
                   help="data generation seed (default: fresh entropy)")
    p.add_argument("--local-join", default="sort-merge",
                   choices=("sort-merge", "hash"),
                   help="shuffle join's per-shard join strategy")
    p.add_argument("--pipeline-chunks", type=int, default=1,
                   help="shuffle join: split the probe exchange into K "
                   "chunks overlapped with per-chunk local joins")
    p.add_argument("--key-dtype", default="int32", choices=("int32", "int64"),
                   help="tuple id width; int64 matches the reference's "
                   "Tuple::id (requires the sort-merge join)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the untimed warmup run (timed phases then "
                   "include one-time XLA compilation)")
    p.add_argument("--reference-spelling", action="store_true",
                   help="emit the reference's literal Type tags, including "
                   "its 'RadixParitioning' typo (main.cpp:127), for tooling "
                   "that string-matches reference output byte-for-byte")
    # multi-host bring-up (parallel/distributed.py): run one process per
    # host with the same flags plus a distinct --process-id
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port; enables "
                   "jax.distributed across --num-processes (shuffle join)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total process count (with --coordinator)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's id in [0, num-processes)")
    p.add_argument("--platform", default=None,
                   help="force a jax platform before backend init (e.g. "
                   "'cpu' for multi-process CPU tests)")
    return p


def parse_arguments(argv: Optional[Sequence[str]] = None) -> "tuple[Configuration, argparse.Namespace]":
    args = build_parser().parse_args(argv)
    config = Configuration()
    config.primary_relation_size = args.primary
    config.secondary_relation_size = args.secondary
    config.skew_parameter = args.skew
    if args.join in ("no-partitioning", "radix-partitioning"):
        config.join_type = JoinAlgorithmType.from_string(args.join)
    config.logger_config.log_level = args.log
    config.output_format_config.format = config.output_format_config.format.from_string(args.format)
    config.output_format_config.time_unit = args.unit
    config.output_config.type = OutputType.from_string(args.output)
    config.output_config.file.name = args.filename
    if args.partitions is not None:
        config.radix_clustering_config.number_of_partitions = args.partitions
    config.seed = args.seed
    config.key_dtype = args.key_dtype
    if args.key_dtype == "int64" and args.join != "sort-merge":
        raise SystemExit(
            "int64 keys are supported by the sort-merge join only "
            "(hash-table kernels are 32-bit)."
        )
    # cross-field check (src/Arguments.hpp:7-18): --partitions is only legal
    # with the radix join.  Extended join names (sort-merge/shuffle) leave
    # config.join_type at the non-radix default, so the shared validator
    # covers them too.
    try:
        validate_parsed_configuration(
            config, partitions_given=args.partitions is not None
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return config, args


def generate_tables(config: Configuration, log):
    """Generate both relations on device (main.cpp:35-79)."""
    import jax
    import jax.numpy as jnp

    from partitionedhashjoin_tpu.ops.generators import (
        sequential_table,
        zipf_table,
    )

    if config.key_dtype == "int64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.int64 if config.key_dtype == "int64" else jnp.int32

    log.info(
        "Generating primary (%d) and secondary (%d, skew %.2f) relations",
        config.primary_relation_size,
        config.secondary_relation_size,
        config.skew_parameter,
    )
    table_a = sequential_table(config.primary_relation_size, dtype=dtype)
    # alias method: a cheaper device program than the rejection
    # while_loop (its tables are built by the native library)
    method = (
        "alias" if config.primary_relation_size <= (1 << 24) else "rejection"
    )
    table_b = zipf_table(
        config.secondary_relation_size,
        alpha=config.skew_parameter,
        key_range=(1, config.primary_relation_size),
        seed=config.seed,
        method=method,
        dtype=dtype,
    )
    jax.block_until_ready((table_a.keys, table_b.keys))
    return table_a, table_b


def _base_parameters(config: Configuration) -> Parameters:
    params = Parameters()
    params.set_parameter(
        "PrimaryRelationSize", str(config.primary_relation_size)
    )
    params.set_parameter(
        "SecondaryRelationSize", str(config.secondary_relation_size)
    )
    # six decimals like C++ std::to_string(double) (main.cpp:97)
    params.set_parameter("Skew", f"{config.skew_parameter:.6f}")
    return params


def build_joiner(join_name: str, config: Configuration, args, params,
                 table_a, table_b):
    """The selected joiner (main.cpp:260-282) and the tables it runs on
    (the shuffle join's are sharded over its mesh); records the join's
    Type parameters in ``params``."""
    if join_name == "no-partitioning":
        from partitionedhashjoin_tpu.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        params.set_parameter("Type", "NoPartitioning")
        joiner = NoPartitioningHashJoiner(
            config.no_partitioning_config, seed=config.seed
        )
    elif join_name == "radix-partitioning":
        from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner

        params.set_parameter(
            "Type",
            # the reference's enum literal is typo'd (main.cpp:127); tooling
            # that diffs against its output can opt into byte parity
            "RadixParitioning"
            if getattr(args, "reference_spelling", False)
            else "RadixPartitioning",
        )
        params.set_parameter(
            "NumberOfPartitions",
            str(config.radix_clustering_config.number_of_partitions),
        )
        joiner = RadixHashJoiner(
            config.radix_clustering_config, seed=config.seed
        )
    elif join_name == "sort-merge":
        from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner

        params.set_parameter("Type", "SortMerge")
        joiner = SortMergeJoiner()
    elif join_name == "planned":
        from partitionedhashjoin_tpu.ops.planner import PlannedJoiner

        params.set_parameter("Type", "Planned")
        joiner = PlannedJoiner()
    elif join_name == "shuffle":
        from partitionedhashjoin_tpu.parallel.mesh import make_mesh, shard_table
        from partitionedhashjoin_tpu.parallel.shuffle import (
            DistributedShuffleJoiner,
        )

        mesh = make_mesh(args.shards)
        params.set_parameter("Type", "DistributedShuffle")
        params.set_parameter("NumberOfShards", str(mesh.devices.size))
        joiner = DistributedShuffleJoiner(
            mesh,
            seed=config.seed,
            local_join=args.local_join,
            pipeline_chunks=args.pipeline_chunks,
        )
        table_a = shard_table(table_a, mesh)
        table_b = shard_table(table_b, mesh)
    else:  # pragma: no cover
        raise ValueError(join_name)
    return joiner, table_a, table_b


def run_join(
    join_name: str, config: Configuration, args, table_a, table_b, log,
    warmup: bool = True,
):
    """Run the selected joiner and return its timing result."""
    params = _base_parameters(config)
    timer = HashJoinTimer(params)
    joiner, table_a, table_b = build_joiner(
        join_name, config, args, params, table_a, table_b
    )
    if warmup:
        # compile/warm untimed so phase durations measure device work, not
        # one-time XLA compilation (the C++ reference has no JIT to exclude)
        joiner.run(table_a, table_b)
    count = joiner.run(table_a, table_b, timer)
    if join_name == "planned":
        # observability: which plan the stats routed to (interval/two-run)
        params.set_parameter("Plan", joiner.last_plan or "")
    log.info("Join produced %d matches", count)
    return timer.get_result()


def run_distributed(config: Configuration, args, log):
    """Multi-host path: bootstrap, per-host generation, global shuffle join.

    Every participating host runs this same entrypoint with its own
    ``--process-id``; only process 0 returns a result document (the others
    return None and render nothing) — the single-writer convention of
    multi-host JAX programs.
    """
    from partitionedhashjoin_tpu.parallel import distributed
    from partitionedhashjoin_tpu.parallel.shuffle import DistributedShuffleJoiner

    if args.join != "shuffle":
        raise SystemExit("--coordinator requires --join shuffle")
    distributed.initialize(
        args.coordinator,
        args.num_processes,
        args.process_id,
        platform=args.platform,
    )
    mesh = distributed.global_mesh(args.shards)
    seed = config.seed if config.seed is not None else 0
    table_a, table_b = distributed.generate_global_tables(
        config.primary_relation_size,
        config.secondary_relation_size,
        config.skew_parameter,
        mesh,
        seed=seed,
    )
    params = _base_parameters(config)
    params.set_parameter("Type", "DistributedShuffle")
    params.set_parameter("NumberOfShards", str(mesh.devices.size))
    params.set_parameter("NumberOfProcesses", str(args.num_processes))
    timer = HashJoinTimer(params)
    joiner = DistributedShuffleJoiner(
        mesh,
        seed=seed,
        local_join=args.local_join,
        pipeline_chunks=args.pipeline_chunks,
    )
    if not args.no_warmup:
        joiner.run(table_a, table_b)
    count = joiner.run(table_a, table_b, timer)
    log.info("Join produced %d matches", count)
    import jax

    return timer.get_result() if jax.process_index() == 0 else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    config, args = parse_arguments(argv)
    from partitionedhashjoin_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    if args.platform and args.coordinator is None:
        # single-process --platform: pin before the first backend touch
        # (the distributed path applies it inside distributed.initialize)
        import jax

        jax.config.update("jax_platforms", args.platform)
    logging_utils.initialize_logger(config.logger_config.log_level)
    log = logging_utils.get_new_logger("Main")

    formatter = select_results_formatter(config.output_format_config)
    renderer = select_results_renderer(config.output_config)

    if args.coordinator is not None:
        result = run_distributed(config, args, log)
        if result is not None:
            renderer.render(formatter, result)
        return 0

    table_a, table_b = generate_tables(config, log)
    result = run_join(
        args.join, config, args, table_a, table_b, log,
        warmup=not args.no_warmup,
    )
    renderer.render(formatter, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
