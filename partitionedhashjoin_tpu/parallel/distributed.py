"""Multi-host (multi-process) execution: the cross-host scale-out layer.

SURVEY.md §5 "Distributed communication backend" and §7 step 6 call for
multi-host bring-up; the reference has no analogue (it is a single process
whose "workers" are threads, src/Common/ThreadPool.cpp) — this layer is what
replaces it across hosts:

- ``initialize``: ``jax.distributed.initialize`` bootstrap — one coordinator,
  N processes, each owning its local devices (GPUs, or virtual CPU devices
  in tests, where collectives ride Gloo over TCP).
- ``global_mesh``: one 1-D "shards" mesh over every device of every process;
  ``shard_map`` programs and collectives are unchanged from the single-host
  path (parallel/shuffle.py).
- ``host_slice`` + ``make_global_table``: each host GENERATES only its row
  slice (the per-host native-generation topology of docs/SCALING.md) and the
  slices are assembled into one globally-sharded Table without any cross-host
  data motion (``jax.make_array_from_process_local_data``).

Per-host generator streams are decorrelated by folding the process id into
the base seed — the multi-process counterpart of the reference's per-worker
leapfrogged LCG streams (src/Common/Random.cpp:9-30; like there, the stream
an individual row sees depends on the worker/host count, the distribution
does not).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from partitionedhashjoin_tpu.data.table import Table, make_table
from partitionedhashjoin_tpu.parallel.mesh import make_mesh, row_sharding
from partitionedhashjoin_tpu.utils.logger import get_new_logger

_log = get_new_logger("Distributed")


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    platform: Optional[str] = None,
) -> None:
    """Bootstrap the multi-process runtime (idempotent per process).

    ``platform="cpu"`` pins the CPU backend BEFORE backend init (the
    multi-process CPU tests); leave it unset on GPU hosts.  Nothing tells
    JAX of a cluster here: ``coordinator`` (``host:port``),
    ``num_processes`` and ``process_id`` are always passed explicitly.
    """
    if platform:
        jax.config.update("jax_platforms", platform)
    kwargs = dict(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    if local_device_count is not None:
        kwargs["local_device_count"] = local_device_count
    jax.distributed.initialize(**kwargs)
    _log.info(
        "process %d/%d up: %d local / %d global devices",
        process_id,
        num_processes,
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(num_devices: Optional[int] = None):
    """1-D "shards" mesh over all processes' devices (XLA picks the
    transport per edge)."""
    return make_mesh(num_devices, devices=jax.devices())


def host_slice(total_rows: int, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """(start, rows) of this host's generation slice.

    Row counts must divide evenly by the process count (pad upstream
    otherwise — the same contract as mesh.shard_table).
    """
    nproc = jax.process_count() if num_processes is None else num_processes
    pid = jax.process_index() if process_id is None else process_id
    if total_rows % nproc:
        raise ValueError(
            f"total rows {total_rows} not divisible by {nproc} processes"
        )
    rows = total_rows // nproc
    return pid * rows, rows


def make_global_table(local_keys, local_payloads, mesh) -> Table:
    """Assemble per-host row slices into one globally row-sharded Table.

    Each process passes ONLY its local slice; no cross-host transfer happens
    (every host's rows land on its own devices).  Global row order is
    process-major — exactly ``host_slice``'s layout.
    """
    sharding = row_sharding(mesh)
    nproc = jax.process_count()
    local_keys = np.asarray(local_keys)
    local_payloads = np.asarray(local_payloads)
    n_global = local_keys.shape[0] * nproc
    keys = jax.make_array_from_process_local_data(
        sharding, local_keys, (n_global,)
    )
    payloads = jax.make_array_from_process_local_data(
        sharding, local_payloads, (n_global,)
    )
    return make_table(keys, payloads)


def generate_global_tables(
    primary_rows: int,
    secondary_rows: int,
    skew: float,
    mesh,
    seed: int,
    zipf_method: str = "alias",
) -> Tuple[Table, Table]:
    """Per-host generation of both relations, assembled globally.

    Primary: this host's slice of the sequential ids (payload = global row).
    Secondary: Zipf over [1, primary_rows] with a per-host folded seed (the
    leapfrog-stream analogue; see module docstring).  ``zipf_method="alias"``
    exercises the per-host NATIVE generator path (host_loader builds the
    Vose tables in C++ on every host).
    """
    from partitionedhashjoin_tpu.ops import generators

    a_start, a_rows = host_slice(primary_rows)
    b_start, b_rows = host_slice(secondary_rows)
    keys_a = np.arange(a_start + 1, a_start + a_rows + 1, dtype=np.int32)
    pays_a = np.arange(a_start, a_start + a_rows, dtype=np.int32)

    host_seed = (seed ^ (0x9E3779B9 * (jax.process_index() + 1))) & 0x7FFFFFFF
    table_b_local = generators.zipf_table(
        b_rows,
        alpha=skew,
        key_range=(1, primary_rows),
        seed=host_seed,
        method=zipf_method,
    )
    keys_b = np.asarray(jax.device_get(table_b_local.keys))
    pays_b = np.arange(b_start, b_start + b_rows, dtype=np.int32)

    table_a = make_global_table(keys_a, pays_a, mesh)
    table_b = make_global_table(keys_b, pays_b, mesh)
    return table_a, table_b
