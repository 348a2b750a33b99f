"""Device-mesh utilities.

The reference scales with a fixed-size thread pool over shared memory
(src/Common/ThreadPool.cpp:9-34, ``hardware_concurrency() - 1`` workers,
src/main.cpp:235-241).  Here the scaling unit is a ``jax.sharding.Mesh``
over devices: ``shard_map`` programs replace worker threads, collectives
(NCCL over NVLink between the GPUs of a host) replace the shared-memory
queue.  A single flat 1-D ``"shards"`` axis is the analogue of the worker
count; it assumes no topology, which suits NVLink's all-to-all links.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from partitionedhashjoin_tpu.data.table import Table

SHARD_AXIS = "shards"


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` available devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} present"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Rows split across the shard axis."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(
    array: jax.Array, multiple: int, fill
) -> tuple[jax.Array, int]:
    """Pad a 1-D array up to a length multiple; returns (padded, n_valid)."""
    import jax.numpy as jnp

    n = array.shape[0]
    padded = (n + multiple - 1) // multiple * multiple
    if padded == n:
        return array, n
    return (
        jnp.concatenate(
            [array, jnp.full((padded - n,), fill, array.dtype)]
        ),
        n,
    )


def shard_array(array: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a 1-D per-row array (e.g. a validity mask) row-sharded on the
    mesh, matching ``shard_table``'s layout so it can ride the exchange."""
    n_shards = mesh.devices.size
    if array.shape[0] % n_shards:
        raise ValueError(
            f"array length {array.shape[0]} not divisible by "
            f"{n_shards} shards; pad first (pad_to_multiple)"
        )
    return jax.device_put(array, row_sharding(mesh))


def shard_table(table: Table, mesh: Mesh) -> Table:
    """Place a table's columns row-sharded on the mesh.

    Row count must divide evenly by the shard count (pad first with
    ``pad_to_multiple`` + a validity convention if it does not).
    """
    n_shards = mesh.devices.size
    if table.size % n_shards:
        raise ValueError(
            f"table size {table.size} not divisible by {n_shards} shards; "
            "pad first (pad_to_multiple)"
        )
    sharding = row_sharding(mesh)
    return Table(
        keys=jax.device_put(table.keys, sharding),
        payloads=jax.device_put(table.payloads, sharding),
        uuid=table.uuid,
    )
