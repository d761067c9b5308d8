"""Device-mesh helpers for the distribution layer.

The reference has no distributed execution at all (SURVEY §2.3: TBB threads
only); this module IS the "communication backend": a 1-D (or hosts x
devices) ``jax.sharding.Mesh`` whose data axis shards the
landmark/observation dimension of BA problems, with XLA inserting the
collectives (psum / reduce-scatter, NCCL on GPUs) for the reduced camera
system.  The cards of one host are joined all to all, so the mesh follows
the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a multi-host run (SPMD over several hosts).

    Wraps ``jax.distributed.initialize``; pass the coordinator address,
    process count and id (nothing in the environment provides them).
    After this, ``jax.devices()`` spans all hosts and ``make_mesh()``
    builds a global mesh.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_host_chip_mesh(hosts: int, chips_per_host: int) -> Mesh:
    """2-D (host, chip) mesh: shard landmarks over the cards within a
    host (NVLink) and keyframe blocks over hosts (network boundary) —
    SURVEY §7's keyframe-block partitioning axis is the host axis."""
    devices = np.asarray(jax.devices()[: hosts * chips_per_host]).reshape(
        hosts, chips_per_host
    )
    return Mesh(devices, ("host", DATA_AXIS))
