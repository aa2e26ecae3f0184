"""Device mesh helpers for stream-batch sharding."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "streams"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over available devices; the stream/frame batch shards across
    it (streams are independent, so cross-device traffic is minimal and
    every device pair is equally close on an all-to-all host).

    Raises if fewer than ``n_devices`` devices exist — a silently smaller
    mesh would make "N-way sharded" claims vacuous (tests and the driver
    dryrun both rely on getting exactly the mesh they asked for).
    """
    devs = jax.devices()
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"make_mesh: n_devices must be >= 1, got {n_devices}")
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}): only {len(devs)} device(s) available "
                f"on backend {devs[0].platform if devs else '?'}; run under "
                f"JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} for a virtual mesh"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (STREAM_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (stream-batch) sharding."""
    return NamedSharding(mesh, P(STREAM_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Mesh):
    """Place a host batch onto the mesh, sharded over its leading axis."""
    return jax.device_put(x, batch_sharding(mesh))
