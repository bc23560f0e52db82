"""Device mesh topology.

The reference's parallelism knob is a thread count (``OMP_NUM_THREADS``,
swept by ``monolithic/scripts/bench_and_plot_monolithic.sh:34-46``). The
replacement is a device mesh: the host's devices (optionally several hosts)
arranged into named axes, with shardings — not threads — deciding how work
spreads. The mesh follows the algorithm: a data axis for scenario batches,
a model axis for spatial row shards. This module owns mesh construction,
the mesh-shape knob, and multi-host initialization.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

# Canonical axis names. "data" shards independent work items (scenario
# batches / image batches — the analogue of the reference's queue-sharded
# jobs); "model" shards within one work item (feature dimensions, spatial
# rows — the analogue of OpenMP threads inside one kernel).
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: how many devices along each named axis.

    ``data=-1`` means "all remaining devices". Build with ``spec.build()``.
    """

    data: int = -1
    model: int = 1

    def build(self, devices=None) -> Mesh:
        devices = list(devices if devices is not None else jax.devices())
        n = len(devices)
        model = self.model
        data = self.data if self.data != -1 else max(1, n // model)
        if data * model > n:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, "
                f"have {n}")
        arr = np.array(devices[: data * model]).reshape(data, model)
        return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over the local (or given) devices."""
    return MeshSpec(data=data, model=model).build(devices)


def data_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading axis over ``data``, replicate the rest."""
    return NamedSharding(
        mesh, PartitionSpec(DATA_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Initialize the multi-host JAX runtime (DCN tier).

    One process per host feeds its local devices; collectives ride the
    host's device interconnect (NVLink) within a host and the network
    across hosts. This replaces the reference's
    RabbitMQ-worker fan-out (``event-driven/grayscale_service/app.py:92-94``)
    as the multi-machine scaling mechanism. No-op when the environment
    carries no multi-host configuration.
    """
    coordinator = coordinator or os.environ.get("OMPC_COORDINATOR")
    if coordinator is None:
        return
    # `x if x is not None else ...`, NOT `x or ...`: process_id=0 is valid.
    if num_processes is None:
        num_processes = int(os.environ["OMPC_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["OMPC_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
