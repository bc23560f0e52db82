"""Batched vision pipeline runner.

The throughput-oriented counterpart to ``parallel.spatial``: many frames at
once, batch dimension sharded over the mesh's data axis (the analogue of the
reference's queue of independent jobs fanned out to competing workers,
``event-driven/README.md:57-73``, as pure data parallelism under one jit).

Used for offline batch processing (the dispatch tier) and as the perception
front-end for multi-frame MPC scenario evaluation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openmp_parallel_computing_tpu import ops, parallel


class EdgeBatchRunner:
    """Runs the fused edge pipeline over (B, C, H, W) u8 frame batches.

    With a mesh, frames are sharded over the data axis; the op runs per
    device on its local sub-batch (vmap over frames).
    """

    def __init__(self, mesh: Mesh | None = None, kernel: str = "edge"):
        self.mesh = mesh
        base = {
            "edge": ops.edge_pipeline,
            "grayscale": ops.grayscale,
            "blur": ops.gaussian_blur,
        }[kernel]
        self._fn = jax.jit(jax.vmap(base))

    def __call__(self, frames) -> jax.Array:
        frames = jnp.asarray(frames)
        if self.mesh is not None:
            sharding = NamedSharding(self.mesh,
                                     P(parallel.DATA_AXIS, None, None, None))
            frames = jax.device_put(frames, sharding)
        return self._fn(frames)

    def throughput_fn(self, passes: int = 1):
        """One jitted computation applying the pipeline ``passes`` times to
        every frame (bench building block)."""
        fn = self._fn

        @jax.jit
        def run(frames):
            return jax.lax.fori_loop(0, passes, lambda _, x: fn(x), frames)

        return run
