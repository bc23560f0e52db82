"""Pod-scale scenario dispatch: the MPC solve sharded over a device mesh.

BASELINE config 5 ("pod-scale MPC: 4096 scenarios sharded across devices,
ADMM QP with collectives, H=50"). Realized with ``shard_map`` so each
device runs the lanes sweep solver (``models.mpc.sweep``) on its local
scenario shard:

- **scenarios** shard over BOTH mesh axes jointly (every device owns an
  equal slice — the device analogue of the reference's competing queue
  consumers, ``event-driven/grayscale_service/app.py:92-94``);
- **perception** optionally shards the frame's rows over the model axis:
  ppermute halo exchange for the stencil, then each shard pools its edge
  rows into partial cost-pyramid bands and a tiny ``psum`` assembles
  the global base level every device needs (~32 KB for 1080p, vs the
  ~8 MB edge-plane all_gather it replaces — the solver only ever samples
  the pooled pyramid, never the full-res edge map);
- the ADMM/iLQR solve itself needs NO communication; the only mesh-wide
  traffic after perception is the pmean/pmax of the diagnostics.

Multi-host: call ``parallel.initialize_multihost()`` first (one process per
host); each host passes its process-local scenario slice and
``shard_scenarios`` assembles the global array across processes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openmp_parallel_computing_tpu import parallel
from openmp_parallel_computing_tpu.models.mpc import costs
from openmp_parallel_computing_tpu.models.mpc import solver as _solver
from openmp_parallel_computing_tpu.models.mpc.solver import Scenario
from openmp_parallel_computing_tpu.ops import (
    edge_pipeline,
    edge_pyramid_base,
)
from openmp_parallel_computing_tpu.parallel import collectives
from openmp_parallel_computing_tpu.parallel.spatial import _border_mask_rows
from openmp_parallel_computing_tpu.utils.config import MPCConfig

DATA = parallel.DATA_AXIS
MODEL = parallel.MODEL_AXIS


def perception_base(frame_local, n_model: int):
    """Cost-pyramid base level and the full frame's (H, W) from this
    device's frame block (the whole frame when ``n_model == 1``, else a
    row shard over the model axis). Runs inside ``shard_map``."""
    # With model-axis sharding each device holds a row shard; halos ride
    # a ppermute, then — because every scenario only ever samples the
    # POOLED cost pyramid — each shard pools its own edge rows into
    # partial pyramid-base bands and a tiny psum assembles the global
    # base level. The collective payload is the (ceil(H/16), ceil(W/16))
    # f32 base (~32 KB for 1080p) instead of the full-res edge plane
    # (~8 MB all_gather). Bit-exact with the single-device pyramid: band
    # sums of u8-valued magnitudes are integers < 2^24, exact in f32
    # under any summation order or sharding split.
    s0 = costs.PYRAMID_SCALES[0]
    if n_model > 1:
        c, h_loc, w = frame_local.shape
        h = h_loc * n_model
        top, bottom = collectives.halo_exchange_rows(frame_local, MODEL)
        ext = jnp.concatenate([top, frame_local, bottom], axis=1)
        rows = edge_pipeline(ext, border="none")[0, 1:-1]
        rows = _border_mask_rows(rows, h, w, MODEL, h_loc)
        rows = rows.astype(jnp.float32)
        # local column pooling (full width is device-local) ...
        wb = -(-w // s0)
        colpool = jnp.pad(rows, ((0, 0), (0, -w % s0)))
        colpool = colpool.reshape(h_loc, wb, s0).sum(-1)
        # ... then scatter local rows into the global band grid via a 0/1
        # assignment matmul (shard offsets are traced). HIGHEST: band sums
        # reach 255*16*16 = 65,280, which a TF32 product would round.
        r0 = jax.lax.axis_index(MODEL) * h_loc
        nb = -(-h // s0)
        band = (r0 + jnp.arange(h_loc)) // s0
        assign = (jnp.arange(nb)[:, None]
                  == band[None, :]).astype(jnp.float32)
        bands = jnp.matmul(assign, colpool,
                           precision=jax.lax.Precision.HIGHEST)
        level0 = jax.lax.psum(bands, MODEL) / float(s0 * s0)
        shape = (h, w)
    else:
        level0 = edge_pyramid_base(frame_local, s=s0)
        shape = frame_local.shape[1:]
    return level0, shape


class DistributedMPC:
    """Scenario-sharded MPC over a (data, model) mesh."""

    def __init__(self, cfg: MPCConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self._step = self._build()
        self._step_full = None  # built lazily (solve_full)

    def _build(self, full: bool = False):
        cfg = self.cfg
        mesh = self.mesh
        n_model = mesh.shape[MODEL]

        solve_local = (_solver._solve_batch_sweep if cfg.backend == "sweep"
                       else None)

        def local(frame_local, scen_local: Scenario):
            level0, shape = perception_base(frame_local, n_model)

            pyramid = costs.pyramid_from_base(level0)
            if solve_local is not None:
                sol = solve_local(pyramid, shape, scen_local, cfg)
            else:
                sol = jax.vmap(lambda s: _solver._solve_single(
                    pyramid, shape, s, cfg))(scen_local)

            if full:
                # Per-scenario results for the dispatch tier: first
                # controls, final costs, primal residuals — all sharded
                # like the scenario batch (no reduction).
                return sol.us[:, 0], sol.cost, sol.primal_residual
            # Mesh-wide diagnostics — the ADMM QP's only global reduction.
            mean_cost = jax.lax.pmean(jnp.mean(sol.cost), (DATA, MODEL))
            max_res = jax.lax.pmax(jnp.max(sol.primal_residual),
                                   (DATA, MODEL))
            return sol.us[:, 0], mean_cost, max_res

        frame_spec = P(None, MODEL, None) if n_model > 1 else P()
        batch = P((DATA, MODEL))
        out_specs = ((batch, batch, batch) if full
                     else (batch, P(), P()))
        f = jax.shard_map(
            local, mesh=mesh,
            in_specs=(frame_spec,
                      jax.tree.map(lambda _: P((DATA, MODEL)), Scenario(
                          p0=0, target=0, depth=0, us0=0))),
            out_specs=out_specs,
            check_vma=False)
        return jax.jit(f)

    def shard_scenarios(self, scen: Scenario) -> Scenario:
        """Shard a scenario batch over all mesh devices.

        Single-process: ``scen`` is the global batch. Multi-host: ``scen``
        is this process's LOCAL slice; the global array is assembled from
        per-process shards."""
        sharding = NamedSharding(self.mesh, P((DATA, MODEL)))
        if jax.process_count() > 1:
            return jax.tree.map(
                lambda a: jax.make_array_from_process_local_data(
                    sharding, a), scen)
        return jax.tree.map(lambda a: jax.device_put(a, sharding), scen)

    def _prepare(self, frame, scen: Scenario):
        if scen.y0 is not None:
            # The shard_map in_specs are built once against the cold
            # 4-leaf Scenario structure; dispatch-tier solves are
            # cold-start by design (jobs arrive without solver state).
            raise ValueError(
                "DistributedMPC solves cold-start; Scenario.y0 (dual "
                "warm start) applies to the receding-horizon loops")
        n_dev = self.mesh.shape[DATA] * self.mesh.shape[MODEL]
        global_batch = scen.p0.shape[0] * jax.process_count()
        if global_batch % n_dev:
            raise ValueError(
                f"global scenario batch {global_batch} not divisible by "
                f"device count {n_dev}")
        if self.mesh.shape[MODEL] > 1 and frame.shape[1] % \
                self.mesh.shape[MODEL]:
            raise ValueError("frame height not divisible by model axis")
        frame = jnp.asarray(frame)
        n_model = self.mesh.shape[MODEL]
        frame_spec = (P(None, MODEL, None) if n_model > 1 else P())
        sharding = NamedSharding(self.mesh, frame_spec)
        if jax.process_count() == 1:
            frame = jax.device_put(frame, sharding)
        else:
            # Multi-host: every process ingests the full camera frame
            # (unlike scenarios, which arrive as per-process slices).
            # Assemble the GLOBAL array by serving each addressable shard
            # from the local copy — a host-local array fed straight into
            # the multi-process jit only works for the fully-replicated
            # spec (uncommitted-input replication) and cannot express the
            # MODEL-sharded frame.
            import numpy as np

            local = np.asarray(frame)
            frame = jax.make_array_from_callback(
                local.shape, sharding, lambda idx: local[idx])
        return frame, self.shard_scenarios(scen)

    def solve(self, frame, scen: Scenario):
        """frame (C, H, W) u8, scenario batch divisible by the device
        count. Returns (u0 batch, mean cost, max primal residual)."""
        return self._step(*self._prepare(frame, scen))

    def solve_full(self, frame, scen: Scenario):
        """Like ``solve`` but returns per-scenario arrays
        (u0 (B, 6), cost (B,), primal_residual (B,)) — the result payload
        of the async dispatch tier's MPC jobs."""
        if self._step_full is None:
            self._step_full = self._build(full=True)
        return self._step_full(*self._prepare(frame, scen))
