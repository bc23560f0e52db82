"""Headline benchmark: closed-loop MPC solves/s on one GPU at H=20 with
per-step perception on 1080p frames.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}. Exits
non-zero without a result when JAX finds no GPU: a CPU timing is not a
device figure.

The measured unit of work is one full closed-loop control step, with
EVERY stage paid EVERY step: grayscale->Sobel->pooled-pyramid perception
on that step's 1080p camera frame, a batch of complete ADMM+iLQR MPC
solves (H=20, 8 features, box-constrained), the first control applied to
the true feature dynamics, and the warm-start shift. solves/s = scenarios
* steps / wall. The loop runs device-resident via
``VisualServoMPC.receding_horizon_frames`` (``lax.scan`` over full
control steps against a ring of DISTINCT frames — the device cannot reuse
a pyramid across steps; equivalence-tested against the per-step host loop
in tests/test_mpc.py::TestRecedingHorizon). This mirrors the reference's
timing discipline (``monolithic/src/main.c:31-39``: every measured pass
reruns the whole kernel).

A second row reports the SOLVER-ONLY CEILING: the fixed-frame
``receding_horizon`` loop, where one pyramid build amortizes over the
window (offline policy evaluation / solver tuning — perception excluded
by construction).

Each window ends in ``jax.block_until_ready`` on its results; the value is
the median of the trial windows, with every trial on record.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

SCENARIOS = 4096
SCENARIOS_SMALL = 256
STEPS = 100          # control steps per timed window
RING = 8             # distinct 1080p frames cycled by the scan
TRIALS = 5


def main() -> int:
    from openmp_parallel_computing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import jax

    from openmp_parallel_computing_tpu import data, smoke
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    device = smoke.device_facts()
    if device["platform"] != "gpu":
        print(f"bench: no GPU found (JAX platform {device['platform']!r})",
              file=sys.stderr)
        return 2

    # edge_refresh="solve": one edge linearization per solve, sampled at
    # the warm-start trajectory — the receding-horizon real-time mode this
    # loop models (staleness bounded by the per-frame warm-start distance).
    # The MPCConfig default stays "admm" because cold-start solves have no
    # staleness bound. Iteration budget + over-relaxation: the MPCConfig
    # defaults (1 iLQR sweep x (2 + 3@tol 0.1) ADMM iterations at
    # admm_relax=1.3 with the decayed dual carry; docs/DESIGN.md §2j).
    frames = jax.device_put(data.frame_ring(data.load_frame_planar(), RING))

    def timed_loop(loop, batch):
        """Median throughput over TRIALS windows, after warming up TWICE:
        the first window's outgoing scenario gains the dual warm-start
        carry (Scenario.y0, None -> array), so the second call traces a
        second executable."""
        cfg = MPCConfig(horizon=20, num_features=8, scenarios=batch,
                        edge_refresh="solve")
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(0), batch)
        for _ in range(2):
            u0s, _, scen = loop(mpc, scen)
            jax.block_until_ready(u0s)
        trials = []
        for _ in range(TRIALS):
            t0 = time.perf_counter()
            u0s, _, scen = loop(mpc, scen)
            jax.block_until_ready(u0s)
            trials.append(batch * STEPS / (time.perf_counter() - t0))
        assert bool(jax.numpy.isfinite(u0s[-1]).all())
        return statistics.median(trials), trials

    def frames_loop(mpc, scen):
        return mpc.receding_horizon_frames(frames, scen, STEPS)

    def fixed_loop(mpc, scen):
        return mpc.receding_horizon(frames[0], scen, STEPS)

    headline, trials = timed_loop(frames_loop, SCENARIOS)
    small, small_trials = timed_loop(frames_loop, SCENARIOS_SMALL)
    ceiling, ceiling_trials = timed_loop(fixed_loop, SCENARIOS)

    print(json.dumps({
        "metric": "mpc_solves_per_s_h20_1080p_perstep_perception",
        "value": headline,
        "unit": "solves/s",
        "device": device,
        "card": smoke.card_line(),
        "batch": SCENARIOS,
        "trials": trials,
        "value_256": small,
        "trials_256": small_trials,
        "solver_only_ceiling": ceiling,
        "ceiling_trials": ceiling_trials,
        "perception_schedule": (
            f"full grayscale->Sobel->pyramid on a fresh 1080p frame EVERY "
            f"control step (ring of {RING} distinct frames), {STEPS}-step "
            f"windows; ceiling row amortizes one pyramid per window"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
