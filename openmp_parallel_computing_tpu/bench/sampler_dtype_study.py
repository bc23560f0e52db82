"""Sampler weight-dtype throughput study (on-chip): f32 vs bf16.

Prices ``MPCConfig.sampler_dtype`` (docs/DESIGN.md §2m): the dense lanes
sampler's cost at large point counts is the HBM materialization of the
hat-weight tensors (~188 floats/point in f32 — the §2g floor) plus the
f32 einsum passes; storing weights + mean-centered level residuals in
bf16 halves those bytes and runs the contractions at the tensor cores'
bf16 rate, with all accumulation kept in f32. Quality bound per the config
docstring (~2^-8 of a pyramid cell on positions); closed-loop quality in
results/cpu/sampler_dtype_quality.json.

Methodology identical to bench.py / dual_budget_study: device-resident
``receding_horizon_frames`` windows (per-step 1080p perception, ring of
8 distinct frames), median of trials.

Usage::

    python -m openmp_parallel_computing_tpu.bench.sampler_dtype_study \
        [--batches 4096,8192,16384] [--horizons 20,50] [--steps 97] \
        [--trials 3] [--out chiprun_out/sampler_dtype.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def run(batches, horizons, dtypes, steps: int, trials: int) -> list[dict]:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = data.load_frame_planar()
    ring = 8
    shift = frame.shape[-1] // ring
    frames = jax.device_put(jnp.stack(
        [jnp.roll(frame, k * shift, axis=-1) for k in range(ring)]))

    rows = []
    for B in batches:
        for horizon in horizons:
            for sd in dtypes:
                cfg = MPCConfig(horizon=horizon, num_features=8,
                                scenarios=B, edge_refresh="solve",
                                sampler_dtype=sd)
                mpc = VisualServoMPC(cfg)
                scen = mpc.random_scenarios(jax.random.PRNGKey(0), B)
                scen = jax.tree.map(jax.device_put, scen)
                # Warm twice: the first window's outgoing scenario gains
                # the dual carry (y0 None -> array), retracing the loop.
                for _ in range(2):
                    u0s, _, scen = mpc.receding_horizon_frames(
                        frames, scen, steps)
                    np.asarray(u0s[-1])      # warm + honest sync
                vals = []
                for _ in range(trials):
                    t0 = time.perf_counter()
                    u0s, _, scen = mpc.receding_horizon_frames(
                        frames, scen, steps)
                    np.asarray(u0s[-1])
                    vals.append(B * steps / (time.perf_counter() - t0))
                assert np.all(np.isfinite(np.asarray(u0s[-1])))
                rows.append({
                    "batch": B, "horizon": horizon, "sampler_dtype": sd,
                    "solves_per_s": int(statistics.median(vals)),
                    "trials": [int(v) for v in vals],
                })
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4096,8192,16384")
    ap.add_argument("--horizons", default="20,50")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = run([int(b) for b in args.batches.split(",") if b],
               [int(h) for h in args.horizons.split(",") if h],
               [d for d in args.dtypes.split(",") if d],
               args.steps, args.trials)
    out = {"methodology": (
        "device-resident receding_horizon_frames windows (per-step 1080p "
        "perception, ring of 8 distinct frames — the headline bench "
        "methodology), median of trials, result-dependent fetch sync; "
        "identical solves except MPCConfig.sampler_dtype; function-level "
        "quantization bound tested in "
        "tests/test_mpc.py::TestSamplerDtype; closed-loop quality: "
        "results/cpu/sampler_dtype_quality.json"),
        "rows": rows}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
