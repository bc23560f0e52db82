"""Warm-loop budget x dual-carry throughput study (on-chip).

The 100-frame CPU quality study (results/cpu/dual_warm_loop_solve.json,
docs/DESIGN.md §2i) measured that with the ADMM duals warm-started across
receding-horizon steps, a reduced 1x3 budget reaches within ~0.15% of the
shipped 1x5 budget's asymptotic closed-loop cost with BETTER constraint
satisfaction than 1x3-cold. This study prices the option: device-resident
``receding_horizon_frames`` windows (per-step 1080p perception — the
headline methodology, bench.py) at each (admm_iters, dual_warm_start)
point, median of trials.

Usage::

    python -m openmp_parallel_computing_tpu.bench.dual_budget_study \
        [--batches 4096] [--steps 97] [--trials 3] \
        [--out chiprun_out/dual_budget.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def parse_arm(spec: str):
    """"admm[:extra:tol][:cold]" -> (admm, extra, tol, dual). Examples:
    "5" (fixed 1x5 + dual carry), "5:cold", "3:2:0.1" (the shipped r5
    adaptive arm), "3:2:0.1:cold"."""
    parts = spec.split(":")
    dual = True
    if parts[-1] in ("cold", "dual"):
        dual = parts.pop() == "dual"
    admm = int(parts[0])
    extra = int(parts[1]) if len(parts) > 1 else 0
    tol = float(parts[2]) if len(parts) > 2 else 0.0
    return admm, extra, tol, dual


def run(batches, arms, steps: int, trials: int,
        horizon: int = 20) -> list[dict]:
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
        for admm, extra, tol, dual in arms:
                cfg = MPCConfig(horizon=horizon, num_features=8,
                                scenarios=B, admm_iters=admm,
                                admm_iters_extra=extra, admm_tol=tol,
                                edge_refresh="solve",
                                dual_warm_start=dual)
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
                    "batch": B, "horizon": horizon, "admm": admm,
                    "extra": extra, "tol": tol, "dual": dual,
                    "solves_per_s": int(statistics.median(vals)),
                    "trials": [int(v) for v in vals],
                })
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4096")
    ap.add_argument("--arms", default="5:cold,5,3,3:2:0.1",
                    help="comma list of admm[:extra:tol][:cold|:dual] "
                         "arms (default prices the fixed 1x5 cold/dual, "
                         "the fixed 1x3-dual option, and the r5 "
                         "adaptive 3+2@0.1 budget; the r5b shipped "
                         "default is 2:3:0.1)")
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = run([int(b) for b in args.batches.split(",") if b],
               [parse_arm(a) for a in args.arms.split(",") if a],
               args.steps, args.trials, horizon=args.horizon)
    out = {"methodology": (
        "device-resident receding_horizon_frames windows (per-step 1080p "
        "perception, ring of 8 distinct frames — the headline bench "
        "methodology), median of trials, result-dependent fetch sync; "
        "identical solves except MPCConfig.admm_iters/_extra/_tol / "
        "dual_warm_start; quality of each arm: "
        "results/cpu/dual_warm_loop_solve.json + adaptive_budget_h*.json"),
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
