"""Online depth identification in the closed loop: quality + price.

Round-4 VERDICT weak #7: sysid was "tested but never integrated". This
study runs the integrated adaptive loop (``models/mpc/adaptive.py``) on
real 1080p perception with a depth-mismatched plant and measures:

1. QUALITY (any host — model math is hardware-independent): closed-loop
   tracking error of ORACLE (controller knows the true depths) vs FROZEN
   (wrong prior, no adaptation) vs ADAPTIVE (wrong prior + in-loop
   learning), plus the depth-estimate error trajectory. Mismatch is the
   overshoot direction (prior z0 above the true depths), where depth
   error measurably hurts IBVS tracking.
2. PRICE (run on the GPU): throughput of the adaptive scan loop vs the
   plain ``receding_horizon_frames`` at the same batch — what the
   per-frame sysid step (a handful of (B, m) ops + optimizer update)
   costs next to the solver.

Usage::

    python -m ...bench.sysid_loop_study --cpu --quality \
        --out results/cpu/sysid_loop_r5.json
    python -m ...bench.sysid_loop_study --price --batches 1024,4096 \
        --out chiprun_out/sysid_loop.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def _setup(batch: int, horizon: int, seed: int):
    import jax
    import jax.numpy as jnp

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = data.load_frame_planar()
    ring = 8
    shift = frame.shape[-1] // ring
    frames = jax.device_put(jnp.stack(
        [jnp.roll(frame, k * shift, axis=-1) for k in range(ring)]))
    cfg = MPCConfig(horizon=horizon, num_features=8, scenarios=batch,
                    edge_refresh="solve")
    mpc = VisualServoMPC(cfg)
    scen = mpc.random_scenarios(jax.random.PRNGKey(seed), batch)
    import numpy as np

    rng = np.random.default_rng(seed)
    depth_true = jnp.asarray(
        rng.uniform(1.2, 2.0, (batch, cfg.num_features)), jnp.float32)
    return cfg, mpc, frames, jax.tree.map(jax.device_put, scen), depth_true


def run_quality(batch: int, frames_n: int, horizon: int, z0: float,
                lr: float, seed: int = 0) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu.models.mpc.adaptive import (
        adaptive_receding_horizon)
    from openmp_parallel_computing_tpu.models.mpc.sysid import (
        DepthEstimator)

    cfg, mpc, frames, scen, depth_true = _setup(batch, horizon, seed)

    def err(s_out):
        return float(jnp.mean(jnp.abs(s_out.p0 - scen.target)))

    rows = []
    # oracle: the controller plans with the plant's own depths
    _, _, s_or = mpc.receding_horizon_frames(
        frames, scen._replace(depth=depth_true), frames_n)
    rows.append({"mode": "oracle", "final_err": round(err(s_or), 4)})

    for mode, rate in (("frozen", 0.0), ("adaptive", lr)):
        est = DepthEstimator(cfg.num_features, cfg.dt, lr=rate)
        st = est.init(batch, z0=z0)
        derr0 = float(jnp.mean(jnp.abs(est.depths(st) - depth_true)))
        # chunked so the depth-error trajectory is observable
        chunk, derrs, losses = max(1, frames_n // 10), [], []
        s = scen
        for _ in range(frames_n // chunk):
            _, _, loss, s, st = adaptive_receding_horizon(
                mpc, est, frames, s, depth_true, chunk, st)
            derrs.append(round(float(jnp.mean(jnp.abs(
                est.depths(st) - depth_true))), 4))
            losses.append(float(loss[-1]))
        rows.append({
            "mode": mode, "lr": rate, "final_err": round(err(s), 4),
            "depth_err0": round(derr0, 4),
            "depth_err_by_chunk": derrs,
            "sysid_loss_final": losses[-1],
        })
        print(json.dumps(rows[-1]), flush=True)

    o, f, a = (rows[0]["final_err"], rows[1]["final_err"],
               rows[2]["final_err"])
    return {
        "methodology": (
            "device-resident adaptive closed loop on real 1080p per-step "
            "perception; plant depths drawn in [1.2, 2.0], controller "
            f"prior z0={z0} (overshoot-direction mismatch); tracking "
            "error |p - target| after the window; depth error per chunk"),
        "batch": batch, "frames": frames_n, "horizon": horizon,
        "z0": z0, "lr": lr,
        "mismatch_penalty_recovered_pct": round(
            100.0 * (f - a) / (f - o), 1) if f > o else None,
        "rows": rows,
    }


def run_price(batches, steps: int, trials: int, horizon: int,
              lr: float = 0.05, seed: int = 0) -> list[dict]:
    import numpy as np

    from openmp_parallel_computing_tpu.models.mpc.adaptive import (
        adaptive_receding_horizon)
    from openmp_parallel_computing_tpu.models.mpc.sysid import (
        DepthEstimator)

    rows = []
    for B in batches:
        cfg, mpc, frames, scen, depth_true = _setup(B, horizon, seed)

        def timed(fn, sync):
            for _ in range(2):
                out = fn()
                np.asarray(sync(out))
            vals = []
            for _ in range(trials):
                t0 = time.perf_counter()
                out = fn()
                np.asarray(sync(out))
                vals.append(B * steps / (time.perf_counter() - t0))
            return int(statistics.median(vals)), [int(v) for v in vals]

        plain, plain_trials = timed(
            lambda: mpc.receding_horizon_frames(frames, scen, steps),
            lambda out: out[0][-1])
        est = DepthEstimator(cfg.num_features, cfg.dt, lr=lr)
        st = est.init(B)
        adaptive, ad_trials = timed(
            lambda: adaptive_receding_horizon(mpc, est, frames, scen,
                                              depth_true, steps, st),
            lambda out: out[0][-1])
        rows.append({
            "batch": B, "horizon": horizon, "steps": steps,
            "plain_solves_per_s": plain, "plain_trials": plain_trials,
            "adaptive_solves_per_s": adaptive,
            "adaptive_trials": ad_trials,
            "price_pct": round(100.0 * (1 - adaptive / plain), 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--price", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", default="1024,4096")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--steps", type=int, default=97)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--z0", type=float, default=8.0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.quality:
        out = run_quality(args.batch, args.frames, args.horizon,
                          args.z0, args.lr, seed=args.seed)
    elif args.price:
        out = {"methodology": (
            "adaptive scan loop vs plain receding_horizon_frames, same "
            "batch/window, median of trials, result-dependent fetch "
            "sync — the on-chip cost of the per-frame sysid step"),
            "rows": run_price([int(b) for b in args.batches.split(",")],
                              args.steps, args.trials, args.horizon,
                              lr=args.lr, seed=args.seed)}
    else:
        raise SystemExit("pass --quality or --price")
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
