"""Adaptive-ADMM-budget quality study (closed loop, CPU-friendly).

Round 4 priced the reduced 1x3 warm-loop budget with the decayed dual
carry as a throughput gain (bench.dual_budget_study) but left it a
labeled option: its asymptotic closed-loop cost ran +0.16-0.18%
over the shipped 1x5 budget. Round 5's hybrid
(``MPCConfig.admm_iters_extra`` / ``admm_tol``) carries the duals at the
reduced base budget and spends the extra iterations ONLY when the
batch-max primal residual after the base iterations still exceeds the
tolerance — full budget through cold starts and transients, reduced
budget once the loop settles.

This study answers the two questions that gate shipping it as default:

1. QUALITY: closed-loop tracking error and cost of the adaptive budget
   vs the shipped 1x5-cold baseline and the fixed 1x3-dual option, at
   H=20 and H=50 (the r4 divergence horizon).
2. TRIP RATE: what fraction of frames fire the continuation at each
   tolerance — 3 + 2*rate is the expected sweeps/frame, i.e. the
   throughput the on-chip bench should see.

The adaptive solve is emulated exactly: the gate's predicate is computed
from the base-budget solve's own ``primal_residual`` (max over the
batch — precisely the tensor the in-graph ``lax.cond`` reduces), and a
fired frame re-solves at the full budget, which is bit-identical to the
in-graph continuation (tests/test_mpc.py::TestAdaptiveBudget pins both
boundary cases bit-exactly). The emulation exposes the per-frame fired
flag that the fused device loop hides.

Quality is hardware-independent (backends equivalence-tested), so this
runs on CPU with the sweep backend; batch-max gating is CONSERVATIVE in
the batch size — the headline's 4096-scenario batch can only trip more
often than the study batch, trading throughput for quality, never the
reverse.

Usage::

    python -m openmp_parallel_computing_tpu.bench.adaptive_budget_study \
        --cpu [--scenarios 64] [--frames 100] [--horizon 20] \
        [--tols 0.05,0.1,0.2] [--out results/cpu/adaptive_budget_h20.json]
"""

from __future__ import annotations

import argparse
import json


def run_loop(scenarios: int, frames: int, horizon: int, tols,
             seed: int = 0, base_admm: int = 3, extra: int = 2,
             full_admm: int = 5) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.ops import xla_ref
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = data.load_frame_planar()
    edge_map = xla_ref.edge_pipeline(frame)[0].astype(jnp.float32)

    def mk(admm, dual):
        # admm_iters_extra/admm_tol are pinned OFF: this study emulates
        # the adaptive gate itself, so its arms must be genuinely fixed
        # budgets. (Regression guard — when the adaptive budget became
        # the MPCConfig DEFAULT, the unpinned construction silently
        # turned every "fixed" arm into budget+2@0.1 and the full-budget
        # continuation into 7 effective iterations, which DIVERGES with
        # the dual carry at H=50: 50.17 -> 61.21 asymptotic cost, see
        # docs/DESIGN.md §2j "budget ceiling" and
        # tests/test_solver_quality.py::test_long_horizon_budget_ceiling.)
        return VisualServoMPC(MPCConfig(
            horizon=horizon, ilqr_iters=1, admm_iters=admm,
            admm_iters_extra=0, admm_tol=0.0,
            backend="sweep", edge_refresh="solve", dual_warm_start=dual))

    def advance(cfg, scen, sol):
        shifted = jnp.concatenate(
            [sol.us[:, 1:], jnp.zeros_like(sol.us[:, :1])], axis=1)
        y0 = None
        if sol.dual is not None:
            y0 = cfg.dual_decay * jnp.concatenate(
                [sol.dual[:, 1:], jnp.zeros_like(sol.dual[:, :1])], axis=1)
        return scen._replace(p0=sol.ps[:, 1], us0=shifted, y0=y0)

    def closed_loop(tol=None, admm=None, dual=True):
        """tol=None: fixed budget ``admm``. tol set: adaptive
        base_admm + extra @ tol (full_admm == base_admm + extra)."""
        mpc_base = mk(base_admm if tol is not None else admm, dual)
        mpc_full = mk(full_admm, dual) if tol is not None else None
        cfg = mpc_base.cfg
        scen = mpc_base.random_scenarios(jax.random.PRNGKey(seed),
                                         scenarios)
        if dual:
            scen = scen._replace(y0=jnp.zeros_like(scen.us0))
        errs, costs, fired_seq = [], [], []
        for _ in range(frames):
            sol = mpc_base.solve_batch(edge_map, scen)
            if tol is not None:
                fired = bool(np.max(np.asarray(sol.primal_residual))
                             > tol)
                fired_seq.append(fired)
                if fired:
                    # Continuation == full fixed budget (bit-exact,
                    # TestAdaptiveBudget boundary case).
                    sol = mpc_full.solve_batch(edge_map, scen)
            scen = advance(cfg, scen, sol)
            errs.append(float(jnp.mean(jnp.abs(scen.p0 - scen.target))))
            costs.append(float(jnp.mean(sol.cost)))
        tail = frames // 5
        row = {
            "mode": ("adaptive" if tol is not None else "fixed"),
            "admm": (f"{base_admm}+{extra}@{tol}" if tol is not None
                     else admm),
            "dual": dual,
            "final_err": round(errs[-1], 4),
            "final_mean_cost": round(costs[-1], 4),
            "asymptotic_mean_cost": round(
                float(np.mean(costs[-tail:])), 4),
            "mean_abs_err_by_frame": [round(e, 4) for e in errs],
            "mean_cost_by_frame": [round(c, 4) for c in costs],
        }
        if tol is not None:
            n_f = sum(fired_seq)
            row.update({
                "tol": tol,
                "frames_fired": n_f,
                "trip_rate": round(n_f / frames, 3),
                "expected_sweeps_per_frame": round(
                    base_admm + extra * n_f / frames, 2),
                "last_fired_frame": (max(i for i, f in
                                         enumerate(fired_seq) if f)
                                     if n_f else -1),
            })
        print(json.dumps({k: v for k, v in row.items()
                          if "by_frame" not in k}), flush=True)
        return row

    rows = [
        closed_loop(admm=full_admm, dual=False),   # shipped 1x5 cold
        closed_loop(admm=full_admm, dual=True),    # 1x5 + dual carry
        closed_loop(admm=base_admm, dual=True),    # fixed 1x3-dual option
    ]
    rows += [closed_loop(tol=t) for t in tols]
    base_cost = rows[0]["asymptotic_mean_cost"]
    for r in rows:
        r["cost_gap_vs_1x5_cold_pct"] = round(
            100.0 * (r["asymptotic_mean_cost"] - base_cost)
            / abs(base_cost), 3)
    return {
        "methodology": (
            "closed receding-horizon loop (shift-by-one + decayed dual "
            "carry, static scene) on real 1080p Sobel features, sweep "
            "backend; adaptive budget emulated exactly via the base "
            "solve's batch-max primal residual (bit-identical to the "
            "in-graph lax.cond continuation — "
            "tests/test_mpc.py::TestAdaptiveBudget); asymptotic cost = "
            "mean over the last fifth of the window"),
        "scenarios": scenarios, "frames": frames, "horizon": horizon,
        "base_admm": base_admm, "extra": extra, "full_admm": full_admm,
        "rows": rows,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--tols", default="0.05,0.1,0.2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    out = run_loop(args.scenarios, args.frames, args.horizon,
                   [float(t) for t in args.tols.split(",") if t],
                   seed=args.seed)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
