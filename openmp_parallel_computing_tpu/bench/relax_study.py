"""ADMM over-relaxation quality study: final cost vs iteration budget.

Measures whether over-relaxation (``MPCConfig.admm_relax``, Boyd et al.,
*Distributed Optimization* §3.4.3) reaches the plain-ADMM quality plateau
with a smaller iteration budget. Throughput scales ~linearly with
``admm_iters x ilqr_iters`` (the sweep count — docs/DESIGN.md §2b), so a
budget cut at equal final cost converts directly into solves/s.

This is a QUALITY study, not a throughput bench: the solve is identical
math on every backend/hardware (equivalence-tested), so it runs fine on
CPU with the "reference" backend — pass ``--cpu`` on a GPU host.
Quality metric: mean true final cost (tracking + control + edge, evaluated
on the feasible projected controls) against a converged baseline
(``--baseline-iters`` ADMM x iLQR, plain ADMM), plus the primal residual.

Usage::

    python -m openmp_parallel_computing_tpu.bench.relax_study --cpu \
        [--scenarios 64] [--edge-refresh solve] [--out results/cpu/...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def run(scenarios: int, edge_refresh: str, relaxes, budgets,
        baseline_iters=(8, 30), seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.ops import xla_ref
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    # Real 1080p Sobel features (the shipped perception ops, checked
    # against the reference goldens in tests/test_golden_parity.py) so the
    # edge cost term sees the production texture statistics.
    frame = data.load_frame_planar()
    edge_map = xla_ref.edge_pipeline(frame)[0].astype(jnp.float32)

    def solve(ilqr, admm, relax):
        cfg = MPCConfig(ilqr_iters=ilqr, admm_iters=admm, admm_relax=relax,
                        backend="reference", edge_refresh=edge_refresh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(seed), scenarios)
        sol = mpc.solve_batch(edge_map, scen)
        return (float(jnp.mean(sol.cost)),
                float(jnp.mean(sol.primal_residual)),
                float(jnp.max(sol.primal_residual)))

    base_ilqr, base_admm = baseline_iters
    base_cost, _, _ = solve(base_ilqr, base_admm, 1.0)

    rows = []
    for ilqr, admm in budgets:
        for relax in relaxes:
            cost, res_mean, res_max = solve(ilqr, admm, relax)
            rows.append({
                "ilqr": ilqr, "admm": admm, "sweeps": ilqr * admm,
                "relax": relax, "mean_cost": round(cost, 4),
                "cost_gap_vs_converged_pct": round(
                    100.0 * (cost - base_cost) / abs(base_cost), 3),
                "mean_primal_residual": round(res_mean, 4),
                "max_primal_residual": round(res_max, 4),
            })
            print(json.dumps(rows[-1]), flush=True)
    return {
        "methodology": (
            "mean true final cost (feasible controls) on real 1080p Sobel "
            "features, reference backend, cold-start random scenarios; "
            f"converged baseline = plain ADMM {base_ilqr}x{base_admm}"),
        "edge_refresh": edge_refresh,
        "scenarios": scenarios,
        "baseline_mean_cost": round(base_cost, 4),
        "rows": rows,
    }


def run_loop(scenarios: int, frames: int, edge_refresh: str, configs,
             seed: int = 0, horizon: int = 20,
             dual_decay: float | None = None) -> dict:
    """Closed-loop receding-horizon quality: run ``frames`` warm-started
    solves (shift-by-one, the MPCRuntime pattern) per config and report the
    tracking-error trajectory — the regime the headline bench models, where
    a smaller relaxed iteration budget must not destabilize the loop."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.ops import xla_ref
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = data.load_frame_planar()
    edge_map = xla_ref.edge_pipeline(frame)[0].astype(jnp.float32)

    rows = []
    for config in configs:
        # (ilqr, admm, relax) or (ilqr, admm, relax, dual_carry): the
        # 4th element turns on the ADMM dual warm start across frames
        # (MPCConfig.dual_warm_start — Scenario.y0 carries the shifted
        # scaled duals, the closed-loop regime where warm-started ADMM
        # classically needs fewer iterations).
        ilqr, admm, relax = config[:3]
        dual = bool(config[3]) if len(config) > 3 else False
        kw = {} if dual_decay is None else {"dual_decay": dual_decay}
        cfg = MPCConfig(horizon=horizon, ilqr_iters=ilqr,
                        admm_iters=admm, admm_relax=relax,
                        backend="reference", edge_refresh=edge_refresh,
                        dual_warm_start=dual, **kw)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(seed), scenarios)
        if dual:
            # duals out iff duals in: seed the carry with cold zeros
            scen = scen._replace(y0=jnp.zeros_like(scen.us0))
        err0 = float(jnp.mean(jnp.abs(scen.p0 - scen.target)))
        errs, costs, resids = [], [], []
        for _ in range(frames):
            sol = mpc.solve_batch(edge_map, scen)
            resids.append(float(jnp.mean(sol.primal_residual)))
            # MPCRuntime.step: advance to the predicted next state, shift
            # the optimized controls one step (and the duals, when warm-
            # started).
            shifted = jnp.concatenate(
                [sol.us[:, 1:], jnp.zeros_like(sol.us[:, :1])], axis=1)
            y0 = None
            if dual:
                y0 = cfg.dual_decay * jnp.concatenate(
                    [sol.dual[:, 1:], jnp.zeros_like(sol.dual[:, :1])],
                    axis=1)
            scen = scen._replace(p0=sol.ps[:, 1], us0=shifted, y0=y0)
            errs.append(float(jnp.mean(jnp.abs(scen.p0 - scen.target))))
            costs.append(float(jnp.mean(sol.cost)))
        rows.append({
            "ilqr": ilqr, "admm": admm, "relax": relax, "dual": dual,
            "dual_decay": cfg.dual_decay if dual else None,
            "sweeps": ilqr * admm, "err0": round(err0, 4),
            "mean_abs_err_by_frame": [round(e, 4) for e in errs],
            "final_err": round(errs[-1], 4),
            "mean_cost_by_frame": [round(c, 4) for c in costs],
            "final_mean_cost": round(costs[-1], 4),
            # constraint satisfaction where the dual carry acts: mean
            # primal residual over the settled back half of the window
            "mean_primal_residual_late": round(
                float(np.mean(resids[frames // 2:])), 5),
        })
        print(json.dumps(rows[-1]), flush=True)
    return {"methodology": (
        "closed receding-horizon loop (shift-by-one warm start, static "
        "scene) on real 1080p Sobel features, reference backend; "
        "mean |p - target| per frame"),
        "edge_refresh": edge_refresh, "scenarios": scenarios,
        "frames": frames, "horizon": horizon, "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (quality is hardware-"
                         "independent; use when the GPU is busy/offline)")
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--edge-refresh", default="solve",
                    choices=("ilqr", "admm", "solve"))
    ap.add_argument("--relaxes", default="1.0,1.3,1.5,1.6,1.8")
    ap.add_argument("--budgets", default="3x5,3x4,3x3,2x5,2x4,2x3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", type=int, default=0, metavar="FRAMES",
                    help="closed-loop mode: run FRAMES warm-started solves "
                         "per config (configs = the budgets grid x relaxes)")
    ap.add_argument("--horizon", type=int, default=20,
                    help="MPC horizon for the closed-loop mode (e.g. 50 "
                         "for the pod config)")
    ap.add_argument("--dual-decay", type=float, default=None,
                    help="override MPCConfig.dual_decay for the dual=True "
                         "arms (e.g. 1.0 to reproduce the measured "
                         "undamped-carry divergence at H=50)")
    ap.add_argument("--dual", action="store_true",
                    help="closed-loop mode: also run every config with the "
                         "ADMM dual warm start carried across frames "
                         "(MPCConfig.dual_warm_start)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    relaxes = [float(x) for x in args.relaxes.split(",")]
    budgets = [tuple(int(v) for v in b.split("x"))
               for b in args.budgets.split(",")]
    if args.loop:
        duals = (False, True) if args.dual else (False,)
        configs = [(i, a, rx, d) for (i, a) in budgets for rx in relaxes
                   for d in duals]
        out = run_loop(args.scenarios, args.loop, args.edge_refresh,
                       configs, seed=args.seed, horizon=args.horizon,
                       dual_decay=args.dual_decay)
    else:
        out = run(args.scenarios, args.edge_refresh, relaxes, budgets,
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
