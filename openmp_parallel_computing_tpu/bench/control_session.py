"""/control receding-horizon sessions: live-server quality + price.

Round-4 VERDICT weak #1: the serving tier re-solved every frame from
zero while the framework's own warm-start machinery sat unused. This
study drives the LIVE server (real handler, real micro-batcher, real
multipart requests) as a camera client would — a closed loop where each
frame's measured feature positions are POSTed, the returned first
control is applied to the plant, and the next frame observes the result
— and A/Bs the round-5 ``session`` field:

- STATELESS arm: every request cold-starts (plan = 0, duals = 0). Under
  the shipped adaptive budget the cold batch-max residual trips the
  gate every frame -> full 1x5 budget per request.
- SESSION arm: the same loop with a session token; the server carries
  the shifted plan + decayed duals between requests
  (``serve.server._SessionStore``), so once the session settles the
  residual passes the gate and the solve runs the reduced 1x3 base.

Reported per arm: per-request device span (``compute_s`` p50/p99 —
server-reported, including the frame upload), closed-loop
TRUE tracking cost on the client's plant, and the per-frame cost
trajectory. Done-criterion: session cost <= stateless cost AND session
compute measurably cheaper.

Usage (owns the GPU; quiet host)::

    python -m openmp_parallel_computing_tpu.bench.control_session \
        [--frames 100] [--out chiprun_out/control_session.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time


def device_decomposition(horizon: int = 20, num_features: int = 8,
                         seed: int = 0, reps: int = 60) -> dict:
    """Per-request DEVICE cost of the warm vs cold solve, amortized
    over a dependent chain (each rep consumes the previous solution, so
    the fixed per-call cost spreads; a single live request's compute_s
    includes the ~6 MB frame upload and cannot resolve a ms-level solver
    delta). Both arms run ONE jitted
    computation per request (solve + carry update)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import Scenario
    from openmp_parallel_computing_tpu.models.mpc.solver import (
        _shift_tail_zero)
    from openmp_parallel_computing_tpu.serve import server as srv

    rng = np.random.default_rng(seed)
    m = num_features
    p0 = rng.uniform(-0.6, 0.6, 2 * m).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, 2 * m).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, m).astype(np.float32)
    mpc = srv._mpc_engine(horizon, m)
    frame_dev = jax.device_put(jnp.asarray(np.transpose(
        data.load_frame_hwc(), (2, 0, 1)))[None])

    def chain(warm: bool):
        scen = Scenario(
            p0=jnp.asarray(p0)[None], target=jnp.asarray(target)[None],
            depth=jnp.asarray(depth)[None],
            us0=jnp.zeros((1, horizon, 6), jnp.float32),
            y0=jnp.zeros((1, horizon, 6), jnp.float32) if warm
            else None)

        @jax.jit
        def one(s):
            u0, sol = mpc.control_step_multi(frame_dev, s)
            if warm:
                return s._replace(
                    p0=sol.ps[:, 1],
                    us0=jax.vmap(_shift_tail_zero)(sol.us),
                    y0=mpc.cfg.dual_decay
                    * jax.vmap(_shift_tail_zero)(sol.dual))
            # stateless: next request still depends on this result
            # (ordering forced) but carries no state
            return s._replace(p0=sol.ps[:, 1])

        for _ in range(10):            # warm compile + settle
            scen = one(scen)
        np.asarray(scen.p0)
        t0 = time.perf_counter()
        for _ in range(reps):
            scen = one(scen)
        jax.block_until_ready(scen.p0)
        return 1e3 * (time.perf_counter() - t0) / reps

    cold_ms = chain(False)
    warm_ms = chain(True)
    return {"chain_reps": reps, "cold_ms_per_request": round(
        cold_ms, 3), "warm_ms_per_request": round(warm_ms, 3),
        "device_saving_pct": round(100 * (1 - warm_ms / cold_ms), 1)}


def run(frames_n: int, horizon: int = 20, num_features: int = 8,
        seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import requests
    from http.server import ThreadingHTTPServer

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import dynamics
    from openmp_parallel_computing_tpu.serve import server as srv
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/control"
    png_bytes = data.frame_path().read_bytes()

    cfg = MPCConfig(horizon=horizon, num_features=num_features)
    rng = np.random.default_rng(seed)
    m = num_features
    p0 = rng.uniform(-0.6, 0.6, 2 * m).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, 2 * m).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, m).astype(np.float32)

    def fmt(v):
        return ",".join(f"{float(x):.9g}" for x in np.asarray(v))

    step_fn = jax.jit(lambda p, u: dynamics.step(
        jnp.asarray(p), jnp.asarray(u), jnp.asarray(depth), cfg.dt))

    def drive(session: str | None):
        p = p0.copy()
        comp, costs, resids = [], [], []
        fields = {"target": fmt(target), "depth": fmt(depth),
                  "horizon": str(horizon), "deadline_ms": "0"}
        if session:
            fields["session"] = session
        for t in range(frames_n + 1):      # +1: round 0 warms, discarded
            fields["p0"] = fmt(p)
            r = requests.post(url, files={"image": ("f.png", png_bytes)},
                              data=fields, timeout=600)
            r.raise_for_status()
            body = r.json()
            u0 = np.asarray(body["u0"], np.float32)
            if t > 0:
                comp.append(1e3 * body["compute_s"])
                resids.append(body["primal_residual"])
                # TRUE closed-loop stage cost on the client's plant
                costs.append(float(
                    cfg.q_track * np.sum((p - target) ** 2)
                    + cfg.r_ctrl * np.sum(u0 ** 2)))
            if session:
                assert body.get("session") == session, body
            p = np.asarray(step_fn(p, u0))
        tail = max(1, frames_n // 5)
        return {
            "mode": "session" if session else "stateless",
            "compute_ms_p50": round(statistics.median(comp), 3),
            "compute_ms_p99": round(float(np.quantile(comp, 0.99)), 3),
            "compute_ms_mean": round(float(np.mean(comp)), 3),
            "mean_stage_cost": round(float(np.mean(costs)), 5),
            "asymptotic_stage_cost": round(
                float(np.mean(costs[-tail:])), 5),
            "final_err": round(float(np.mean(np.abs(p - target))), 5),
            "mean_primal_residual": round(float(np.mean(resids)), 4),
            "cost_by_frame": [round(c, 4) for c in costs],
        }

    try:
        stateless = drive(None)
        print(json.dumps({k: v for k, v in stateless.items()
                          if k != "cost_by_frame"}), flush=True)
        session = drive("cam-bench-r5")
        print(json.dumps({k: v for k, v in session.items()
                          if k != "cost_by_frame"}), flush=True)
        # repeat the stateless arm to bound run-to-run compute noise
        stateless2 = drive(None)
        decomp = device_decomposition(horizon=horizon,
                                      num_features=num_features,
                                      seed=seed)
        print(json.dumps(decomp), flush=True)
    finally:
        httpd.shutdown()

    return {
        "methodology": (
            "LIVE server (real handler + micro-batcher), one camera "
            "client in closed loop: POST frame + measured p0, apply the "
            "returned u0 to the plant (dynamics.step, same depths), "
            "observe, repeat. compute_s is the server-reported device "
            "span, including the frame upload. Arms are identical except "
            "the session token."),
        "frames": frames_n, "horizon": horizon,
        "num_features": num_features,
        "engine_defaults": "adaptive 1x(2+3@0.1) + dual carry (r5b)",
        "rows": [stateless, session, stateless2],
        "device_decomposition": decomp,
        "compute_saving_pct": round(100.0 * (
            1 - session["compute_ms_mean"]
            / stateless["compute_ms_mean"]), 1),
        "cost_delta_pct": round(100.0 * (
            session["asymptotic_stage_cost"]
            / stateless["asymptotic_stage_cost"] - 1), 2),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="debug/shakeout on the CPU backend (timings are "
                         "then not device figures)")
    ap.add_argument("--decomp-only", action="store_true",
                    help="re-run just the device-chain decomposition "
                         "(warm vs cold per-request device cost)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    if args.decomp_only:
        out = device_decomposition(horizon=args.horizon)
    else:
        out = run(args.frames, horizon=args.horizon)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    else:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
