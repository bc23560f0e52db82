"""Multi-device scaling-efficiency measurement.

North-star target (BASELINE.md): >=85% scaling efficiency going from 1 to N
workers. This harness measures MPC solve throughput on growing mesh slices
with the per-device scenario load held constant (weak scaling — the
reference's thread sweep held total work constant, but scenario dispatch is
a throughput system, so the production question is "do N devices serve N
times the scenarios"). Efficiency = throughput(N) / (N * throughput(1)).

On a single-chip environment this runs on the virtual CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) as a functional
rehearsal; on a multi-GPU host the same entry point measures the true
efficiency over NVLink. CSV schema: ``devices,scenarios,avg_s,std_s,solves_per_s,
efficiency``.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import jax
import numpy as np

from openmp_parallel_computing_tpu import parallel
from openmp_parallel_computing_tpu.models.mpc import (
    DistributedMPC,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu.utils.config import MPCConfig


def measure_scaling(cfg: MPCConfig | None = None, device_counts=None,
                    scen_per_device: int = 32, runs: int = 3,
                    frame_shape=(3, 64, 128),
                    out_dir: str | Path = "results") -> list[dict]:
    cfg = cfg or MPCConfig(horizon=20, num_features=8, ilqr_iters=3,
                           admm_iters=5)
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    rng_frame = np.random.default_rng(0)
    frame = rng_frame.integers(0, 256, size=frame_shape, dtype=np.uint8)

    rows = []
    base = None  # (devices, throughput) of the first measured point
    for d in device_counts:
        mesh = parallel.make_mesh(data=d, model=1,
                                  devices=jax.devices()[:d])
        dmpc = DistributedMPC(cfg, mesh)
        n_scen = scen_per_device * d
        scen = VisualServoMPC(cfg).random_scenarios(
            jax.random.PRNGKey(0), n_scen)
        jax.block_until_ready(dmpc.solve(frame, scen))  # compile
        values = []
        for _ in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(dmpc.solve(frame, scen))
            values.append(time.perf_counter() - t0)
        mean = float(np.mean(values))
        tp = n_scen / mean
        if base is None:
            base = (d, tp)
        # per-device throughput relative to the first measured point (which
        # need not be 1 device)
        rows.append({
            "devices": d,
            "scenarios": n_scen,
            "avg_s": mean,
            "std_s": float(np.std(values)),
            "solves_per_s": tp,
            "efficiency": (tp / d) / (base[1] / base[0]),
        })

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "scaling_efficiency.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        wr.writeheader()
        wr.writerows(rows)
    return rows


def main() -> None:
    rows = measure_scaling()
    for r in rows:
        print(f"devices={r['devices']} scenarios={r['scenarios']} "
              f"{r['solves_per_s']:.0f} solves/s "
              f"eff={r['efficiency']:.2%}")


if __name__ == "__main__":
    main()
