"""Benchmark harness: the reference's sweep methodology on JAX devices.

Reproduces the contract of ``monolithic/scripts/bench_and_plot_monolithic.sh``
(C8) and ``microservices/grayscale/scripts/bench_grayscale_service.sh`` (C11):

- sweep a worker axis x runs x kernel passes;
- mean +- sigma accumulation per configuration (the awk loop, ``:50-62``);
- CSV schemas ``threads,avg_real_sec,std_real_sec,avg_cpu_pct,avg_mem_kb``
  (``:32``) and ``threads,avg_request_sec,std_request_sec,avg_service_sec,
  std_service_sec`` (service ``:19``);
- ``tempo_vs_thread.png`` / ``speedup_vs_thread.png`` plots with speed-up
  t(1)/t(N) (``:68-86``).

The OpenMP thread count becomes the device count: each sweep point runs the
kernel spatially sharded over that many mesh devices. ``passes`` repeats the
kernel inside one jitted ``fori_loop`` — on-device temporal repetition, the
analogue of the driver's passes loop (``monolithic/src/main.c:33-35``) with
compute timed apart from I/O exactly as ``main.c:31-39`` does.
"""

from __future__ import annotations

import csv
import dataclasses
import resource
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from openmp_parallel_computing_tpu import imgio
from openmp_parallel_computing_tpu.ops.runner import make_runner, pad_rows


@dataclasses.dataclass
class SweepRow:
    workers: int
    avg_real_s: float
    std_real_s: float
    avg_cpu_pct: float
    avg_mem_kb: float


def bench_kernel(image: str | Path | np.ndarray, workers=(1,), runs: int = 3,
                 passes: int = 10, kernel: str = "grayscale",
                 out_dir: str | Path = "results") -> list[SweepRow]:
    """Device-count sweep of a kernel; writes the monolithic-schema CSV and
    the two plots. Returns the rows."""
    if isinstance(image, (str, Path)):
        image = imgio.load(image)
    chw = np.transpose(image, (2, 0, 1)).copy()

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows: list[SweepRow] = []
    n_dev = len(jax.devices())
    usable = [w for w in workers if w <= n_dev]
    if not usable:
        # Fail loudly: silently skipping every count writes an empty CSV
        # and plot_sweep then crashes on ts[0] with a baffling IndexError.
        raise ValueError(
            f"requested worker counts {tuple(workers)} all exceed the "
            f"{n_dev} available devices")

    for w in usable:
        img, orig_h = pad_rows(jnp.asarray(chw), w)
        run = make_runner(kernel, passes, w, orig_h=orig_h)
        x = jax.device_put(img)
        jax.block_until_ready(run(x))  # compile outside the timed region

        values = []
        cpu0 = time.process_time()
        for _ in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(run(x))
            values.append(time.perf_counter() - t0)
        cpu_pct = 100.0 * (time.process_time() - cpu0) / max(sum(values),
                                                            1e-9)
        mem_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        mean = float(np.mean(values))
        rows.append(SweepRow(
            workers=w, avg_real_s=mean, std_real_s=float(np.std(values)),
            avg_cpu_pct=round(cpu_pct, 1), avg_mem_kb=float(mem_kb)))

    csv_path = out_dir / f"{kernel}_bench.csv"
    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["threads", "avg_real_sec", "std_real_sec",
                     "avg_cpu_pct", "avg_mem_kb"])
        for r in rows:
            wr.writerow([r.workers, f"{r.avg_real_s:.6f}",
                         f"{r.std_real_s:.6f}", r.avg_cpu_pct, r.avg_mem_kb])
    plot_sweep(rows, out_dir, kernel)
    return rows


def bench_service(image: str | Path, url: str, workers=(1,), runs: int = 3,
                  passes: int = 1, kernel: str = "grayscale",
                  out_dir: str | Path = "results") -> list[dict]:
    """Service-tier sweep against a running HTTP endpoint (C11 contract):
    per device count, ``runs`` requests; records end-to-end request time and
    the server-side X-Elapsed span; CSV schema
    ``threads,avg_request_sec,std_request_sec,avg_service_sec,
    std_service_sec`` (bench_grayscale_service.sh:19)."""
    from openmp_parallel_computing_tpu.serve.client import run_request

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for w in workers:
        # One unrecorded warmup request absorbs jit compilation (the
        # reference service has no compile step; recording it would skew
        # the mean by orders of magnitude on first contact).
        run_request(url, image, out_dir / f".svc_out_{w}.png",
                    kernel=kernel, threads=w, passes=passes)
        req, svc = [], []
        for i in range(runs):
            r = run_request(url, image, out_dir / f".svc_out_{w}.png",
                            kernel=kernel, threads=w, passes=passes)
            req.append(r["request_s"])
            svc.append(r["service_s"])
        rows.append({
            "threads": w,
            "avg_request_sec": float(np.mean(req)),
            "std_request_sec": float(np.std(req)),
            "avg_service_sec": float(np.mean(svc)),
            "std_service_sec": float(np.std(svc)),
        })
    with open(out_dir / "service_bench.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        wr.writeheader()
        wr.writerows(rows)
    return rows


def plot_sweep(rows: list[SweepRow], out_dir: Path, kernel: str) -> None:
    """tempo/speedup plots in the reference's format."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ws = [r.workers for r in rows]
    ts = [r.avg_real_s for r in rows]
    errs = [r.std_real_s for r in rows]

    fig, ax = plt.subplots()
    ax.errorbar(ws, ts, yerr=errs, marker="o", capsize=3)
    ax.set_xlabel("devices")
    ax.set_ylabel("time [s]")
    ax.set_title(f"{kernel}: time vs devices")
    ax.grid(True, alpha=0.3)
    fig.savefig(out_dir / "tempo_vs_thread.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots()
    base = ts[0]
    ax.plot(ws, [base / t for t in ts], marker="o", label="measured")
    ax.plot(ws, ws, linestyle="--", alpha=0.5, label="ideal")
    ax.set_xlabel("devices")
    ax.set_ylabel("speed-up t(1)/t(N)")
    ax.set_title(f"{kernel}: speed-up vs devices")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(out_dir / "speedup_vs_thread.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)
