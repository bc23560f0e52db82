"""Timing and profiling utilities.

Mirrors the reference's three timing mechanisms (SURVEY.md §5):

- kernel-region timing (``clock_gettime`` around the compute loop,
  ``monolithic/src/main.c:31-39``) -> ``device_time``: wall-clock around a
  jitted, device-blocked computation, excluding compile via warmup;
- process-level ``/usr/bin/time`` stats -> ``measure`` returns mean±σ over
  runs like the bench scripts' awk accumulation
  (``bench_and_plot_monolithic.sh:50-62``);
- service spans (``X-Elapsed``) -> ``Stopwatch`` for host-side spans.

``trace`` wraps ``jax.profiler`` for deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable

import jax


@dataclasses.dataclass
class Measurement:
    mean_s: float
    std_s: float
    runs: int
    values: list[float]

    @property
    def throughput(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else math.inf


class Stopwatch:
    """Host-side span timer (the ``X-Elapsed`` analogue)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self.t0
        return False


def device_time(fn: Callable, *args, runs: int = 5, warmup: int = 1,
                inner_iters: int = 1) -> Measurement:
    """Time a device computation: warm up (compile), then wall-time
    ``runs`` executions, each blocked on the device result.

    ``inner_iters`` divides the measured time when ``fn`` itself loops
    (e.g. a scan over kernel passes) so the result is per-iteration.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    values = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        values.append((time.perf_counter() - t0) / inner_iters)
    mean = sum(values) / len(values)
    var = sum((v - mean) ** 2 for v in values) / len(values)
    return Measurement(mean_s=mean, std_s=math.sqrt(var), runs=runs,
                       values=values)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ompc_trace"):
    """jax.profiler trace context for offline inspection."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
