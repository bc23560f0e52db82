"""Profiler study of the production loops on the GPU.

Captures a ``jax.profiler`` trace of one warm window of

- ``receding_horizon_frames`` at the headline configuration (4096
  scenarios, H=20, per-step perception on a ring of distinct 1080p
  frames, edge_refresh="solve");
- the same loop with the adaptive ADMM budget off
  (``admm_iters_extra=0``: no ``lax.cond`` gate in the step), so the
  difference in device->host copies per step is the gate's;
- ``receding_horizon`` at 256 scenarios (fixed frame: the solver-only
  loop at a small batch),

and reduces each trace to: the device ops grouped by family, kernel
launches per control step, host<->device copies per step (a copy per
step is a host round trip, e.g. a ``lax.cond`` predicate read back),
and the device idle share of the window (1 - the union of
device op intervals over the window's span).

Usage::

    python -m openmp_parallel_computing_tpu.bench.trace_study \
        [--steps 20] [--out chiprun_out/trace_study.json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile

_DEVICE = re.compile(r"/device:GPU:\d+")


def _capture(fn, log_dir: str) -> str:
    """Run fn under a profiler trace (after one warm call); return the
    trace.json.gz path."""
    import jax

    jax.block_until_ready(fn())          # compile outside the trace
    jax.profiler.start_trace(log_dir)
    jax.block_until_ready(fn())
    jax.profiler.stop_trace()
    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins/profile/*/*.trace.json.gz")))
    assert paths, f"no trace written under {log_dir}"
    return paths[-1]


def device_pids(events: list[dict]) -> dict[int, str]:
    """pid -> process name of the GPU device planes of a trace."""
    return {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and _DEVICE.search(str(e.get("args", {}).get("name", "")))}


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_table(events: list[dict], steps: int) -> dict:
    """Per-family device time, launches and copies per step, idle share."""
    pids = device_pids(events)
    durs = collections.Counter()
    counts = collections.Counter()
    spans = []
    copies = to_host = 0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in pids:
            continue
        name = e.get("name", "")
        start, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        spans.append((start, start + dur))
        low = name.lower()
        if "memcpy" in low or "memset" in low:
            # One family per copy kind, so a device->host copy (a host
            # round trip) is told apart from a copy on the device.
            family = re.sub(r"\d+", "", name).strip()
            copies += "memcpy" in low
            to_host += bool(re.search(r"d(to|2)h", low))
        elif "fusion" in name or name.startswith(("loop_", "input_")):
            family = "xla_fusion"
        else:
            family = re.sub(r"[._]\d+$", "", name)
        durs[family] += dur
        counts[family] += 1
    if not spans:
        return {"device_planes": sorted(set(pids.values())),
                "error": "no device events"}
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _union_us(spans)
    total = sum(durs.values())
    return {
        "device_planes": sorted(set(pids.values())),
        "window_us": window,
        "busy_us": busy,
        "idle_share": 1.0 - busy / window if window else None,
        "device_ops": sum(counts.values()),
        "ops_per_step": sum(counts.values()) / steps,
        "memcpy_per_step": copies / steps,
        "device_to_host_per_step": to_host / steps,
        "families": [{"op": n, "total_us": d, "count": counts[n],
                      "share": d / total}
                     for n, d in durs.most_common(15)],
    }


def run_study(steps: int) -> dict:
    import jax

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = data.load_frame_planar()
    frames = data.frame_ring(frame, 8)
    out = {}

    def one(name, batch, per_step_frames, **overrides):
        cfg = MPCConfig(horizon=20, num_features=8, scenarios=batch,
                        edge_refresh="solve", **overrides)
        mpc = VisualServoMPC(cfg)
        # Start from a warm scenario (dual carry present), so the traced
        # window runs the same executable as the warm-up call.
        scen = mpc.random_scenarios(jax.random.PRNGKey(0), batch)
        scen = mpc._seed_duals(scen)
        state = {"scen": scen}

        def go():
            if per_step_frames:
                u0s, _, state["scen"] = mpc.receding_horizon_frames(
                    frames, state["scen"], steps)
            else:
                u0s, _, state["scen"] = mpc.receding_horizon(
                    frame, state["scen"], steps)
            return u0s

        with tempfile.TemporaryDirectory() as td:
            with gzip.open(_capture(go, td)) as f:
                events = json.load(f).get("traceEvents", [])
        table = device_table(events, steps)
        table.update(batch=batch, steps=steps)
        out[name] = table
        print(json.dumps({name: table}), flush=True)

    one("frames_4096_h20", 4096, True)
    one("frames_4096_h20_no_gate", 4096, True, admm_iters_extra=0)
    one("fixed_frame_256_h20", 256, False)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("trace_study: no GPU found", file=sys.stderr)
        return 2
    out = {"device": jax.devices()[0].device_kind, **run_study(args.steps)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
