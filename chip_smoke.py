"""Smoke run of the main path on the attached GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Phases (one process, so one JAX client holds the card): the card; the
image ops at 1080p against the reference goldens; the MPC control step at
the shipped width (4096 scenarios, H=20, 8 features) against the reference
backend and the pinned golden, a 20-step receding-horizon window and one
H=50 step; the HTTP server's /control, /edge and /healthz; one MPC job
through the dispatch queue. The checks live in
``openmp_parallel_computing_tpu.smoke``.

Prints each phase's facts, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Exits non-zero, without that line, when any phase fails or when JAX finds
no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback

from openmp_parallel_computing_tpu.utils.compile_cache import (
    enable_compile_cache,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded checks")
    args = ap.parse_args(argv)
    cache = enable_compile_cache()

    import jax

    from openmp_parallel_computing_tpu import smoke

    dev = smoke.device_facts()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev['platform']!r})",
              file=sys.stderr)
        return 2
    if dev["count"] < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs that many GPUs, "
              f"found {dev['count']}", file=sys.stderr)
        return 2
    print(f"card: {smoke.card_line()}")
    print(f"jax {jax.__version__}: {dev['kind']} x{dev['count']}, "
          f"compile cache {cache}", flush=True)

    if args.devices == 4:
        phases = [("distributed", lambda: smoke.check_distributed(
            n_devices=4))]
    else:
        tmp = tempfile.TemporaryDirectory()
        phases = [("perception", smoke.check_perception),
                  ("mpc", smoke.check_mpc),
                  ("served", smoke.check_served),
                  ("dispatch", lambda: smoke.check_dispatch(tmp.name))]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            facts = run()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            continue
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s "
              f"{json.dumps(facts)}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(f"card: {smoke.card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
