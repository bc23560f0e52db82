"""End-to-end /control latency study through the LIVE serving tier.

The product claim is a real-time control endpoint; this measures what a
client actually experiences. For each concurrency level B in the
micro-batcher's buckets, B clients POST /control simultaneously
(multipart 1080p frame + scenario fields, exactly the production
request) against an in-process server, ``runs`` rounds per level, and
the study reports p50/p99 of

- ``e2e``: client-observed wall per request (HTTP + decode + micro-batch
  window + device solve + response), and
- ``compute``: the server-reported device span (the ``compute_s`` field,
  including the frame's host->device copy and the result fetch),

against a stated real-time budget (default 33.3 ms = one 30 Hz frame).

Usage::

    python -m openmp_parallel_computing_tpu.bench.control_latency \
        [--buckets 1,2,4,8,16] [--runs 40] [--budget-ms 33.3] [--out ...]
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def run_study(buckets=(1, 2, 4, 8, 16), runs: int = 40, horizon: int = 20,
              num_features: int = 8, frame_hw=(1080, 1920),
              budget_ms: float = 1e3 / 30.0, window_ms: float = 5.0,
              deadline_ms: float = 1000.0) -> dict:
    import numpy as np
    import requests

    from http.server import ThreadingHTTPServer

    from openmp_parallel_computing_tpu import imgio
    from openmp_parallel_computing_tpu.serve import server as srv

    # The live handler + the real micro-batcher, sized to the largest
    # bucket under study.
    srv._batcher.configure(window_ms / 1e3, max(buckets))

    class _Server(ThreadingHTTPServer):
        # Default listen backlog is 5; 16 simultaneous multi-MB uploads
        # overflow it and the kernel drops connections mid-handshake.
        request_queue_size = 64

    httpd = _Server(("127.0.0.1", 0), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/control"

    rng = np.random.default_rng(0)
    m = num_features
    if frame_hw == (1080, 1920):
        # The production fixture (a real photo): PNG size and decode cost
        # match what a camera client would actually send — random noise
        # encodes ~3x larger and skews the host-side share of e2e.
        from openmp_parallel_computing_tpu import data

        png_bytes = data.frame_path().read_bytes()
    else:
        import tempfile

        frame = rng.integers(0, 256, frame_hw + (3,), dtype=np.uint8)
        with tempfile.NamedTemporaryFile(suffix=".png") as tf:
            imgio.save_png(tf.name, frame)
            png_bytes = open(tf.name, "rb").read()

    def fmt(v):
        return ",".join(f"{float(x):.9g}" for x in np.asarray(v))

    fields = {
        "p0": fmt(rng.uniform(-0.6, 0.6, 2 * m)),
        "target": fmt(rng.uniform(-0.5, 0.5, 2 * m)),
        "depth": fmt(rng.uniform(1.0, 5.0, m)),
        "horizon": str(horizon),
        # Staleness budget: past it the server sheds with 503 instead of
        # queueing (round-4 admission control). 0 = unbounded queueing
        # (the pre-round-4 behavior, kept reachable for A/B).
        "deadline_ms": f"{deadline_ms:g}",
    }

    def post():
        t0 = time.perf_counter()
        try:
            r = requests.post(url, files={"image": ("f.png", png_bytes)},
                              data=fields, timeout=600)
        except requests.ConnectionError:
            # One retry: a dropped handshake under heavy concurrent upload
            # is transport noise, not a latency sample — so the clock
            # restarts too, or the failed attempt would still be counted.
            t0 = time.perf_counter()
            r = requests.post(url, files={"image": ("f.png", png_bytes)},
                              data=fields, timeout=600)
        wall = time.perf_counter() - t0
        if r.status_code == 503:    # shed: counted, not a latency sample
            return wall, None, None
        r.raise_for_status()
        body = r.json()
        return wall, body["compute_s"], body["batched"]

    rows = []
    try:
        for b in buckets:
            e2e, comp, batched = [], [], []
            shed = 0
            shed_ms = []
            # Round 0 is the warm-up (first compile of this bucket's padded
            # batch shape) and is discarded.
            for rnd in range(runs + 1):
                results: list = [None] * b
                barrier = threading.Barrier(b)

                def one(i):
                    barrier.wait()
                    try:
                        results[i] = post()
                    except Exception as exc:  # surface, don't unpack None
                        results[i] = exc

                ts = [threading.Thread(target=one, args=(i,))
                      for i in range(b)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
                errs = [r for r in results if isinstance(r, Exception)]
                if errs:
                    raise RuntimeError(
                        f"concurrency {b}: {len(errs)} request(s) failed: "
                        f"{errs[0]!r}")
                if rnd == 0:
                    continue
                for wall, c, nb in results:
                    if c is None:           # shed (503): fast rejection
                        shed += 1
                        shed_ms.append(1e3 * wall)
                        continue
                    e2e.append(1e3 * wall)
                    comp.append(1e3 * c)
                    batched.append(nb)

            def pct(xs, p):
                # None (valid JSON null), not NaN: json.dump would emit a
                # bare NaN token that strict parsers reject.
                if not xs:                  # every request shed this level
                    return None
                return round(float(np.percentile(np.asarray(xs), p)), 2)

            p99 = pct(e2e, 99)
            row = {
                "concurrency": b,
                "samples": len(e2e),
                "shed": shed,
                "shed_reject_ms_p50": pct(shed_ms, 50),
                "e2e_ms_p50": pct(e2e, 50),
                "e2e_ms_p99": p99,
                "compute_ms_p50": pct(comp, 50),
                "compute_ms_p99": pct(comp, 99),
                "mean_batched": (round(float(np.mean(batched)), 2)
                                 if batched else None),
                "e2e_p99_within_budget": (p99 <= budget_ms
                                          if p99 is not None else None),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        httpd.shutdown()

    return {
        "methodology": (
            "B concurrent POST /control (multipart 1080p PNG + scenario "
            "fields) against the live in-process server per round; "
            f"{runs} rounds per level; percentiles over all requests. "
            "compute_ms is the server's device span including the frame "
            "upload and result fetch; e2e adds HTTP + PNG decode + the "
            "micro-batch window. "
            "Each request carries deadline_ms: the server sheds (503, "
            "counted in 'shed') rather than queue a frame past its "
            "staleness budget, so accepted-request latency stays bounded "
            "at every concurrency."),
        "horizon": horizon, "num_features": num_features,
        "frame": list(frame_hw), "window_ms": window_ms,
        "budget_ms": round(budget_ms, 2),
        "deadline_ms": round(deadline_ms, 2),
        "rows": rows,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", default="1,2,4,8,16")
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--budget-ms", type=float, default=1e3 / 30.0)
    ap.add_argument("--deadline-ms", type=float, default=1000.0,
                    help="per-request staleness budget (0 = no shedding)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = run_study(buckets=tuple(int(b) for b in args.buckets.split(",")),
                    runs=args.runs, horizon=args.horizon,
                    num_features=args.features, budget_ms=args.budget_ms,
                    deadline_ms=args.deadline_ms)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"budget_ms": out["budget_ms"],
                      "rows": len(out["rows"])}))


if __name__ == "__main__":
    main()
