"""Serving test client.

Capability twin of ``microservices/grayscale/test_client.py:1-55``: multipart
POST of an image with ``--threads`` / ``--passes`` knobs, saves the response
PNG, prints the end-to-end request time and the server-side ``X-Elapsed`` /
``X-Compute`` spans (the two latencies the service bench CSV records).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import requests


def run_request(url: str, image: str | Path, out: str | Path,
                kernel: str = "grayscale", threads: int = 1,
                passes: int = 1, timeout_s: float = 900.0) -> dict:
    # timeout bounds a wedged server (first compiles can run minutes, so
    # the default is generous — but never infinite: a requests.post with
    # no timeout hangs the whole bench sweep if the service stalls).
    with open(image, "rb") as f:
        files = {"image": (Path(image).name, f)}
        data = {"threads": str(threads), "passes": str(passes)}
        t0 = time.perf_counter()
        resp = requests.post(f"{url.rstrip('/')}/{kernel}", files=files,
                             data=data, timeout=timeout_s)
        request_s = time.perf_counter() - t0
    resp.raise_for_status()
    Path(out).write_bytes(resp.content)
    return {
        "request_s": request_s,
        "service_s": float(resp.headers.get("X-Elapsed", "nan")),
        "compute_s": float(resp.headers.get("X-Compute", "nan")),
        "bytes": len(resp.content),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--url", default="http://localhost:5000")
    ap.add_argument("--kernel", default="grayscale")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args()
    r = run_request(args.url, args.image, args.out, args.kernel,
                    args.threads, args.passes)
    print(f"request: {r['request_s']:.4f}s  service: {r['service_s']:.4f}s  "
          f"compute: {r['compute_s']:.4f}s  -> {args.out}")


if __name__ == "__main__":
    main()
