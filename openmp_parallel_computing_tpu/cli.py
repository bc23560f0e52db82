"""End-to-end CLI driver.

Capability twin of the reference's compiled drivers: the binary contract
``<input_img> <output_img.png> [kernel_passes]`` (``monolithic/src/main.c:16``
and ``main_with_sobel.c:16-24``), with compute timed separately from image
I/O exactly as the drivers do (``main.c:31-39``: clock starts after decode,
stops before encode) and the same one-line report format.

    python -m openmp_parallel_computing_tpu <in> <out.png> [passes]
        [--kernel grayscale|edge|blur] [--devices N]

``--kernel edge`` reproduces the 4-stage Sobel pipeline build
(``Makefile_with_sobel``); ``--devices`` is the OMP_NUM_THREADS analogue
(spatial sharding over the mesh).
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from openmp_parallel_computing_tpu import imgio
from openmp_parallel_computing_tpu.ops.runner import (
    kernel_names,
    make_runner,
    pad_rows,
)
from openmp_parallel_computing_tpu.utils.compile_cache import (
    enable_compile_cache,
)

_LABELS = {
    "grayscale": "Compute kernel",
    "edge": "Compute kernel (grayscale + sobel)",
    "blur": "Compute kernel (gaussian blur)",
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="openmp_parallel_computing_tpu",
        description="image-kernel driver (reference binary contract)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("passes", nargs="?", type=int, default=1)
    ap.add_argument("--kernel", default="grayscale",
                    choices=list(kernel_names()))
    ap.add_argument("--devices", type=int, default=1)
    args = ap.parse_args(argv)
    passes = max(1, args.passes)
    enable_compile_cache()

    try:
        hwc = imgio.load(args.input)
    except Exception as exc:
        print(f"error loading image: {exc}", file=sys.stderr)
        return 1

    devices = max(1, min(args.devices, len(jax.devices())))
    chw, orig_h = pad_rows(jnp.asarray(np.transpose(hwc, (2, 0, 1))),
                           devices)
    run = make_runner(args.kernel, passes, devices, orig_h=orig_h)
    # compile outside the timed region (decode also excluded)
    jax.block_until_ready(run(chw))

    t0 = time.perf_counter()
    out = run(chw)
    jax.block_until_ready(out)
    secs = time.perf_counter() - t0
    label = _LABELS.get(args.kernel, f"Compute kernel ({args.kernel})")
    print(f"{label} ×{passes}: {secs:.4f} s")

    out_hwc = np.transpose(np.asarray(out)[:, :orig_h, :], (1, 2, 0))
    try:
        imgio.save_png(args.output, out_hwc)
    except Exception as exc:
        print(f"error saving image: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
