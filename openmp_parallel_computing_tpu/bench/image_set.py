"""Size-scaling studies over the in-package image set (BASELINE configs
2-3): the blur benchmark on the half-megapixel photo and the edge pipeline
across the 1080p -> 6 MP fixture set.

The reference ships its benchmark inputs in-repo and names the runs in its
committed results (``monolithic/results/``; inputs
``images/{test,half_of_a_mega_photo,more_than_one_mega_photo}.jpg``,
canonical input named at ``README.md:28``). This module regenerates the
equivalent artifacts — ``<out>/blur_halfmega/`` (CSV + plots via the
harness) and ``<out>/edge_images_set.json`` — from the
in-package lossless re-encodes (``data.fixture_set()``), so both studies
run from a clean checkout with no reference mount.

Usage::

    python -m openmp_parallel_computing_tpu.bench.image_set \
        [--runs 3] [--passes 10] [--out chiprun_out/image_set]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from openmp_parallel_computing_tpu import data
from openmp_parallel_computing_tpu.bench.harness import bench_kernel


def blur_halfmega(out_dir: str | Path, runs: int = 3,
                  passes: int = 10) -> list:
    """BASELINE config 2: 3x3 Gaussian blur on the 2037x1362 photo —
    CSV + tempo/speed-up plots in the reference harness schema."""
    return bench_kernel(data.half_mega_path(), workers=(1,), runs=runs,
                        passes=passes, kernel="blur",
                        out_dir=Path(out_dir) / "blur_halfmega")


def edge_images_set(out_dir: str | Path, runs: int = 3,
                    passes: int = 10) -> dict[str, float]:
    """BASELINE config 3: the fused grayscale->Sobel edge pipeline across
    the full fixture set (1080p -> 6 MP). Returns and writes
    {fixture_name: avg wall seconds per run of ``passes`` device passes}
    (kernel-only timing, like the monolithic driver's compute region)."""
    import tempfile

    out: dict[str, float] = {}
    for name, path in data.fixture_set().items():
        # Per-image harness CSVs/plots are intermediates; only the summary
        # JSON is the committed artifact, so they go to a temp dir.
        with tempfile.TemporaryDirectory() as tmp:
            rows = bench_kernel(path, workers=(1,), runs=runs,
                                passes=passes, kernel="edge",
                                out_dir=Path(tmp) / f"edge_{name}")
        out[name] = rows[0].avg_real_s
    dst = Path(out_dir) / "edge_images_set.json"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(json.dumps(out, indent=1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--out", default="results/image_set")
    args = ap.parse_args()
    rows = blur_halfmega(args.out, runs=args.runs, passes=args.passes)
    print(json.dumps({"blur_halfmega_avg_s": rows[0].avg_real_s}))
    print(json.dumps(edge_images_set(args.out, runs=args.runs,
                                     passes=args.passes)))


if __name__ == "__main__":
    main()
