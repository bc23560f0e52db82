"""Benchmark harness tests: CSV/plot contract, integration run with runs=1
(the reference keeps its harness runnable as the de-facto regression test)."""

import csv
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from openmp_parallel_computing_tpu import imgio
from openmp_parallel_computing_tpu.bench.harness import (
    bench_kernel,
    bench_service,
)
from openmp_parallel_computing_tpu.serve.server import Handler


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(48, 160, 3), dtype=np.uint8)
    p = tmp_path_factory.mktemp("b") / "in.png"
    imgio.save_png(p, img)
    return p


def test_kernel_sweep_csv_and_plots(png, tmp_path):
    rows = bench_kernel(png, workers=(1, 2), runs=2, passes=2,
                        kernel="edge", out_dir=tmp_path)
    assert [r.workers for r in rows] == [1, 2]
    assert all(r.avg_real_s > 0 for r in rows)
    with open(tmp_path / "edge_bench.csv") as f:
        header = next(csv.reader(f))
    assert header == ["threads", "avg_real_sec", "std_real_sec",
                      "avg_cpu_pct", "avg_mem_kb"]
    assert (tmp_path / "tempo_vs_thread.png").exists()
    assert (tmp_path / "speedup_vs_thread.png").exists()


def test_grayscale_sweep_single(png, tmp_path):
    rows = bench_kernel(png, workers=(1,), runs=1, passes=3,
                        kernel="grayscale", out_dir=tmp_path)
    assert len(rows) == 1 and rows[0].avg_real_s > 0


def test_service_sweep(png, tmp_path):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        rows = bench_service(png, url, workers=(1,), runs=2,
                             out_dir=tmp_path)
        assert rows[0]["avg_request_sec"] >= rows[0]["avg_service_sec"] > 0
        with open(tmp_path / "service_bench.csv") as f:
            header = next(csv.reader(f))
        assert header == ["threads", "avg_request_sec", "std_request_sec",
                          "avg_service_sec", "std_service_sec"]
    finally:
        httpd.shutdown()


def test_fixture_set_in_package():
    """BASELINE configs 2-3 must be re-runnable from a clean checkout:
    all three benchmark inputs ship in-package with the reference's
    dimensions (images/: 1920x1080, 2037x1362, 2000x3000)."""
    from openmp_parallel_computing_tpu import data

    shapes = {}
    for name, path in data.fixture_set().items():
        assert path.exists(), f"{name} fixture missing from the package"
        shapes[name] = imgio.load(path).shape
    assert shapes == {"frame_1080p": (1080, 1920, 3),
                      "photo_half_mega": (1362, 2037, 3),
                      "photo_6mp": (3000, 2000, 3)}


def test_image_set_study_runs(tmp_path, monkeypatch):
    """The blur-halfmega + edge-set studies run end to end (tiny stand-in
    fixtures; the artifact names/schemas are the real ones)."""
    import json

    from openmp_parallel_computing_tpu import data
    from openmp_parallel_computing_tpu.bench import image_set

    rng = np.random.default_rng(9)
    tiny = {}
    for name in ("frame_1080p", "photo_half_mega", "photo_6mp"):
        p = tmp_path / f"{name}.png"
        imgio.save_png(p, rng.integers(0, 256, (24, 136, 3), dtype=np.uint8))
        tiny[name] = p
    monkeypatch.setattr(data, "fixture_set", lambda: tiny)
    monkeypatch.setattr(data, "half_mega_path",
                        lambda: tiny["photo_half_mega"])

    out = tmp_path / "results"
    rows = image_set.blur_halfmega(out, runs=1, passes=2)
    assert (out / "blur_halfmega" / "blur_bench.csv").exists()
    assert rows[0].avg_real_s > 0
    res = image_set.edge_images_set(out, runs=1, passes=2)
    assert set(res) == set(tiny)
    on_disk = json.loads((out / "edge_images_set.json").read_text())
    assert set(on_disk) == set(tiny)


def _trace_events():
    """A GPU trace in the profiler's JSON form: one device plane with two
    fusions, a device->host and a device->device copy over a 100 us window,
    plus a host plane whose events must be ignored."""
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "/device:GPU:0"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "/host:CPU"}}]
    ops = [("loop_add_fusion", 0, 20), ("input_reduce_fusion.3", 20, 30),
           ("MemcpyDtoH", 60, 5), ("MemcpyDtoD", 90, 10)]
    dev = [{"ph": "X", "pid": 1, "name": n, "ts": t, "dur": d}
           for n, t, d in ops]
    host = [{"ph": "X", "pid": 2, "name": "PjitFunction", "ts": 0,
             "dur": 500}]
    return meta + dev + host


@pytest.mark.parametrize("steps", [1, 2])
def test_trace_study_device_table(steps):
    from openmp_parallel_computing_tpu.bench.trace_study import (
        device_pids,
        device_table,
    )

    events = _trace_events()
    assert device_pids(events) == {1: "/device:GPU:0"}
    t = device_table(events, steps)
    assert t["window_us"] == 100.0 and t["busy_us"] == 65.0
    assert t["idle_share"] == pytest.approx(0.35)
    assert t["ops_per_step"] == 4 / steps
    assert t["memcpy_per_step"] == 2 / steps
    assert t["device_to_host_per_step"] == 1 / steps
    fams = {f["op"]: f for f in t["families"]}
    assert fams["xla_fusion"]["count"] == 2
    assert {"MemcpyDtoH", "MemcpyDtoD"} <= set(fams)


def test_trace_study_without_device_events():
    from openmp_parallel_computing_tpu.bench.trace_study import device_table

    assert device_table(_trace_events()[1:], 1)["error"] == "no device events"
