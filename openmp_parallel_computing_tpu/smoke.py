"""On-device checks of the main path, shared by ``chip_smoke.py`` and the
GPU test suite (``tests_gpu/``).

Each ``check_*`` drives one phase through the entry points a user calls,
compares the result with the repository's own references, raises
``AssertionError`` on a mismatch and returns a dict of facts for the log.
Sizes are parameters so the suite can run a phase small; the defaults are
the shipped configuration (``MPCConfig(horizon=20, num_features=8)``,
4096 scenarios, 1080p frames — the BASELINE.json headline).

Tolerances: the perception ops are integer-valued and must match bit for
bit (the golden files from the reference C binaries at
tests/test_golden_parity.py's bounds). Two MPC solves of the same
scenarios (the sweep backend against the reference backend, four cards
against one) agree at the CPU suite's rtol=atol=1e-4 on all but a share
``MPC_OUTLIER_SHARE`` of the entries, and every entry within
``MPC_TOL_MAX``. The looser tail is the card's: the GPU contracts a*b+c
into one rounding (FMA) and cuBLAS sums in its own order, and where two
line-search candidates are nearly tied, or a control sits at the box
clip, that last-bit difference picks the other branch for a handful of
scenarios (on an H100: 8 of 24,576 first controls at 4096 x H=20 and 8
of 6,144 at 1024 x H=20, at most 1.2e-3 apart).
"""

from __future__ import annotations

import io
import json
import subprocess
import tempfile
import threading
import time
import urllib.request
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from openmp_parallel_computing_tpu import data, imgio, ops
from openmp_parallel_computing_tpu.models.mpc import costs
from openmp_parallel_computing_tpu.ops import xla_ref

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden"
MPC_TOL = 1e-4            # two solves of the same scenarios, u0 and cost
MPC_OUTLIER_SHARE = 5e-3  # share of entries allowed past MPC_TOL ...
MPC_TOL_MAX = 1e-2        # ... each still within this (module docstring)
GOLDEN_MPC_TOL = 1e-3     # tests/test_solver_quality.py's pinned golden


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"
    return out.stdout.strip()


def device_facts() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _cpu(x):
    """Commit ``x`` to the host CPU device, so jitted ops on it run there."""
    return jax.device_put(np.asarray(x), jax.devices("cpu")[0])


def _golden_hwc(name: str) -> np.ndarray:
    return imgio.load(GOLDEN / name)


def _assert_luma_parity(ours: np.ndarray, golden: np.ndarray) -> dict:
    diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    assert diff.max() <= 1, f"luma parity: max diff {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"luma skew {(diff > 0).mean()}"
    return {"max_diff": int(diff.max()),
            "mismatch_share": float((diff > 0).mean())}


def _assert_edge_parity(ours: np.ndarray, golden: np.ndarray) -> dict:
    # The reference leaves the 1-px border uninitialized: interior only.
    diff = np.abs(ours[1:-1, 1:-1].astype(np.int32)
                  - golden[1:-1, 1:-1].astype(np.int32))
    assert diff.max() <= 16, f"edge parity: max diff {diff.max()}"
    assert (diff > 0).mean() < 0.05 and (diff > 2).mean() < 0.005
    return {"max_diff": int(diff.max()),
            "mismatch_share": float((diff > 0).mean())}


def _np_conv3x3(img: np.ndarray, taps, norm: int) -> np.ndarray:
    """Integer zero-padded 3x3 correlation with C truncating division."""
    c, h, w = img.shape
    xp = np.pad(img.astype(np.int64), ((0, 0), (1, 1), (1, 1)))
    out = np.zeros((c, h, w), np.int64)
    for ky in range(3):
        for kx in range(3):
            out += xp[:, ky:ky + h, kx:kx + w] * taps[ky][kx]
    return np.sign(out) * (np.abs(out) // norm)


def check_perception(frame_chw: np.ndarray | None = None) -> dict:
    """The image ops on the default device at 1080p: bit-exact against the
    same ops on the host CPU and numpy, and within the golden tolerances
    of the reference C binaries."""
    frame = data.load_frame_planar() if frame_chw is None else frame_chw
    frame = np.asarray(frame)
    dev = jnp.asarray(frame)
    facts = {"shape": list(frame.shape)}

    gray = np.asarray(ops.grayscale(dev))
    np.testing.assert_array_equal(gray, np.asarray(ops.grayscale(_cpu(frame))))
    facts["grayscale_vs_golden"] = _assert_luma_parity(
        gray[0], _golden_hwc("gray_1080p.png")[:, :, 0])

    edge = np.asarray(ops.edge_pipeline(dev))
    np.testing.assert_array_equal(
        edge, np.asarray(ops.edge_pipeline(_cpu(frame))))
    facts["edge_vs_golden"] = _assert_edge_parity(
        edge[0], _golden_hwc("edge_1080p.png")[:, :, 0])

    blur = np.asarray(ops.gaussian_blur(dev))
    want = np.clip(_np_conv3x3(frame, xla_ref.GBLUR_KERNEL,
                               xla_ref.GBLUR_NORM), 0, 255)
    np.testing.assert_array_equal(blur, want.astype(np.uint8))
    facts["blur_vs_numpy"] = "bit-exact"

    base = np.asarray(ops.edge_pyramid_base(dev, s=16))
    staged = np.asarray(costs.avg_pool(
        jnp.asarray(edge[0].astype(np.float32)), 16))
    np.testing.assert_array_equal(base, staged)
    np.testing.assert_array_equal(
        base, np.asarray(ops.edge_pyramid_base(_cpu(frame), s=16)))
    facts["pyramid_base"] = {"shape": list(base.shape),
                             "vs_staged": "bit-exact"}

    legacy = np.load(GOLDEN / "legacy" / "legacy_golden.npz")
    chw = np.ascontiguousarray(np.transpose(legacy["input"], (2, 0, 1)))
    np.testing.assert_array_equal(
        np.asarray(ops.conv3x3(jnp.asarray(chw), integer=True)),
        np.transpose(legacy["gblur"], (2, 0, 1)))
    g, gmin, gmax = ops.grayscale_mean_minmax(jnp.asarray(chw))
    np.testing.assert_array_equal(np.asarray(g),
                                  np.transpose(legacy["gray"], (2, 0, 1)))
    assert (int(gmin), int(gmax)) == tuple(int(v) for v in legacy["minmax"])
    facts["legacy_goldens"] = "bit-exact"
    return facts


def _memory_facts(compiled) -> dict:
    mem = compiled.memory_analysis()
    if mem is None:
        return {"memory_analysis": None}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}


def _agreement(got, want) -> dict:
    """How far two solves of the same scenarios agree; raises when they
    fall outside the MPC tolerances (module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want)
    facts = {"max_abs_diff": float(diff.max()),
             "outside_tol": int((diff > MPC_TOL * (1 + np.abs(want))).sum()),
             "n": int(diff.size)}
    assert facts["outside_tol"] <= MPC_OUTLIER_SHARE * diff.size, facts
    assert (diff <= MPC_TOL_MAX * (1 + np.abs(want))).all(), facts
    return facts


def check_mpc(frame_chw=None, scenarios: int = 4096, horizon: int = 20,
              features: int = 8, ring: int = 8, steps: int = 20,
              long_horizon: int = 50) -> dict:
    """``VisualServoMPC`` at full width: the compiled control step with its
    memory analysis, agreement with the reference backend, the pinned
    golden solve, a receding-horizon window over a ring of frames, and
    one long-horizon step."""
    import dataclasses

    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    frame = jnp.asarray(data.load_frame_planar() if frame_chw is None
                        else frame_chw)
    cfg = MPCConfig(horizon=horizon, num_features=features)
    mpc = VisualServoMPC(cfg)
    scen = mpc.random_scenarios(jax.random.PRNGKey(0), scenarios)
    facts = {"scenarios": scenarios, "horizon": horizon,
             "features": features, "frame": list(frame.shape)}

    t0 = time.perf_counter()
    compiled = VisualServoMPC.control_step.lower(mpc, frame, scen).compile()
    facts["compile_s"] = round(time.perf_counter() - t0, 2)
    facts["memory"] = _memory_facts(compiled)
    u0, sol = compiled(frame, scen)
    u0 = np.asarray(u0)
    assert u0.shape == (scenarios, 6) and np.isfinite(u0).all()
    assert np.isfinite(np.asarray(sol.cost)).all()

    ref = VisualServoMPC(dataclasses.replace(cfg, backend="reference"))
    u0_ref, sol_ref = ref.control_step(frame, scen)
    facts["u0_vs_reference"] = _agreement(u0, u0_ref)
    facts["cost_vs_reference"] = _agreement(sol.cost, sol_ref.cost)

    gold = np.load(GOLDEN / "mpc_us_h20_defaults.npz")
    gmpc = VisualServoMPC(MPCConfig())
    rng = np.random.default_rng(int(gold["edge_seed"]))
    edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
    gscen = gmpc.random_scenarios(jax.random.PRNGKey(int(gold["scen_key"])),
                                  int(gold["n_scen"]))
    gsol = gmpc.solve_batch(edge, gscen)
    np.testing.assert_allclose(np.asarray(gsol.us), gold["us"],
                               rtol=GOLDEN_MPC_TOL, atol=GOLDEN_MPC_TOL)
    np.testing.assert_allclose(np.asarray(gsol.cost), gold["cost"],
                               rtol=GOLDEN_MPC_TOL, atol=GOLDEN_MPC_TOL)
    facts["golden_us_max_abs_diff"] = float(
        np.abs(np.asarray(gsol.us) - gold["us"]).max())

    # The receding-horizon window the benchmark runs: per-step perception
    # on a ring of distinct frames, edge_refresh="solve".
    loop = VisualServoMPC(dataclasses.replace(cfg, edge_refresh="solve"))
    frames = data.frame_ring(frame, ring)
    t0 = time.perf_counter()
    u0s, cost_seq, _ = loop.receding_horizon_frames(frames, scen, steps)
    u0s = np.asarray(u0s)
    facts["receding_first_call_s"] = round(time.perf_counter() - t0, 2)
    assert u0s.shape == (steps, scenarios, 6) and np.isfinite(u0s).all()
    assert np.isfinite(np.asarray(cost_seq)).all()

    long_mpc = VisualServoMPC(dataclasses.replace(cfg, horizon=long_horizon))
    lscen = long_mpc.random_scenarios(jax.random.PRNGKey(1), scenarios)
    lu0, lsol = long_mpc.control_step(frame, lscen)
    assert np.isfinite(np.asarray(lu0)).all()
    assert np.isfinite(np.asarray(lsol.cost)).all()
    facts["long_horizon"] = long_horizon
    return facts


def _multipart(fields: dict, image: bytes) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
    parts.append(
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
        f"filename=\"frame.png\"\r\nContent-Type: image/png\r\n\r\n"
        .encode() + image + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _post(url: str, fields: dict, image: bytes) -> tuple[int, bytes]:
    body, ctype = _multipart(fields, image)
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read()


def check_served(frame_path: Path | None = None, features: int = 8,
                 horizon: int = 20) -> dict:
    """``serve.server.serve()`` on a thread at an ephemeral port: /control
    stateless and in a session, /edge against the in-process op and the
    golden, /healthz naming the backend."""
    from openmp_parallel_computing_tpu.serve import server
    from openmp_parallel_computing_tpu.utils.config import ServeConfig

    path = data.frame_path() if frame_path is None else frame_path
    png = Path(path).read_bytes()
    rng = np.random.default_rng(3)
    vec = lambda a: ",".join(f"{v:.6f}" for v in a)
    fields = {"p0": vec(rng.uniform(-0.6, 0.6, 2 * features)),
              "target": vec(rng.uniform(-0.5, 0.5, 2 * features)),
              "depth": vec(rng.uniform(1.0, 5.0, features)),
              "horizon": str(horizon), "deadline_ms": "0"}
    httpd = server.serve(ServeConfig(host="127.0.0.1", port=0))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    facts: dict = {}
    try:
        for i, extra in enumerate(({}, {}, {"session": "smoke"},
                                   {"session": "smoke"})):
            t0 = time.perf_counter()
            status, body = _post(f"{url}/control", {**fields, **extra}, png)
            out = json.loads(body)
            assert status == 200, (status, body[:200])
            u0 = np.asarray(out["u0"], np.float32)
            assert u0.shape == (6,) and np.isfinite(u0).all()
            if extra:
                assert out["session_frame"] == i - 1, out
            facts[f"control_{i}_s"] = round(time.perf_counter() - t0, 3)

        status, body = _post(f"{url}/edge", {}, png)
        assert status == 200
        with tempfile.TemporaryDirectory() as td:
            p = Path(td) / "edge.png"
            p.write_bytes(body)
            got = imgio.load(p)
        frame_chw = np.transpose(imgio.load(path), (2, 0, 1))
        want = np.asarray(ops.edge_pipeline(jnp.asarray(frame_chw)))
        np.testing.assert_array_equal(got, np.transpose(want, (1, 2, 0)))
        facts["edge_vs_golden"] = _assert_edge_parity(
            got[:, :, 0], _golden_hwc("edge_1080p.png")[:, :, 0])

        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["backend"] == jax.default_backend(), health
        facts["healthz"] = health
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return facts


def check_dispatch(root: str | Path, scenarios: int = 64, features: int = 8,
                   horizon: int = 20) -> dict:
    """One MPC job through a filesystem queue and an in-process worker."""
    from openmp_parallel_computing_tpu.dispatch import (
        DurableQueue,
        ObjectStore,
        Worker,
    )
    from openmp_parallel_computing_tpu.utils.config import DispatchConfig

    cfg = DispatchConfig(root=str(root))
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    np.savez(buf,
             p0=rng.uniform(-0.6, 0.6, (scenarios, 2 * features)
                            ).astype(np.float32),
             target=rng.uniform(-0.5, 0.5, (scenarios, 2 * features)
                                ).astype(np.float32),
             depth=rng.uniform(1.0, 5.0, (scenarios, features)
                               ).astype(np.float32))
    store = ObjectStore(cfg.root)
    key = store.put("uploads/smoke_scen.npz", buf.getvalue())
    DurableQueue(cfg.root, cfg.queue).publish(
        {"type": "mpc", "scenario_key": key, "devices": 1,
         "config": {"horizon": horizon, "num_features": features}})
    Worker(cfg).run(stop_when_empty=True)
    status = json.loads(store.get("status/smoke_scen.npz.json"))
    assert "u0_key" in status and "error" not in status, status
    result = np.load(io.BytesIO(store.get(status["u0_key"])))
    assert result["u0"].shape == (scenarios, 6)
    assert np.isfinite(result["u0"]).all()
    assert np.isfinite(result["costs"]).all()
    return {"scenarios": scenarios, "mean_cost": float(result["costs"].mean())}


def _shard_devices(arr) -> set:
    return {s.device for s in arr.addressable_shards}


def check_distributed(frame_chw=None, scenarios: int = 4096,
                      horizon: int = 50, features: int = 8,
                      n_devices: int = 4) -> dict:
    """``DistributedMPC`` and the sharded stencils on ``n_devices`` cards,
    each against the same work on one card."""
    from jax.sharding import PartitionSpec as P

    from openmp_parallel_computing_tpu import parallel
    from openmp_parallel_computing_tpu.models.mpc import (
        DistributedMPC, VisualServoMPC)
    from openmp_parallel_computing_tpu.models.mpc.distributed import (
        MODEL, perception_base)
    from openmp_parallel_computing_tpu.ops.runner import make_runner
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    devs = jax.devices()
    assert len(devs) >= n_devices, f"need {n_devices} devices, have {devs}"
    devs = devs[:n_devices]
    frame_np = np.asarray(data.load_frame_planar() if frame_chw is None
                          else frame_chw)
    frame = jax.device_put(frame_np, devs[0])
    facts: dict = {"devices": [d.device_kind for d in devs]}

    cfg = MPCConfig(horizon=horizon, num_features=features)
    single = VisualServoMPC(cfg)
    scen = single.random_scenarios(jax.random.PRNGKey(2), scenarios)
    scen = jax.tree.map(lambda a: jax.device_put(a, devs[0]), scen)
    u0_one, sol_one = single.control_step(frame, scen)

    mesh = parallel.make_mesh(data=n_devices, model=1, devices=devs)
    dmpc = DistributedMPC(cfg, mesh)
    u0, cost, _ = dmpc.solve_full(frame_np, jax.device_get(scen))
    assert len(_shard_devices(u0)) == n_devices, _shard_devices(u0)
    facts["solve_u0_vs_single"] = _agreement(u0, u0_one)
    facts["solve_cost_vs_single"] = _agreement(cost, sol_one.cost)

    # (data=2, model=2): ppermute halo + psum pyramid base, bit-exact.
    side = int(round(n_devices ** 0.5))
    mesh2 = parallel.make_mesh(data=n_devices // side, model=side,
                               devices=devs)
    base_fn = jax.jit(jax.shard_map(
        lambda f: perception_base(f, side)[0], mesh=mesh2,
        in_specs=P(None, MODEL, None), out_specs=P(), check_vma=False))
    base = np.asarray(base_fn(frame_np))
    want = np.asarray(ops.edge_pyramid_base(frame, s=costs.PYRAMID_SCALES[0]))
    np.testing.assert_array_equal(base, want)
    facts["sharded_pyramid_base"] = {"mesh": dict(mesh2.shape),
                                     "vs_single": "bit-exact"}

    run4 = make_runner("edge", devices=n_devices)
    out4 = run4(frame_np)
    assert len(_shard_devices(out4)) == n_devices, _shard_devices(out4)
    out1 = make_runner("edge", devices=1)(frame)
    np.testing.assert_array_equal(np.asarray(out4), np.asarray(out1))
    facts["sharded_edge"] = f"bit-exact on {n_devices} devices"
    return facts
