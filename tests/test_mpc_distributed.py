"""Distributed MPC, receding-horizon runtime, and /control endpoint tests
(virtual 8-device mesh)."""

import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmp_parallel_computing_tpu import imgio, parallel
from openmp_parallel_computing_tpu.models.mpc import (
    DistributedMPC,
    MPCRuntime,
    Scenario,
    VisualServoMPC,
)
from openmp_parallel_computing_tpu.utils.config import MPCConfig


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(21)
    return rng.integers(0, 256, size=(3, 32, 128), dtype=np.uint8)


@pytest.fixture(scope="module")
def cfg():
    return MPCConfig(horizon=6, num_features=4, ilqr_iters=2, admm_iters=2)


class TestDistributed:
    def test_data_sharded_solve(self, frame, cfg):
        mesh = parallel.make_mesh(data=8, model=1)
        dmpc = DistributedMPC(cfg, mesh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(0), 16)
        u0, mean_cost, res = dmpc.solve(frame, scen)
        assert u0.shape == (16, 6)
        assert np.isfinite(float(mean_cost))
        assert float(res) >= 0

    def test_data_model_mesh(self, frame, cfg):
        mesh = parallel.make_mesh(data=4, model=2)
        dmpc = DistributedMPC(cfg, mesh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(1), 8)
        u0, mean_cost, _ = dmpc.solve(frame, scen)
        assert u0.shape == (8, 6) and np.isfinite(float(mean_cost))

    def test_matches_single_device_cost_scale(self, frame, cfg):
        """Sharded and unsharded solves agree on solution quality."""
        mesh = parallel.make_mesh(data=8, model=1)
        dmpc = DistributedMPC(cfg, mesh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(2), 8)
        _, mean_cost, _ = dmpc.solve(frame, scen)
        edge = jnp.asarray(
            np.asarray(
                __import__("openmp_parallel_computing_tpu.ops",
                           fromlist=["ops"]).edge_pipeline(frame))[0],
            jnp.float32)
        sol = mpc.solve_batch(edge, scen)
        ref = float(sol.cost.mean())
        got = float(mean_cost)
        assert abs(got - ref) <= 0.05 * max(abs(ref), 1e-3)

    def test_pod_shape_rehearsal(self):
        """BASELINE config 5 scaled to the 8-device CPU mesh: H=50, 8
        features, 512 scenarios, a 1080p row-sharded frame, shipped
        iteration defaults. Exercises pooled-band psum perception and
        halo exchange at production dimensions — the small-shape tests
        above cannot catch a shape bug that only real sizes hit."""
        mesh = parallel.make_mesh(data=4, model=2)
        cfg_pod = MPCConfig(horizon=50, num_features=8)
        dmpc = DistributedMPC(cfg_pod, mesh)
        mpc = VisualServoMPC(cfg_pod)
        rng = np.random.default_rng(7)
        frame_1080 = rng.integers(0, 256, size=(3, 1080, 1920),
                                  dtype=np.uint8)
        scen = mpc.random_scenarios(jax.random.PRNGKey(4), 512)
        u0, mean_cost, res = dmpc.solve(jnp.asarray(frame_1080), scen)
        assert u0.shape == (512, 6)
        assert np.isfinite(float(mean_cost))
        assert float(res) >= 0

    def test_indivisible_batch_raises(self, frame, cfg):
        mesh = parallel.make_mesh(data=8, model=1)
        dmpc = DistributedMPC(cfg, mesh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(3), 6)
        with pytest.raises(ValueError):
            dmpc.solve(frame, scen)


class TestCollectiveFootprint:
    """parallel.introspect on the real distributed step: the traffic
    inventory the pod-scaling prediction (bench.pod_model,
    results/model/pod_scaling_model.json) is built from. Guards the
    scaling story's load-bearing fact: the ADMM solve itself is
    communication-free, so the only traffic on the cross-host (data)
    axis is the scalar diagnostics reduction."""

    def test_distributed_step_footprint(self, frame, cfg):
        from openmp_parallel_computing_tpu.parallel import introspect

        mesh = parallel.make_mesh(data=4, model=2)
        dmpc = DistributedMPC(cfg, mesh)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(5), 8)
        frame_s, scen_s = dmpc._prepare(jnp.asarray(frame), scen)
        cols = introspect.collective_footprint(dmpc._step, frame_s, scen_s)

        prims = {c.primitive for c in cols}
        # Halo exchange (ppermute) + pooled-band assembly (psum) ride the
        # model axis; the diagnostics reduction spans both axes.
        assert any("ppermute" in p for p in prims), prims
        model_only = [c for c in cols
                      if c.axes and "data" not in c.axes]
        assert any(c.primitive.startswith("psum") for c in model_only)
        dcn = [c for c in cols if "data" in c.axes]
        assert dcn, "diagnostics reduction missing from the footprint"
        # THE claim: cross-host traffic is scalar diagnostics only.
        dcn_bytes = sum(c.bytes * c.count for c in dcn)
        assert dcn_bytes <= 64, (
            f"cross-host payload grew to {dcn_bytes} B — the "
            "communication-free-solve property broke", dcn)

    def test_footprint_counts_scan_multiplicity(self):
        from openmp_parallel_computing_tpu.parallel import introspect

        mesh = parallel.make_mesh(data=8, model=1)

        def step(x):
            def body(c, _):
                return c + jax.lax.psum(c, "data"), None
            out, _ = jax.lax.scan(body, x, None, length=5)
            return out

        f = jax.jit(jax.shard_map(
            step, mesh=mesh,
            in_specs=jax.sharding.PartitionSpec("data"),
            out_specs=jax.sharding.PartitionSpec("data")))
        x = jnp.ones((8, 4), jnp.float32)
        cols = [c for c in introspect.collective_footprint(f, x)
                if c.primitive.startswith("psum")]
        assert cols and cols[0].count == 5
        assert cols[0].bytes == 4 * 4  # (1, 4) f32 per-device payload


class TestRuntime:
    def _scenario_args(self, n, m):
        rng = np.random.default_rng(31)
        return (rng.uniform(-0.5, 0.5, (n, 2 * m)).astype(np.float32),
                rng.uniform(-0.4, 0.4, (n, 2 * m)).astype(np.float32),
                rng.uniform(1.0, 4.0, (n, m)).astype(np.float32))

    def test_receding_horizon_improves(self, frame, cfg):
        rt = MPCRuntime(cfg)
        p0, target, depth = self._scenario_args(2, cfg.num_features)
        rt.reset(p0, target, depth)
        for _ in range(3):
            u0 = rt.step(frame)
        assert u0.shape == (2, 6)
        # predicted state should be closing on the target
        d0 = np.abs(p0 - target).mean()
        dn = np.abs(np.asarray(rt.scen.p0) - target).mean()
        assert dn < d0

    def test_checkpoint_resume(self, frame, cfg, tmp_path):
        rt = MPCRuntime(cfg, ckpt_dir=tmp_path)
        p0, target, depth = self._scenario_args(2, cfg.num_features)
        rt.reset(p0, target, depth)
        rt.step(frame)
        rt.step(frame)

        rt2 = MPCRuntime(cfg, ckpt_dir=tmp_path)
        assert rt2.restore_latest()
        assert rt2.frame_idx == 2
        np.testing.assert_allclose(np.asarray(rt2.scen.us0),
                                   np.asarray(rt.scen.us0))
        rt2.step(frame)  # keeps running from the restored state
        assert rt2.frame_idx == 3

    def test_step_without_reset_raises(self, frame, cfg):
        with pytest.raises(RuntimeError):
            MPCRuntime(cfg).step(frame)


class TestControlEndpoint:
    def test_control_roundtrip(self, tmp_path):
        import requests
        from openmp_parallel_computing_tpu.serve.server import Handler

        rng = np.random.default_rng(41)
        img = rng.integers(0, 256, size=(32, 128, 3), dtype=np.uint8)
        p = tmp_path / "f.png"
        imgio.save_png(p, img)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/control"
            m = 2
            data = {
                "p0": "0.2,0.1,-0.3,0.0",
                "target": "0.0,0.0,0.0,0.1",
                "depth": "2.0,3.0",
                "horizon": "5",
            }
            with open(p, "rb") as f:
                resp = requests.post(url, files={"image": f}, data=data)
            assert resp.status_code == 200, resp.text
            body = resp.json()
            assert len(body["u0"]) == 6
            assert np.isfinite(body["cost"])
            assert body["compute_s"] > 0

            # probe: mismatched dims -> 400
            bad = dict(data, depth="2.0")
            with open(p, "rb") as f:
                resp = requests.post(url, files={"image": f}, data=bad)
            assert resp.status_code == 400
        finally:
            httpd.shutdown()
