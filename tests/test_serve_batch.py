"""Batched serving: the /control micro-batcher and multi-frame solve.

SURVEY §2a mandates a "batched serving endpoint; device-resident model,
host async queue" — unlike the reference's one-subprocess-per-request
model (microservices/grayscale/app.py:44-45). Covers: multi-frame solver
equivalence across backends, request coalescing in ControlBatcher,
per-request correctness under concurrent HTTP clients, mixed-key
deferral, and the bounded thread-safe warm cache.
"""

import threading
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest

from openmp_parallel_computing_tpu import imgio
from openmp_parallel_computing_tpu.models.mpc import Scenario, VisualServoMPC
from openmp_parallel_computing_tpu.serve import server as srv
from openmp_parallel_computing_tpu.utils.config import MPCConfig

H, M = 5, 2  # horizon must be in srv.ALLOWED_HORIZONS


def _frames(b, hw=(32, 136), seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 3) + hw, dtype=np.uint8)


def _scen(b, m=M, h=H, seed=0):
    rng = np.random.default_rng(seed)
    return Scenario(
        p0=jnp.asarray(rng.uniform(-.6, .6, (b, 2 * m)), jnp.float32),
        target=jnp.asarray(rng.uniform(-.5, .5, (b, 2 * m)), jnp.float32),
        depth=jnp.asarray(rng.uniform(1, 5, (b, m)), jnp.float32),
        us0=jnp.zeros((b, h, 6), jnp.float32))


class TestMultiFrameSolve:
    """control_step_multi: per-scenario frames in ONE computation."""

    @pytest.mark.parametrize("backend", ["sweep", "reference", "assoc"])
    def test_matches_per_frame_solves(self, backend):
        cfg = MPCConfig(horizon=H, num_features=M, ilqr_iters=2,
                        admm_iters=2, admm_iters_extra=0, backend=backend)
        mpc = VisualServoMPC(cfg)
        B = 3
        frames = _frames(B)
        scen = _scen(B)
        u0_multi, sol_multi = mpc.control_step_multi(
            jnp.asarray(frames), scen)
        for i in range(B):
            si = Scenario(*(None if a is None else a[i:i + 1] for a in scen))
            u0_i, sol_i = mpc.control_step(jnp.asarray(frames[i]), si)
            np.testing.assert_allclose(np.asarray(u0_multi)[i],
                                       np.asarray(u0_i)[0],
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(np.asarray(sol_multi.cost)[i],
                                       np.asarray(sol_i.cost)[0],
                                       rtol=2e-5, atol=2e-5)

    def test_solve_batch_multi_identical_frames_match_shared(self):
        """B copies of one frame through the multi path == the shared-
        pyramid solve_batch (same math, batched pyramid)."""
        from openmp_parallel_computing_tpu.ops import edge_pipeline

        cfg = MPCConfig(horizon=H, num_features=M, ilqr_iters=2,
                        admm_iters=2, admm_iters_extra=0)
        mpc = VisualServoMPC(cfg)
        B = 4
        frame = _frames(1)[0]
        scen = _scen(B, seed=3)
        edge = edge_pipeline(jnp.asarray(frame))[0].astype(jnp.float32)
        sol_shared = mpc.solve_batch(edge, scen)
        sol_multi = mpc.solve_batch_multi(
            jnp.broadcast_to(edge, (B,) + edge.shape), scen)
        np.testing.assert_allclose(np.asarray(sol_multi.us),
                                   np.asarray(sol_shared.us),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(sol_multi.cost),
                                   np.asarray(sol_shared.cost),
                                   rtol=2e-5, atol=2e-5)


class TestControlBatcher:
    def test_concurrent_submits_coalesce_and_are_correct(self):
        batcher = srv.ControlBatcher(window_s=0.5, max_batch=8)
        B = 6
        frames = _frames(B, seed=11)
        scen = _scen(B, seed=12)
        results: list = [None] * B
        barrier = threading.Barrier(B)

        def client(i):
            barrier.wait()
            results[i] = batcher.submit(
                frames[i], np.asarray(scen.p0[i]),
                np.asarray(scen.target[i]), np.asarray(scen.depth[i]), H)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(B)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(r is not None for r in results)
        # all six arrived inside the 0.5 s window -> one device solve
        assert any(r["batched"] >= 2 for r in results)
        # Reference engine = the server's STATELESS contract: the fixed
        # 1x5 budget (srv._mpc_engine(..., adaptive=False)). The
        # engine-default adaptive gate is batch-global, so comparing a
        # coalesced batch against solo solves is only well-defined under
        # a fixed budget — which is exactly why the stateless serving
        # path pins one (see _mpc_engine's docstring).
        mpc = VisualServoMPC(MPCConfig(horizon=H, num_features=M,
                                       admm_iters=5, admm_iters_extra=0))
        for i, r in enumerate(results):
            si = Scenario(*(None if a is None else a[i:i + 1] for a in scen))
            u0_i, sol_i = mpc.control_step(jnp.asarray(frames[i]), si)
            np.testing.assert_allclose(r["u0"], np.asarray(u0_i)[0],
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(r["cost"],
                                       float(np.asarray(sol_i.cost)[0]),
                                       rtol=1e-4, atol=1e-4)

    def test_mixed_keys_defer_but_complete(self):
        """Requests with different (horizon, m) cannot share a solve; the
        collector defers them to the next batch instead of dropping."""
        batcher = srv.ControlBatcher(window_s=0.2, max_batch=8)
        frames = _frames(2, seed=21)
        s_a = _scen(1, seed=22)
        s_b = _scen(1, m=3, h=10, seed=23)
        out: dict = {}
        barrier = threading.Barrier(2)

        def run(tag, frame, s, m, h):
            barrier.wait()
            out[tag] = batcher.submit(
                frame, np.asarray(s.p0[0]), np.asarray(s.target[0]),
                np.asarray(s.depth[0]), h)

        ts = [threading.Thread(target=run,
                               args=("a", frames[0], s_a, M, H)),
              threading.Thread(target=run,
                               args=("b", frames[1], s_b, 3, 10))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert set(out) == {"a", "b"}
        assert len(out["a"]["u0"]) == 6 and len(out["b"]["u0"]) == 6
        assert np.isfinite(out["a"]["cost"])
        assert np.isfinite(out["b"]["cost"])

    def test_solver_error_propagates_to_caller(self):
        batcher = srv.ControlBatcher(window_s=0.01, max_batch=4)
        frame = _frames(1)[0]
        s = _scen(1)
        with pytest.raises(Exception):
            # zero-feature depth makes the engine solve unrepresentable;
            # whatever the solver raises must surface in the caller,
            # not kill the collector thread
            batcher.submit(frame, np.asarray(s.p0[0]),
                           np.asarray(s.target[0]),
                           np.zeros((0,), np.float32), 7)
        # the collector thread survived the failure
        r = batcher.submit(frame, np.asarray(s.p0[0]),
                           np.asarray(s.target[0]),
                           np.asarray(s.depth[0]), H)
        assert np.isfinite(r["cost"])


class TestAdmissionControl:
    """Real-time shedding: /control must bound its wait against the
    request's staleness deadline instead of queueing unboundedly
    (round-3 measured p99 17.2 s at concurrency 16 — pure queueing)."""

    def _key(self, frame):
        # trailing False = stateless (sessions batch under their own key)
        return (H, M, frame.shape, False)

    def test_predicted_overload_sheds_at_submit(self):
        batcher = srv.ControlBatcher(window_s=0.001, max_batch=4)
        frame = _frames(1)[0]
        s = _scen(1)
        # Prime the solve-time estimate: 10 s per batch, one in flight.
        batcher._solve_s[self._key(frame)] = 10.0
        batcher._inflight = True
        with pytest.raises(srv.ControlOverload) as exc:
            batcher.submit(frame, np.asarray(s.p0[0]),
                           np.asarray(s.target[0]), np.asarray(s.depth[0]),
                           H, deadline_s=0.5)
        assert exc.value.predicted_wait_s > 0.5

    def test_unmeasured_key_always_admitted(self):
        """No estimate yet (first compile) -> prediction is None, no shed."""
        batcher = srv.ControlBatcher(window_s=0.001, max_batch=4)
        frame = _frames(1)[0]
        assert batcher.predicted_wait_s(self._key(frame)) is None

    def test_stale_items_dropped_at_dispatch(self):
        batcher = srv.ControlBatcher(window_s=0.001, max_batch=4)
        frame = _frames(1)[0]
        s = _scen(1)
        item = srv._PendingControl(frame, np.asarray(s.p0[0]),
                                   np.asarray(s.target[0]),
                                   np.asarray(s.depth[0]), H,
                                   deadline_s=1.0)
        item.t_submit -= 5.0                      # aged 5 s in the queue
        batcher._solve_s[item.key] = 0.01         # steady state known
        fresh = batcher._shed_stale([item])
        assert fresh == []
        assert isinstance(item.error, srv.ControlOverload)
        assert item.event.is_set()
        # A fresh item with the same deadline survives.
        item2 = srv._PendingControl(frame, np.asarray(s.p0[0]),
                                    np.asarray(s.target[0]),
                                    np.asarray(s.depth[0]), H,
                                    deadline_s=1.0)
        assert batcher._shed_stale([item2]) == [item2]

    def test_no_deadline_never_sheds(self):
        batcher = srv.ControlBatcher(window_s=0.001, max_batch=4,
                                     default_deadline_s=None)
        frame = _frames(1)[0]
        s = _scen(1)
        batcher._solve_s[self._key(frame)] = 100.0
        item = srv._PendingControl(frame, np.asarray(s.p0[0]),
                                   np.asarray(s.target[0]),
                                   np.asarray(s.depth[0]), H,
                                   deadline_s=None)
        item.t_submit -= 500.0
        assert batcher._shed_stale([item]) == [item]

    def test_http_503_with_retry_after(self, tmp_path):
        import requests

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/control"
        frame = _frames(1, seed=41)[0]
        s = _scen(1, seed=42)
        p = tmp_path / "f.png"
        imgio.save_png(p, np.transpose(frame, (1, 2, 0)))
        key = (H, M, frame.shape, False)
        old = srv._batcher._solve_s.get(key)
        srv._batcher._solve_s[key] = 100.0       # pretend: 100 s per batch
        try:
            def fmt(v):
                return ",".join(f"{float(x):.9g}" for x in np.asarray(v))
            with open(p, "rb") as f:
                resp = requests.post(url, files={"image": f}, data={
                    "p0": fmt(s.p0[0]), "target": fmt(s.target[0]),
                    "depth": fmt(s.depth[0]), "horizon": str(H),
                    "deadline_ms": "50"})
            assert resp.status_code == 503
            assert float(resp.headers["Retry-After"]) > 0
            assert resp.json()["predicted_wait_s"] > 0.05

            # NaN is not a deadline: it passes `< 0` and is truthy, so
            # unvalidated it would silently disable every shed
            # comparison (worse than the explicit deadline_ms=0 opt-out:
            # the client THINKS it has a staleness bound). Must 400.
            with open(p, "rb") as f:
                resp = requests.post(url, files={"image": f}, data={
                    "p0": fmt(s.p0[0]), "target": fmt(s.target[0]),
                    "depth": fmt(s.depth[0]), "horizon": str(H),
                    "deadline_ms": "nan"})
            assert resp.status_code == 400
        finally:
            if old is None:
                srv._batcher._solve_s.pop(key, None)
            else:
                srv._batcher._solve_s[key] = old
            httpd.shutdown()


class TestConcurrentHTTP:
    def test_n_clients_each_get_their_own_result(self, tmp_path):
        import requests

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/control"
        B = 4
        frames = _frames(B, seed=31)
        scen = _scen(B, seed=32)
        paths = []
        for i in range(B):
            p = tmp_path / f"f{i}.png"
            imgio.save_png(p, np.transpose(frames[i], (1, 2, 0)))
            paths.append(p)

        responses: list = [None] * B
        barrier = threading.Barrier(B)

        def post(i):
            def fmt(v):
                # 9 significant digits: exact float32 round-trip
                return ",".join(f"{float(x):.9g}" for x in np.asarray(v))
            barrier.wait()
            with open(paths[i], "rb") as f:
                # deadline_ms=0 opts out of admission control: this test
                # asserts per-request correctness, and CPU first-compiles
                # can push the measured batch time past the default
                # deadline (shedding is covered by TestAdmissionControl).
                responses[i] = requests.post(url, files={"image": f}, data={
                    "p0": fmt(scen.p0[i]), "target": fmt(scen.target[i]),
                    "depth": fmt(scen.depth[i]), "horizon": str(H),
                    "deadline_ms": "0"})

        try:
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            # the server's stateless /control contract: fixed 1x5
            # (see _mpc_engine(adaptive=False))
            mpc = VisualServoMPC(MPCConfig(horizon=H, num_features=M,
                                           admm_iters=5,
                                           admm_iters_extra=0))
            for i, resp in enumerate(responses):
                assert resp is not None and resp.status_code == 200
                body = resp.json()
                si = Scenario(*(None if a is None else a[i:i + 1] for a in scen))
                u0_i, _ = mpc.control_step(jnp.asarray(frames[i]), si)
                np.testing.assert_allclose(body["u0"], np.asarray(u0_i)[0],
                                           rtol=1e-4, atol=1e-4)
        finally:
            httpd.shutdown()


class TestWarmCache:
    def test_claim_once_and_bounded(self):
        cache = srv._WarmCache(cap=3)
        _, owner = cache.claim("a")
        assert owner
        _, owner = cache.claim("a")
        assert not owner
        for k in ("b", "c", "d"):   # evicts "a" (cap 3, LRU)
            cache.claim(k)
        _, owner = cache.claim("a")
        assert owner

    def test_thread_safe_single_owner_under_contention(self):
        cache = srv._WarmCache(cap=64)
        owners: list = []

        def worker(seed):
            for i in range(200):
                ev, owner = cache.claim(("k", i % 50))
                if owner:
                    owners.append(("k", i % 50))
                    cache.done(("k", i % 50))
                else:
                    ev.wait(timeout=5)

        ts = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # exactly one owner per key, and the cache never exceeded its bound
        assert len(owners) == len(set(owners))
        assert len(cache._keys) <= 64


class TestControlSessions:
    """Receding-horizon sessions on /control (round 5): a client token
    binds requests to a carried (plan, duals) pair, giving the serving
    tier the warm-start shift + decayed dual carry that MPCRuntime
    implements for the embedded loop — previously the endpoint
    cold-started every frame (VERDICT r4 weak #1)."""

    def _submit(self, batcher, frame, scen, i, sid=None):
        fields = {"p0": ",".join(map(str, np.asarray(scen.p0[i]))),
                  "target": ",".join(map(str, np.asarray(scen.target[i]))),
                  "depth": ",".join(map(str, np.asarray(scen.depth[i]))),
                  "horizon": str(H)}
        if sid is not None:
            fields["session"] = sid
        return fields

    def test_session_sequence_matches_mpc_runtime(self, monkeypatch):
        """N frames through a /control session == MPCRuntime.step driven
        with the same per-frame states: the endpoint's carry IS the
        runtime's carry (same _shift_tail_zero convention)."""
        from openmp_parallel_computing_tpu.models.mpc.runtime import (
            MPCRuntime)

        store = srv._SessionStore(cap=8, idle_s=60.0)
        monkeypatch.setattr(srv, "_sessions", store)
        batcher = srv.ControlBatcher(window_s=0.0, max_batch=4)
        frame = _frames(1, seed=21)[0]
        scen = _scen(1, seed=22)

        cfg = srv._mpc_engine(H, M).cfg      # the server's own engine cfg
        rt = MPCRuntime(cfg)
        rt.reset(np.asarray(scen.p0), np.asarray(scen.target),
                 np.asarray(scen.depth))
        frame_j = jnp.asarray(frame)

        p0 = np.asarray(scen.p0[0])
        for k in range(4):
            u0_rt = np.asarray(rt.step(frame_j))[0]
            r = batcher.submit(
                frame, p0, np.asarray(scen.target[0]),
                np.asarray(scen.depth[0]), H, sid="sess-a",
                us0=(store.get("sess-a", H, M) or
                     {"us0": np.zeros((H, 6), np.float32)})["us0"],
                y0=(store.get("sess-a", H, M) or
                    {"y0": np.zeros((H, 6), np.float32)})["y0"],
                session_frames=k)
            np.testing.assert_allclose(r["u0"], u0_rt,
                                       rtol=5e-4, atol=5e-4)
            assert r["session"] == "sess-a"
            assert r["session_frame"] == k + 1
            # follow the runtime's predicted-state progression so both
            # loops see identical per-frame scenario states
            p0 = np.asarray(rt.scen.p0[0])

    def test_control_request_session_flow(self, monkeypatch):
        """End-to-end through control_request: first frame cold, second
        frame warm (carry present, session_frame increments), and the
        warm result differs from a cold re-solve (the carry is real)."""
        store = srv._SessionStore(cap=8, idle_s=60.0)
        monkeypatch.setattr(srv, "_sessions", store)
        monkeypatch.setattr(srv, "_batcher",
                            srv.ControlBatcher(window_s=0.0, max_batch=4))
        frame_hwc = np.transpose(_frames(1, seed=31)[0], (1, 2, 0))
        scen = _scen(1, seed=32)
        fields = self._submit(None, None, scen, 0, sid="cam-1")
        r1 = srv.control_request(frame_hwc, fields)
        assert r1["session_frame"] == 1 and len(store) == 1
        r2 = srv.control_request(frame_hwc, fields)
        assert r2["session_frame"] == 2
        # warm second solve: carried plan/duals change the solution
        rc = srv.control_request(frame_hwc, {
            k: v for k, v in fields.items() if k != "session"})
        assert "session" not in rc
        assert not np.allclose(r2["u0"], rc["u0"], atol=1e-7)

    def test_bad_session_token_rejected(self):
        frame_hwc = np.transpose(_frames(1)[0], (1, 2, 0))
        scen = _scen(1)
        fields = self._submit(None, None, scen, 0, sid="../etc")
        with pytest.raises(ValueError, match="session"):
            srv.control_request(frame_hwc, fields)


class TestSessionStore:
    def test_lru_eviction_past_cap(self):
        st = srv._SessionStore(cap=2, idle_s=60.0)
        z = np.zeros((H, 6), np.float32)
        st.put("a", H, M, z, z, 1)
        st.put("b", H, M, z, z, 1)
        assert st.get("a", H, M) is not None     # touch a -> b is LRU
        st.put("c", H, M, z, z, 1)
        assert st.get("b", H, M) is None         # evicted
        assert st.get("a", H, M) is not None
        assert st.get("c", H, M) is not None
        assert len(st) == 2

    def test_idle_expiry(self):
        import time as _t

        st = srv._SessionStore(cap=8, idle_s=0.02)
        z = np.zeros((H, 6), np.float32)
        st.put("a", H, M, z, z, 1)
        assert st.get("a", H, M) is not None
        _t.sleep(0.05)
        assert st.get("a", H, M) is None         # expired, restarts cold

    def test_shape_change_restarts_cold(self):
        st = srv._SessionStore(cap=8, idle_s=60.0)
        z = np.zeros((H, 6), np.float32)
        st.put("a", H, M, z, z, 3)
        assert st.get("a", 50, M) is None        # horizon changed
        assert st.get("a", H, M) is None         # and the entry is gone
