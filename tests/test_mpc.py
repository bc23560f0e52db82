"""MPC engine tests: dynamics shapes/jacobians, Riccati sanity on an
analytic LQR problem, and end-to-end solver behavior (target convergence,
box-constraint feasibility, batching)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmp_parallel_computing_tpu.models.mpc import (
    Scenario,
    VisualServoMPC,
    costs,
    dynamics,
    riccati,
)
from openmp_parallel_computing_tpu.utils.config import MPCConfig


class TestDynamics:
    def test_interaction_matrix_shape(self):
        p = jnp.zeros(8)
        L = dynamics.interaction_matrix(p, jnp.ones(4))
        assert L.shape == (8, 6)

    def test_center_point_pure_translation(self):
        # A feature at the optical axis (0,0) at depth 1: vx moves x by -vx*dt.
        p = jnp.zeros(2)
        u = jnp.array([1.0, 0, 0, 0, 0, 0])
        nxt = dynamics.step(p, u, jnp.ones(1), dt=0.1)
        np.testing.assert_allclose(np.asarray(nxt), [-0.1, 0.0], atol=1e-7)

    def test_rollout_shape(self):
        us = jnp.zeros((20, 6))
        ps = dynamics.rollout(jnp.zeros(8), us, jnp.ones(4), 0.03)
        assert ps.shape == (21, 8)

    def test_analytic_linearization_matches_autodiff(self):
        key = jax.random.PRNGKey(7)
        p = jax.random.normal(key, (8,)) * 0.4
        u = jax.random.normal(jax.random.PRNGKey(8), (6,))
        depth = jnp.array([1.0, 2.0, 3.0, 0.7])
        fx_a, fu_a = dynamics.linearize_analytic(p, u, depth, 0.04)
        fx_d, fu_d = dynamics.linearize(p, u, depth, 0.04)
        np.testing.assert_allclose(np.asarray(fx_a), np.asarray(fx_d),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(fu_a), np.asarray(fu_d),
                                   rtol=1e-5, atol=1e-6)

    def test_linearize_matches_autodiff(self):
        key = jax.random.PRNGKey(0)
        p = jax.random.normal(key, (8,)) * 0.3
        u = jax.random.normal(key, (6,)) * 0.5
        depth = jnp.ones(4) * 2.0
        fx, fu = dynamics.linearize(p, u, depth, 0.05)
        fu_ad = jax.jacrev(lambda v: dynamics.step(p, v, depth, 0.05))(u)
        np.testing.assert_allclose(np.asarray(fu), np.asarray(fu_ad),
                                   rtol=1e-5)


class TestBilinear:
    def test_exact_on_grid(self):
        field = jnp.arange(12.0).reshape(3, 4)
        xy = jnp.array([[1.0, 2.0], [3.0, 0.0]])
        got = costs.bilinear_sample(field, xy)
        np.testing.assert_allclose(np.asarray(got), [9.0, 3.0])

    def test_interpolates(self):
        field = jnp.array([[0.0, 2.0], [4.0, 6.0]])
        got = costs.bilinear_sample(field, jnp.array([[0.5, 0.5]]))
        np.testing.assert_allclose(np.asarray(got), [3.0])

    def test_gradient_flows(self):
        field = jnp.arange(16.0).reshape(4, 4)
        g = jax.grad(
            lambda xy: costs.bilinear_sample(field, xy[None]).sum())(
                jnp.array([1.2, 1.7]))
        assert np.abs(np.asarray(g)).sum() > 0


class TestHatWeightGradients:
    """The hat weights must differentiate sanely at their kinks.

    The old ``maximum(0, 1-|d|)`` form hit the max/abs tie-gradient
    conventions whenever a sample landed on an exact integer grid
    coordinate — which every border-CLAMPED point does — and leaked a
    full weighted field row into the gradient (measured -42.6 where the
    true one-sided derivative is 1.0). The one-hot-pair construction
    (costs._hat_weights) yields the exact one-sided derivative at every
    kink: right-hand in the interior, left-hand at the top border."""

    def _sample_1d(self, field):
        def f(x):
            return costs.separable_sample(field,
                                          jnp.stack([x, jnp.float32(3.3)]))
        return jax.grad(f)

    def test_exact_one_sided_at_integer_coords(self):
        # linear field: every one-sided derivative is exactly 1
        field = jnp.asarray(
            np.arange(8 * 12, dtype=np.float32).reshape(8, 12))
        g = self._sample_1d(field)
        for x in (0.0, 3.0, 11.0):
            np.testing.assert_allclose(float(g(jnp.float32(x))), 1.0,
                                       rtol=1e-5, err_msg=str(x))

    def test_zero_beyond_border(self):
        field = jnp.asarray(
            np.arange(8 * 12, dtype=np.float32).reshape(8, 12))
        g = self._sample_1d(field)
        for x in (-0.5, -3.0, 11.5, 40.0):
            assert float(g(jnp.float32(x))) == 0.0, x

    def test_exact_away_from_kinks(self):
        field = jnp.asarray(
            np.arange(8 * 12, dtype=np.float32).reshape(8, 12))
        g = self._sample_1d(field)
        # linear field: d/dx == 1 in the interior (off-integer)
        for x in (0.25, 3.7, 10.5):
            np.testing.assert_allclose(float(g(jnp.float32(x))), 1.0,
                                       rtol=1e-5)


class TestEdgeCostPyramidXY:
    """The lanes-layout sampler twin must match the interleaved one —
    values AND gradients — since the sweep backend now samples straight
    off split-layout lanes trajectories (solver._SweepLanes.edge_grads)."""

    def _pyramid(self, rng):
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        return costs.build_cost_pyramid(edge), (64, 128)

    def test_values_match_interleaved(self):
        rng = np.random.default_rng(7)
        pyramid, (hh, ww) = self._pyramid(rng)
        K, m, B = 5, 4, 9
        # interleaved points (B, K, 2m) vs lanes split (K, n, B)
        ps = jnp.asarray(rng.uniform(-1.2, 1.2, (B, K, 2 * m)), jnp.float32)
        ref = jax.vmap(jax.vmap(
            lambda p: costs.edge_cost_pyramid(pyramid, p, hh, ww)))(ps)
        pts = ps.reshape(B, K, m, 2)
        x = jnp.transpose(pts[..., 0], (1, 2, 0))      # (K, m, B)
        y = jnp.transpose(pts[..., 1], (1, 2, 0))
        got = costs.edge_cost_pyramid_xy(pyramid, x, y, hh, ww)  # (K, B)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(ref.T), rtol=1e-5, atol=1e-6)

    def test_grads_match_autodiff_of_interleaved(self):
        rng = np.random.default_rng(8)
        pyramid, (hh, ww) = self._pyramid(rng)
        K, m, B = 4, 4, 6
        ps = jnp.asarray(rng.uniform(-1.1, 1.1, (B, K, 2 * m)), jnp.float32)
        _, g_ref = jax.vmap(jax.vmap(jax.value_and_grad(
            lambda p: costs.edge_cost_pyramid(pyramid, p, hh, ww))))(ps)
        # lanes split layout: (K, n, B) with [x..., y...] state order
        pts = ps.reshape(B, K, m, 2)
        ps_l = jnp.concatenate([
            jnp.transpose(pts[..., 0], (1, 2, 0)),
            jnp.transpose(pts[..., 1], (1, 2, 0))], axis=1)  # (K, n, B)
        g_l = jax.grad(lambda q: jnp.sum(costs.edge_cost_pyramid_xy(
            pyramid, q[:, :m], q[:, m:], hh, ww)))(ps_l)
        # back to interleaved (B, K, 2m)
        g_split = jnp.transpose(g_l, (2, 0, 1))            # (B, K, n)
        g_got = jnp.stack([g_split[..., :m], g_split[..., m:]],
                          axis=-1).reshape(B, K, 2 * m)
        np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-6)


class TestAnalyticSampler:
    """costs.edge_vg_pyramid_xy: the one-pass analytic value+gradient XLA
    sampler must reproduce the autodiff of edge_cost_pyramid_xy — values
    and gradients — including the kink (integer coordinates) and border
    conventions the hat-weight construction encodes."""

    def test_matches_autodiff(self):
        rng = np.random.default_rng(17)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        pyramid = costs.build_cost_pyramid(edge)
        K, m, B = 5, 4, 96
        x = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
        y = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
        x[0, 0] = -1.0                      # exactly on the border
        y[0, 0] = 1.0
        x[:, 1] = np.round(x[:, 1], 0)      # integer normalized coords
        x, y = jnp.asarray(x), jnp.asarray(y)

        def val_sum(q):
            return jnp.sum(costs.edge_cost_pyramid_xy(
                pyramid, q[:, :m], q[:, m:], 64, 128))

        ps_l = jnp.concatenate([x, y], axis=1)
        g_want = jax.grad(val_sum)(ps_l)
        v_want = costs.edge_cost_pyramid_xy(pyramid, x, y, 64, 128)
        v, gx, gy = costs.edge_vg_pyramid_xy(pyramid, x, y, 64, 128)
        np.testing.assert_allclose(np.asarray(v), np.asarray(v_want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gx),
                                   np.asarray(g_want[:, :m]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gy),
                                   np.asarray(g_want[:, m:]),
                                   rtol=1e-4, atol=1e-6)

    def test_degenerate_single_cell_axis(self):
        """A 64-px-tall map's 64x-pooled level is 1 cell tall: the
        degenerate axis must give constant weight / ZERO gradient
        (_hat_weights' convention) — regression: the one-hot-pair builder
        produced garbage weights from clip(floor, 0, size-2) at size=1,
        flipping the solve's edge-attraction direction."""
        rng = np.random.default_rng(19)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        pyramid = costs.build_cost_pyramid(edge)
        assert pyramid[1].shape[0] == 1     # the degenerate geometry
        x = jnp.asarray(rng.uniform(-1, 1, (3, 2, 8)), jnp.float32)
        y = jnp.asarray(rng.uniform(-1, 1, (3, 2, 8)), jnp.float32)

        def val_sum(q):
            return jnp.sum(costs.edge_cost_pyramid_xy(
                pyramid, q[:, :2], q[:, 2:], 64, 128))

        g_want = jax.grad(val_sum)(jnp.concatenate([x, y], axis=1))
        v_want = costs.edge_cost_pyramid_xy(pyramid, x, y, 64, 128)
        v, gx, gy = costs.edge_vg_pyramid_xy(pyramid, x, y, 64, 128)
        np.testing.assert_allclose(np.asarray(v), np.asarray(v_want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(g_want[:, :2]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gy), np.asarray(g_want[:, 2:]),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("edge_refresh", ["solve", "admm"])
    def test_solver_equivalence_vs_xla(self, edge_refresh):
        """Full sweep-backend solve: edge_sampler="analytic" reproduces
        the autodiff XLA sampler's solution."""
        rng = np.random.default_rng(18)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)

        def solve(sampler):
            cfg = MPCConfig(horizon=8, num_features=4, ilqr_iters=2,
                            admm_iters=3, edge_refresh=edge_refresh,
                            edge_sampler=sampler)
            mpc = VisualServoMPC(cfg)
            scen = mpc.random_scenarios(jax.random.PRNGKey(5), 6)
            sol = mpc.solve_batch(edge, scen)
            return np.asarray(sol.us), np.asarray(sol.cost)

        us_x, cost_x = solve("xla")
        us_a, cost_a = solve("analytic")
        np.testing.assert_allclose(us_a, us_x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cost_a, cost_x, rtol=1e-4, atol=1e-4)


class TestRiccatiLQR:
    def test_matches_analytic_single_step(self):
        """H=1 LQR: u* = -(R + B'QB)^-1 B'Q A x0."""
        n, c = 4, 2
        key = jax.random.PRNGKey(1)
        A = jax.random.normal(key, (n, n)) * 0.3 + jnp.eye(n)
        B = jax.random.normal(jax.random.PRNGKey(2), (n, c))
        Q = jnp.eye(n)
        R = 0.1 * jnp.eye(c)
        x0 = jnp.array([1.0, -1.0, 0.5, 0.2])

        gains = riccati.backward(
            fx=A[None], fu=B[None],
            lx=jnp.zeros((1, n)), lu=jnp.zeros((1, c)),
            lxx=jnp.zeros((1, n, n)), luu=2 * R[None],
            lux=jnp.zeros((1, c, n)),
            vx=jnp.zeros(n), vxx=2 * Q, reg=0.0)
        # u = k + K x0 with zero nominal trajectory
        u = gains.k[0] + gains.K[0] @ x0
        u_analytic = -jnp.linalg.solve(R + B.T @ Q @ B, B.T @ Q @ A @ x0)
        np.testing.assert_allclose(np.asarray(u), np.asarray(u_analytic),
                                   rtol=1e-4, atol=1e-5)

    def test_assoc_matches_sequential(self):
        """Associative-scan backward == sequential scan (log-depth twin),
        including nonzero lux cross terms and both reg settings."""
        rng = np.random.default_rng(5)
        H, n, c = 13, 6, 3

        def spd(*s):
            a = rng.standard_normal(s).astype(np.float32)
            return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(s[-1],
                                                             dtype=np.float32)

        fx = jnp.asarray(rng.standard_normal((H, n, n)) * 0.3
                         + np.eye(n), jnp.float32)
        fu = jnp.asarray(rng.standard_normal((H, n, c)) * 0.4, jnp.float32)
        lx = jnp.asarray(rng.standard_normal((H, n)), jnp.float32)
        lu = jnp.asarray(rng.standard_normal((H, c)), jnp.float32)
        lxx = jnp.asarray(spd(H, n, n))
        luu = jnp.asarray(spd(H, c, c))
        lux = jnp.asarray(rng.standard_normal((H, c, n)) * 0.3, jnp.float32)
        vx = jnp.asarray(rng.standard_normal(n), jnp.float32)
        vxx = jnp.asarray(spd(n, n))
        for reg in (0.0, 1e-6):
            seq = riccati.backward(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                                   reg=reg)
            par = riccati.backward_assoc(fx, fu, lx, lu, lxx, luu, lux,
                                         vx, vxx, reg=reg)
            np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(np.asarray(par.k), np.asarray(seq.k),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(np.asarray(par.dV),
                                       np.asarray(seq.dV),
                                       rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def flat_edge_map():
    return jnp.full((64, 128), 128.0, jnp.float32)


@pytest.fixture(scope="module")
def small_cfg():
    return MPCConfig(horizon=10, num_features=4, scenarios=4, ilqr_iters=3,
                     admm_iters=5, q_edge=0.0)


class TestSolver:
    def test_converges_toward_target(self, flat_edge_map, small_cfg):
        mpc = VisualServoMPC(small_cfg)
        m = small_cfg.num_features
        p0 = jnp.tile(jnp.array([0.3, 0.2]), m)[None]
        target = jnp.tile(jnp.array([-0.1, 0.0]), m)[None]
        scen = Scenario(p0=p0, target=target, depth=jnp.ones((1, m)) * 2.0,
                        us0=jnp.zeros((1, small_cfg.horizon, 6)))
        sol = mpc.solve_batch(flat_edge_map, scen)
        d0 = float(jnp.abs(p0 - target).max())
        dH = float(jnp.abs(sol.ps[0, -1] - target[0]).max())
        assert dH < 0.25 * d0, f"no convergence: {d0} -> {dH}"

    def test_controls_respect_box(self, flat_edge_map, small_cfg):
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(0), 3)
        sol = mpc.solve_batch(flat_edge_map, scen)
        assert float(jnp.abs(sol.us).max()) <= small_cfg.u_limit + 1e-6

    def test_batch_shapes(self, flat_edge_map, small_cfg):
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(1), 5)
        sol = mpc.solve_batch(flat_edge_map, scen)
        assert sol.us.shape == (5, small_cfg.horizon, 6)
        assert sol.ps.shape == (5, small_cfg.horizon + 1,
                                2 * small_cfg.num_features)
        assert sol.cost.shape == (5,)

    def test_assoc_backend_matches_reference(self, small_cfg):
        """Full-solve equivalence of the log-depth backend."""
        import dataclasses
        rng = np.random.default_rng(17)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        assoc = VisualServoMPC(
            dataclasses.replace(small_cfg, backend="assoc", q_edge=0.1))
        ref = VisualServoMPC(
            dataclasses.replace(small_cfg, backend="reference", q_edge=0.1))
        scen = assoc.random_scenarios(jax.random.PRNGKey(6), 4)
        sa = assoc.solve_batch(edge, scen)
        sr = ref.solve_batch(edge, scen)
        np.testing.assert_allclose(np.asarray(sa.us), np.asarray(sr.us),
                                   rtol=2e-2, atol=5e-3)
        np.testing.assert_allclose(np.asarray(sa.cost), np.asarray(sr.cost),
                                   rtol=1e-3, atol=1e-3)

    def test_deterministic(self, flat_edge_map, small_cfg):
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(2), 3)
        a = mpc.solve_batch(flat_edge_map, scen)
        b = mpc.solve_batch(flat_edge_map, scen)
        np.testing.assert_array_equal(np.asarray(a.us), np.asarray(b.us))

    def test_batch_cost_consistent_with_individual(self, flat_edge_map,
                                                   small_cfg):
        """Batched and single solves may diverge bitwise (XLA fuses
        differently per batch shape; 15 nonconvex solver iterations amplify
        fp noise) but must land at comparable solution quality."""
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(2), 3)
        batched = mpc.solve_batch(flat_edge_map, scen)
        one = mpc.solve_batch(
            flat_edge_map, jax.tree.map(lambda a: a[1:2], scen))
        cb, co = float(batched.cost[1]), float(one.cost[0])
        assert abs(cb - co) <= 0.1 * max(abs(cb), abs(co), 1e-3)

    def test_edge_cost_pulls_to_edges(self):
        """With zero tracking weight, features should move toward the bright
        edge band in the map."""
        # Fixed budget (extra=0): this edge-dominated instance (q_track=0)
        # is the class DESIGN.md §2f flags as over-iteration-sensitive for
        # the inexact nonconvex ADMM — at 4+3 gated iterations (the r5b
        # default extra) the solve overshoots the band and drifts left.
        # The test pins the physical contract (edge attraction works) at
        # the budget it was designed for, not the scheduler.
        cfg = MPCConfig(horizon=12, num_features=1, ilqr_iters=4,
                        admm_iters=4, admm_iters_extra=0,
                        q_track=0.0, q_edge=5.0, r_ctrl=1e-3,
                        u_limit=5.0)
        mpc = VisualServoMPC(cfg)
        edge = jnp.zeros((64, 128), jnp.float32)
        edge = edge.at[:, 90:100].set(255.0)  # bright vertical band right
        p0 = jnp.array([[0.0, 0.0]])  # center (col 64)
        scen = Scenario(p0=p0, target=jnp.zeros((1, 2)),
                        depth=jnp.ones((1, 1)) * 2.0,
                        us0=jnp.zeros((1, cfg.horizon, 6)))
        sol = mpc.solve_batch(edge, scen)
        x_final = float(sol.ps[0, -1, 0])
        assert x_final > 0.05, f"feature did not move toward edges: {x_final}"

    def test_control_step_from_frame(self, small_cfg, rng):
        mpc = VisualServoMPC(small_cfg)
        frame = rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8)
        scen = mpc.random_scenarios(jax.random.PRNGKey(3), 2)
        u0, sol = mpc.control_step(frame, scen)
        assert u0.shape == (2, 6)
        assert np.isfinite(np.asarray(sol.cost)).all()

    def test_control_step_matches_edge_map_path(self, small_cfg, rng):
        """control_step's fused perception->pyramid front-end is bit-exact
        with solving on the staged edge map (the pooled pyramid levels are
        identical, so the Solutions are too)."""
        from openmp_parallel_computing_tpu import ops

        mpc = VisualServoMPC(small_cfg)
        frame = rng.integers(0, 256, size=(3, 70, 130), dtype=np.uint8)
        scen = mpc.random_scenarios(jax.random.PRNGKey(5), 3)
        u0, sol = mpc.control_step(frame, scen)
        edge = np.asarray(ops.edge_pipeline(frame))[0].astype(np.float32)
        sol_ref = mpc.solve_batch(edge, scen)
        for a, b in zip(sol, sol_ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(u0),
                                      np.asarray(sol_ref.us[:, 0]))


class TestRecedingHorizon:
    # The headline bench runs q_edge=0.1 with edge_refresh="solve"; the
    # equivalence tests cover that configuration plus the cold-start-safe
    # default ("admm") so the scan loops are verified at the shipped
    # settings, not only the edge-free small_cfg.
    #
    # Tolerances: the scan body and control_step compile to DIFFERENT XLA
    # programs, so fp rounding differs at the ~1e-7 level per step; the
    # closed loop amplifies it (controls ride the saturation boundary), to
    # ~6e-4 by step 4 on adversarial random frames. Step 0 is compared
    # tightly (same inputs, one program each); later steps use closed-loop
    # tolerances. Each test draws its own seeded rng so failures reproduce
    # independent of test order (the shared session fixture is stateful).
    def _loop_check(self, mpc, frame_for_step, scen, n, u0s, costs_seq,
                    scen_out):
        from openmp_parallel_computing_tpu.models.mpc import dynamics

        from openmp_parallel_computing_tpu.models.mpc.solver import (
            _shift_tail_zero)

        s = mpc._seed_duals(scen)
        for i in range(n):
            u0, sol = mpc.control_step(frame_for_step(i), s)
            tol = dict(rtol=1e-5, atol=1e-6) if i == 0 else \
                dict(rtol=1e-3, atol=5e-3)
            np.testing.assert_allclose(np.asarray(u0s[i]), np.asarray(u0),
                                       **tol)
            np.testing.assert_allclose(np.asarray(costs_seq[i]),
                                       np.asarray(sol.cost),
                                       rtol=1e-3, atol=1e-4)
            p1 = jax.vmap(lambda p, u, d: dynamics.step(
                p, u, d, mpc.cfg.dt))(s.p0, u0, s.depth)
            # Mirror the device loops' carry (solver._advance): zero-fill
            # shifts, decayed duals when the carry is active (duals out
            # iff duals in).
            y0 = (mpc.cfg.dual_decay * _shift_tail_zero(sol.dual, axis=1)
                  if s.y0 is not None else None)
            s = s._replace(p0=p1,
                           us0=_shift_tail_zero(sol.us, axis=1), y0=y0)
        np.testing.assert_allclose(np.asarray(scen_out.p0),
                                   np.asarray(s.p0), rtol=1e-3, atol=5e-3)

    @pytest.mark.parametrize("refresh", ["admm", "solve"])
    def test_scan_matches_host_loop(self, small_cfg, refresh):
        """The device-resident lax.scan loop (one dispatch) matches a host
        loop of control_step + manual dynamics step + warm-start shift —
        the scan only removes host round-trips."""
        import dataclasses

        cfg = dataclasses.replace(small_cfg, q_edge=0.1,
                                  edge_refresh=refresh)
        mpc = VisualServoMPC(cfg)
        rng = np.random.default_rng(41)
        frame = jnp.asarray(
            rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8))
        scen = mpc.random_scenarios(jax.random.PRNGKey(11), 3)

        n = 4
        u0s, costs_seq, scen_out = mpc.receding_horizon(frame, scen, n)
        assert u0s.shape == (n, 3, 6)
        assert costs_seq.shape == (n, 3)
        self._loop_check(mpc, lambda i: frame, scen, n, u0s, costs_seq,
                         scen_out)

    @pytest.mark.parametrize("refresh", ["admm", "solve"])
    def test_frames_scan_matches_host_loop(self, small_cfg, refresh):
        """receding_horizon_frames (per-step perception over a frame ring)
        matches a host loop of control_step on frame t mod F. Frames are
        DISTINCT (q_edge > 0), so a frame-indexing or pyramid-reuse bug
        changes the solutions and fails the comparison."""
        import dataclasses

        cfg = dataclasses.replace(small_cfg, q_edge=0.1,
                                  edge_refresh=refresh)
        mpc = VisualServoMPC(cfg)
        rng = np.random.default_rng(42)
        n_ring, n = 3, 5
        frames = jnp.asarray(rng.integers(
            0, 256, size=(n_ring, 3, 64, 128), dtype=np.uint8))
        scen = mpc.random_scenarios(jax.random.PRNGKey(12), 3)

        u0s, costs_seq, scen_out = mpc.receding_horizon_frames(
            frames, scen, n)
        assert u0s.shape == (n, 3, 6)
        self._loop_check(mpc, lambda i: frames[i % n_ring], scen, n, u0s,
                         costs_seq, scen_out)

    def test_frames_ring_actually_varies(self, small_cfg):
        """With distinct ring frames the per-step controls must differ from
        a fixed-frame loop (guards against the scan silently reusing one
        pyramid — the round-2 headline-honesty finding)."""
        import dataclasses

        cfg = dataclasses.replace(small_cfg, q_edge=0.5)
        mpc = VisualServoMPC(cfg)
        rng = np.random.default_rng(43)
        f0 = rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8)
        f1 = np.roll(f0, 31, axis=2)
        frames = jnp.asarray(np.stack([f0, f1]))
        scen = mpc.random_scenarios(jax.random.PRNGKey(13), 2)
        u_ring, _, _ = mpc.receding_horizon_frames(frames, scen, 4)
        u_fixed, _, _ = mpc.receding_horizon(jnp.asarray(f0), scen, 4)
        # step 0 sees the same frame either way...
        np.testing.assert_allclose(np.asarray(u_ring[0]),
                                   np.asarray(u_fixed[0]),
                                   rtol=1e-5, atol=1e-6)
        # ...but step 1 sees f1 in the ring and must diverge.
        assert not np.allclose(np.asarray(u_ring[1]),
                               np.asarray(u_fixed[1]), atol=1e-6)

    def test_closed_loop_progresses(self, rng):
        """Closed-loop receding horizon drives features toward the target
        (the solver actually controls the simulated plant)."""
        cfg = MPCConfig(horizon=10, num_features=4, scenarios=2,
                        q_edge=0.0)
        mpc = VisualServoMPC(cfg)
        frame = rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8)
        scen = mpc.random_scenarios(jax.random.PRNGKey(2), 2)
        d0 = np.abs(np.asarray(scen.p0 - scen.target)).mean()
        _, _, scen_out = mpc.receding_horizon(jnp.asarray(frame), scen, 12)
        d1 = np.abs(np.asarray(scen_out.p0 - scen_out.target)).mean()
        # progress rate is bounded by the control box and dt (~dt*|L||u|
        # per frame); 12 frames of the default budget measure ~0.70x.
        assert d1 < 0.8 * d0


class TestEdgeRefresh:
    """edge_refresh="admm" (one pyramid linearization per ADMM iteration,
    shared by the iLQR sweeps) must keep cross-backend equivalence and
    solution quality vs the per-sweep schedule."""

    def _solve(self, backend, refresh, edge, scen, cfg):
        import dataclasses
        mpc = VisualServoMPC(dataclasses.replace(
            cfg, backend=backend, q_edge=0.1, edge_refresh=refresh))
        return mpc.solve_batch(edge, scen)

    @pytest.mark.parametrize("refresh", ["admm", "solve"])
    def test_backends_agree_under_stale_refresh(self, small_cfg, refresh):
        rng = np.random.default_rng(23)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(9), 5)
        ss = self._solve("sweep", refresh, edge, scen, small_cfg)
        sr = self._solve("reference", refresh, edge, scen, small_cfg)
        np.testing.assert_allclose(np.asarray(ss.us), np.asarray(sr.us),
                                   rtol=2e-2, atol=5e-3)
        np.testing.assert_allclose(np.asarray(ss.cost), np.asarray(sr.cost),
                                   rtol=1e-3, atol=1e-3)

    def test_quality_parity_with_per_sweep_refresh(self, small_cfg):
        """Stale (per-ADMM) linearization must not degrade the final true
        cost beyond ~1% on random textured scenes."""
        rng = np.random.default_rng(31)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(11), 16)
        c_ilqr = np.asarray(
            self._solve("reference", "ilqr", edge, scen, small_cfg).cost)
        c_admm = np.asarray(
            self._solve("reference", "admm", edge, scen, small_cfg).cost)
        assert np.isfinite(c_admm).all()
        rel = (c_admm.mean() - c_ilqr.mean()) / abs(c_ilqr.mean())
        assert rel < 0.01, f"stale-grad quality loss {rel:.4%}"


class TestAdmmRelax:
    """Over-relaxed ADMM (cfg.admm_relax, Boyd §3.4.3) must keep every
    backend numerically equivalent and the solution feasible; relax=1.0 is
    the plain solver (Python branch — same graph, covered by every other
    test in this file)."""

    def _solve(self, backend, edge, scen, cfg, relax):
        import dataclasses
        mpc = VisualServoMPC(dataclasses.replace(
            cfg, backend=backend, q_edge=0.1, admm_relax=relax))
        return mpc.solve_batch(edge, scen)

    @pytest.mark.parametrize("backend", ["sweep", "assoc"])
    def test_backends_agree_when_relaxed(self, small_cfg, backend):
        rng = np.random.default_rng(41)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(19), 5)
        sb = self._solve(backend, edge, scen, small_cfg, 1.6)
        sr = self._solve("reference", edge, scen, small_cfg, 1.6)
        np.testing.assert_allclose(np.asarray(sb.us), np.asarray(sr.us),
                                   rtol=2e-2, atol=5e-3)
        np.testing.assert_allclose(np.asarray(sb.cost), np.asarray(sr.cost),
                                   rtol=1e-3, atol=1e-3)

    def test_relaxed_solution_feasible_and_finite(self, small_cfg):
        rng = np.random.default_rng(43)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(21), 8)
        sol = self._solve("sweep", edge, scen, small_cfg, 1.8)
        us = np.asarray(sol.us)
        assert np.isfinite(us).all()
        assert np.abs(us).max() <= small_cfg.u_limit + 1e-6
        assert np.isfinite(np.asarray(sol.cost)).all()

    def test_relax_changes_the_iterates(self, small_cfg):
        """Sanity: the knob is actually wired through (relax=1.6 must not
        reproduce the plain-ADMM controls bit-for-bit)."""
        rng = np.random.default_rng(47)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(small_cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(23), 4)
        s1 = self._solve("reference", edge, scen, small_cfg, 1.0)
        s2 = self._solve("reference", edge, scen, small_cfg, 1.6)
        assert np.abs(np.asarray(s1.us) - np.asarray(s2.us)).max() > 0


class TestDualWarmStart:
    """ADMM scaled-dual warm starting (MPCConfig.dual_warm_start,
    Scenario.y0): the closed-loop carry the 100-frame study measured as a
    strict improvement at the shipped budget — identical asymptotic cost,
    mean primal residual -35% (results/cpu/dual_warm_loop_solve.json)."""

    def _cfg(self, backend, **kw):
        # admm_iters_extra=0: these tests pin FIXED-budget dual-carry
        # behavior (the adaptive gate has its own suite below).
        kw.setdefault("admm_iters_extra", 0)
        return MPCConfig(horizon=6, num_features=2, ilqr_iters=1,
                         admm_iters=3, backend=backend, q_edge=0.1, **kw)

    def test_warm_duals_equivalent_across_backends(self):
        """A nonzero Scenario.y0 must produce the same solution (and the
        same returned Solution.dual) on every backend."""
        rng = np.random.default_rng(29)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        y0 = jnp.asarray(rng.uniform(-0.2, 0.2, (4, 6, 6)), jnp.float32)
        sols = {}
        for backend in ("sweep", "reference", "assoc"):
            mpc = VisualServoMPC(self._cfg(backend))
            scen = mpc.random_scenarios(jax.random.PRNGKey(31), 4)
            sols[backend] = mpc.solve_batch(edge, scen._replace(y0=y0))
        for b in ("reference", "assoc"):
            np.testing.assert_allclose(np.asarray(sols["sweep"].us),
                                       np.asarray(sols[b].us),
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(np.asarray(sols["sweep"].dual),
                                       np.asarray(sols[b].dual),
                                       rtol=2e-4, atol=2e-4)

    def test_warm_duals_change_the_solve(self):
        """The y0 input is actually wired through (a warm dual must not
        reproduce the cold solve bit-for-bit)."""
        rng = np.random.default_rng(37)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        mpc = VisualServoMPC(self._cfg("sweep"))
        scen = mpc.random_scenarios(jax.random.PRNGKey(41), 4)
        cold = mpc.solve_batch(edge, scen)
        warm = mpc.solve_batch(
            edge, scen._replace(y0=0.3 * jnp.ones_like(scen.us0)))
        assert np.abs(np.asarray(cold.us) - np.asarray(warm.us)).max() > 0

    @pytest.mark.parametrize("backend", ["sweep", "reference"])
    def test_receding_horizon_carries_duals(self, backend):
        """With dual_warm_start the loop's outgoing scenario holds the
        shifted duals (nonzero once constraints are active), and the
        closed-loop residual improves on the cold-dual loop."""
        import dataclasses

        rng = np.random.default_rng(53)
        frame = jnp.asarray(
            rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8))
        resid = {}
        for dual in (False, True):
            cfg = self._cfg(backend, dual_warm_start=dual)
            mpc = VisualServoMPC(cfg)
            # far-off targets keep the control box active
            scen = mpc.random_scenarios(jax.random.PRNGKey(59), 8)
            scen = scen._replace(target=-0.9 * scen.p0)
            _, _, scen_out = mpc.receding_horizon(frame, scen, 8)
            if dual:
                assert scen_out.y0 is not None
                assert bool(jnp.any(scen_out.y0 != 0))
            else:
                assert scen_out.y0 is None
            sol = mpc.solve_batch(
                jnp.full((64, 128), 128.0, jnp.float32) * 0 + 128.0,
                scen_out)
            resid[dual] = float(jnp.mean(sol.primal_residual))
        # warm duals must not make constraint satisfaction worse
        assert resid[True] <= resid[False] * 1.05, resid

    def test_decay_zero_reproduces_cold_loop(self):
        """dual_decay=0 must reproduce the cold-dual loop bit-for-bit —
        the carry structure alone cannot change the math (and γ is
        actually wired: the default 0.5 loop differs)."""
        import dataclasses

        rng = np.random.default_rng(71)
        frame = jnp.asarray(
            rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8))
        cfg_cold = self._cfg("sweep", dual_warm_start=False)
        mpc_cold = VisualServoMPC(cfg_cold)
        scen = mpc_cold.random_scenarios(jax.random.PRNGKey(73), 4)
        u_cold, _, _ = mpc_cold.receding_horizon(frame, scen, 5)
        mpc_zero = VisualServoMPC(dataclasses.replace(
            cfg_cold, dual_warm_start=True, dual_decay=0.0))
        u_zero, _, _ = mpc_zero.receding_horizon(frame, scen, 5)
        np.testing.assert_allclose(np.asarray(u_zero), np.asarray(u_cold),
                                   rtol=1e-6, atol=1e-7)
        mpc_half = VisualServoMPC(dataclasses.replace(
            cfg_cold, dual_warm_start=True, dual_decay=0.5))
        u_half, _, _ = mpc_half.receding_horizon(frame, scen, 5)
        assert not np.allclose(np.asarray(u_half)[1:],
                               np.asarray(u_cold)[1:], atol=1e-7)


class TestAdaptiveBudget:
    """Quality-gated adaptive ADMM budget (MPCConfig.admm_iters_extra /
    admm_tol, round 5): after the base iterations, a continuation of
    extra iterations runs iff the BATCH-max primal residual exceeds the
    tolerance. The gating is batch-global in every backend, so the two
    boundary cases pin it exactly: a tolerance of 0 must reproduce the
    fixed (base+extra) budget bit-for-bit, an unreachable tolerance the
    fixed base budget."""

    def _solve(self, edge, scen, **kw):
        kw.setdefault("admm_iters_extra", 0)   # fixed unless stated
        cfg = MPCConfig(horizon=8, num_features=4, q_edge=0.1, **kw)
        return VisualServoMPC(cfg).solve_batch(edge, scen)

    @pytest.fixture()
    def edge_and_scen(self):
        rng = np.random.default_rng(83)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        scen = VisualServoMPC(MPCConfig(horizon=8, num_features=4)
                              ).random_scenarios(jax.random.PRNGKey(29), 6)
        return edge, scen

    @pytest.mark.parametrize("backend",
                             ["sweep", "reference", "assoc"])
    def test_boundary_cases_bit_exact(self, edge_and_scen, backend):
        edge, scen = edge_and_scen
        trig = self._solve(edge, scen, backend=backend, admm_iters=2,
                           admm_iters_extra=3, admm_tol=0.0)
        fixed5 = self._solve(edge, scen, backend=backend, admm_iters=5)
        np.testing.assert_array_equal(np.asarray(trig.us),
                                      np.asarray(fixed5.us))
        skip = self._solve(edge, scen, backend=backend, admm_iters=2,
                           admm_iters_extra=3, admm_tol=1e9)
        fixed2 = self._solve(edge, scen, backend=backend, admm_iters=2)
        np.testing.assert_array_equal(np.asarray(skip.us),
                                      np.asarray(fixed2.us))

    @pytest.mark.parametrize("backend", ["reference", "assoc"])
    def test_backends_agree_at_mid_tolerance(self, edge_and_scen, backend):
        edge, scen = edge_and_scen
        kw = dict(admm_iters=2, admm_iters_extra=3, admm_tol=0.05)
        sb = self._solve(edge, scen, backend=backend, **kw)
        ss = self._solve(edge, scen, backend="sweep", **kw)
        np.testing.assert_allclose(np.asarray(ss.us), np.asarray(sb.us),
                                   rtol=2e-2, atol=5e-3)
        np.testing.assert_allclose(np.asarray(ss.cost),
                                   np.asarray(sb.cost),
                                   rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("backend", ["sweep", "reference"])
    def test_receding_loop_with_adaptive_budget(self, backend):
        """The cond-gated continuation must compose with the scan-resident
        receding loop and the dual carry (the headline configuration)."""
        rng = np.random.default_rng(89)
        frame = jnp.asarray(
            rng.integers(0, 256, size=(3, 64, 128), dtype=np.uint8))
        frames = jnp.stack([frame, jnp.roll(frame, 11, axis=-1)])
        cfg = MPCConfig(horizon=8, num_features=4, q_edge=0.1,
                        admm_iters=3, admm_iters_extra=2, admm_tol=0.05,
                        backend=backend, edge_refresh="solve")
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(31), 5)
        u0s, costs, scen_out = mpc.receding_horizon_frames(frames, scen, 6)
        assert np.isfinite(np.asarray(u0s)).all()
        assert np.isfinite(np.asarray(costs)).all()
        assert scen_out.y0 is not None          # dual carry still active
        assert np.abs(np.asarray(u0s)).max() <= cfg.u_limit + 1e-6


class TestSamplerDtype:
    """MPCConfig.sampler_dtype: bf16 weight-tensor storage for the dense
    lanes samplers (docs/DESIGN.md §2m). Contracts: (a) the default
    (float32 / dtype=None) is BIT-identical to the historical path; (b)
    the bf16 path matches f32 within the quantization bound the config
    documents (~2^-8 of a pyramid cell on positions, ~0.4% on edge
    values); (c) a full sweep-backend solve under bf16 stays within
    sub-percent of the f32 solution (accumulation is f32 throughout)."""

    def _points(self, seed=23, K=5, m=4, B=96):
        rng = np.random.default_rng(seed)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)
        pyramid = costs.build_cost_pyramid(edge)
        x = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
        y = rng.uniform(-1.4, 1.4, (K, m, B)).astype(np.float32)
        x[0, 0] = -1.0                      # border-clamped
        x[:, 1] = np.round(x[:, 1], 0)      # on-integer coords (kinks)
        return pyramid, jnp.asarray(x), jnp.asarray(y)

    def test_f32_dtype_arg_bit_identical(self):
        pyramid, x, y = self._points()
        for fn in (costs.edge_cost_pyramid_xy,):
            base = fn(pyramid, x, y, 64, 128)
            same = fn(pyramid, x, y, 64, 128, dtype=jnp.float32)
            np.testing.assert_array_equal(np.asarray(base),
                                          np.asarray(same))
        v0, gx0, gy0 = costs.edge_vg_pyramid_xy(pyramid, x, y, 64, 128)
        v1, gx1, gy1 = costs.edge_vg_pyramid_xy(pyramid, x, y, 64, 128,
                                                dtype=jnp.float32)
        for a, b in ((v0, v1), (gx0, gx1), (gy0, gy1)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_bf16_within_quantization_bound(self):
        """At production geometry (1080p -> 68x120 base level) the bf16
        path must stay within the documented bound: ~0.4% on values,
        ~1% of the gradient scale (the tiny-fixture levels used by the
        other tests have a much smaller gradient scale, which inflates
        the RELATIVE error without changing the absolute quantization)."""
        rng = np.random.default_rng(29)
        edge = jnp.asarray(rng.uniform(0, 255, (1080, 1920)), jnp.float32)
        pyramid = costs.build_cost_pyramid(edge)
        x = jnp.asarray(rng.uniform(-1.4, 1.4, (5, 4, 96)), jnp.float32)
        y = jnp.asarray(rng.uniform(-1.4, 1.4, (5, 4, 96)), jnp.float32)
        v, gx, gy = costs.edge_vg_pyramid_xy(pyramid, x, y, 1080, 1920)
        vb, gxb, gyb = costs.edge_vg_pyramid_xy(pyramid, x, y, 1080, 1920,
                                                dtype=jnp.bfloat16)
        assert vb.dtype == jnp.float32      # outputs stay f32
        # values live on a ~O(1) scale (mean of 1 - e/255)
        assert float(jnp.max(jnp.abs(v - vb))) < 1e-2
        for g, gb in ((gx, gxb), (gy, gyb)):
            scale = float(jnp.max(jnp.abs(g))) + 1e-30
            assert float(jnp.max(jnp.abs(g - gb))) < 0.02 * scale
        cv = costs.edge_cost_pyramid_xy(pyramid, x, y, 1080, 1920)
        cvb = costs.edge_cost_pyramid_xy(pyramid, x, y, 1080, 1920,
                                         dtype=jnp.bfloat16)
        assert float(jnp.max(jnp.abs(cv - cvb))) < 1e-2

    @pytest.mark.parametrize("edge_refresh", ["solve", "admm"])
    def test_solver_bf16_close_to_f32(self, edge_refresh):
        rng = np.random.default_rng(31)
        edge = jnp.asarray(rng.uniform(0, 255, (64, 128)), jnp.float32)

        def solve(sd):
            cfg = MPCConfig(horizon=8, num_features=4, ilqr_iters=2,
                            admm_iters=3, edge_refresh=edge_refresh,
                            sampler_dtype=sd)
            mpc = VisualServoMPC(cfg)
            scen = mpc.random_scenarios(jax.random.PRNGKey(5), 6)
            sol = mpc.solve_batch(edge, scen)
            return np.asarray(sol.us), np.asarray(sol.cost)

        us32, cost32 = solve("float32")
        us16, cost16 = solve("bfloat16")
        # controls are on a u_limit=1 scale; the measured end-to-end
        # deviation is ~1.4e-3 (the config's documented noise floor)
        np.testing.assert_allclose(us16, us32, atol=8e-3)
        np.testing.assert_allclose(cost16, cost32, rtol=5e-3, atol=5e-3)
