"""The lanes sweep backend (``models.mpc.sweep``, batch-last ``lax.scan``
programs) against the per-scenario reference backend, across batch sizes
on both sides of every old tile boundary, horizons, edge-refresh
schedules, over-relaxation and cold or warm ADMM duals; plus the
line-search candidate pick the sweep relies on."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC, sweep
from openmp_parallel_computing_tpu.models.mpc import dynamics, riccati
from openmp_parallel_computing_tpu.utils.config import MPCConfig

REFRESH = ("ilqr", "admm", "solve")
RELAX = (1.0, 1.6)
DUALS = ("cold", "warm")


@pytest.fixture(scope="module")
def edge_map():
    rng = np.random.default_rng(23)
    return jnp.asarray(rng.uniform(0, 255, (32, 128)), jnp.float32)


@pytest.fixture(scope="module")
def cfg():
    return MPCConfig(horizon=4, num_features=2, ilqr_iters=2, admm_iters=2)


def _solve_pair(edge_map, B, H, refresh, relax, duals):
    cfg = MPCConfig(horizon=H, num_features=2, ilqr_iters=1, admm_iters=2,
                    admm_iters_extra=0, edge_refresh=refresh,
                    admm_relax=relax)
    sweep_mpc = VisualServoMPC(cfg)
    ref_mpc = VisualServoMPC(dataclasses.replace(cfg, backend="reference"))
    scen = sweep_mpc.random_scenarios(jax.random.PRNGKey(B + H), B)
    if duals == "warm":
        rng = np.random.default_rng(B)
        scen = scen._replace(y0=jnp.asarray(
            rng.uniform(-0.2, 0.2, scen.us0.shape), jnp.float32))
    return sweep_mpc.solve_batch(edge_map, scen), \
        ref_mpc.solve_batch(edge_map, scen)


def _assert_equivalent(ss, sr, duals):
    # Same tolerances as the other cross-backend tests: fp noise can flip a
    # line-search tie in a nonconvex sweep; costs agree much tighter.
    np.testing.assert_allclose(np.asarray(ss.us), np.asarray(sr.us),
                               rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(np.asarray(ss.cost), np.asarray(sr.cost),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ss.primal_residual),
                               np.asarray(sr.primal_residual),
                               rtol=2e-2, atol=5e-3)
    if duals == "warm":
        np.testing.assert_allclose(np.asarray(ss.dual), np.asarray(sr.dual),
                                   rtol=2e-2, atol=5e-3)
    else:
        assert ss.dual is None and sr.dual is None


# Batch sizes around the 128-scenario boundary the removed lane tiling
# padded to, across both horizons; the schedule options cycle so each
# value meets both horizons.
_BATCH_GRID = [
    (B, H, REFRESH[i % 3], RELAX[i % 2], DUALS[(i // 2) % 2])
    for i, (B, H) in enumerate(itertools.product((1, 127, 128, 129, 300),
                                                 (3, 20)))]


@pytest.mark.parametrize("B,H,refresh,relax,duals", _BATCH_GRID)
def test_sweep_matches_reference_batches(edge_map, B, H, refresh, relax,
                                         duals):
    ss, sr = _solve_pair(edge_map, B, H, refresh, relax, duals)
    assert ss.us.shape == (B, H, 6)
    _assert_equivalent(ss, sr, duals)


@pytest.mark.parametrize("refresh,relax,duals",
                         list(itertools.product(REFRESH, RELAX, DUALS)))
def test_sweep_matches_reference_schedules(edge_map, refresh, relax, duals):
    ss, sr = _solve_pair(edge_map, 5, 3, refresh, relax, duals)
    _assert_equivalent(ss, sr, duals)


def test_solver_multi_tile_batch(edge_map, cfg):
    """Sweep solver at a batch of several hundred scenarios matches the
    reference backend."""
    mpc_sweep = VisualServoMPC(dataclasses.replace(cfg, backend="sweep"))
    mpc_ref = VisualServoMPC(dataclasses.replace(cfg, backend="reference"))
    scen = mpc_sweep.random_scenarios(jax.random.PRNGKey(3), 384)
    ss = mpc_sweep.solve_batch(edge_map, scen)
    sr = mpc_ref.solve_batch(edge_map, scen)
    np.testing.assert_allclose(np.asarray(ss.cost), np.asarray(sr.cost),
                               rtol=1e-3, atol=1e-3)


class TestLanesSweep:
    """Step-level checks of ``models.mpc.sweep`` against the reference
    Riccati recursion and dynamics on the same linearization."""

    H, M, B = 5, 3, 7

    def _inputs(self, seed=5):
        rng = np.random.default_rng(seed)
        H, m, B = self.H, self.M, self.B
        n, c = 2 * m, 6
        p0 = rng.uniform(-.5, .5, (B, n)).astype(np.float32)
        us = (rng.normal(size=(B, H, c)) * 0.1).astype(np.float32)
        z = np.clip(us + 0.05, -0.1, 0.1)
        y = (rng.normal(size=(B, H, c)) * 0.05).astype(np.float32)
        g = (rng.normal(size=(B, H + 1, n)) * 0.2).astype(np.float32)
        tg = rng.uniform(-.4, .4, (B, n)).astype(np.float32)
        depth = rng.uniform(1.0, 5.0, (B, m)).astype(np.float32)
        return p0, us, z, y, g, tg, depth

    @staticmethod
    def _split(a):
        s = a.shape
        return a.reshape(s[:-1] + (-1, 2)).swapaxes(-1, -2).reshape(s)

    def test_rollout_matches_dynamics(self):
        p0, us, _, _, _, _, depth = self._inputs()
        dt = 1 / 30
        want = jax.vmap(lambda p, u, d: dynamics.rollout(p, u, d, dt))(
            p0, us, depth)
        got = sweep.rollout(jnp.asarray(self._split(p0)).T,
                            jnp.transpose(us, (1, 2, 0)),
                            jnp.asarray(1.0 / depth).T, dt, self.M)
        np.testing.assert_allclose(
            np.asarray(jnp.transpose(got, (2, 0, 1))),
            self._split(np.asarray(want)), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("qe", [0.0, 0.1])
    def test_backward_gains_match_riccati(self, qe):
        """Gains of the lanes backward sweep == ``riccati.backward`` on the
        analytic expansion of the same augmented cost (split state order)."""
        p0, us, z, y, g, tg, depth = self._inputs(11)
        q, r, rho, dt, m = 1.0, 0.01, 0.1, 1 / 30, self.M
        n, c = 2 * m, 6
        ps = jax.vmap(lambda p, u, d: dynamics.rollout(p, u, d, dt))(
            p0, us, depth)
        ps_s, g_s, tg_s = (self._split(np.asarray(a)) for a in (ps, g, tg))

        def ref_one(ps_b, us_b, z_b, y_b, g_b, tg_b, d_b):
            fx, fu = jax.vmap(lambda p, u: dynamics.linearize_analytic(
                p, u, d_b, dt))(ps_b[:-1], us_b)
            perm = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])
            fx = fx[:, perm][:, :, perm]
            fu = fu[:, perm]
            p_s = self._split(ps_b)
            lx = 2 * q * (p_s[:-1] - self._split(tg_b)) \
                + qe * self._split(g_b)[:-1]
            lu = 2 * r * us_b + rho * (us_b - z_b + y_b)
            lxx = jnp.broadcast_to(2 * q * jnp.eye(n), (self.H, n, n))
            luu = jnp.broadcast_to((2 * r + rho) * jnp.eye(c),
                                   (self.H, c, c))
            lux = jnp.zeros((self.H, c, n))
            vx = 2 * q * (p_s[-1] - self._split(tg_b)) \
                + qe * self._split(g_b)[-1]
            vxx = 2 * q * jnp.eye(n)
            return riccati.backward(fx, fu, lx, lu, lxx, luu, lux, vx, vxx)

        want = jax.vmap(ref_one)(ps, us, z, y, g, tg, depth)
        lanes = lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1)
        K, k = sweep.backward_sweep(
            lanes(ps_s), lanes(us), lanes(z), lanes(y), lanes(g_s),
            lanes(tg_s), lanes(1.0 / depth), m=m, q=q, r=r, rho=rho, qe=qe,
            dt=dt)
        np.testing.assert_allclose(np.asarray(jnp.moveaxis(K, -1, 0)),
                                   np.asarray(want.K), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(np.asarray(jnp.moveaxis(k, -1, 0)),
                                   np.asarray(want.k), rtol=2e-4, atol=2e-5)

    def test_alpha_zero_candidate_is_nominal(self):
        """Candidate 0 (alpha=0) of the forward sweep reproduces the
        nominal trajectory exactly, so the argmin over candidates is the
        'did anything improve' test."""
        p0, us, z, y, g, tg, depth = self._inputs(13)
        m, dt = self.M, 1 / 30
        lanes = lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1)
        p0_l = lanes(self._split(p0))
        izd = lanes(1.0 / depth)
        ps_l = sweep.rollout(p0_l, lanes(us), izd, dt, m)
        kw = dict(m=m, q=1.0, r=0.01, rho=0.1, qe=0.1, dt=dt)
        K, k = sweep.backward_sweep(ps_l, lanes(us), lanes(z), lanes(y),
                                    lanes(self._split(g)),
                                    lanes(self._split(tg)), izd, **kw)
        ps_c, us_c, J = sweep.forward_sweep(
            p0_l, ps_l, lanes(us), K, k, lanes(z), lanes(y),
            lanes(self._split(g)), lanes(self._split(tg)), izd, **kw)
        assert ps_c.shape == (self.H + 1, len(sweep.ALPHAS), 2 * m, self.B)
        assert us_c.shape == (self.H, len(sweep.ALPHAS), 6, self.B)
        np.testing.assert_array_equal(np.asarray(ps_c[:, 0]),
                                      np.asarray(ps_l))
        np.testing.assert_array_equal(np.asarray(us_c[:, 0]),
                                      np.asarray(lanes(us)))
        assert np.isfinite(np.asarray(J)).all()


class TestPickCandidates:
    """solver._pick_candidates: the first-wins, NaN-guarded winner select
    over line-search candidates."""

    def test_losing_nan_candidate_cannot_poison_winner(self):
        """A NaN in a LOSING candidate must not leak into the finite
        winner (regression: a one-hot contraction computed 0.0 * NaN =
        NaN in the winner's lane, breaking backend equivalence on
        diverging line searches)."""
        from openmp_parallel_computing_tpu.models.mpc import solver as S

        # 3 candidates x 4 scenarios; candidate 2 diverged (NaN) in
        # scenarios 1 and 3 but only WINS (finite J) nowhere.
        J = jnp.asarray([[1.0, 2.0, 3.0, 4.0],
                         [0.5, 9.0, 1.0, 9.0],
                         [9.0, jnp.nan, 9.0, jnp.nan]])
        cand = jnp.asarray(np.stack([
            np.full((2, 4), 10.0, np.float32),
            np.full((2, 4), 20.0, np.float32),
            np.full((2, 4), np.nan, np.float32)]))   # (A, c, B)
        out = np.asarray(S._pick_candidates(J, cand, 0, 1))
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[0], [20.0, 10.0, 20.0, 10.0])

    def test_all_nonfinite_falls_back_to_first(self):
        from openmp_parallel_computing_tpu.models.mpc import solver as S

        J = jnp.asarray([[jnp.nan], [jnp.inf]])
        cand = jnp.asarray([[[7.0]], [[np.nan]]])
        out = np.asarray(S._pick_candidates(J, cand, 0, 1))
        np.testing.assert_array_equal(out, [[7.0]])

    def test_matches_take_along_axis_on_finite_costs(self):
        from openmp_parallel_computing_tpu.models.mpc import solver as S

        rng = np.random.default_rng(0)
        J = jnp.asarray(rng.uniform(0, 1, (4, 16)).astype(np.float32))
        cand = jnp.asarray(rng.normal(size=(4, 3, 16)).astype(np.float32))
        want = np.take_along_axis(
            np.asarray(cand), np.argmin(np.asarray(J), 0)[None, None], 0)[0]
        np.testing.assert_array_equal(
            np.asarray(S._pick_candidates(J, cand, 0, 1)), want)
