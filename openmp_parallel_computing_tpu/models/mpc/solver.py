"""The visual-servo MPC engine (flagship model).

Per BASELINE.json: Sobel edge-feature maps from the perception front-end
(``ops.edge_pyramid_base``) feed stage costs; image-plane feature dynamics
are rolled out over the horizon; the box-constrained QP is solved by an ADMM loop whose
inner solve is an iLQR/Riccati sweep; scenario batches fill the device and
shard across the mesh's data axis (``models.mpc.distributed``), with solver
diagnostics reduced via ``psum``.

Solve structure (all fixed-iteration, jit-compilable, static shapes):

    ADMM outer (admm_iters):
        iLQR inner (ilqr_iters):
            rollout -> closed-form linearization -> analytic cost
            expansion (+ ADMM augmentation, Gauss-Newton edge term)
            -> Riccati backward -> line-searched gain forward
        z = clip(u^ + y)   # projection onto the control box
        y = y + u^ - z     # dual ascent
        # u^ = us, or relax*us + (1-relax)*z_prev under over-relaxation
        # (cfg.admm_relax, Boyd §3.4.3 — same semantics in every backend)

Three numerically equivalent backends (docs/DESIGN.md):
  "sweep" (default)  batch-last lanes layout: the Riccati backward and the
                     line-searched forward as ``lax.scan`` programs over
                     the horizon (``models.mpc.sweep``)
  "reference"        per-scenario vmapped XLA (audit/fallback)
  "assoc"            reference with the log-depth associative-scan
                     backward (audit)

The whole perception->solve path compiles into ONE device computation
(``control_step``). Its one host round trip per solve is the adaptive
budget's ``lax.cond`` (``_adaptive_extra``), whose predicate the GPU
copies back to the host before it picks a branch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmp_parallel_computing_tpu.models.mpc import (
    costs,
    dynamics,
    riccati,
    sweep,
)
from openmp_parallel_computing_tpu.ops import edge_pyramid_base
from openmp_parallel_computing_tpu.utils.config import MPCConfig

_ALPHAS = (1.0, 0.5, 0.25)  # backtracking candidates, evaluated in parallel

def _to_split(a):
    """Permute the trailing state axis from the public interleaved order
    [x0, y0, x1, y1, ...] to the sweep kernels' split order
    [x0..x_{m-1}, y0..y_{m-1}] (see the ``models.mpc.sweep`` docstring)."""
    s = a.shape
    return a.reshape(s[:-1] + (-1, 2)).swapaxes(-1, -2).reshape(s)


def _from_split(a):
    """Inverse of :func:`_to_split`."""
    s = a.shape
    return a.reshape(s[:-1] + (2, -1)).swapaxes(-1, -2).reshape(s)


def _pick_candidates(J, cand, a_axis: int, n_batch_dims: int):
    """Select the argmin-J line-search candidate per scenario, first-wins
    on ties. J (A, *bshape); ``cand`` has the A axis at ``a_axis`` and the
    ``n_batch_dims`` batch dims trailing.

    Non-finite candidate costs are pushed to +inf so a NaN rollout can
    never win — the alpha=0 (nominal) candidate is always finite and wins
    instead, matching the reference backend's strict J < j0 guard.
    Masked ``where`` chain rather than a one-hot contraction:
    ``sum(cand * onehot)`` computes 0.0 * NaN = NaN wherever a LOSING
    candidate diverged, poisoning the finite winner."""
    J = jnp.where(jnp.isfinite(J), J, jnp.inf)
    Jmin = jnp.min(J, axis=0)                       # (*bshape,)
    cand = jnp.moveaxis(cand, a_axis, 0)
    mshape = [1] * (cand.ndim - 1)
    mshape[len(mshape) - n_batch_dims:] = J.shape[1:]
    out = cand[0]
    taken = J[0] == Jmin
    for a in range(1, cand.shape[0]):
        hit = (J[a] == Jmin) & ~taken
        taken = taken | hit
        out = jnp.where(hit.reshape(mshape), cand[a], out)
    return out


def _shift_tail_zero(a, axis=0):
    """Receding-horizon shift: drop entry 0 along ``axis``, zero-fill the
    tail (beyond-horizon steps carry no information — the MPCRuntime
    convention). Every loop and quality study shares this convention so
    closed-loop artifacts transfer exactly between the host runtime and
    the device-resident scans."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, 1)
    return jnp.pad(
        jax.lax.slice_in_dim(a, 1, a.shape[axis], axis=axis), pad)


class Scenario(NamedTuple):
    """One MPC problem instance (batch these along a leading axis)."""

    p0: jax.Array        # (2m,) initial normalized feature coords
    target: jax.Array    # (2m,) desired feature coords
    depth: jax.Array     # (m,) feature depths
    us0: jax.Array       # (H, 6) warm-start control sequence
    # Optional ADMM scaled-dual warm start (H, 6); None = cold duals
    # (zeros — the default, bit-identical to the pre-field solver). The
    # receding-horizon loops carry this when MPCConfig.dual_warm_start.
    y0: jax.Array | None = None


class Solution(NamedTuple):
    us: jax.Array        # (H, 6) optimized (projected, feasible) controls
    ps: jax.Array        # (H+1, 2m) predicted feature trajectory
    cost: jax.Array      # () final trajectory cost (unaugmented)
    primal_residual: jax.Array  # () max |us - z| over the horizon
    # Final ADMM scaled duals (H, 6) for warm-starting the next solve
    # (Scenario.y0); None for a cold solve (no Scenario.y0 given).
    dual: jax.Array | None = None


def _pyramid_batched(pyramid) -> bool:
    """True when pyramid levels carry a leading per-scenario batch dim
    ((B, Hf, Wf) rather than the shared (Hf, Wf)) — the serving
    micro-batcher's multi-frame path."""
    return pyramid[0].ndim == 3


def _edge_vg_batch(pyramid, ps_b, shape):
    """Pyramid edge cost value+grad at (B, K, n) trajectories.

    Accepts a shared pyramid or per-scenario (leading-B) pyramid levels;
    returns ((B, K) values, (B, K, n) grads)."""
    h_img, w_img = shape

    def eo(pyr, p):
        return costs.edge_cost_pyramid(pyr, p, h_img, w_img)

    if _pyramid_batched(pyramid):
        return jax.vmap(lambda pyr, ps_i: jax.vmap(
            jax.value_and_grad(lambda p: eo(pyr, p)))(ps_i))(pyramid, ps_b)
    return jax.vmap(jax.vmap(
        jax.value_and_grad(lambda p: eo(pyramid, p))))(ps_b)


def _edge_val_batch(pyramid, ps_b, shape):
    """Values only (final-cost evaluation); same batching contract as
    ``_edge_vg_batch``."""
    h_img, w_img = shape

    def eo(pyr, p):
        return costs.edge_cost_pyramid(pyr, p, h_img, w_img)

    if _pyramid_batched(pyramid):
        return jax.vmap(lambda pyr, ps_i: jax.vmap(
            lambda p: eo(pyr, p))(ps_i))(pyramid, ps_b)
    return jax.vmap(jax.vmap(lambda p: eo(pyramid, p)))(ps_b)


def _single_admm(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                 backward_fn=riccati.backward):
    """One-scenario ADMM machinery as ``(init, run, finalize)`` closures.

    ``init() -> (us, z, y)`` builds the ADMM carry from the scenario,
    ``run(carry, n)`` advances it ``n`` iterations (a fixed-length scan),
    and ``finalize(carry) -> Solution`` does the feasible rollout + cost.
    Split this way so the ADAPTIVE budget (``cfg.admm_iters_extra``) can
    gate a continuation on the BATCH-max residual from outside the vmap —
    per-scenario gating here would silently diverge from the lanes
    backend's batch-global predicate (see ``_solve_batch_ref``).

    ``backward_fn``: the Riccati backward implementation — sequential scan
    by default, ``riccati.backward_assoc`` for the log-depth backend."""
    cdim = dynamics.CONTROL_DIM

    def step_fn(p, u):
        return dynamics.step(p, u, scen.depth, cfg.dt)

    stage = costs.make_stage_cost(pyramid, shape, scen.target, cfg.q_track,
                                  cfg.r_ctrl, cfg.q_edge)
    terminal = costs.make_terminal_cost(pyramid, shape, scen.target,
                                        cfg.q_track, cfg.q_edge)
    # Quadratic-only twins: the edge term is handled via its linearization
    # (sampled once per sweep at the nominal trajectory) so the line search
    # never re-samples the pyramid.
    stage_q = costs.make_stage_cost(pyramid, shape, scen.target, cfg.q_track,
                                    cfg.r_ctrl, 0.0)
    terminal_q = costs.make_terminal_cost(pyramid, shape, scen.target,
                                          cfg.q_track, 0.0)
    expand = costs.make_expansions(pyramid, shape, scen.target, cfg.q_track,
                                   cfg.r_ctrl, cfg.q_edge)

    h_img, w_img = shape

    def edge_only(p):
        return costs.edge_cost_pyramid(pyramid, p, h_img, w_img)

    edge_val_grad = jax.vmap(jax.value_and_grad(edge_only))

    rho = cfg.rho
    eye_c = jnp.eye(cdim, dtype=jnp.float32)

    def sample_edge(us):
        """Edge value+grad linearized at the trajectory of ``us``."""
        ps_s = dynamics.rollout(scen.p0, us, scen.depth, cfg.dt)
        if cfg.q_edge:
            return edge_val_grad(ps_s)
        return jnp.zeros(ps_s.shape[0], ps_s.dtype), jnp.zeros_like(ps_s)

    def ilqr_once(us, z, y, eg=None):
        ps = dynamics.rollout(scen.p0, us, scen.depth, cfg.dt)
        fx, fu = jax.vmap(
            lambda p, u: dynamics.linearize_analytic(p, u, scen.depth,
                                                     cfg.dt))(ps[:-1], us)
        # eg: stale linearization shared across sweeps (edge_refresh=
        # "admm"); the constant offset e_ref(at the sampling trajectory)
        # cancels in the line-search comparisons.
        e_ref, g_ref = eg if eg is not None else sample_edge(us)
        lx, lu, lxx, luu, lux, vx, vxx = expand(ps, us, edge_grads=g_ref)
        # Analytic expansion of the ADMM penalty 0.5*rho*||u - z + y||^2.
        lu = lu + rho * (us - z + y)
        luu = luu + rho * eye_c[None]
        gains = backward_fn(fx, fu, lx, lu, lxx, luu, lux, vx, vxx)

        def aug_cost_lin(ps_c, us_c):
            quad = riccati.trajectory_cost(stage_q, terminal_q, ps_c, us_c)
            edge = cfg.q_edge * jnp.sum(
                e_ref + jnp.einsum("kn,kn->k", g_ref, ps_c - ps,
                                   precision=jax.lax.Precision.HIGHEST))
            admm = 0.5 * rho * jnp.sum((us_c - z + y) ** 2)
            return quad + edge + admm

        def try_alpha(alpha):
            ps_a, us_a = riccati.forward(step_fn, scen.p0, ps, us, gains,
                                         alpha)
            return ps_a, us_a, aug_cost_lin(ps_a, us_a)

        ps_c, us_c, J_c = jax.vmap(try_alpha)(jnp.asarray(_ALPHAS))
        j0 = aug_cost_lin(ps, us)
        best = jnp.argmin(J_c)
        improved = J_c[best] < j0
        return jnp.where(improved, us_c[best], us)

    us0 = scen.us0
    # edge_refresh="solve": one linearization at the warm-start trajectory
    # shared by the whole solve (warm-started real-time operation keeps the
    # trajectory near the sampling point).
    eg_solve = sample_edge(us0) if cfg.edge_refresh == "solve" else None

    def admm_body(carry, _):
        us, z, y = carry
        eg = (sample_edge(us) if cfg.edge_refresh == "admm"
              else eg_solve)
        us = jax.lax.fori_loop(
            0, cfg.ilqr_iters, lambda _, u: ilqr_once(u, z, y, eg), us)
        # Over-relaxation (off at 1.0 — Python branch keeps the default
        # graph bit-identical): the projection/dual steps see
        # u_hat = relax*us + (1-relax)*z_prev.
        uh = (us if cfg.admm_relax == 1.0
              else cfg.admm_relax * us + (1.0 - cfg.admm_relax) * z)
        z = jnp.clip(uh + y, -cfg.u_limit, cfg.u_limit)
        y = y + uh - z
        return (us, z, y), None

    def init():
        z0 = jnp.clip(us0, -cfg.u_limit, cfg.u_limit)
        y0 = scen.y0 if scen.y0 is not None else jnp.zeros_like(us0)
        return (us0, z0, y0)

    def run(carry, n: int):
        carry, _ = jax.lax.scan(admm_body, carry, None, length=n)
        return carry

    def finalize(carry) -> Solution:
        us, z, y = carry
        ps = dynamics.rollout(scen.p0, z, scen.depth, cfg.dt)
        return Solution(
            us=z,
            ps=ps,
            cost=riccati.trajectory_cost(stage, terminal, ps, z),
            primal_residual=jnp.max(jnp.abs(us - z)),
            dual=y if scen.y0 is not None else None,
        )

    return init, run, finalize


def _solve_single(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                  backward_fn=riccati.backward) -> Solution:
    """Solve one scenario against a shared edge cost pyramid (fixed
    budget; the adaptive-budget reference path goes through
    ``_solve_batch_ref``, which needs the closures separately)."""
    init, run, finalize = _single_admm(pyramid, shape, scen, cfg,
                                       backward_fn)
    return finalize(run(init(), cfg.admm_iters))


def _adaptive_extra(carry, us, z, cfg: MPCConfig, run_extra):
    """Shared adaptive-budget gate: when the BATCH-max primal residual
    after the base iterations still exceeds ``cfg.admm_tol``, run the
    ``cfg.admm_iters_extra`` continuation; otherwise keep the carry.
    One scalar reduction + ``lax.cond`` around a fixed-length scan —
    jit- and scan-body-safe, identical semantics in every backend."""
    resid = jnp.max(jnp.abs(us - z))
    return jax.lax.cond(resid > cfg.admm_tol, run_extra,
                        lambda c: c, carry)


def _solve_batch_ref(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                     backward_fn=riccati.backward) -> Solution:
    """Vmapped per-scenario XLA solve (the audit/fallback backends), with
    the adaptive budget gated on the BATCH-max residual from outside the
    vmap — a per-scenario ``lax.cond`` would lower to a select under vmap
    and, worse, gate each scenario on its own residual, diverging from
    the lanes backend's batch-global predicate."""
    batched = _pyramid_batched(pyramid)

    def vb(f):
        """Batch ``f(pyr, scen_row, *rest)``: pyramid levels map with the
        batch when per-scenario, close over as shared constants else."""
        if batched:
            return lambda *a: jax.vmap(f)(pyramid, *a)
        return lambda *a: jax.vmap(functools.partial(f, pyramid))(*a)

    def base(pyr, s):
        init, run, _ = _single_admm(pyr, shape, s, cfg, backward_fn)
        return run(init(), cfg.admm_iters)

    def extra(pyr, s, c):
        _, run, _ = _single_admm(pyr, shape, s, cfg, backward_fn)
        return run(c, cfg.admm_iters_extra)

    def fin(pyr, s, c):
        *_, finalize = _single_admm(pyr, shape, s, cfg, backward_fn)
        return finalize(c)

    carry = vb(base)(scen)
    if cfg.admm_iters_extra:
        us, z, _ = carry
        carry = _adaptive_extra(carry, us, z, cfg,
                                lambda c: vb(extra)(scen, c))
    return vb(fin)(scen, carry)


class _SweepLanes:
    """Lanes-layout machinery for the sweep backend, built once per trace.

    Holds the ``lanes``/``unlanes`` converters between the public
    (B, ...) layout and the batch-last layout of ``models.mpc.sweep``, and
    exposes the whole ADMM+iLQR solve as :meth:`solve` operating PURELY in
    lanes layout — so callers that live in lanes land
    (``receding_horizon``'s scan carry) never pay the (B, K, n) transposes
    per step. ``_solve_batch_sweep`` is the thin interleaved-API
    wrapper."""

    def __init__(self, pyramid, shape, cfg: MPCConfig, B: int):
        self.pyramid = pyramid
        self.shape = shape
        self.cfg = cfg
        self.B = B
        self.h = cfg.horizon
        self.m = cfg.num_features
        self.n = 2 * self.m
        self.cdim = dynamics.CONTROL_DIM
        self.qe = cfg.q_edge
        # Weight-tensor storage dtype for the dense lanes samplers
        # (None = f32, bit-identical; see MPCConfig.sampler_dtype).
        self.sampler_dt = (jnp.bfloat16
                           if cfg.sampler_dtype == "bfloat16" else None)
        self.kw = dict(m=self.m, q=cfg.q_track, r=cfg.r_ctrl, rho=cfg.rho,
                       qe=self.qe, dt=cfg.dt)

    # -- layout ------------------------------------------------------------

    @staticmethod
    def lanes(a, ndim):
        """(B, **lead) -> (**lead, B)."""
        return jnp.transpose(a, tuple(range(1, ndim)) + (0,))

    @staticmethod
    def unlanes(a_l, lead_dims):
        """(**lead, B) -> (B, **lead)."""
        return jnp.transpose(a_l, (lead_dims,) + tuple(range(lead_dims)))

    def lanes_scenario(self, scen: Scenario):
        """Scenario -> (p0_l, target_l, izd_l, us_l), split order."""
        p0_l = self.lanes(_to_split(scen.p0), 2)
        target_l = self.lanes(_to_split(scen.target), 2)
        izd_l = self.lanes(1.0 / scen.depth, 2)
        us_l = self.lanes(scen.us0, 3)     # (h, c, B)
        return p0_l, target_l, izd_l, us_l

    # -- edge term ----------------------------------------------------------

    def edge_vals(self, ps_l):
        """Pyramid edge cost at a lanes-land trajectory -> (h+1, B),
        sampled straight off the split layout (no transposes). Batched
        pyramids (serving multi-frame, single-digit batches) go through
        the interleaved sampler and back."""
        m = self.m
        if _pyramid_batched(self.pyramid):
            ps_b = _from_split(self.unlanes(ps_l, 2))       # (B, h+1, n)
            v = _edge_val_batch(self.pyramid, ps_b, self.shape)  # (B, h+1)
            return jnp.transpose(v, (1, 0))
        return costs.edge_cost_pyramid_xy(
            self.pyramid, ps_l[:, :m], ps_l[:, m:], *self.shape,
            dtype=self.sampler_dt)

    def edge_grads(self, ps_l):
        """d(edge cost summed over the trajectory)/d ps_l, lanes layout.

        Lanes are independent scenarios, so grad-of-sum gives per-lane
        gradients. Batched pyramids (serving multi-frame) fall back to the
        interleaved sampler — micro-batches are single digits, layout
        cost is nil."""
        if not self.qe:
            return jnp.zeros((self.h + 1, self.n, self.B), jnp.float32)
        if _pyramid_batched(self.pyramid):
            ps_b = _from_split(self.unlanes(ps_l, 2))      # (B, h+1, n)
            _, g = _edge_vg_batch(self.pyramid, ps_b, self.shape)
            return jnp.transpose(_to_split(g), (1, 2, 0))
        if self.cfg.edge_sampler == "analytic":
            m = self.m
            _, gx, gy = costs.edge_vg_pyramid_xy(
                self.pyramid, ps_l[:, :m], ps_l[:, m:], *self.shape,
                dtype=self.sampler_dt)
            return jnp.concatenate([gx, gy], axis=1)
        return jax.grad(lambda ps: jnp.sum(self.edge_vals(ps)))(ps_l)

    # -- solve ---------------------------------------------------------------

    def solve(self, p0_l, target_l, izd_l, us_l, y0_l=None):
        """Full ADMM+iLQR solve in lanes layout.

        ``y0_l``: optional warm-start scaled duals (h, c, B); None = cold
        (zeros, bit-identical to the pre-parameter solver).

        Returns ``(z_l, ps_final_l, resid_l, y_l)``: the projected
        feasible controls (h, c, B), their true rollout (h+1, n, B), the
        per-lane primal residual (B,), and the final scaled duals
        (h, c, B) for warm-starting the next solve."""
        cfg, kw = self.cfg, self.kw

        def rollout(us_l):
            return sweep.rollout(p0_l, us_l, izd_l, cfg.dt, self.m)

        def pick(J, cand):
            return _pick_candidates(J, cand, 1, 1)

        def ilqr_once(us_l, ps_l, z_l, y_l, g_l):
            K, kff = sweep.backward_sweep(ps_l, us_l, z_l, y_l, g_l,
                                          target_l, izd_l, **kw)
            ps_c, us_c, J = sweep.forward_sweep(p0_l, ps_l, us_l, K, kff,
                                                z_l, y_l, g_l, target_l,
                                                izd_l, **kw)
            return pick(J, us_c), pick(J, ps_c)     # (h, c, B), (h+1, n, B)

        def admm_body(carry, _):
            us_l, ps_l, z_l, y_l, g_solve = carry
            # edge_refresh="admm": linearize the edge term once here and
            # share it across the iLQR sweeps (constant shift in the
            # line-search comparisons — argmin unaffected; see
            # config.MPCConfig). "solve": the warm-start linearization
            # rides the carry. "ilqr": re-sample before every sweep.
            g_fix = (self.edge_grads(ps_l) if cfg.edge_refresh == "admm"
                     else g_solve)

            def inner(_, c2):
                us2, ps2 = c2
                g = g_fix if g_fix is not None else self.edge_grads(ps2)
                return ilqr_once(us2, ps2, z_l, y_l, g)

            us_l, ps_l = jax.lax.fori_loop(0, cfg.ilqr_iters, inner,
                                           (us_l, ps_l))
            # Over-relaxation (off at 1.0; see _solve_single.admm_body).
            uh_l = (us_l if cfg.admm_relax == 1.0
                    else cfg.admm_relax * us_l
                    + (1.0 - cfg.admm_relax) * z_l)
            z_l = jnp.clip(uh_l + y_l, -cfg.u_limit, cfg.u_limit)
            y_l = y_l + uh_l - z_l
            return (us_l, ps_l, z_l, y_l, g_solve), None

        z0 = jnp.clip(us_l, -cfg.u_limit, cfg.u_limit)
        y0 = y0_l if y0_l is not None else jnp.zeros_like(us_l)
        ps_l = rollout(us_l)
        g_solve0 = (self.edge_grads(ps_l)
                    if cfg.edge_refresh == "solve" else None)
        carry, _ = jax.lax.scan(
            admm_body, (us_l, ps_l, z0, y0, g_solve0), None,
            length=cfg.admm_iters)
        if cfg.admm_iters_extra:
            # Adaptive budget: the continuation scan runs only when the
            # batch-max residual says the base budget has not settled.
            carry = _adaptive_extra(
                carry, carry[0], carry[2], cfg,
                lambda c: jax.lax.scan(
                    admm_body, c, None,
                    length=cfg.admm_iters_extra)[0])
        us_l, ps_l, z_l, y_l, _ = carry

        # Final feasible controls + their true trajectory/cost.
        ps_final_l = rollout(z_l)
        resid_l = jnp.max(jnp.abs(us_l - z_l), axis=(0, 1))
        return z_l, ps_final_l, resid_l, y_l

    def final_cost(self, z_l, ps_final_l, target_l):
        """Unaugmented trajectory cost, reduced per lane -> (B,)."""
        cfg = self.cfg
        track = cfg.q_track * jnp.sum((ps_final_l - target_l[None]) ** 2,
                                      axis=(0, 1))
        ctrl = cfg.r_ctrl * jnp.sum(z_l ** 2, axis=(0, 1))
        if self.qe:
            edge_total = self.qe * jnp.sum(self.edge_vals(ps_final_l),
                                           axis=0)
        else:
            edge_total = jnp.zeros((self.B,), jnp.float32)
        return track + ctrl + edge_total


def _solve_batch_sweep(pyramid, shape, scen: Scenario,
                       cfg: MPCConfig) -> Solution:
    """Lanes-layout solve (``models.mpc.sweep``), solver state kept batch-last
    across the whole ADMM loop. Same math as the other backends
    (equivalence-tested)."""
    B = scen.us0.shape[0]
    sw = _SweepLanes(pyramid, shape, cfg, B)
    p0_l, target_l, izd_l, us_l = sw.lanes_scenario(scen)
    y0_l = sw.lanes(scen.y0, 3) if scen.y0 is not None else None
    z_l, ps_final_l, resid_l, y_l = sw.solve(p0_l, target_l, izd_l, us_l,
                                             y0_l)
    # Contract: duals out iff duals in (Scenario.y0). Cold solves skip
    # the unlanes transpose and the extra jit output entirely, so the
    # serving/dispatch paths pay nothing for the warm-start feature.
    return Solution(
        us=sw.unlanes(z_l, 2),
        ps=_from_split(sw.unlanes(ps_final_l, 2)),
        cost=sw.final_cost(z_l, ps_final_l, target_l),
        primal_residual=resid_l,
        dual=sw.unlanes(y_l, 2) if y0_l is not None else None,
    )


class VisualServoMPC:
    """Batched visual-servo MPC over Sobel edge-feature maps.

    ``solve_batch`` treats the leading scenario axis as the data-parallel
    dimension: under jit with a sharded scenario batch the whole solve
    partitions over the mesh with zero cross-device traffic except the
    diagnostics reductions.
    """

    def __init__(self, cfg: MPCConfig | None = None):
        self.cfg = cfg or MPCConfig()

    # -- scenario construction -------------------------------------------

    def random_scenarios(self, key, n: int) -> Scenario:
        """Sample a batch of n scenarios (features in the central image)."""
        cfg = self.cfg
        m = cfg.num_features
        k1, k2, k3 = jax.random.split(key, 3)
        p0 = jax.random.uniform(k1, (n, 2 * m), minval=-0.6, maxval=0.6)
        target = jax.random.uniform(k2, (n, 2 * m), minval=-0.5, maxval=0.5)
        depth = jax.random.uniform(k3, (n, m), minval=1.0, maxval=5.0)
        us0 = jnp.zeros((n, cfg.horizon, dynamics.CONTROL_DIM))
        return Scenario(p0=p0, target=target, depth=depth, us0=us0)

    # -- solving ----------------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0)
    def solve_batch(self, edge_map: jax.Array, scen: Scenario) -> Solution:
        """edge_map (H, W) f32, scenario batch (leading axis) -> Solution
        batch. The cost pyramid is built once and shared by the batch."""
        pyramid = costs.build_cost_pyramid(edge_map)
        return self._solve_pyramid(pyramid, edge_map.shape, scen)

    def _solve_pyramid(self, pyramid, shape, scen: Scenario) -> Solution:
        """Backend dispatch over a prebuilt cost pyramid (shared, or with a
        leading per-scenario batch dim). Called inside a jit."""
        if self.cfg.backend == "sweep":
            return _solve_batch_sweep(pyramid, shape, scen, self.cfg)
        bwd = (riccati.backward_assoc if self.cfg.backend == "assoc"
               else riccati.backward)
        return _solve_batch_ref(pyramid, shape, scen, self.cfg, bwd)

    @functools.partial(jax.jit, static_argnums=0)
    def solve_batch_multi(self, edge_maps: jax.Array,
                          scen: Scenario) -> Solution:
        """edge_maps (B, H, W) f32 — scenario i solves against map i.

        The multi-frame twin of ``solve_batch`` for the serving
        micro-batcher: B concurrent requests, each with its own camera
        frame, fused into ONE device computation. Pyramid levels carry a
        leading batch dim; every backend samples them per-scenario."""
        pyramid = jax.vmap(costs.build_cost_pyramid)(edge_maps)
        return self._solve_pyramid(pyramid, edge_maps.shape[1:], scen)

    @functools.partial(jax.jit, static_argnums=0)
    def control_step_multi(self, frames: jax.Array, scen: Scenario):
        """Per-request frames micro-batched into one device computation.

        frames: (B, C, H, W) u8 — one camera image per scenario. Runs the
        fused perception -> pyramid front-end per frame (unrolled; B is the
        serving micro-batch, single digits) and the multi-frame batched
        solve; returns (u0 batch, Solution batch). No host round-trips."""
        s0 = costs.PYRAMID_SCALES[0]
        base = jnp.stack([edge_pyramid_base(frames[i], s=s0)
                          for i in range(frames.shape[0])])
        pyramid = [base]
        prev = s0
        for s in costs.PYRAMID_SCALES[1:]:
            pyramid.append(jax.vmap(
                lambda l, f=s // prev: costs.avg_pool(l, f))(pyramid[-1]))
            prev = s
        sol = self._solve_pyramid(tuple(pyramid), frames.shape[2:], scen)
        return sol.us[:, 0], sol

    @functools.partial(jax.jit, static_argnums=0)
    def control_step(self, frame: jax.Array, scen: Scenario):
        """Full per-frame control path in one jitted computation.

        frame: planar (C, H, W) u8 camera image. Runs the perception ->
        pyramid front-end (grayscale -> Sobel -> block pooling,
        ``ops.edge_pyramid_base``), then the batched solve;
        returns (u0 batch, Solution batch). No host round-trips.
        """
        pyramid = costs.build_cost_pyramid_from_frame(frame)
        sol = self._solve_pyramid(pyramid, frame.shape[1:], scen)
        return sol.us[:, 0], sol

    def _seed_duals(self, scen: Scenario) -> Scenario:
        """With ``cfg.dual_warm_start``, make the dual warm start part of
        the receding-horizon carry: seed cold zeros when the caller did
        not provide ``Scenario.y0`` (the scan carry must be
        structure-stable). A caller-provided y0 is carried regardless of
        the flag — it is data, not configuration."""
        if self.cfg.dual_warm_start and scen.y0 is None:
            return scen._replace(y0=jnp.zeros_like(scen.us0))
        return scen

    def _advance(self, s: Scenario, sol: Solution):
        """One receding-horizon advance (shared by both scan bodies):
        apply the first control to the true dynamics, shift the plan,
        and shift the decayed duals when the carry is active."""
        u0 = sol.us[:, 0]
        p1 = jax.vmap(lambda p, u, d: dynamics.step(
            p, u, d, self.cfg.dt))(s.p0, u0, s.depth)
        y0 = (self.cfg.dual_decay * _shift_tail_zero(sol.dual, axis=1)
              if s.y0 is not None else None)
        return s._replace(p0=p1, us0=_shift_tail_zero(sol.us, axis=1),
                          y0=y0), u0

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def receding_horizon(self, frame: jax.Array, scen: Scenario,
                         n_frames: int):
        """Device-resident closed receding-horizon loop: ``n_frames``
        control steps in ONE dispatch (``lax.scan`` over full solves).

        Each step solves the batch from the previous step's shifted plan
        (warm start), applies the first control to the TRUE feature
        dynamics (``dynamics.step``, depth held constant — the same model
        the solver plans with), and carries the evolved state into the
        next solve. The camera frame is FIXED for the window, so the
        perception front-end and cost pyramid run ONCE per window and stay
        device-resident — this is the solver-only throughput ceiling, the
        shape for offline policy evaluation and solver
        tuning sweeps. A live camera loop pays perception every step: for
        perception-honest throughput (and the headline bench) use
        :meth:`receding_horizon_frames`, which rebuilds the pyramid from a
        fresh frame inside every scan step.

        Returns ``(u0s (n_frames, B, c), costs (n_frames, B), scen')``
        with ``scen'`` positioned to continue the loop (e.g. on the next
        camera frame via ``control_step``).
        """
        pyramid = costs.build_cost_pyramid_from_frame(frame)
        shape = frame.shape[1:]
        if self.cfg.backend == "sweep":
            return self._receding_lanes(lambda i: pyramid, shape, scen,
                                        n_frames)
        scen = self._seed_duals(scen)

        def body(s, _):
            sol = self._solve_pyramid(pyramid, shape, s)
            s, u0 = self._advance(s, sol)
            return s, (u0, sol.cost)

        scen_out, (u0s, cost_seq) = jax.lax.scan(
            body, scen, None, length=n_frames)
        return u0s, cost_seq, scen_out

    def _receding_lanes(self, pyramid_at, shape, scen: Scenario,
                        n_steps: int):
        """Sweep-backend receding-horizon loop with a LANES-RESIDENT scan
        carry: the scenario state (p0, warm-start plan) stays in the
        sweep's split/lanes layout across control steps, so the per-step
        (B, K, n) transposes of the interleaved API never run inside the
        loop. The true-dynamics update reuses the sweep's own split-layout
        ``_dyn_step`` (bit-identical model); outputs are stacked in lanes
        and converted ONCE after the scan.

        ``pyramid_at(step_index)`` returns the cost pyramid for a step —
        a constant closure for the fixed-frame loop, a per-step frame
        slice + rebuild for the frame-ring loop."""
        cfg = self.cfg
        B = scen.us0.shape[0]
        dual_carry = cfg.dual_warm_start or scen.y0 is not None
        # Layout-only context (the pyramid is per-step inside the scan).
        sw0 = _SweepLanes(None, shape, cfg, B)
        p0_l, target_l, izd_l, us_l = sw0.lanes_scenario(scen)
        # Dual warm-start carry: last solve's scaled duals, shifted like
        # the control plan. Entering duals come from Scenario.y0 (cold
        # zeros when absent).
        y_l = (None if not dual_carry
               else sw0.lanes(scen.y0, 3) if scen.y0 is not None
               else jnp.zeros_like(us_l))

        def body(carry, idx):
            p0_l, us_l, y_l = carry
            sw = _SweepLanes(pyramid_at(idx), shape, cfg, B)
            z_l, ps_final_l, _, y_out = sw.solve(p0_l, target_l, izd_l,
                                                 us_l, y_l)
            cost = sw.final_cost(z_l, ps_final_l, target_l)
            u0_l = z_l[0]                           # (c, B)
            p1_l = sweep._dyn_step(p0_l, u0_l, izd_l, cfg.dt, sw.m)
            y_next = (cfg.dual_decay * _shift_tail_zero(y_out, axis=0)
                      if dual_carry else None)
            return ((p1_l, _shift_tail_zero(z_l, axis=0), y_next),
                    (u0_l, cost))

        idxs = jnp.arange(n_steps, dtype=jnp.int32)
        (p0_l, us_l, y_l), (u0s_l, cost_seq) = jax.lax.scan(
            body, (p0_l, us_l, y_l), idxs)
        # One layout conversion per WINDOW (not per step): stacked
        # (T, c, B) -> (T, B, c); scenario back to the public layout.
        u0s = jnp.transpose(u0s_l, (0, 2, 1))
        scen_out = scen._replace(
            p0=_from_split(sw0.unlanes(p0_l, 1)),
            us0=sw0.unlanes(us_l, 2),
            y0=sw0.unlanes(y_l, 2) if y_l is not None else scen.y0)
        return u0s, cost_seq, scen_out

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def receding_horizon_frames(self, frames: jax.Array, scen: Scenario,
                                n_steps: int):
        """Device-resident receding-horizon loop over a RING OF FRAMES:
        every control step runs the FULL per-frame path — perception
        (grayscale -> Sobel -> pooled pyramid on that step's camera frame,
        then the batched solve, the first control applied to the true
        dynamics, and the warm-start shift — all inside one ``lax.scan``
        dispatch.

        This is the perception-honest throughput loop: unlike
        :meth:`receding_horizon` (which amortizes one pyramid build over
        the whole window — the solver-only ceiling), each step here pays
        the perception front-end, exactly like a live camera loop does and
        like the reference's per-pass timing discipline
        (``monolithic/src/main.c:31-39``: every measured pass reruns the
        whole kernel). ``frames`` is (F, C, H, W) u8; step t uses frame
        ``t mod F`` via an in-scan dynamic slice, so the device cannot
        hoist or reuse a pyramid across steps with distinct frames.

        Returns ``(u0s (n_steps, B, c), costs (n_steps, B), scen')`` —
        the same contract as :meth:`receding_horizon`.
        """
        n_ring = frames.shape[0]
        shape = frames.shape[2:]

        def pyramid_at(idx):
            frame = jax.lax.dynamic_index_in_dim(frames, idx % n_ring,
                                                 axis=0, keepdims=False)
            return costs.build_cost_pyramid_from_frame(frame)

        if self.cfg.backend == "sweep":
            return self._receding_lanes(pyramid_at, shape, scen, n_steps)
        scen = self._seed_duals(scen)

        def body(s, idx):
            pyramid = pyramid_at(idx)
            sol = self._solve_pyramid(pyramid, shape, s)
            s, u0 = self._advance(s, sol)
            return s, (u0, sol.cost)

        idxs = jnp.arange(n_steps, dtype=jnp.int32)
        scen_out, (u0s, cost_seq) = jax.lax.scan(body, scen, idxs)
        return u0s, cost_seq, scen_out

    # jit static self: the key must cover everything the traced program
    # depends on, which is the config.
    def _static_key(self):
        return dataclasses.astuple(self.cfg)

    def __hash__(self):
        return hash(self._static_key())

    def __eq__(self, other):
        return (isinstance(other, VisualServoMPC)
                and self._static_key() == other._static_key())
