"""Batch-last ("lanes") iLQR sweep: Riccati backward and line-searched
forward rollout as two ``lax.scan`` programs over the horizon.

Layout: scenario batch B in the LAST dimension everywhere —
ps (H+1, n, B), us/z/y (H, c, B), gains K (H, c, n, B). The solver keeps
this layout across the whole ADMM loop and transposes only at the
boundaries (scenario ingest, results), so every per-step operation is an
elementwise op over a contiguous batch vector: one scenario per element,
coalesced along the minor dimension.

State axis: SPLIT order [x_0..x_{m-1}, y_0..y_{m-1}] rather than the
public interleaved [x_0, y_0, ...] (the solver permutes at the lanes
boundary). Split order makes the coordinate planes contiguous slices and
turns the IBVS Jacobian into four diagonal m x m blocks, so applying fx
or fx^T anywhere in the recursion is a handful of (.., m, B)-wide FMAs
instead of an n-term dense matmul (``_fx_coeffs``/``_fx_right``/
``_fxT_left``).

All small matrix products are unrolled sums of broadcasted FMAs over the
batch vector (``_mm``/``_mv``/``_mtm``/``_mtv``), and the gain solve is an
unrolled column Cholesky (``_spd_solve_lanes``): no contraction reaches a
matrix unit, so no matmul precision setting applies here.

Line search: candidates alpha = (0, 1, 0.5, 0.25). alpha=0 reproduces the
nominal trajectory exactly (u = u_nom + K(p - p_nom) stays u_nom when p
tracks p_nom), so the "did anything improve" comparison is just the argmin
over candidates — no separate nominal cost evaluation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from openmp_parallel_computing_tpu.models.mpc.dynamics import STATE_LIMIT

ALPHAS = (0.0, 1.0, 0.5, 0.25)
CONTROL_DIM = 6


def _mm(a, b, ka: int):
    """Batch-last matmul: a (p, ka, *B) @ b (ka, q, *B) -> (p, q, *B) via an
    unrolled sum of broadcasted FMAs (no transposes)."""
    out = a[:, 0:1, ...] * b[0:1, :, ...]
    for j in range(1, ka):
        out = out + a[:, j:j + 1, ...] * b[j:j + 1, :, ...]
    return out


def _mv(a, v, ka: int):
    """a (p, ka, *B) @ v (ka, *B) -> (p, *B)."""
    out = a[:, 0, ...] * v[0:1, ...]
    for j in range(1, ka):
        out = out + a[:, j, ...] * v[j:j + 1, ...]
    return out


def _mtm(a, b, ka: int):
    """a^T @ b without materializing a^T: a (ka, p, *B), b (ka, q, *B) ->
    (p, q, *B) as a sum of ka broadcasted outer products."""
    out = a[0][:, None, ...] * b[0][None, :, ...]
    for k in range(1, ka):
        out = out + a[k][:, None, ...] * b[k][None, :, ...]
    return out


def _mtv(a, v, ka: int):
    """a^T @ v without materializing a^T: a (ka, p, *B), v (ka, *B) ->
    (p, *B)."""
    out = a[0] * v[0:1, ...]
    for k in range(1, ka):
        out = out + a[k] * v[k:k + 1, ...]
    return out


def _spd_solve_lanes(A, B, n: int):
    """Solve A X = B with A (n, n, *Bt) SPD, B (n, k, *Bt): unrolled
    column-oriented Cholesky over batch vectors.

    Each column update is ONE (n, *Bt) FMA instead of n scalar-row ops.
    ``cols[j]`` holds d_j at row j and L[i][j] below it; rows above j carry
    garbage that never crosses into valid rows (all ops are row-aligned).
    Divisions in the triangular solves are multiplies by the cached 1/d_j.
    """
    cols = []                       # cols[j]: (n, *Bt)
    inv_d = []                      # (1, *Bt) reciprocals of the pivots
    for j in range(n):
        s = A[:, j, ...]
        for p in range(j):
            s = s - cols[p] * cols[p][j:j + 1, ...]
        r = 1.0 / jnp.sqrt(s[j:j + 1, ...])
        cols.append(s * r)          # row j: pivot/sqrt(pivot) = d_j
        inv_d.append(r)
    Y = [None] * n
    for i in range(n):
        s = B[i, :, ...]
        for p in range(i):
            s = s - cols[p][i:i + 1, ...] * Y[p]
        Y[i] = s * inv_d[i]
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for p in range(i + 1, n):
            s = s - cols[i][p:p + 1, ...] * X[p]
        X[i] = s * inv_d[i]
    return jnp.concatenate([x[None] for x in X], axis=0)  # (n, k, *Bt)


def _features(p, m: int):
    """Split a (n, *B) SPLIT-layout state block into x (m, *B), y (m, *B)."""
    return p[:m, ...], p[m:, ...]


def _fx_coeffs(p, u, inv_depth, dt: float, m: int):
    """Diagonal-block coefficients of the IBVS state Jacobian.

    In split layout fx = [[diag(A), diag(Bc)], [diag(C), diag(D)]] — the
    per-feature 2x2 blocks of ``dynamics.linearize_analytic`` become four
    diagonal m x m blocks. Returns (A, Bc, C, D), each (m, *B)."""
    x, y = _features(p, m)
    vz, wx, wy, wz = u[2:3], u[3:4], u[4:5], u[5:6]  # (1, *B)
    iz = inv_depth
    A = 1.0 + dt * (vz * iz + y * wx - 2.0 * x * wy)
    Bc = dt * (x * wx + wz)
    C = dt * (-y * wy - wz)
    D = 1.0 + dt * (vz * iz + 2.0 * y * wx - x * wy)
    return A, Bc, C, D


def _fx_right(M, A, Bc, C, D, m: int):
    """M @ fx for M (p, n, *B) with fx in diagonal-block form."""
    Ml, Mr = M[:, :m, ...], M[:, m:, ...]
    left = Ml * A[None] + Mr * C[None]
    right = Ml * Bc[None] + Mr * D[None]
    return jnp.concatenate([left, right], axis=1)


def _fxT_left(M, A, Bc, C, D, m: int):
    """fx^T @ M for M (n, q, *B)."""
    Mt, Mb = M[:m, ...], M[m:, ...]
    top = A[:, None, ...] * Mt + C[:, None, ...] * Mb
    bot = Bc[:, None, ...] * Mt + D[:, None, ...] * Mb
    return jnp.concatenate([top, bot], axis=0)


def _fxT_vec(v, A, Bc, C, D, m: int):
    """fx^T @ v for v (n, *B)."""
    vt, vb = v[:m, ...], v[m:, ...]
    return jnp.concatenate([A * vt + C * vb, Bc * vt + D * vb], axis=0)


def _build_fu(p, inv_depth, dt: float, m: int):
    """Control Jacobian in split row order: fu (n, c, *B), x-plane rows
    first. Columns mirror ``dynamics.linearize_analytic``."""
    x, y = _features(p, m)
    iz = inv_depth
    one = jnp.ones_like(x)
    zv = jnp.zeros_like(x)
    col = lambda v: v[:, None, ...]             # (m,*B) -> (m,1,*B)
    fu_x = jnp.concatenate([
        col(-iz), col(zv), col(x * iz),
        col(x * y), col(-(one + x * x)), col(y)], axis=1)
    fu_y = jnp.concatenate([
        col(zv), col(-iz), col(y * iz),
        col(one + y * y), col(-(x * y)), col(-x)], axis=1)
    return dt * jnp.concatenate([fu_x, fu_y], axis=0)


def _dyn_step(p, u, inv_depth, dt: float, m: int):
    """p' = p + dt * L(p) u on batch vectors, split layout. p (n, *B)."""
    x, y = _features(p, m)
    vx, vy, vz = u[0:1], u[1:2], u[2:3]
    wx, wy, wz = u[3:4], u[4:5], u[5:6]
    iz = inv_depth
    xdot = (-vx * iz + x * vz * iz + x * y * wx - (1.0 + x * x) * wy
            + y * wz)
    ydot = (-vy * iz + y * vz * iz + (1.0 + y * y) * wx - x * y * wy
            - x * wz)
    # State trust region keeps diverging candidates finite; must match
    # dynamics.step.
    lim = STATE_LIMIT
    nxt_x = jnp.clip(x + dt * xdot, -lim, lim)
    nxt_y = jnp.clip(y + dt * ydot, -lim, lim)
    return jnp.concatenate([nxt_x, nxt_y], axis=0)


def rollout(p0, us, inv_depth, dt: float, m: int):
    """Open-loop trajectory of ``us`` (H, c, *B) from ``p0`` (n, *B) ->
    (H+1, n, *B), row 0 = p0."""

    def body(p, u_t):
        nxt = _dyn_step(p, u_t, inv_depth, dt, m)
        return nxt, nxt

    _, tail = jax.lax.scan(body, p0, us)
    return jnp.concatenate([p0[None], tail], axis=0)


def _eye(k: int, bdims: int):
    """(k, k, 1, ...) identity broadcastable over ``bdims`` batch dims."""
    return jnp.eye(k, dtype=jnp.float32).reshape((k, k) + (1,) * bdims)


def _backward_step(p_t, u_t, z_t, y_t, g_t, izd, target, Vx, Vxx, *,
                   m: int, q: float, r: float, rho: float, qe: float,
                   dt: float, reg: float):
    """One Riccati backward step on batch vectors: linearize, expand,
    solve. Returns (K, kff, Vx_new, Vxx_new)."""
    n, c = 2 * m, CONTROL_DIM
    bdims = target.ndim - 1
    Af, Bf, Cf, Df = _fx_coeffs(p_t, u_t, izd, dt, m)
    fu = _build_fu(p_t, izd, dt, m)
    lx = 2.0 * q * (p_t - target) + qe * g_t
    lu = 2.0 * r * u_t + rho * (u_t - z_t + y_t)
    # fx is applied structurally (4 diagonal blocks -> wide FMAs), fu^T /
    # Qux^T products are outer-product sums, and the value update uses
    # the simplified exact identities (Vx' = Qx + Qux'k, Vxx' = Qxx +
    # Qux'K) — see riccati.backward.
    Qx = lx + _fxT_vec(Vx, Af, Bf, Cf, Df, m)
    Qu = lu + _mtv(fu, Vx, n)
    Qxx = 2.0 * q * _eye(n, bdims) + _fxT_left(
        _fx_right(Vxx, Af, Bf, Cf, Df, m), Af, Bf, Cf, Df, m)
    U = _mtm(fu, Vxx, n)                      # fu^T Vxx (c, n, *B)
    Quu = (2.0 * r + rho + reg) * _eye(c, bdims) + _mm(U, fu, n)
    Qux = _fx_right(U, Af, Bf, Cf, Df, m)     # (fu^T Vxx) fx
    rhs = jnp.concatenate([Qu[:, None, ...], Qux], axis=1)
    sol = -_spd_solve_lanes(Quu, rhs, c)
    kff = sol[:, 0, ...]
    K = sol[:, 1:, ...]
    Vx_new = Qx + _mtv(Qux, kff, c)
    # No explicit symmetrization: Qux^T K = -Qux^T Quu_reg^{-1} Qux is
    # symmetric up to fp-ulp noise (as is Qxx's fx sandwich), and the
    # Cholesky consumes the matrix as if symmetric.
    Vxx_new = Qxx + _mtm(Qux, K, c)
    return K, kff, Vx_new, Vxx_new


@functools.partial(jax.jit, static_argnames=("m", "q", "r", "rho", "qe",
                                             "dt", "reg"))
def backward_sweep(ps, us, z, y, g, target, inv_depth, *, m: int, q: float,
                   r: float, rho: float, qe: float, dt: float,
                   reg: float = 1e-6):
    """Riccati backward sweep over the horizon (reverse ``lax.scan``).

    ps (H+1, n, *B), us/z/y (H, c, *B), g (H+1, n, *B), target (n, *B),
    inv_depth (m, *B). Returns K (H, c, n, *B), k (H, c, *B).
    """
    n = 2 * m
    bdims = target.ndim - 1
    Vx0 = 2.0 * q * (ps[-1] - target) + qe * g[-1]
    Vxx0 = jnp.broadcast_to(2.0 * q * _eye(n, bdims),
                            (n, n) + target.shape[1:])

    def step(carry, xs):
        Vx, Vxx = carry
        p_t, u_t, z_t, y_t, g_t = xs
        K, kff, Vx, Vxx = _backward_step(
            p_t, u_t, z_t, y_t, g_t, inv_depth, target, Vx, Vxx, m=m, q=q,
            r=r, rho=rho, qe=qe, dt=dt, reg=reg)
        return (Vx, Vxx), (K, kff)

    _, (K, kff) = jax.lax.scan(step, (Vx0, Vxx0),
                               (ps[:-1], us, z, y, g[:-1]), reverse=True)
    return K, kff


@functools.partial(jax.jit, static_argnames=("m", "q", "r", "rho", "qe",
                                             "dt"))
def forward_sweep(p0, ps, us, K, k, z, y, g, target, inv_depth, *, m: int,
                  q: float, r: float, rho: float, qe: float, dt: float):
    """Line-searched forward rollout of every alpha candidate at once
    (``lax.scan`` over the horizon, candidates vectorized).

    Returns (ps_c (H+1, A, n, *B), us_c (H, A, c, *B), J (A, *B)) where
    candidate 0 (alpha=0) is exactly the nominal trajectory/cost: the
    stage cost (tracking + effort + ADMM penalty + linearized edge term)
    summed over the horizon plus the terminal terms.
    """
    n = 2 * m
    A = len(ALPHAS)
    alphas = jnp.asarray(ALPHAS, jnp.float32)

    def step(carry, xs):
        P, J = carry                          # (A, n, *B), (A, *B)
        K_t, k_t, p_nom, u_nom, z_t, y_t, g_t = xs

        def candidate(p_a, alpha):
            u_a = u_nom + alpha * k_t + _mv(K_t, p_a - p_nom, n)
            J_add = (q * jnp.sum((p_a - target) ** 2, axis=0)
                     + r * jnp.sum(u_a ** 2, axis=0)
                     + 0.5 * rho * jnp.sum((u_a - z_t + y_t) ** 2, axis=0)
                     + qe * jnp.sum(g_t * (p_a - p_nom), axis=0))
            return u_a, J_add, _dyn_step(p_a, u_a, inv_depth, dt, m)

        U, J_add, P_next = jax.vmap(candidate)(P, alphas)
        return (P_next, J + J_add), (P_next, U)

    P0 = jnp.broadcast_to(p0[None], (A,) + p0.shape)
    J0 = jnp.zeros((A,) + p0.shape[1:], jnp.float32)
    (P_H, J), (ps_tail, us_c) = jax.lax.scan(
        step, (P0, J0), (K, k, ps[:-1], us, z, y, g[:-1]))
    J = J + (q * jnp.sum((P_H - target[None]) ** 2, axis=1)
             + qe * jnp.sum(g[-1][None] * (P_H - ps[-1][None]), axis=1))
    ps_c = jnp.concatenate([P0[None], ps_tail], axis=0)
    return ps_c, us_c, J
