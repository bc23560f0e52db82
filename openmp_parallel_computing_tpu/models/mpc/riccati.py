"""Time-varying LQR machinery: quadratic expansion, Riccati backward sweep,
gain-feedback forward rollout — all as ``lax.scan`` programs.

The backward recursion is the block-structured QP solve of the BASELINE
north star ("ADMM/Riccati sweep over the horizon"): for the batched MPC each
per-step operation is a small (2m x 2m / 2m x 6) matrix product which, once
vmapped over hundreds of scenarios, becomes large batched matmuls.

Every contraction runs at ``Precision.HIGHEST``: this module is the plain
reference the sweep backend is tested against, so a float32 product must
not drop to a reduced-precision matrix-unit mode (TF32 on the GPU).

Conventions: state dim n, control dim c, horizon H.
- dynamics jacobians  fx (H, n, n), fu (H, n, c)
- cost expansions     lx (H, n), lu (H, c), lxx (H, n, n), luu (H, c, c),
                      lux (H, c, n); terminal vx (n,), vxx (n, n)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HIGHEST)


class Gains(NamedTuple):
    K: jax.Array      # (H, c, n) feedback
    k: jax.Array      # (H, c) feedforward
    dV: jax.Array     # (2,) expected cost decrease coefficients


def spd_solve(A: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B for small SPD A via fully unrolled Cholesky.

    A (..., n, n), B (..., n, k) with n known statically and small (the
    control dimension, 6). Every operation is a batched elementwise op —
    no pivoting, unlike the batched LU of ``jnp.linalg.solve`` — and it
    vmaps cleanly over scenario batches.
    """
    n = A.shape[-1]
    # Cholesky: L rows built column-by-column, kept as a list of (.., n)
    # row vectors to avoid materializing scatter updates.
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * inv_d
    # Forward substitution: L Y = B  (Y rows (..., k)).
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for p in range(i):
            s = s - L[i][p][..., None] * Y[p]
        Y[i] = s / L[i][i][..., None]
    # Backward substitution: L^T X = Y.
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for p in range(i + 1, n):
            s = s - L[p][i][..., None] * X[p]
        X[i] = s / L[i][i][..., None]
    return jnp.stack(X, axis=-2)


def backward(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
             reg: float = 1e-6) -> Gains:
    """Riccati backward sweep; returns time-varying affine gains."""

    def step(carry, inp):
        Vx, Vxx, dv1, dv2 = carry
        fx_k, fu_k, lx_k, lu_k, lxx_k, luu_k, lux_k = inp
        Vxx_fx = _mm(Vxx, fx_k)                 # shared by Qxx and Qux
        Vxx_fu = _mm(Vxx, fu_k)                 # shared by Quu
        Qx = lx_k + _mm(fx_k.T, Vx)
        Qu = lu_k + _mm(fu_k.T, Vx)
        Qxx = lxx_k + _mm(fx_k.T, Vxx_fx)
        Quu = luu_k + _mm(fu_k.T, Vxx_fu)
        Qux = lux_k + _mm(fu_k.T, Vxx_fx)
        Quu_reg = Quu + reg * jnp.eye(Quu.shape[0], dtype=Quu.dtype)
        # One joint SPD solve for [k | K]; unrolled Cholesky (see spd_solve).
        sol = -spd_solve(
            Quu_reg, jnp.concatenate([Qu[..., None], Qux], axis=-1))
        kff = sol[..., 0]
        K = sol[..., 1:]
        # Simplified value update: with K = -Quu_reg^{-1} Qux and
        # kff = -Quu_reg^{-1} Qu the quadratic/cross terms of the general
        # form (Qx + K'Quu kff + K'Qu + Qux'kff) collapse exactly to
        # Qux' kff (resp. Qux' K) — one tiny matmul instead of three. All
        # solver backends use the same form (equivalence-tested).
        Vx_new = Qx + _mm(Qux.T, kff)
        Vxx_new = Qxx + _mm(Qux.T, K)
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
        dv1 = dv1 + _mm(kff, Qu)
        dv2 = dv2 + 0.5 * _mm(_mm(kff, Quu), kff)
        return (Vx_new, Vxx_new, dv1, dv2), (K, kff)

    init = (vx, vxx, jnp.zeros((), vx.dtype), jnp.zeros((), vx.dtype))
    (_, _, dv1, dv2), (Ks, ks) = jax.lax.scan(
        step, init, (fx, fu, lx, lu, lxx, luu, lux), reverse=True,
        unroll=4)
    return Gains(K=Ks, k=ks, dV=jnp.stack([dv1, dv2]))


def backward_assoc(fx, fu, lx, lu, lxx, luu, lux, vx, vxx,
                   reg: float = 1e-6) -> Gains:
    """Associative-scan Riccati backward sweep: depth log2(H) instead of H.

    Same inputs/outputs as ``backward`` (equivalence-tested); built for the
    latency-bound regime (small scenario batch, long horizon) where the
    sequential scan's H dependent steps dominate. The horizon becomes the
    parallel axis: cost-to-go propagation is expressed as composition of
    affine-quadratic "span" elements and reduced with
    ``jax.lax.associative_scan`` (cf. "The Parallelization of Riccati
    Recursion", arXiv:1809.06360; derivation re-done from scratch below).

    Element representation. A span [s, e) is the conditional cost map

        F(x_s, x_e) = min_{controls} { sum of stage costs }
                      s.t. the dynamics connect x_s to x_e,

    stored as the 5-tuple (A, b, C, eta, J) meaning

        F(x, z) = 0.5 x'Jx - eta'x + delta_C(z - Ax - b),
        delta_C(d) = sup_l [l'd - 0.5 l'C l]

    (delta_C is the convex dual of the control-effort-to-reach term; C = 0
    degenerates to the hard constraint z = Ax + b, so rank-deficient
    reachability needs no special casing). One LQR step with cost
    0.5x'lxx x + lx'x + 0.5u'luu u + lu'u + u'lux x and dynamics
    z = fx x + fu u completes the square in u and reads off

        A = fx - fu luu^{-1} lux        b = -fu luu^{-1} lu
        C = fu luu^{-1} fu'             J = lxx - lux' luu^{-1} lux
        eta = -(lx - lux' luu^{-1} lu)

    with the terminal element (0, 0, 0, -vx, vxx). Minimizing out the
    midpoint state of two adjacent spans gives the associative combine
    (E = (I + C_i J_j)^{-1}; i earlier in time, j later; E' = (I+J_jC_i)^{-1}):

        A_ij  = A_j E A_i
        b_ij  = A_j E (b_i + C_i eta_j) + b_j
        C_ij  = A_j E C_i A_j' + C_j
        eta_ij= eta_i + A_i' E' (eta_j - J_j b_i)
        J_ij  = J_i + A_i' E' J_j A_i

    The suffix reduction of [E_0..E_{H-1}, E_term] yields V_t for every t
    at once (Vxx_t = J, vx_t = -eta); the time-varying gains then come from
    the standard one-step formulas, batched over the whole horizon.
    ``reg`` regularizes only the gain solve, exactly like ``backward``.
    """
    H, n = fx.shape[0], fx.shape[-1]
    eye_n = jnp.eye(n, dtype=fx.dtype)

    # -- leaf elements (one per step) + terminal ---------------------------
    luu_inv_lu = spd_solve(luu, lu[..., None])[..., 0]          # (H, c)
    luu_inv_lux = spd_solve(luu, lux)                           # (H, c, n)
    luu_inv_fuT = spd_solve(luu, jnp.swapaxes(fu, -1, -2))      # (H, c, n)
    A = fx - _mm(fu, luu_inv_lux)
    b = -_mm(fu, luu_inv_lu[..., None])[..., 0]
    C = _mm(fu, luu_inv_fuT)
    eta = -(lx - jnp.einsum("tcn,tc->tn", luu_inv_lux, lu,
                             precision=_HIGHEST))
    J = lxx - _mm(jnp.swapaxes(lux, -1, -2), luu_inv_lux)

    zeros_m = jnp.zeros((1, n, n), fx.dtype)
    zeros_v = jnp.zeros((1, n), fx.dtype)
    elems = (
        jnp.concatenate([A, zeros_m]),
        jnp.concatenate([b, zeros_v]),
        jnp.concatenate([C, zeros_m]),
        jnp.concatenate([eta, -vx[None]]),
        jnp.concatenate([J, vxx[None]]),
    )

    def combine(ej, ei):
        """Compose adjacent spans; ``ei`` is earlier in time than ``ej``.

        Argument order matches ``associative_scan(reverse=True)``, which
        feeds the LATER element first (verified: a reverse matmul scan
        yields M_{k-1}...M_1 @ M_0 per suffix, i.e. fn(a, b) = a after b).
        """
        A_i, b_i, C_i, eta_i, J_i = ei
        A_j, b_j, C_j, eta_j, J_j = ej
        M = eye_n + _mm(C_i, J_j)                     # (..., n, n)
        rhs1 = jnp.concatenate(
            [A_i, (b_i + _mm(C_i, eta_j[..., None])[..., 0])[..., None], C_i],
            axis=-1)
        X1 = jnp.linalg.solve(M, rhs1)            # E @ [A_i | b~ | C_i]
        rhs2 = jnp.concatenate(
            [(eta_j - _mm(J_j, b_i[..., None])[..., 0])[..., None],
             _mm(J_j, A_i)], axis=-1)
        X2 = jnp.linalg.solve(jnp.swapaxes(M, -1, -2), rhs2)  # E' @ [...]
        E_Ai = X1[..., :n]
        E_b = X1[..., n]
        E_Ci = X1[..., n + 1:]
        A_ij = _mm(A_j, E_Ai)
        b_ij = _mm(A_j, E_b[..., None])[..., 0] + b_j
        C_ij = _mm(_mm(A_j, E_Ci), jnp.swapaxes(A_j, -1, -2)) + C_j
        C_ij = 0.5 * (C_ij + jnp.swapaxes(C_ij, -1, -2))
        AiT = jnp.swapaxes(A_i, -1, -2)
        eta_ij = eta_i + _mm(AiT, X2[..., 0:1])[..., 0]
        J_ij = J_i + _mm(AiT, X2[..., 1:])
        J_ij = 0.5 * (J_ij + jnp.swapaxes(J_ij, -1, -2))
        return A_ij, b_ij, C_ij, eta_ij, J_ij

    suffix = jax.lax.associative_scan(combine, elems, reverse=True)
    Vxx_all = suffix[4]                  # (H+1, n, n): V_t for t = 0..H
    vx_all = -suffix[3]                  # (H+1, n)

    # -- gains for every step in parallel ---------------------------------
    Vx_n = vx_all[1:]                    # V_{t+1}, (H, n)
    Vxx_n = Vxx_all[1:]                  # (H, n, n)
    fuT = jnp.swapaxes(fu, -1, -2)
    Vxx_fu = _mm(Vxx_n, fu)
    Qu = lu + _mm(fuT, Vx_n[..., None])[..., 0]
    Quu = luu + _mm(fuT, Vxx_fu)
    Qux = lux + _mm(fuT, _mm(Vxx_n, fx))
    c = lu.shape[-1]
    Quu_reg = Quu + reg * jnp.eye(c, dtype=Quu.dtype)
    sol = -spd_solve(Quu_reg, jnp.concatenate([Qu[..., None], Qux],
                                              axis=-1))
    kff = sol[..., 0]
    K = sol[..., 1:]
    dv1 = jnp.einsum("tc,tc->", kff, Qu, precision=_HIGHEST)
    dv2 = 0.5 * jnp.einsum("tc,tcd,td->", kff, Quu, kff,
                           precision=_HIGHEST)
    return Gains(K=K, k=kff, dV=jnp.stack([dv1, dv2]))


def forward(step_fn, p0, ps_nom, us_nom, gains: Gains, alpha):
    """Closed-loop rollout with the affine policy
    u = u_nom + alpha * k + K (p - p_nom)."""

    def body(p, inp):
        p_nom, u_nom, K, kff = inp
        u = u_nom + alpha * kff + _mm(K, p - p_nom)
        nxt = step_fn(p, u)
        return nxt, (nxt, u)

    _, (ps, us) = jax.lax.scan(body, p0, (ps_nom[:-1], us_nom, gains.K,
                                          gains.k), unroll=4)
    return jnp.concatenate([p0[None], ps], axis=0), us


def expand_costs(stage_cost, terminal_cost, ps, us):
    """Autodiff quadratic expansion of the costs along a trajectory.

    ps (H+1, n), us (H, c) -> (lx, lu, lxx, luu, lux, vx, vxx) plus the
    total trajectory cost.
    """
    lx = jax.vmap(jax.grad(stage_cost, argnums=0))(ps[:-1], us)
    lu = jax.vmap(jax.grad(stage_cost, argnums=1))(ps[:-1], us)
    lxx = jax.vmap(jax.hessian(stage_cost, argnums=0))(ps[:-1], us)
    luu = jax.vmap(jax.hessian(stage_cost, argnums=1))(ps[:-1], us)
    lux = jax.vmap(jax.jacrev(jax.grad(stage_cost, argnums=1),
                              argnums=0))(ps[:-1], us)
    vx = jax.grad(terminal_cost)(ps[-1])
    vxx = jax.hessian(terminal_cost)(ps[-1])
    total = (jax.vmap(stage_cost)(ps[:-1], us).sum()
             + terminal_cost(ps[-1]))
    return lx, lu, lxx, luu, lux, vx, vxx, total


def trajectory_cost(stage_cost, terminal_cost, ps, us):
    return jax.vmap(stage_cost)(ps[:-1], us).sum() + terminal_cost(ps[-1])
