"""Image-plane feature dynamics for visual servoing.

The controlled system: m feature points tracked in the normalized image
plane; the control is the camera twist u = (vx, vy, vz, wx, wy, wz). Each
point (x, y) at depth Z moves with the classical IBVS interaction matrix

    L(x, y, Z) = [ -1/Z    0    x/Z    x*y   -(1+x^2)   y ]
                 [   0   -1/Z   y/Z   1+y^2   -x*y     -x ]

and the discrete dynamics are one explicit-Euler step p' = p + dt * L(p) u.

State layout: p is (2m,) as [x1, y1, x2, y2, ...]; depths are (m,).
Everything is jit/vmap/scan-friendly (static shapes, pure functions).

This is the "feature dynamics rolled out under lax.scan" of the BASELINE
north star; the reference repo has no dynamics — its temporal axis is the
kernel ``passes`` loop (``monolithic/src/main.c:33-35``), which the MPC
horizon generalizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

STATE_PER_FEATURE = 2
CONTROL_DIM = 6

# State-space trust region: normalized image coords live in [-1, 1]; beyond
# a few units the quadratic terms of the interaction matrix make the Euler
# dynamics exponentially unstable and the edge field is gradient-free, so a
# diverging line-search candidate could run to inf within one horizon.
# Clamping the state here bounds every rollout (all solver backends) without
# affecting any physically meaningful trajectory.
STATE_LIMIT = 4.0


def interaction_matrix(p: jax.Array, depth: jax.Array) -> jax.Array:
    """(2m,) state, (m,) depths -> (2m, 6) image Jacobian."""
    pts = p.reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    iz = 1.0 / depth
    zeros = jnp.zeros_like(x)
    row_x = jnp.stack(
        [-iz, zeros, x * iz, x * y, -(1.0 + x * x), y], axis=-1)
    row_y = jnp.stack(
        [zeros, -iz, y * iz, 1.0 + y * y, -x * y, -x], axis=-1)
    return jnp.stack([row_x, row_y], axis=1).reshape(-1, CONTROL_DIM)


def step_unclamped(p: jax.Array, u: jax.Array, depth: jax.Array,
                   dt: float) -> jax.Array:
    """One Euler step of the smooth feature dynamics (no trust region)."""
    return p + dt * jnp.matmul(interaction_matrix(p, depth), u,
                               precision=jax.lax.Precision.HIGHEST)


def step(p: jax.Array, u: jax.Array, depth: jax.Array,
         dt: float) -> jax.Array:
    """One Euler step of the feature dynamics (state clamped to the
    trust region, see STATE_LIMIT)."""
    return jnp.clip(step_unclamped(p, u, depth, dt),
                    -STATE_LIMIT, STATE_LIMIT)


def rollout(p0: jax.Array, us: jax.Array, depth: jax.Array,
            dt: float) -> jax.Array:
    """Roll the dynamics over a control sequence.

    p0 (2m,), us (H, 6) -> states (H+1, 2m) including the initial state.
    """

    def body(p, u):
        nxt = step(p, u, depth, dt)
        return nxt, nxt

    _, ps = jax.lax.scan(body, p0, us, unroll=4)
    return jnp.concatenate([p0[None], ps], axis=0)


def linearize(p: jax.Array, u: jax.Array, depth: jax.Array, dt: float):
    """Jacobians (fx, fu) of ``step_unclamped`` at one (p, u).

    Deliberately the SMOOTH dynamics: the STATE_LIMIT clip in ``step`` is
    a rollout trust-region safeguard, not a modeled dynamic — where it
    binds, its true Jacobian rows are zero, and feeding those to the
    Riccati sweep would zero the gains exactly where the solver needs
    authority to pull a saturated candidate back (the line-search
    J-comparison plus the finite-J candidate pick already absorb the
    local-model mismatch). All backends (reference, the lanes sweep, and
    ``linearize_analytic``) share this convention.
    """
    fx = jax.jacrev(lambda q: step_unclamped(q, u, depth, dt))(p)
    fu = dt * interaction_matrix(p, depth)
    return fx, fu


def linearize_analytic(p: jax.Array, u: jax.Array, depth: jax.Array,
                       dt: float):
    """Closed-form (fx, fu) — no autodiff, no dense jacobian buildup.

    d(L(p)u)/dp is block-diagonal with one 2x2 block per feature:

        dxdot/dx = vz/Z + y*wx - 2x*wy      dxdot/dy = x*wx + wz
        dydot/dx = -y*wy - wz               dydot/dy = vz/Z + 2y*wx - x*wy

    so fx = I + dt * blockdiag(...). Verified against ``linearize`` in
    tests (both linearize the smooth ``step_unclamped`` — see the
    ``linearize`` docstring for why the STATE_LIMIT clip is excluded from
    the local model). Identical math an order of magnitude cheaper inside
    the iLQR sweep (the reference-free analogue of hand-written stencil
    derivatives).
    """
    pts = p.reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    iz = 1.0 / depth
    vz, wx, wy, wz = u[2], u[3], u[4], u[5]
    a = vz * iz + y * wx - 2.0 * x * wy      # dxdot/dx
    b = x * wx + wz                          # dxdot/dy
    c = -y * wy - wz                         # dydot/dx
    d = vz * iz + 2.0 * y * wx - x * wy      # dydot/dy
    blocks = jnp.stack(
        [jnp.stack([a, b], -1), jnp.stack([c, d], -1)], -2)  # (m, 2, 2)
    m = pts.shape[0]
    eye_m = jnp.eye(m, dtype=p.dtype)
    # (m,2,2) -> block-diagonal (2m, 2m) via outer product with basis.
    bd = jnp.einsum("mij,mn->minj", blocks, eye_m,
                    precision=jax.lax.Precision.HIGHEST).reshape(2 * m, 2 * m)
    fx = jnp.eye(2 * m, dtype=p.dtype) + dt * bd
    fu = dt * interaction_matrix(p, depth)
    return fx, fu
