"""Collective helpers over the device mesh.

Device replacements for the reference's cross-worker aggregation
patterns: OpenMP reduction clauses (``old/parallel_avg_pixel.c:16``,
``old/parallel_to_grayscale.c:12``) become ``psum``/``pmin``/``pmax`` over
mesh axes; the stencil's row-neighbor access across a spatial shard boundary
becomes a ``ppermute`` neighbor shift (the halo exchange).
"""

from __future__ import annotations

import jax


def psum(x, axis_name: str):
    return jax.lax.psum(x, axis_name)


def pmean(x, axis_name: str):
    return jax.lax.pmean(x, axis_name)


def pmin(x, axis_name: str):
    return jax.lax.pmin(x, axis_name)


def pmax(x, axis_name: str):
    return jax.lax.pmax(x, axis_name)


def shift_up(x: jax.Array, axis_name: str) -> jax.Array:
    """Send ``x`` to the previous device along ``axis_name``.

    Device i receives device i+1's value; the last device receives zeros.
    (Used to fetch the *first* rows of the next shard as a bottom halo.)
    """
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i - 1) for i in range(1, n)]
    return jax.lax.ppermute(x, axis_name, perm)


def shift_down(x: jax.Array, axis_name: str) -> jax.Array:
    """Send ``x`` to the next device along ``axis_name``.

    Device i receives device i-1's value; the first device receives zeros.
    (Used to fetch the *last* rows of the previous shard as a top halo.)
    """
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(x, axis_name, perm)


def halo_exchange_rows(x: jax.Array, axis_name: str, halo: int = 1):
    """Exchange ``halo`` boundary rows with mesh neighbors.

    ``x`` is this device's row-shard ``(..., H_local, W)``. Returns
    ``(top, bottom)`` halo blocks of ``halo`` rows each: the last rows of the
    previous shard and the first rows of the next shard (zeros at the mesh
    edges, matching the zero-padded stencil boundary).
    """
    top = shift_down(x[..., -halo:, :], axis_name)
    bottom = shift_up(x[..., :halo, :], axis_name)
    return top, bottom
