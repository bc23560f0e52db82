"""The framework's image ops, compiled by XLA.

Each op is its ``xla_ref`` twin (the numerical contract, pinned against the
reference C binaries by tests/test_golden_parity.py) plus what callers need
beyond one application: the on-device ``passes`` repeat of the reference
drivers (``monolithic/src/main.c:33-35``), the halo-shard border mode of
``parallel.spatial``, and the pooled edge map the MPC cost pyramid starts
from. These are memory-bound stencils and reductions; XLA fuses each chain
(luma -> Sobel -> block pooling included) into a few kernels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from openmp_parallel_computing_tpu.ops import xla_ref


def _repeat(fn, x: jax.Array, passes: int) -> jax.Array:
    """``fn`` applied ``passes`` times on device (one unrolled call when 1)."""
    if passes == 1:
        return fn(x)
    return jax.lax.fori_loop(0, passes, lambda _, v: fn(v), x)


@functools.partial(jax.jit, static_argnames=("passes",))
def grayscale(img: jax.Array, passes: int = 1) -> jax.Array:
    """Planar (C, H, W) u8 -> (C, H, W) u8: BT.601 fixed-point luma in the
    RGB channels, alpha passed through."""
    return _repeat(xla_ref.grayscale, img, passes)


@functools.partial(jax.jit, static_argnames=("border",))
def sobel(gray: jax.Array, border: str = "zero") -> jax.Array:
    """(H, W) u8 plane -> (H, W) u8 edge magnitude.

    ``border="zero"`` (default) zeroes the 1-px image border — the
    framework's defined replacement for the reference's uninitialized
    border. ``border="none"`` computes every row with zero out-of-plane
    neighbors: what a spatially sharded caller wants when the plane is a
    halo-extended local shard (see ``parallel.spatial``)."""
    return xla_ref.sobel(gray, border=border)


@functools.partial(jax.jit, static_argnames=("border", "passes"))
def edge_pipeline(img: jax.Array, border: str = "zero",
                  passes: int = 1) -> jax.Array:
    """Planar (C, H, W) u8 -> (C, H, W) u8 Sobel-edge image
    (grayscale -> extract -> Sobel -> broadcast, ``main_with_sobel.c:51-74``),
    repeated ``passes`` times on device. ``border`` as in :func:`sobel`."""
    return _repeat(functools.partial(xla_ref.edge_pipeline, border=border),
                   img, passes)


@functools.partial(jax.jit, static_argnames=("s",))
def edge_pyramid_base(img: jax.Array, s: int = 16) -> jax.Array:
    """Planar (C, H, W) u8 frame -> (ceil(H/s), ceil(W/s)) f32 block mean
    of the u8 Sobel edge map: the base level of the MPC cost pyramid.

    Bit-exact with ``costs.avg_pool(edge_pipeline(img)[0].astype(f32), s)``:
    blocks are anchored at (0, 0), partial blocks zero-pad, and block sums
    of u8-valued magnitudes are integers below 2^24, so no summation order
    changes them. One reshape-sum, which XLA fuses with the stencil.
    """
    _, h, w = img.shape
    mag = xla_ref.sobel(xla_ref.luma(img)).astype(jnp.float32)
    hb, wb = -(-h // s), -(-w // s)
    mag = jnp.pad(mag, ((0, hb * s - h), (0, wb * s - w)))
    return mag.reshape(hb, s, wb, s).sum(axis=(1, 3)) / float(s * s)


@functools.partial(jax.jit, static_argnames=("taps", "norm", "integer",
                                             "clamp_u8", "passes"))
def conv3x3(img: jax.Array, taps=xla_ref.GBLUR_KERNEL,
            norm: int | float = xla_ref.GBLUR_NORM, integer: bool = True,
            clamp_u8: bool = False, passes: int = 1) -> jax.Array:
    """Planar (C, H, W) -> (C, H, W) zero-padded 3x3 weighted correlation.

    ``integer=True`` -> int32 accumulate + truncating division (reference
    semantics); otherwise f32. ``clamp_u8=True`` additionally clamps to
    [0, 255] and returns uint8 (the blur-image op). With ``passes > 1`` the
    input is cast once to the output dtype so every pass maps that dtype
    to itself; pass 1 sees identical values either way.
    """
    def one(v):
        out = xla_ref.conv3x3(v, taps, norm, integer)
        return jnp.clip(out, 0, 255).astype(jnp.uint8) if clamp_u8 else out

    if passes > 1 and not clamp_u8:
        img = img.astype(jnp.int32 if integer else jnp.float32)
    return _repeat(one, img, passes)


def gaussian_blur(img: jax.Array, passes: int = 1) -> jax.Array:
    """1-2-1 Gaussian blur of a planar u8 image, reference GBLUR semantics."""
    return conv3x3(img, xla_ref.GBLUR_KERNEL, xla_ref.GBLUR_NORM,
                   integer=True, clamp_u8=True, passes=passes)


@jax.jit
def channel_sum(img: jax.Array) -> jax.Array:
    """Planar (C, H, W) -> (C,) float32 per-channel sum
    (``reduction(+:...)`` in ``old/parallel_avg_pixel.c:14-31``)."""
    return jnp.sum(img.astype(jnp.float32), axis=(1, 2))


def channel_mean(img: jax.Array) -> jax.Array:
    """Planar (C, H, W) -> (C,) float32 per-channel mean."""
    _, h, w = img.shape
    return channel_sum(img) / jnp.float32(h * w)


grayscale_mean_minmax = jax.jit(xla_ref.grayscale_mean_minmax)
