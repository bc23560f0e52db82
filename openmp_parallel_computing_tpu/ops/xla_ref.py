"""Pure-jnp (XLA) reference implementations of the image ops.

These define the numerical contract of every op in ``ops.image`` (which
builds on them), and are themselves tested bit-tolerantly against the
reference C/OpenMP pipeline
(golden fixtures in ``tests/golden``). Semantics follow the reference repo:

- grayscale: BT.601 luma, float32 accumulate, C-cast truncation to u8, all
  RGB channels overwritten, alpha untouched
  (reference ``monolithic/src/parallel_to_grayscale.c:5-17``).
- sobel: 3x3 integer taps on a u8 plane, ``mag = trunc(sqrtf(gx^2+gy^2))``
  clamped to 255, computed on the interior only. The reference leaves the
  1-px border *uninitialized* (``monolithic/src/sobel.c:11-21`` writing into a
  malloc'd buffer); this framework specifies the border as 0.
- conv3x3: zero-padded same-size 3x3 weighted convolution with post-hoc
  normalization; integer mode reproduces the reference's C integer division
  (``old/parallel_convolution.c:8-24`` with GBLUR_NORM).
- reductions: per-channel mean (``old/parallel_avg_pixel.c:5-42``) and
  channel-mean grayscale with fused min/max
  (``old/parallel_to_grayscale.c:7-38``).

All image ops use the framework's planar device layout ``(C, H, W) uint8``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# BT.601 luma weights, exactly as the reference kernel writes them.
LUMA_R, LUMA_G, LUMA_B = 0.299, 0.587, 0.114

# The framework's canonical luma is fixed-point: floor((wr*r+wg*g+wb*b)/2^16)
# with the BT.601 weights rounded to 16 fractional bits. Integer arithmetic is
# bit-deterministic across every kernel/compiler (XLA fusion and FMA
# contraction cannot perturb it), the weights sum to exactly 2^16 so
# r==g==b==k maps to k, and the result stays within +-1 of the reference C
# kernel's f32 computation (the agreed u8 parity tolerance, SURVEY.md §7).
LUMA_FIX_R, LUMA_FIX_G, LUMA_FIX_B = 19595, 38470, 7471  # == round(w * 2^16)
LUMA_FIX_SHIFT = 16

# Gaussian blur taps + normalizer used by the reference's GBLUR kernel.
GBLUR_KERNEL = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
GBLUR_NORM = 16


def hwc_to_chw(img: jax.Array) -> jax.Array:
    """Interleaved (H, W, C) -> planar (C, H, W) (the device layout)."""
    return jnp.transpose(img, (2, 0, 1))


def chw_to_hwc(img: jax.Array) -> jax.Array:
    return jnp.transpose(img, (1, 2, 0))


def grayscale(img: jax.Array) -> jax.Array:
    """Planar (C, H, W) u8 -> same shape u8; luma in RGB, alpha preserved."""
    r = img[0].astype(jnp.int32)
    g = img[1].astype(jnp.int32)
    b = img[2].astype(jnp.int32)
    lum = (LUMA_FIX_R * r + LUMA_FIX_G * g + LUMA_FIX_B * b) >> LUMA_FIX_SHIFT
    lum = lum.astype(jnp.uint8)  # exact: 0 <= lum <= 255 by construction
    out = jnp.broadcast_to(lum[None], (3,) + lum.shape)
    if img.shape[0] > 3:
        out = jnp.concatenate([out, img[3:]], axis=0)
    return out


def luma(img: jax.Array) -> jax.Array:
    """Planar (C, H, W) u8 -> (H, W) u8 luma plane (grayscale + extract fused)."""
    return grayscale(img)[0]


def sobel(gray: jax.Array, border: str = "zero") -> jax.Array:
    """(H, W) u8 plane -> (H, W) u8 edge magnitude; out-of-plane neighbors
    are 0. ``border="zero"`` zeroes the 1-px border rows/cols; ``"none"``
    keeps every computed row (for halo-extended shards)."""
    g = gray.astype(jnp.float32)
    gp = jnp.pad(g, 1)

    def sh(dy: int, dx: int) -> jax.Array:  # neighbor at (y+dy, x+dx)
        h, w = g.shape
        return jax.lax.dynamic_slice(gp, (1 + dy, 1 + dx), (h, w))

    gx = (-sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1)
          + sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
    gy = (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
          - sh(1, -1) - 2 * sh(1, 0) - sh(1, 1))
    # u8 inputs make gx^2+gy^2 <= 2*1020^2 < 2^24: exact in f32, as are
    # the squares below. A device sqrt that is not correctly rounded can
    # land one below an exact root; the two corrections restore
    # floor(sqrt(.)) exactly, so every backend gives the same bytes.
    s = gx * gx + gy * gy
    mag = jnp.floor(jnp.sqrt(s))
    mag = jnp.where((mag + 1.0) * (mag + 1.0) <= s, mag + 1.0, mag)
    mag = jnp.where(mag * mag > s, mag - 1.0, mag)
    mag = jnp.minimum(mag, 255.0)
    if border == "zero":
        h, w = gray.shape
        row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        interior = (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)
        mag = jnp.where(interior, mag, 0.0)
    return mag.astype(jnp.uint8)


def edge_pipeline(img: jax.Array, border: str = "zero") -> jax.Array:
    """The reference's 4-stage sobel driver as one fused computation.

    grayscale (in-place) -> extract mono plane -> sobel -> broadcast back to
    RGB (``monolithic/src/main_with_sobel.c:51-74``), with the luma plane
    truncated to u8 *before* the stencil, exactly as the staged C pipeline
    materializes it. ``border`` as in :func:`sobel`.
    """
    e = sobel(luma(img), border=border)
    out = jnp.broadcast_to(e[None], (3,) + e.shape)
    if img.shape[0] > 3:
        out = jnp.concatenate([out, img[3:]], axis=0)
    return out


def conv3x3(img: jax.Array, kernel=GBLUR_KERNEL,
            norm: int | float = GBLUR_NORM,
            integer: bool = True) -> jax.Array:
    """Zero-padded same-size 3x3 weighted convolution with normalization.

    ``integer=True`` reproduces the reference's semantics: integer tap
    accumulation followed by C integer division (truncation toward zero) by
    ``norm``. ``integer=False`` is the float-native mode.
    Input planar (C, H, W), any integer/float dtype; output matches the
    accumulation dtype (int32 for integer mode, float32 otherwise).
    """
    k = jnp.asarray(kernel)
    acc_dtype = jnp.int32 if integer else jnp.float32
    x = img.astype(acc_dtype)
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1)))
    c, h, w = img.shape
    out = jnp.zeros((c, h, w), acc_dtype)
    for ky in range(3):
        for kx in range(3):
            tap = jax.lax.dynamic_slice(xp, (0, ky, kx), (c, h, w))
            out = out + tap * k[ky, kx].astype(acc_dtype)
    if integer:
        # C integer division truncates toward zero.
        out = jnp.sign(out) * (jnp.abs(out) // jnp.asarray(norm, acc_dtype))
        return out.astype(jnp.int32)
    return out / jnp.asarray(norm, jnp.float32)


def channel_mean(img: jax.Array) -> jax.Array:
    """Per-channel mean over all pixels: (C, H, W) -> (C,) float32.

    Capability twin of the reference's ``parallel_avg_pixel`` reduction
    (``old/parallel_avg_pixel.c:14-31``). The reference divides the summed
    channel totals by H*W*3 after a triple-counted loop; this op returns the
    plain per-channel mean (sum / (H*W)) — the well-defined quantity the
    reference approximates.
    """
    return jnp.mean(img.astype(jnp.float32), axis=(1, 2))


def grayscale_mean_minmax(img: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Channel-mean grayscale with fused min/max reduction.

    Twin of ``old/parallel_to_grayscale.c:7-38``: gray = (r+g+b)/3 with C
    integer division, broadcast to all channels; returns (gray_img, min, max).
    """
    s = img[:3].astype(jnp.int32).sum(axis=0)
    gray = s // 3
    out = jnp.broadcast_to(gray[None], (3,) + gray.shape)
    return out, gray.min(), gray.max()
