"""Spatially sharded stencils: one image split row-wise across the mesh.

This is the device analogue of the reference's intra-kernel OpenMP
parallelism: where ``collapse(2) schedule(static)`` splits the row loop over
threads sharing one address space (``monolithic/src/sobel.c:10``), here the
row range is sharded over devices, each device runs the stencil on its
local rows, and the one-row overlap a neighboring thread would have read from
shared memory becomes a ``ppermute`` halo exchange between devices
(``parallel.collectives.halo_exchange_rows``).

Used for frames too large for one device or to cut per-frame latency across
several; for throughput over many frames prefer batch data-parallelism
(``models.vision``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from openmp_parallel_computing_tpu.ops.image import (
    edge_pipeline as _edge_pipeline,
    gaussian_blur as _blur_op,
    grayscale as _grayscale_op,
    sobel as _sobel_op,
)
from openmp_parallel_computing_tpu.parallel import collectives
from openmp_parallel_computing_tpu.parallel.mesh import MODEL_AXIS


def _border_mask_rows(out: jax.Array, h: int, w: int, axis: str,
                      h_local: int) -> jax.Array:
    """Re-impose the image-border-zero contract on a row shard.

    ``h`` is the ORIGINAL image height: when the frame was zero-padded to a
    device multiple (``ops.runner.pad_rows``), the true last image row is
    ``h - 1`` — masking with the padded height would leave it computed
    against the pad rows instead of zeroed (threads=N vs threads=1 parity).
    """
    idx = jax.lax.axis_index(axis)
    shape = out.shape[-2:]
    row = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + idx * h_local
    col = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    interior = (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)
    return jnp.where(interior, out, jnp.zeros_like(out))


def sharded_sobel(gray: jax.Array, mesh: Mesh, axis: str = MODEL_AXIS,
                  orig_h: int | None = None) -> jax.Array:
    """(H, W) u8 -> (H, W) u8 Sobel with rows sharded over ``mesh[axis]``.

    H must divide evenly by the axis size (pad upstream if not, passing the
    unpadded height as ``orig_h`` so border zeroing lands on the true image
    border).
    """
    h, w = gray.shape
    n = mesh.shape[axis]
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis {axis}={n}")
    h_local = h // n
    img_h = orig_h if orig_h is not None else h

    def local(plane):  # (h_local, W) on this device
        top, bottom = collectives.halo_exchange_rows(plane, axis)
        ext = jnp.concatenate([top, plane, bottom], axis=0)
        out = _sobel_op(ext, border="none")[1:-1]
        return _border_mask_rows(out, img_h, w, axis, h_local)

    f = jax.shard_map(local, mesh=mesh, in_specs=P(axis, None),
                      out_specs=P(axis, None))
    return f(gray)


def sharded_grayscale(img: jax.Array, mesh: Mesh, axis: str = MODEL_AXIS,
                      orig_h: int | None = None) -> jax.Array:
    """(C, H, W) u8 grayscale with rows sharded over ``mesh[axis]``.

    Elementwise per pixel — no halo needed; each device converts its rows
    (``orig_h`` accepted for interface uniformity; zero pad rows map to
    zero luma, so no masking is required).
    """
    c, h, w = img.shape
    n = mesh.shape[axis]
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis {axis}={n}")

    f = jax.shard_map(lambda block: _grayscale_op(block), mesh=mesh,
                      in_specs=P(None, axis, None),
                      out_specs=P(None, axis, None))
    return f(img)


def sharded_gaussian_blur(img: jax.Array, mesh: Mesh,
                          axis: str = MODEL_AXIS,
                          orig_h: int | None = None) -> jax.Array:
    """(C, H, W) u8 Gaussian blur (reference GBLUR semantics) with rows
    sharded over ``mesh[axis]``; 1-row ppermute halos.

    Correctness at shard seams: each device convolves its halo-extended
    block and crops the halo rows. The conv kernel's own row masking only
    affects the discarded halo rows, and the zero halos delivered at the
    mesh edges reproduce the global zero-padding exactly. When the frame
    was zero-padded to H > ``orig_h``, output rows past the true image are
    re-zeroed so repeated passes never feed pad contamination back into the
    last real row.
    """
    c, h, w = img.shape
    n = mesh.shape[axis]
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis {axis}={n}")
    h_local = h // n
    img_h = orig_h if orig_h is not None else h

    def local(block):  # (C, h_local, W)
        top, bottom = collectives.halo_exchange_rows(block, axis)
        ext = jnp.concatenate([top, block, bottom], axis=1)
        out = _blur_op(ext)[:, 1:-1]
        if img_h < h:
            idx = jax.lax.axis_index(axis)
            row = (jax.lax.broadcasted_iota(jnp.int32, out.shape[-2:], 0)
                   + idx * h_local)
            out = jnp.where(row < img_h, out, jnp.zeros_like(out))
        return out

    f = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis, None),
                      out_specs=P(None, axis, None))
    return f(img)


def sharded_edge_pipeline(img: jax.Array, mesh: Mesh,
                          axis: str = MODEL_AXIS,
                          orig_h: int | None = None) -> jax.Array:
    """(C, H, W) u8 -> (C, H, W) u8 fused edge pipeline, rows sharded."""
    c, h, w = img.shape
    n = mesh.shape[axis]
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis {axis}={n}")
    h_local = h // n
    img_h = orig_h if orig_h is not None else h

    def local(block):  # (C, h_local, W)
        top, bottom = collectives.halo_exchange_rows(block, axis)
        ext = jnp.concatenate([top, block, bottom], axis=1)
        out = _edge_pipeline(ext, border="none")[:, 1:-1]
        masked = _border_mask_rows(out[:3], img_h, w, axis, h_local)
        if c > 3:
            masked = jnp.concatenate([masked, block[3:]], axis=0)
        return masked

    f = jax.shard_map(local, mesh=mesh, in_specs=P(None, axis, None),
                      out_specs=P(None, axis, None))
    return f(img)
