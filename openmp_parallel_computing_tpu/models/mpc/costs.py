"""Stage costs for the visual-servo MPC.

Two ingredients:

- quadratic feature tracking + control effort (classic IBVS objective);
- an edge-attraction term evaluated on the device-resident Sobel edge map
  produced by ``ops.edge_pipeline`` — the stage cost "evaluated on
  edge-feature cost maps" of the BASELINE north star. Features are pulled
  toward strong edges via bilinear sampling of the (negated, normalized)
  edge magnitude; gradients flow through the sampler by autodiff.

All functions are per-scenario; batch with vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_sample(field: jax.Array, xy: jax.Array) -> jax.Array:
    """Sample a (H, W) float field at continuous pixel coords.

    xy is (m, 2) as (x, y) in pixel units; out-of-bounds clamps to the
    border. Differentiable in xy.
    """
    h, w = field.shape
    x = jnp.clip(xy[:, 0], 0.0, float(w - 1))
    y = jnp.clip(xy[:, 1], 0.0, float(h - 1))
    # Clamp the *cell* index so the +1 gather stays in bounds; the fractional
    # weight then reaches exactly 1.0 at the far border (exact on-grid
    # values everywhere, including the last row/column).
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = field[y0, x0]
    v01 = field[y0, x0 + 1]
    v10 = field[y0 + 1, x0]
    v11 = field[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def separable_sample(field: jax.Array, xy: jax.Array) -> jax.Array:
    """Gather-free bilinear sampling of a small (Hf, Wf) field.

    Bilinear interpolation at (x, y) equals w_y^T F w_x where w_x / w_y are
    hat-function weight vectors (at most two nonzeros each). Materializing
    the weights densely turns sampling into batched contractions that run on
    the vector/matrix units instead of per-index gathers — the same values
    as ``bilinear_sample`` (verified in tests), and far cheaper than
    per-index gathers at the solver's sampling volume. xy is (..., 2) in
    pixel units, clamped to the border.
    """
    hf, wf = field.shape
    x = _clip_coord(xy[..., 0], float(wf - 1))
    y = _clip_coord(xy[..., 1], float(hf - 1))
    wx = _hat_weights(x, wf)                                  # (..., Wf)
    wy = _hat_weights(y, hf)                                  # (..., Hf)
    return jnp.einsum("...i,ij,...j->...", wy, field, wx,
                      precision=jax.lax.Precision.HIGHEST)


def _clip_coord(x: jax.Array, hi: float) -> jax.Array:
    """clip(x, 0, hi) whose gradient is 1 ON the border, 0 strictly
    outside (``jnp.clip``'s min/max tie convention passes only half the
    cotangent at an exactly-boundary coordinate — and border-clamped
    points are the common case for off-frame features)."""
    return jnp.where(x < 0.0, 0.0, jnp.where(x > hi, hi, x))


def _hat_weights(xl: jax.Array, size: int) -> jax.Array:
    """Dense bilinear weights over a grid axis, (...,) -> (..., size).

    Built as the one-hot PAIR ``(j == x0)·(1-fx) + (j == x0+1)·fx`` with
    ``x0 = clip(floor(xl), 0, size-2)`` rather than the hat form
    ``maximum(0, 1-|xl-j|)``. The values are identical (the two active
    columns get exactly 1-fx / fx, the rest exactly 0), but the autodiff
    differs where it matters: the max/abs form is garbage whenever a
    sample lands on an exact integer coordinate — which every
    border-CLAMPED point does — because ``abs``'s tie convention
    (abs'(0) = +1) differentiates the center weight to -1 while the
    neighbor's support boundary contributes 0, so kink terms that must
    cancel in the summed interpolant don't: the measured gradient was
    -42.6 where the true one-sided derivative is 1.0 (a full weighted
    field row leaking in). Here ``floor`` carries zero gradient, so
    d(weights)/dxl is exactly ``-(j==x0) + (j==x0+1)`` and the summed
    interpolation gradient is the true one-sided derivative at every
    kink — right-hand in the interior, left-hand at the top border
    (x0 clamps to size-2 there). Regression-tested in
    tests/test_mpc.py::TestHatWeightGradients."""
    if size == 1:
        # degenerate single-cell axis: constant weight, zero gradient
        return jnp.ones(xl.shape + (1,), xl.dtype) + 0.0 * xl[..., None]
    grid = jnp.arange(size, dtype=xl.dtype)
    x0 = jnp.clip(jnp.floor(xl), 0.0, float(size - 2))[..., None]
    fx = xl[..., None] - x0
    return (jnp.where(grid == x0, 1.0 - fx, 0.0)
            + jnp.where(grid == x0 + 1.0, fx, 0.0))


def normalized_to_pixels(p: jax.Array, height: int, width: int) -> jax.Array:
    """(2m,) normalized coords in [-1, 1] -> (m, 2) pixel coords."""
    pts = p.reshape(-1, 2)
    x = (pts[:, 0] + 1.0) * 0.5 * (width - 1)
    y = (pts[:, 1] + 1.0) * 0.5 * (height - 1)
    return jnp.stack([x, y], axis=-1)


def edge_cost(edge_map: jax.Array, p: jax.Array) -> jax.Array:
    """Edge-attraction cost: mean (1 - E/255) over features; E from the u8
    Sobel magnitude map. Low where features sit on strong edges."""
    xy = normalized_to_pixels(p, *edge_map.shape)
    e = bilinear_sample(edge_map, xy) / 255.0
    return jnp.mean(1.0 - e)


# Pyramid scales for the edge cost-to-go field. A raw edge map gives zero
# gradient more than one pixel from an edge (bilinear support); coarse
# average-pooled levels extend the basin of attraction across the whole
# frame, coarse-to-fine, like a soft distance transform.
#
# The base scale is 16, not 1: the solver samples the pyramid tens of
# thousands of times per sweep, too many for per-index gathers. Sampling
# is therefore done with *dense separable weights* (``separable_sample``):
# bilinear interpolation expressed as two tiny contractions against the
# whole level — no gathers — which requires levels small enough that an
# (N_points x W_level) weight product stays cheap. At scale 16 a 1080p map is 68x120; the ~16 px
# sampling resolution only bounds the edge-attraction field, not the MPC's
# tracking precision (the quadratic tracking term is exact).
PYRAMID_SCALES = (16, 64)


def avg_pool(field: jax.Array, s: int) -> jax.Array:
    """(H, W) -> (ceil(H/s), ceil(W/s)) mean pooling (zero-padded).

    Pooling windows are anchored at (0, 0) with all zero-padding on the
    high side (NOT XLA's "SAME", which splits the padding and shifts the
    window grid by pad//2 on non-divisible dims — that both breaks the
    half-cell centering model in ``edge_cost_pyramid`` and misaligns
    ``ops.edge_pyramid_base``, which pools blocks [s*k, s*k+s)).
    """
    if s == 1:
        return field
    h, w = field.shape
    summed = jax.lax.reduce_window(
        field, 0.0, jax.lax.add, (s, s), (s, s),
        ((0, -h % s), (0, -w % s)))
    return summed / float(s * s)


def build_cost_pyramid(edge_map: jax.Array,
                       scales=PYRAMID_SCALES) -> tuple[jax.Array, ...]:
    """Precompute the multi-scale edge field once per frame (device-resident,
    shared by every scenario in the batch).

    Levels are built by chained pooling (each level pools the previous one),
    so each reduce_window reads the small level before it, not the
    full-resolution map.
    """
    levels = []
    prev = edge_map
    prev_scale = 1
    for s in scales:
        factor = s // prev_scale
        prev = avg_pool(prev, factor)
        levels.append(prev)
        prev_scale = s
    return tuple(levels)


def pyramid_from_base(level0: jax.Array,
                      scales=PYRAMID_SCALES) -> tuple[jax.Array, ...]:
    """Complete a cost pyramid from a prebuilt base level (the
    ``scales[0]``-pooled edge mean): higher levels chain-pool it exactly
    like ``build_cost_pyramid`` does."""
    levels = [level0]
    prev_scale = scales[0]
    for s in scales[1:]:
        levels.append(avg_pool(levels[-1], s // prev_scale))
        prev_scale = s
    return tuple(levels)


def build_cost_pyramid_from_frame(frame: jax.Array,
                                  scales=PYRAMID_SCALES
                                  ) -> tuple[jax.Array, ...]:
    """Fused perception → pyramid: (C, H, W) u8 planar camera frame to the
    same levels ``build_cost_pyramid(edge_pipeline(frame)[0].astype(f32))``
    produces, without ever materializing the full-resolution edge map.

    Level 0 comes straight from ``ops.edge_pyramid_base`` — luma → Sobel →
    per-block mean in one fused XLA computation (bit-exact with the staged
    path: block sums of u8-valued magnitudes are integers below 2^24, so
    f32 accumulation order cannot change them). Higher levels chain-pool
    level 0 exactly like ``build_cost_pyramid``.
    """
    from openmp_parallel_computing_tpu.ops import edge_pyramid_base

    return pyramid_from_base(edge_pyramid_base(frame, s=scales[0]), scales)


def edge_cost_pyramid(pyramid, p: jax.Array, height: int,
                      width: int, scales=PYRAMID_SCALES) -> jax.Array:
    """Mean edge-attraction cost over pyramid levels; differentiable in p
    with non-vanishing gradients at every distance from an edge.

    Uses gather-free separable sampling; p may carry arbitrary leading batch
    dims (..., 2m) and the result reduces over features per batch element.
    """
    pts = p.reshape(p.shape[:-1] + (-1, 2))
    x = (pts[..., 0] + 1.0) * 0.5 * (width - 1)
    y = (pts[..., 1] + 1.0) * 0.5 * (height - 1)
    xy = jnp.stack([x, y], axis=-1)          # (..., m, 2)
    total = 0.0
    for level, s in zip(pyramid, scales):
        # Cell k of an s-pooled level is centered at pixel s*k + (s-1)/2,
        # so the continuous level coordinate of pixel q is (q - (s-1)/2)/s.
        # Without the half-cell shift the interpolation gradient points the
        # wrong way on half of every cell.
        e = separable_sample(level, (xy - (s - 1) / 2.0) / s) / 255.0
        total = total + jnp.mean(1.0 - e, axis=-1)
    return total / len(pyramid)


def edge_cost_pyramid_xy(pyramid, x: jax.Array, y: jax.Array,
                         height: int, width: int,
                         scales=PYRAMID_SCALES, dtype=None) -> jax.Array:
    """Lanes-layout twin of ``edge_cost_pyramid``: coordinates arrive as
    separate x / y arrays of shape (K, m, *B) — the solver's split-state
    lanes layout sliced in half, feature axis at position 1, batch dims
    trailing — instead of interleaved (..., m, 2) points.

    Same math, same separable gather-free sampling; the difference is
    PURELY layout: the sweep backend samples straight off its
    lanes-resident trajectories without the (B, K, n) unlanes/relanes
    transposes that the batch-ceiling study measured as the growing glue
    cost (docs/DESIGN.md §2g). Returns (K, *B) per-state costs (mean
    over levels and features). Equivalence vs ``edge_cost_pyramid`` is
    tested (tests/test_mpc.py).

    ``dtype``: storage dtype for the materialized weight tensors and the
    level (None = float32, bit-identical to the historical path). All
    contractions accumulate in f32 (``preferred_element_type``); bf16
    halves the sampler's HBM-bound weight bytes (MPCConfig.sampler_dtype,
    docs/DESIGN.md §2m)."""
    dt = jnp.float32 if dtype is None else dtype
    xp = (x + 1.0) * 0.5 * (width - 1)
    yp = (y + 1.0) * 0.5 * (height - 1)
    total = 0.0
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape
        xl = _clip_coord((xp - (s - 1) / 2.0) / s, float(wf - 1))
        yl = _clip_coord((yp - (s - 1) / 2.0) / s, float(hf - 1))
        wx = _hat_weights(xl, wf).astype(dt)
        wy = _hat_weights(yl, hf).astype(dt)
        # Mean-center the level before any low-precision cast: the field's
        # DC component (~128 on a 255 scale) would otherwise dominate the
        # quantization error, while the hat weights sum to 1 so a constant
        # shift passes through interpolation exactly — store only the
        # residual in ``dt`` and add the f32 mean back to the scalar
        # result (the level itself is tiny and shared; the traffic that
        # ``dt`` halves is the per-point weight tensors).
        mu = jnp.mean(level) if dt != jnp.float32 else 0.0
        e = mu + jnp.einsum("...i,ij,...j->...", wy,
                            (level - mu).astype(dt), wx,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        total = total + (1.0 - e / 255.0)
    return jnp.mean(total, axis=1) / len(pyramid)


def edge_vg_pyramid_xy(pyramid, x: jax.Array, y: jax.Array,
                       height: int, width: int, scales=PYRAMID_SCALES,
                       dtype=None):
    """Analytic value+gradient twin of ``edge_cost_pyramid_xy``: one pass
    computes the per-state costs AND d(sum(costs))/d(x, y) — the exact
    pair ``_SweepLanes`` needs per edge linearization — without autodiff.

    Returns ``(vals (K, *B), gx (K, m, *B), gy (K, m, *B))``. The gradient
    formulas are the hat-weight one-hot-pair derivatives autodiff produces
    from ``_hat_weights`` (floor carries zero gradient; the border mask
    passes ON the border, blocks strictly outside — ``_clip_coord``'s
    convention), so values AND gradients match
    ``jax.grad(sum ∘ edge_cost_pyramid_xy)`` to reassociation (tested).

    Why it exists: the autodiff path materializes the forward weight
    tensors AND the backward pass's rebuilt weights + cotangent products
    in device memory — the dominant sampling cost at large point counts
    (docs/DESIGN.md §2g). Building ``w`` and
    ``dw`` together from one one-hot pair and contracting each level
    exactly twice is the leanest dense-weight formulation.

    ``dtype``: storage dtype for the weight tensors and level (None =
    float32, bit-identical to the historical path). Coordinates, cell
    fractions, masks, and all contraction ACCUMULATION stay f32
    (``preferred_element_type``); under bf16 only the stored weights and
    level values are rounded — halving the HBM-bound weight bytes that
    ARE this function's cost (MPCConfig.sampler_dtype, DESIGN §2m).
    """
    dt = jnp.float32 if dtype is None else dtype
    m = x.shape[1]
    xp = (x + 1.0) * (0.5 * (width - 1))
    yp = (y + 1.0) * (0.5 * (height - 1))
    total = 0.0
    gx_tot = 0.0
    gy_tot = 0.0
    norm = 1.0 / (m * len(pyramid))
    for level, s in zip(pyramid, scales):
        hf, wf = level.shape
        xl_raw = (xp - (s - 1) / 2.0) / s
        yl_raw = (yp - (s - 1) / 2.0) / s
        xl = _clip_coord(xl_raw, float(wf - 1))
        yl = _clip_coord(yl_raw, float(hf - 1))

        def w_dw(cl, size):
            """Hat weights and their d/d(level coord) from ONE one-hot
            pair: with a = onehot(c0), b = onehot(c0+1):
            w = a + f*(b-a), dw = b - a. Stored in
            ``dt``; the cell fraction ``f`` is computed in the coord
            dtype (f32) BEFORE rounding, so bf16 costs one rounding of
            the final weights, not cancellation on the coordinates."""
            if size == 1:
                # degenerate single-cell axis (_hat_weights' convention):
                # constant weight, zero gradient
                one = jnp.ones(cl.shape + (1,), dt)
                return one, jnp.zeros_like(one)
            grid = jnp.arange(size, dtype=cl.dtype)
            c0 = jnp.clip(jnp.floor(cl), 0.0, float(size - 2))[..., None]
            f = (cl[..., None] - c0).astype(dt)
            a = jnp.where(grid == c0, 1.0, 0.0).astype(dt)
            b = jnp.where(grid == c0 + 1.0, 1.0, 0.0).astype(dt)
            dw = b - a
            return a + f * dw, dw

        # Mean-center before any low-precision cast (see
        # edge_cost_pyramid_xy): the mean rides back onto the VALUE as an
        # exact f32 scalar, and contributes EXACTLY zero to the gradient
        # contractions because each dw = b - a sums to zero even in dt.
        mu = jnp.mean(level) if dt != jnp.float32 else 0.0
        lv = (level - mu).astype(dt)
        wx, dwx = w_dw(xl, wf)                        # (K, m, *B, wf)
        wy, dwy = w_dw(yl, hf)                        # (K, m, *B, hf)
        t2 = jnp.einsum("...i,ij->...j", wy, lv,      # (K, m, *B, wf)
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
        t1 = jnp.einsum("...j,ij->...i", wx, lv,      # (K, m, *B, hf)
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
        e = mu + jnp.sum(wy * t1, axis=-1)            # == wy . L . wx
        total = total + (1.0 - e * (1.0 / 255.0))
        # Border mask + chain factors (level coord -> normalized coord).
        mx = ((xl_raw >= 0.0) & (xl_raw <= float(wf - 1))).astype(x.dtype)
        my = ((yl_raw >= 0.0) & (yl_raw <= float(hf - 1))).astype(y.dtype)
        cx = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (width - 1)
        cy = -(1.0 / 255.0) * (1.0 / s) * 0.5 * (height - 1)
        gx_tot = gx_tot + cx * mx * jnp.sum(t2 * dwx, axis=-1)
        gy_tot = gy_tot + cy * my * jnp.sum(t1 * dwy, axis=-1)
    return (jnp.mean(total, axis=1) / len(pyramid),
            gx_tot * norm, gy_tot * norm)


def make_stage_cost(pyramid, shape: tuple[int, int], target: jax.Array,
                    q_track: float, r_ctrl: float, q_edge: float):
    """Build l(p, u) for one scenario over a precomputed cost pyramid.

    ``pyramid`` from ``build_cost_pyramid``; ``shape`` is the (H, W) of the
    base edge map.
    """
    h, w = shape

    def l(p, u):
        track = q_track * jnp.sum((p - target) ** 2)
        ctrl = r_ctrl * jnp.sum(u ** 2)
        if q_edge:
            return track + ctrl + q_edge * edge_cost_pyramid(pyramid, p, h, w)
        return track + ctrl

    return l


def make_terminal_cost(pyramid, shape: tuple[int, int], target: jax.Array,
                       q_track: float, q_edge: float):
    h, w = shape

    def lf(p):
        track = q_track * jnp.sum((p - target) ** 2)
        if q_edge:
            return track + q_edge * edge_cost_pyramid(pyramid, p, h, w)
        return track

    return lf


def make_expansions(pyramid, shape: tuple[int, int], target: jax.Array,
                    q_track: float, r_ctrl: float, q_edge: float):
    """Analytic quadratic expansion of the stage/terminal costs.

    Exact for the quadratic tracking/effort terms; Gauss-Newton for the
    edge-attraction term (first-order gradient, curvature dropped — the
    pyramid field is piecewise-linear so its Hessian is zero a.e. and
    indefinite on cell boundaries). Replaces per-sweep ``jax.hessian`` calls
    through gather-heavy samplers, which dominated both compile and run
    time of the naive autodiff expansion.

    Returns ``expand(ps, us) -> (lx, lu, lxx, luu, lux, vx, vxx)``.
    """
    hh, ww = shape
    n = target.shape[-1]

    def edge_only(p):
        return edge_cost_pyramid(pyramid, p, hh, ww)

    edge_grad = jax.vmap(jax.grad(edge_only))

    def expand(ps, us, edge_grads=None):
        """``edge_grads``: optional precomputed (H+1, n) pyramid gradients
        at ``ps`` (lets the caller share one evaluation with the line
        search's linearized edge model)."""
        H = us.shape[0]
        dtype = ps.dtype
        lx = 2.0 * q_track * (ps[:-1] - target)
        g = None
        if q_edge:
            # One vmapped evaluation covers all H+1 states; the terminal
            # row g[-1] is reused for vx below (a separate
            # jax.grad(edge_only)(ps[-1]) is a fresh trace XLA won't CSE,
            # and the pyramid sampler gradient dominates expansion cost).
            g = edge_grads if edge_grads is not None else edge_grad(ps)
            lx = lx + q_edge * g[:-1]
        lu = 2.0 * r_ctrl * us
        eye_n = jnp.eye(n, dtype=dtype)
        eye_c = jnp.eye(us.shape[-1], dtype=dtype)
        lxx = jnp.broadcast_to(2.0 * q_track * eye_n, (H, n, n))
        luu = jnp.broadcast_to(2.0 * r_ctrl * eye_c,
                               (H,) + eye_c.shape)
        lux = jnp.zeros((H, us.shape[-1], n), dtype)
        vx = 2.0 * q_track * (ps[-1] - target)
        if q_edge:
            vx = vx + q_edge * g[-1]
        vxx = 2.0 * q_track * eye_n
        return lx, lu, lxx, luu, lux, vx, vxx

    return expand
