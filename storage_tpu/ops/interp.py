"""Branchless linear interpolation over inventory grids.

Replaces the reference's per-point bisection + tolerance snapping
(``StorageHelper.BisectInventorySpace``, StorageHelper.cs:280-314, and
``LsmcStorageValuation.InterpolateContinuationValue``, :807-826) with
searchsorted + gather, which vectorises over grid points, decisions and
simulations.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def grid_positions(grid, x):
    """Fractional positions of ``x`` on a *uniform* 1-D ``grid`` [G].

    The engines' inventory grids are linspace (``grid.inventory_grids``), so
    interpolation indices come from arithmetic instead of a searchsorted
    binary search.  Degenerate grids (all equal)
    map everything to position 0.
    """
    g = grid.shape[0]
    span = grid[g - 1] - grid[0]
    delta = span / (g - 1)
    safe = jnp.where(delta > 0, delta, 1.0)
    pos = (jnp.clip(x, grid[0], grid[g - 1]) - grid[0]) / safe
    return jnp.where(delta > 0, pos, 0.0)


def interp_weights(grid, x):
    """Lower index and lerp weight for values ``x`` on a uniform 1-D ``grid`` [G].

    Returns (idx_lo [x.shape], w_hi [x.shape]) with x clamped to the grid range;
    a degenerate grid (all equal) yields weight 0 on index 0.
    """
    g = grid.shape[0]
    pos = grid_positions(grid, x)
    idx_lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, g - 2)
    w_hi = jnp.clip(pos - idx_lo, 0.0, 1.0)
    return idx_lo, w_hi


def interp_per_sim(grid, values, x):
    """Linear interpolation of per-sim value rows at per-sim query points.

    ``values``: [S, G]; ``x``: [S, D] → [S, D].  Implemented as a hat-weight
    contraction over the grid axis (an [S,D,G]x[S,G] einsum at full f32
    precision: the values' magnitude would lose ~3 digits in reduced-precision
    operands).
    """
    pos = grid_positions(grid, x)  # [S, D]
    g_idx = jnp.arange(grid.shape[0], dtype=pos.dtype)
    hat = jnp.clip(1.0 - jnp.abs(pos[..., None] - g_idx), 0.0, 1.0)  # [S, D, G]
    return jnp.einsum(
        "sdg,sg->sd", hat, values, precision=jax.lax.Precision.HIGHEST
    )


def interp_columns(grid, values, x):
    """Interpolate ``values`` [G, S] along the grid axis at inventories ``x`` [...].

    Returns array of shape x.shape + (S,): per-simulation continuation values at
    each queried inventory.
    """
    idx_lo, w_hi = interp_weights(grid, x)
    lo_vals = values[idx_lo]  # x.shape + (S,)
    hi_vals = values[idx_lo + 1]
    return lo_vals + (hi_vals - lo_vals) * w_hi[..., None]


def interp_vector(grid, values, x):
    """Interpolate a 1-D ``values`` [G] at ``x`` [...] (linear, clamped)."""
    idx_lo, w_hi = interp_weights(grid, x)
    lo_vals = values[idx_lo]
    hi_vals = values[idx_lo + 1]
    return lo_vals + (hi_vals - lo_vals) * w_hi


def interp_weights_general(grid, x):
    """(idx_lo, w_hi) on a NON-uniform, non-decreasing 1-D ``grid`` [G]
    (clamped; zero-span segments — e.g. the padding of custom/fixed-spacing
    grids — yield weight 0 on their left node).  Same contract as
    ``interp_weights``; index by counting nodes <= x (G is ≤ a few hundred
    so vectorised compares replace a searchsorted binary search)."""
    g = grid.shape[0]
    x_c = jnp.clip(x, grid[0], grid[g - 1])
    idx = jnp.zeros(jnp.shape(x_c), dtype=jnp.int32)
    for r in range(1, g - 1):
        idx = idx + (x_c >= grid[r]).astype(jnp.int32)
    x0 = grid[idx]
    x1 = grid[idx + 1]
    span = x1 - x0
    w = jnp.where(span > 0, (x_c - x0) / jnp.where(span > 0, span, 1.0), 0.0)
    return idx, w


def interp_per_sim_general(grid, values, x):
    """``interp_per_sim`` on a non-uniform grid: hat weights built from the
    general index/weight pair instead of uniform position arithmetic."""
    idx_lo, w = interp_weights_general(grid, x)  # [S, D]
    g_idx = jnp.arange(grid.shape[0])
    hat = (
        (idx_lo[..., None] == g_idx) * (1.0 - w[..., None])
        + ((idx_lo + 1)[..., None] == g_idx) * w[..., None]
    )  # [S, D, G]
    return jnp.einsum(
        "sdg,sg->sd", hat, values, precision=jax.lax.Precision.HIGHEST
    )


def interp_vector_general(grid, values, x):
    """Linear interpolation on a NON-uniform, non-decreasing 1-D ``grid`` [G]
    (clamped).  Supports the reference's fixed-spacing grids, whose last
    segment is truncated at the band upper bound and whose padding repeats
    that bound (zero-span segments yield their left node's value).  Index by
    counting nodes <= x — G is small for the intrinsic engine, so vectorised
    compares replace a searchsorted binary search."""
    g = grid.shape[0]
    x_c = jnp.clip(x, grid[0], grid[g - 1])
    idx = jnp.zeros(jnp.shape(x_c), dtype=jnp.int32)
    for r in range(1, g - 1):
        idx = idx + (x_c >= grid[r]).astype(jnp.int32)
    x0 = grid[idx]
    x1 = grid[idx + 1]
    span = x1 - x0
    w = jnp.where(span > 0, (x_c - x0) / jnp.where(span > 0, span, 1.0), 0.0)
    return values[idx] * (1 - w) + values[idx + 1] * w


def natural_cubic_solver(num_points: int) -> jnp.ndarray:
    """Inverse of the natural-cubic-spline tridiagonal system for a uniform
    grid of ``num_points`` nodes: interior second-derivative moments satisfy
    M_{i-1} + 4 M_i + M_{i+1} = rhs_i.  Precomputed once per grid size (the
    matrix is constant), applied as a small matmul inside scans."""
    import numpy as np

    n = num_points - 2
    if n <= 0:
        return jnp.zeros((0, 0))
    t = np.zeros((n, n))
    for i in range(n):
        t[i, i] = 4.0
        if i > 0:
            t[i, i - 1] = 1.0
        if i + 1 < n:
            t[i, i + 1] = 1.0
    return jnp.asarray(np.linalg.inv(t))


def cubic_moments(grid, values, solver):
    """Second-derivative moments [G] of the natural cubic spline through
    (grid, values) on a uniform grid; ``solver`` from natural_cubic_solver(G).
    Degenerate grids yield zero moments (spline collapses to linear)."""
    g = grid.shape[0]
    h = (grid[g - 1] - grid[0]) / (g - 1)
    safe_h = jnp.where(h > 0, h, 1.0)
    rhs = 6.0 * (values[2:] - 2.0 * values[1:-1] + values[:-2]) / (safe_h * safe_h)
    # The precomputed inverse arrives as f64 numpy under x64; keep the moment
    # pipeline in the values dtype (a promoted carry breaks downstream scans).
    interior = jnp.where(
        h > 0,
        jnp.dot(solver.astype(values.dtype), rhs,
                precision=jax.lax.Precision.HIGHEST),
        jnp.zeros_like(rhs),
    )
    zero = jnp.zeros((1,), values.dtype)
    return jnp.concatenate([zero, interior, zero])


def interp_vector_cubic(grid, values, moments, x):
    """Natural-cubic-spline evaluation of ``values`` [G] at ``x`` [...]
    (clamped); the reference's NaturalCubicSplineInterpolatorFactory analog
    (InterpolatorFactories/IInterpolatorFactory.cs:33-37)."""
    g = grid.shape[0]
    h = (grid[g - 1] - grid[0]) / (g - 1)
    idx_lo, t = interp_weights(grid, x)
    v_lo = values[idx_lo]
    v_hi = values[idx_lo + 1]
    m_lo = moments[idx_lo]
    m_hi = moments[idx_lo + 1]
    u = 1.0 - t
    linear = v_lo * u + v_hi * t
    curvature = (h * h / 6.0) * ((u * u * u - u) * m_lo + (t * t * t - t) * m_hi)
    return linear + jnp.where(h > 0, curvature, 0.0)
