"""Least-squares regression for the LSMC continuation values.

The reference computes a thin-QR pseudo-inverse of the design matrix with MKL
per backward step (``LsmcStorageValuation.cs:192-197``), which does not shard.
This formulation standardises the basis columns (the normalisation
the reference lists as a TODO at LsmcStorageValuation.cs:189) and solves the
normal equations with a Cholesky factorisation:

    X_std = (X - mean) / std          (column 0, the constant, untouched)
    M     = X_stdᵀ X_std  (+ ridge jitter)     — psum across path shards
    c     = M⁻¹ X_stdᵀ Y                        — Y = [S, G] continuation values

Both cross-shard reductions are tiny ([B,B] and [B,G], B ≈ 10), so path
sharding scales; every shard then solves the same small system redundantly,
which is cheaper than sharding the solve.
"""
from __future__ import annotations

import typing as tp

import jax
import jax.numpy as jnp


def _psum(x, axis_name: tp.Optional[str]):
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def _pmax(x, axis_name: tp.Optional[str]):
    return x if axis_name is None else jax.lax.pmax(x, axis_name)


def column_stats(x, axis_name: tp.Optional[str] = None):
    """Global mean/std of design-matrix columns [S, B] across path shards.

    The constant column (index 0) keeps mean 0 / std 1 so standardisation
    leaves it intact.  A column that holds one value on every path (every
    state column on the valuation date) standardises to exactly zero: its
    mean is that value and its std 1.  The rounded mean of a constant column
    is off by a few ulps, which would otherwise leave a std of a few ulps
    and blow that rounding up to an O(1) column — a column whose sign then
    hangs on the last bit of the forward pass's own spot.
    """
    s_local = x.shape[0]
    count = _psum(jnp.asarray(s_local, x.dtype), axis_name)
    col_sum = _psum(jnp.sum(x, axis=0), axis_name)
    mean = col_sum / count
    x_const = jax.lax.stop_gradient(x)  # a value fix-up; AD keeps the mean's rule
    col_max = _pmax(jnp.max(x_const, axis=0), axis_name)
    constant = col_max == -_pmax(-jnp.min(x_const, axis=0), axis_name)
    mean = mean + jnp.where(
        constant, col_max - jax.lax.stop_gradient(mean), 0.0
    )
    col_sq = _psum(jnp.sum((x - mean) ** 2, axis=0), axis_name)
    std = jnp.sqrt(col_sq / count)
    std = jnp.where(std > 0, std, 1.0)
    b = x.shape[1]
    first = jnp.arange(b) == 0
    mean = jnp.where(first, 0.0, mean)
    std = jnp.where(first, 1.0, std)
    return mean, std


def fit_continuation(
    x_std,
    y,
    axis_name: tp.Optional[str] = None,
    ridge: tp.Optional[float] = None,
):
    """Regression coefficients for standardised design matrix.

    ``x_std``: [S, B]; ``y``: [S, G] (continuation values per sim for each next
    inventory grid point).  Returns coeffs [B, G].  The ridge jitter is scaled
    by mean(diag(M)) to keep the solve well-posed under exactly collinear bases
    (the reference QR simply fails there — README.md:747-751 notes QR dominates
    its runtime; here the [B,B] solve is negligible next to the [B,S] matmuls).

    Near the valuation date the simulated spot is an almost-deterministic
    function of the factors, so the sample correlation of the basis columns is
    singular to within f32 resolution; the default ridge is therefore larger in
    f32 (1e-5) than f64 (1e-7), and a failed Cholesky (non-finite coefficients)
    falls back to the projection on the constant column — the cross-sim mean —
    instead of poisoning the backward scan with NaNs.
    """
    # precision=HIGHEST: the GPU's default f32 matmul rounds operands to
    # TF32 (10-bit mantissa), too coarse for the normal-equation moments
    # that set decision quality.
    m = _psum(
        jnp.dot(
            x_std.T, x_std,
            preferred_element_type=x_std.dtype,
            precision=jax.lax.Precision.HIGHEST,
        ),
        axis_name,
    )
    xty = _psum(
        jnp.dot(
            x_std.T, y,
            preferred_element_type=x_std.dtype,
            precision=jax.lax.Precision.HIGHEST,
        ),
        axis_name,
    )
    return fit_from_moments(m, xty, ridge)


def fit_from_moments(m, xty, ridge: tp.Optional[float] = None):
    """Solve the standardised normal equations given assembled moments
    (``m = X̃ᵀX̃`` [B, B], ``xty = X̃ᵀY`` [B, G]) — the shared tail of
    ``fit_continuation``: trace-scaled ridge jitter, Cholesky, and the
    constant-column fallback on a failed solve."""
    if ridge is None:
        ridge = 1e-5 if m.dtype == jnp.float32 else 1e-7
    b = m.shape[0]
    jitter = ridge * jnp.trace(m) / b
    m = m + jitter * jnp.eye(b, dtype=m.dtype)
    chol, lower = jax.scipy.linalg.cho_factor(m, lower=True)
    coeffs = jax.scipy.linalg.cho_solve((chol, lower), xty)
    # m[0, 0] is the constant column's sum of squares = the global sim count.
    mean_y = xty[0:1] / m[0, 0]
    fallback = jnp.concatenate([mean_y, jnp.zeros_like(xty[1:])], axis=0)
    solve_failed = ~jnp.all(jnp.isfinite(coeffs))
    return jnp.where(solve_failed, fallback, coeffs)


def predict(x_std, coeffs):
    """Fitted continuation values [S, G] = X_std @ coeffs.

    HIGHEST precision: the values feed the forward decision argmax, which
    compares near-equal continuations; with K = B ≈ 9 the product is cheap
    on the f32 units, and TF32 rounding would move values by more than the
    gaps between decisions.
    """
    return jnp.dot(
        x_std, coeffs,
        preferred_element_type=x_std.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
