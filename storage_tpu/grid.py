"""Inventory-space reduction, inventory grids, and bang-bang decision sets.

Host side (numpy float64): the forward/backward feasible-band reduction of
``StorageHelper.CalculateInventorySpace`` (StorageHelper.cs:39-107), which uses
the constraint objects' inverse problems and raises eagerly when the band is
empty — this runs outside jit so the device code never needs data-dependent
error paths.

Device side (jax): vectorised ratchet-rate lookup and the bang-bang decision
set of ``StorageHelper.CalculateBangBangDecisionSet`` (StorageHelper.cs:109-197)
lowered to fixed-width, branchless arrays.
"""
from __future__ import annotations

import typing as tp

import jax.numpy as jnp
import numpy as np

from .facility import CmdtyStorage, CompiledStorage, InventoryConstraintsCannotBeFulfilledException
from .utils import periods as pu


# ------------------------------------------------------------------ host side


def calculate_inventory_space(
    storage: CmdtyStorage, starting_inventory: float, val_period,
    use_native: tp.Optional[bool] = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Feasible inventory band per period after the decision at the previous period.

    Returns (lower, upper) arrays of length num_steps+1: index 0 is the known
    starting inventory, index t>0 the band for period ``start_active + t``.

    ``use_native``: None = use the C++ reducer when available and the facility
    is table-representable (constant/piecewise-linear/step ratchets of uniform
    node count); True forces it; False forces the pure-Python path.  Both paths
    produce identical float64 results (pinned by tests).
    """
    val_p = pu.to_period(val_period, storage.start.freqstr)
    if val_p > storage.end:
        raise ValueError("Storage has expired.")
    start_active = max(storage.start, val_p)
    periods = pu.period_index(start_active, storage.end)
    num_steps = len(periods) - 1
    first_step = pu.period_offset(start_active, storage.start)

    if use_native is not False:
        native_result = _native_inventory_space(
            storage, starting_inventory, periods, first_step, num_steps
        )
        if native_result is not None:
            return native_result
        if use_native:
            raise RuntimeError(
                "Native inventory-space reduction unavailable for this facility."
            )

    fwd_min = np.empty(num_steps)
    fwd_max = np.empty(num_steps)
    min_run = max_run = float(starting_inventory)
    for i in range(num_steps):
        period = periods[i]
        constraint = storage.constraint_at(first_step + i)
        loss_pcnt = storage._inventory_loss[first_step + i]
        next_period = periods[i + 1]
        rng_min = constraint.get_inject_withdraw_range(min_run)
        min_run = max(
            min_run - loss_pcnt * min_run + rng_min.min_inject_withdraw_rate,
            storage.min_inventory(next_period),
        )
        fwd_min[i] = min_run
        rng_max = constraint.get_inject_withdraw_range(max_run)
        max_run = min(
            max_run - loss_pcnt * max_run + rng_max.max_inject_withdraw_rate,
            storage.max_inventory(next_period),
        )
        fwd_max[i] = max_run

    back_min = np.empty(num_steps)
    back_max = np.empty(num_steps)
    if storage.empty_at_end:
        back_min[-1] = back_max[-1] = 0.0
    else:
        back_min[-1] = storage.min_inventory(storage.end)
        back_max[-1] = storage.max_inventory(storage.end)
    for i in range(num_steps - 2, -1, -1):
        period = periods[i + 1]  # period whose constraint links band i+1 -> i+2
        constraint = storage.constraint_at(first_step + i + 1)
        loss_pcnt = storage._inventory_loss[first_step + i + 1]
        back_max[i] = constraint.inventory_space_upper_bound(
            back_min[i + 1],
            back_max[i + 1],
            storage.min_inventory(period),
            storage.max_inventory(period),
            loss_pcnt,
        )
        back_min[i] = constraint.inventory_space_lower_bound(
            back_min[i + 1],
            back_max[i + 1],
            storage.min_inventory(period),
            storage.max_inventory(period),
            loss_pcnt,
        )

    lower = np.empty(num_steps + 1)
    upper = np.empty(num_steps + 1)
    lower[0] = upper[0] = starting_inventory
    for i in range(num_steps):
        lo = max(fwd_min[i], back_min[i])
        hi = min(fwd_max[i], back_max[i])
        if lo > hi:
            raise InventoryConstraintsCannotBeFulfilledException(
                "Inventory constraints cannot be fulfilled."
            )
        lower[i + 1] = lo
        upper[i + 1] = hi
    return lower, upper


def _native_inventory_space(
    storage: CmdtyStorage, starting_inventory, periods, first_step, num_steps
) -> tp.Optional[tp.Tuple[np.ndarray, np.ndarray]]:
    """C++ fast path of the band reduction (native/storage_native.cpp,
    ``stpu_inventory_space_reduce``).  Returns None when ineligible."""
    from . import constraints as con
    from . import native

    lib = native.load()
    if lib is None:
        return None
    # Dense per-period bounds straight from the facility's arrays — avoiding
    # per-period pandas Period construction keeps 10k+-step (hourly) horizons
    # in the low milliseconds (see tests/test_hourly_stress.py).
    min_all = np.asarray(storage._min_inv, dtype=np.float64)
    max_all = np.asarray(storage._max_inv, dtype=np.float64)
    min_inv = min_all[first_step:first_step + num_steps + 1].copy()
    max_inv = max_all[first_step:first_step + num_steps + 1].copy()

    tables = []
    is_step_flags = set()
    # Constraint objects are typically shared across long stretches of periods
    # (one ratchet profile covering many steps) — memoise table construction.
    # Keyed on id(); the keepalive list pins every cached constraint so a
    # recycled id can never alias a different (garbage-collected) object.
    table_cache: tp.Dict[tp.Tuple[int, float, float], tp.Any] = {}
    cache_keepalive: tp.List[tp.Any] = []
    for t in range(num_steps):
        constraint = storage.constraint_at(first_step + t)
        if isinstance(constraint, con.PolynomialInjectWithdrawConstraint):
            return None  # exact polynomial inverse only in the Python path
        key = (id(constraint), min_inv[t], max_inv[t])
        entry = table_cache.get(key)
        if entry is None:
            entry = constraint.table(min_inv[t], max_inv[t])
            table_cache[key] = entry
            cache_keepalive.append(constraint)
        inv, mn, mx, is_step = entry
        tables.append((inv, mn, mx))
        is_step_flags.add(is_step)
    if len(is_step_flags) > 1:
        return None
    widths = {len(t[0]) for t in tables}
    if len(widths) != 1:
        return None  # mixed node counts: padding would distort step brackets
    width = widths.pop()

    import ctypes

    node_inv = np.ascontiguousarray([t[0] for t in tables], dtype=np.float64)
    node_min = np.ascontiguousarray([t[1] for t in tables], dtype=np.float64)
    node_max = np.ascontiguousarray([t[2] for t in tables], dtype=np.float64)
    if storage.empty_at_end:
        min_inv[-1] = max_inv[-1] = 0.0
    loss = np.ascontiguousarray(
        np.asarray(storage._inventory_loss, dtype=np.float64)[
            first_step:first_step + num_steps
        ]
    )
    lower = np.empty(num_steps + 1)
    upper = np.empty(num_steps + 1)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.stpu_inventory_space_reduce(
        num_steps, width, int(is_step_flags == {True}),
        ptr(node_inv), ptr(node_min), ptr(node_max),
        ptr(min_inv), ptr(max_inv), ptr(loss),
        float(starting_inventory), ptr(lower), ptr(upper),
    )
    if rc == 1:
        raise InventoryConstraintsCannotBeFulfilledException(
            "Inventory constraints cannot be fulfilled."
        )
    if rc == 2:
        raise InventoryConstraintsCannotBeFulfilledException(
            "Storage inventory constraints cannot be satisfied."
        )
    return lower, upper


def inventory_grids(
    lower: np.ndarray, upper: np.ndarray, num_grid_points: int
) -> np.ndarray:
    """Per-period inventory grid [num_steps+1, G], linspace over the feasible band.

    Static shape per period (unlike the reference's variable-length
    ``FixedSpacingStateSpaceGridCalc`` grids, FixedSpacingStateSpaceGridCalc.cs:34-81)
    — same continuum limit, but static shapes for jit.  Degenerate bands collapse to
    a constant grid.
    """
    num_periods = len(lower)
    g = max(int(num_grid_points), 2)
    grids = np.empty((num_periods, g))
    for t in range(num_periods):
        if upper[t] > lower[t]:
            grids[t] = np.linspace(lower[t], upper[t], g)
        else:
            grids[t] = np.full(g, lower[t])
    return grids


def inventory_grids_custom(
    lower: np.ndarray, upper: np.ndarray, grid_calc
) -> np.ndarray:
    """Per-period grids from a user-supplied ``grid_calc(lower, upper)``
    callable — the open extension point of the reference's
    ``IDoubleStateSpaceGridCalc.GetGridPoints`` (IDoubleStateSpaceGridCalc.cs:32).

    The callable returns the grid points for one period's feasible band; rows
    may have different lengths and are padded to a static rectangular width by
    repeating the last point (the engines' interpolation treats zero-span
    segments as their left node — same padding contract as the fixed-spacing
    scheme).  Points are validated sorted and within [lower, upper].

    ``grid_calc`` may also be a pre-built array [num_periods, G] (or a
    sequence of per-period point arrays) instead of a callable — the raw
    user-supplied-grid form of the same extension point."""
    num_periods = len(lower)
    if not callable(grid_calc):
        supplied = [np.asarray(row, dtype=np.float64) for row in grid_calc]
        if len(supplied) != num_periods:
            raise ValueError(
                f"grid array must have one row per period ({num_periods}), "
                f"got {len(supplied)}."
            )
        grid_calc = lambda lo, hi, _it=iter(supplied): next(_it)  # noqa: E731
    rows = []
    for t in range(num_periods):
        pts = np.asarray(grid_calc(float(lower[t]), float(upper[t])), dtype=np.float64)
        if pts.ndim != 1 or pts.size < 1:
            raise ValueError(
                f"grid_calc must return a 1-D array of at least one point "
                f"(period {t}: shape {pts.shape})."
            )
        if np.any(np.diff(pts) < 0):
            raise ValueError(f"grid_calc points must be sorted (period {t}).")
        eps = 1e-9 * max(1.0, abs(upper[t] - lower[t]))
        if pts[0] < lower[t] - eps or pts[-1] > upper[t] + eps:
            raise ValueError(
                f"grid_calc points must lie within the feasible band "
                f"[{lower[t]}, {upper[t]}] (period {t})."
            )
        rows.append(pts)
    width = max(2, max(len(r) for r in rows))
    grids = np.empty((num_periods, width))
    for t, pts in enumerate(rows):
        grids[t, : len(pts)] = pts
        grids[t, len(pts):] = pts[-1]
    return grids


def rows_uniform(grids) -> bool:
    """True when every grid row is evenly spaced (within f32-scale
    tolerance): such grids keep the engines' fast arithmetic-position
    interpolation and the decision kernel; anything else routes to the
    general compare-count interpolation."""
    g = np.asarray(grids, dtype=np.float64)
    if g.shape[1] < 3:
        return True
    d = np.diff(g, axis=1)
    span = g[:, -1] - g[:, 0]
    tol = 1e-6 * np.maximum(1.0, np.abs(span))[:, None]
    return bool(np.all(np.abs(d - d[:, :1]) <= tol))


def inventory_grids_fixed_spacing(
    lower: np.ndarray,
    upper: np.ndarray,
    global_min: float,
    global_max: float,
    num_grid_points: int,
) -> np.ndarray:
    """Per-period grids replicating the reference's
    ``FixedSpacingStateSpaceGridCalc`` (FixedSpacingStateSpaceGridCalc.cs:45-63
    + CreateForFixedNumberOfPointsOnGlobalInventoryRange): spacing =
    global_range/(G-1); each period's points run lower, lower+h, ... capped at
    upper.  Rows are padded to a static width by repeating the upper bound
    (the engines' interpolation treats zero-span segments as their left
    node), keeping the jit-friendly rectangular layout."""
    g = max(int(num_grid_points), 2)
    h = (float(global_max) - float(global_min)) / (g - 1)
    if h <= 0:
        return np.tile(lower[:, None], (1, 2))
    # Width: enough slots for the widest band (count = ceil(span/h) + 1).
    spans = np.asarray(upper, dtype=np.float64) - np.asarray(lower, dtype=np.float64)
    width = int(np.ceil(spans.max() / h - 1e-12)) + 1 if spans.max() > 0 else 1
    width = max(width + 1, 2)  # +1: the capped point at the band upper bound
    num_periods = len(lower)
    grids = np.empty((num_periods, width))
    for t in range(num_periods):
        pts = lower[t] + h * np.arange(width)
        grids[t] = np.minimum(pts, upper[t])
    return grids


# ---------------------------------------------------------------- device side


def ratchet_rates(ratchet_inv, ratchet_min, ratchet_max, is_step: bool, inventory):
    """Vectorised (min_rate, max_rate) lookup at ``inventory``.

    ``ratchet_*`` are [R] node tables for one step; ``inventory`` any shape.
    Linear tables lerp between nodes; step tables take the left node
    (StepInjectWithdrawConstraint.cs:72-79).
    """
    inv = jnp.clip(inventory, ratchet_inv[0], ratchet_inv[-1])
    # Segment index by counting nodes <= inv (tables are tiny, so R vectorised
    # compares replace a searchsorted binary search).
    idx = jnp.zeros(jnp.shape(inv), dtype=jnp.int32)
    for r in range(1, ratchet_inv.shape[0] - 1):
        idx = idx + (inv >= ratchet_inv[r]).astype(jnp.int32)
    if is_step:
        return ratchet_min[idx], ratchet_max[idx]
    x0 = ratchet_inv[idx]
    x1 = ratchet_inv[idx + 1]
    w = jnp.where(x1 > x0, (inv - x0) / jnp.where(x1 > x0, x1 - x0, 1.0), 0.0)
    min_rate = ratchet_min[idx] * (1 - w) + ratchet_min[idx + 1] * w
    max_rate = ratchet_max[idx] * (1 - w) + ratchet_max[idx + 1] * w
    return min_rate, max_rate


def bang_bang_decisions(
    min_rate,
    max_rate,
    inventory,
    loss_pcnt,
    next_min,
    next_max,
    num_extra_decisions: int,
):
    """Fixed-width decision volumes, shape inventory.shape + (D,).

    D = 2*num_extra_decisions + 3.  Mirrors
    ``StorageHelper.CalculateBangBangDecisionSet`` (StorageHelper.cs:109-197):
    the endpoints are the constrained max-withdrawal / max-injection volumes
    (snapped into the next period's feasible band); when the hold decision (0)
    is feasible it sits at the middle slot with extra decisions spread either
    side; when a non-zero decision is forced, interior slots collapse onto the
    feasible segment (slot 1 duplicates the withdrawal endpoint so that the
    zero-extra case reproduces the reference's two-point set exactly).
    """
    inv_after_loss = inventory - loss_pcnt * inventory
    w_target = min_rate + inv_after_loss
    yielded_w = jnp.where(
        w_target > next_max,
        next_max - inv_after_loss,  # tolerance snap (host precompute keeps this tiny)
        jnp.where(w_target > next_min, min_rate, next_min - inv_after_loss),
    )
    i_target = max_rate + inv_after_loss
    yielded_i = jnp.where(
        i_target < next_min,
        next_min - inv_after_loss,
        jnp.where(i_target < next_max, max_rate, next_max - inv_after_loss),
    )
    has_zero = (yielded_w < 0.0) & (yielded_i > 0.0)

    e = num_extra_decisions
    d = 2 * e + 3
    k = jnp.arange(d, dtype=yielded_w.dtype)
    mid = e + 1
    w = yielded_w[..., None]
    i = yielded_i[..., None]
    # With a feasible hold: piecewise [w -> 0 -> i] with 0 at the middle slot.
    frac_lo = k / mid
    frac_hi = (k - mid) / mid
    with_zero = jnp.where(k <= mid, w * (1.0 - frac_lo), i * frac_hi)
    # Forced non-zero: slot 0 and 1 at w, remaining slots spread to i.
    frac = jnp.clip(k - 1.0, 0.0, None) / (d - 2)
    without_zero = w + (i - w) * frac
    return jnp.where(has_zero[..., None], with_zero, without_zero)
