"""Intrinsic storage valuation: deterministic DP on the forward curve.

Accelerator re-design of ``IntrinsicStorageValuation`` (reference
``IntrinsicValuation/IntrinsicStorageValuation.cs:120-322``): a ``lax.scan``
backward over time with the inventory grid vmapped, linear
interpolation of the continuation value in inventory, and a forward scan
re-deriving the optimal decision profile.  All facility data arrives as dense
per-step arrays (``facility.CompiledStorage``); there are no delegates or
per-period Python objects inside the scan.
"""
from __future__ import annotations

import typing as tp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import grid as gridmod
from ..facility import CompiledStorage
from ..ops import interp


class IntrinsicEngineResult(tp.NamedTuple):
    npv: jnp.ndarray  # scalar
    inventory: jnp.ndarray  # [N+1] inventory after each period's decision (end: final)
    inject_withdraw: jnp.ndarray  # [N+1] (end: 0)
    cmdty_consumed: jnp.ndarray  # [N+1]
    inventory_loss: jnp.ndarray  # [N+1]
    period_pv: jnp.ndarray  # [N+1] (end: terminal pv)


def immediate_pv(
    decision,
    inventory,
    price,
    df_settle,
    df_flow,
    inj_cost,
    wdr_cost,
    inj_pcnt,
    wdr_pcnt,
    inv_cost_rate,
):
    """Present value of one period's cash flows for a decision volume.

    Mirrors ``StorageHelper.StorageImmediateNpvForDecision``
    (StorageHelper.cs:224-248) plus the inventory-cost term: the commodity leg
    settles on the settlement date, operating costs on the period start day.
    Returns (pv, consumed_volume).
    """
    is_inject = decision > 0.0
    cost_rate = jnp.where(is_inject, inj_cost, wdr_cost)
    consumed_pcnt = jnp.where(is_inject, inj_pcnt, wdr_pcnt)
    abs_decision = jnp.abs(decision)
    consumed = consumed_pcnt * abs_decision
    iw_npv = -decision * price * df_settle
    cost_npv = cost_rate * abs_decision * df_flow
    consumed_npv = -consumed * price * df_settle
    inv_cost_npv = inv_cost_rate * inventory * df_flow
    return iw_npv - cost_npv + consumed_npv - inv_cost_npv, consumed


def _step_inputs(c: tp.Dict[str, jnp.ndarray], t_slice):
    return {k: v[t_slice] for k, v in c.items()}


@partial(
    jax.jit,
    static_argnames=(
        "num_extra_decisions", "terminal_fn", "ratchet_is_step", "interpolation",
        "uniform_grids",
    ),
)
def _intrinsic_core(
    arrays: tp.Dict[str, jnp.ndarray],
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
):
    if interpolation not in ("linear", "cubic"):
        raise ValueError("interpolation must be 'linear' or 'cubic'.")
    if not uniform_grids and interpolation == "cubic":
        raise ValueError(
            "cubic interpolation requires the (uniform) linspace grid scheme."
        )
    cubic_solver = (
        interp.natural_cubic_solver(arrays["grids"].shape[1])
        if interpolation == "cubic"
        else None
    )
    grids = arrays["grids"]  # [N+1, G]
    fwd = arrays["fwd"]  # [N+1]
    lower = arrays["lower"]  # [N+1]
    upper = arrays["upper"]  # [N+1]
    n = grids.shape[0] - 1

    if terminal_fn is None:
        v_end = jnp.zeros_like(grids[n])
    else:
        # Broadcast: user terminal functions may return scalars.
        v_end = jnp.broadcast_to(
            jnp.asarray(terminal_fn(fwd[n], grids[n]), grids.dtype), grids[n].shape
        )

    per_step = {
        "grid": grids[:n],
        "grid_next": grids[1:],
        "next_min": lower[1:],
        "next_max": upper[1:],
        "fwd": fwd[:n],
        "df_settle": arrays["df_settle"],
        "df_flow": arrays["df_flow"],
        "inj_cost": arrays["inj_cost"],
        "wdr_cost": arrays["wdr_cost"],
        "inj_pcnt": arrays["inj_pcnt"],
        "wdr_pcnt": arrays["wdr_pcnt"],
        "loss_pcnt": arrays["loss_pcnt"],
        "inv_cost_rate": arrays["inv_cost_rate"],
        "ratchet_inv": arrays["ratchet_inv"],
        "ratchet_min": arrays["ratchet_min"],
        "ratchet_max": arrays["ratchet_max"],
    }

    def decision_values(x, inventory, v_next_grid):
        """Optimal decision at ``inventory`` (any shape) for one period."""
        min_rate, max_rate = gridmod.ratchet_rates(
            x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, inventory
        )
        decisions = gridmod.bang_bang_decisions(
            min_rate,
            max_rate,
            inventory,
            x["loss_pcnt"],
            x["next_min"],
            x["next_max"],
            num_extra_decisions,
        )  # inventory.shape + (D,)
        pv, consumed = immediate_pv(
            decisions,
            inventory[..., None],
            x["fwd"],
            x["df_settle"],
            x["df_flow"],
            x["inj_cost"],
            x["wdr_cost"],
            x["inj_pcnt"],
            x["wdr_pcnt"],
            x["inv_cost_rate"],
        )
        loss = x["loss_pcnt"] * inventory
        inv_after = inventory[..., None] + decisions - loss[..., None]
        if interpolation == "cubic":
            # Natural cubic spline in inventory — the reference's alternative
            # interpolator (documented as occasionally ill-behaved,
            # IntrinsicStorageValuationExtensions.cs:127-139).
            moments = interp.cubic_moments(
                x["grid_next"], v_next_grid, cubic_solver.astype(v_next_grid.dtype)
            )
            continuation = interp.interp_vector_cubic(
                x["grid_next"], v_next_grid, moments, inv_after
            )
        elif uniform_grids:
            continuation = interp.interp_vector(x["grid_next"], v_next_grid, inv_after)
        else:
            # Fixed-spacing grids are non-uniform (capped + padded at the band
            # upper bound) — general segment search.
            continuation = interp.interp_vector_general(
                x["grid_next"], v_next_grid, inv_after
            )
        total = pv + continuation
        best = jnp.argmax(total, axis=-1)
        take = lambda a: jnp.take_along_axis(a, best[..., None], axis=-1)[..., 0]
        return (
            jnp.max(total, axis=-1),
            take(decisions),
            take(consumed),
            take(pv),
            loss,
        )

    def backward_step(v_next, x):
        value, _, _, _, _ = decision_values(x, x["grid"], v_next)
        return value, value

    # Backward over t = N-1 .. 1 (t = 0 handled by the forward pass from the
    # single known starting inventory, as in IntrinsicStorageValuation.cs:191-216).
    if n > 1:
        _, vs_mid = jax.lax.scan(
            backward_step, v_end, _step_inputs(per_step, slice(1, n)), reverse=True
        )
        vs = jnp.concatenate([jnp.zeros_like(v_end)[None], vs_mid, v_end[None]], axis=0)
    else:
        vs = jnp.stack([jnp.zeros_like(v_end), v_end], axis=0)

    def forward_step(inventory, x):
        _, decision, consumed, pv, loss = decision_values(
            x, inventory[None], x["v_next"]
        )
        decision, consumed, pv, loss = decision[0], consumed[0], pv[0], loss[0]
        new_inventory = inventory + decision - loss
        return new_inventory, (new_inventory, decision, consumed, loss, pv)

    fwd_inputs = dict(per_step)
    fwd_inputs["v_next"] = vs[1:]
    inv0 = jnp.asarray(starting_inventory, dtype=grids.dtype)
    final_inv, (inv_path, decisions, consumed, losses, pvs) = jax.lax.scan(
        forward_step, inv0, fwd_inputs
    )

    end_pv = (
        jnp.zeros(())
        if terminal_fn is None
        else jnp.broadcast_to(jnp.asarray(terminal_fn(fwd[n], final_inv)), ())
    ).astype(grids.dtype)
    npv = jnp.sum(pvs) + end_pv
    zero = jnp.zeros((1,), dtype=grids.dtype)
    return IntrinsicEngineResult(
        npv=npv,
        inventory=jnp.concatenate([inv_path, final_inv[None]]),
        inject_withdraw=jnp.concatenate([decisions, zero]),
        cmdty_consumed=jnp.concatenate([consumed, zero]),
        inventory_loss=jnp.concatenate([losses, zero]),
        period_pv=jnp.concatenate([pvs, end_pv[None]]),
    )


def intrinsic_valuation(
    compiled: CompiledStorage,
    starting_inventory: float,
    fwd: np.ndarray,
    df_settle: np.ndarray,
    df_flow: np.ndarray,
    inventory_lower: np.ndarray,
    inventory_upper: np.ndarray,
    num_grid_points: int = 100,
    num_extra_decisions: int = 0,
    dtype=jnp.float32,
    interpolation: str = "linear",
    grid_scheme: str = "linspace",
    grid_calc=None,
) -> IntrinsicEngineResult:
    """Run the intrinsic DP.  Inputs are host arrays from the precompute stage.

    ``grid_scheme``: 'linspace' (default; per-band linspace, uniform rows) or
    'fixed_spacing' (the reference's FixedSpacingStateSpaceGridCalc layout —
    global-range spacing from the band lower bound, capped at the upper; use
    for exact per-period decision parity with the reference's intrinsic
    profiles, tests/test_reference_goldens.py).  ``grid_calc``: user callable
    ``(lower, upper) -> points`` applied per period (the reference's open
    ``IDoubleStateSpaceGridCalc`` extension point,
    IDoubleStateSpaceGridCalc.cs:32); overrides ``grid_scheme``."""
    if grid_calc is not None:
        if interpolation == "cubic":
            raise ValueError(
                "cubic interpolation requires the (uniform) linspace grid scheme."
            )
        grids = gridmod.inventory_grids_custom(
            inventory_lower, inventory_upper, grid_calc
        )
        grid_scheme = "custom"
    elif grid_scheme == "linspace":
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
    elif grid_scheme == "fixed_spacing":
        grids = gridmod.inventory_grids_fixed_spacing(
            inventory_lower, inventory_upper,
            float(np.min(compiled.min_inv)), float(np.max(compiled.max_inv)),
            num_grid_points,
        )
    else:
        raise ValueError("grid_scheme must be 'linspace' or 'fixed_spacing'.")
    arrays = {
        "grids": jnp.asarray(grids, dtype),
        "fwd": jnp.asarray(fwd, dtype),
        "lower": jnp.asarray(inventory_lower, dtype),
        "upper": jnp.asarray(inventory_upper, dtype),
        "df_settle": jnp.asarray(df_settle, dtype),
        "df_flow": jnp.asarray(df_flow, dtype),
        "inj_cost": jnp.asarray(compiled.inj_cost, dtype),
        "wdr_cost": jnp.asarray(compiled.wdr_cost, dtype),
        "inj_pcnt": jnp.asarray(compiled.inj_consumed_pcnt, dtype),
        "wdr_pcnt": jnp.asarray(compiled.wdr_consumed_pcnt, dtype),
        "loss_pcnt": jnp.asarray(compiled.loss_pcnt, dtype),
        "inv_cost_rate": jnp.asarray(compiled.inv_cost_rate, dtype),
        "ratchet_inv": jnp.asarray(compiled.ratchet_inv, dtype),
        "ratchet_min": jnp.asarray(compiled.ratchet_min, dtype),
        "ratchet_max": jnp.asarray(compiled.ratchet_max, dtype),
    }
    terminal_fn = compiled.engine_terminal_fn
    return _intrinsic_core(
        arrays,
        jnp.asarray(starting_inventory, dtype),
        num_extra_decisions,
        terminal_fn,
        compiled.ratchet_is_step,
        interpolation,
        uniform_grids=(grid_scheme == "linspace"),
    )
