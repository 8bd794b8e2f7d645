"""Trinomial-tree storage valuation: backward induction over (price node x
inventory grid).

Re-design of ``TreeStorageValuation`` (reference
``TreeValuation/TreeStorageValuation.cs:143-342``): a ``lax.scan`` backward
over time, vmapped over tree node levels, with the expected continuation value
formed as the probability-weighted mix of the three destination rows before a
single linear interpolation in inventory (linear interp commutes with the
convex combination because all destinations share the period's grid).
"""
from __future__ import annotations

import typing as tp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import grid as gridmod
from ..facility import CompiledStorage
from ..models.trinomial_tree import TrinomialTree
from ..ops import interp
from .intrinsic import immediate_pv


class TreeEngineResult(tp.NamedTuple):
    npv: jnp.ndarray
    values: tp.Optional[jnp.ndarray] = None  # [N+1, M, G] when collected


class TreeSimulationResult(tp.NamedTuple):
    """Decisions simulated along one path of branch choices (analog of
    ``TreeStorageValuation.SimulateDecisions``, TreeStorageValuation.cs:344-433)."""

    npv: jnp.ndarray
    decisions: jnp.ndarray  # [N]
    cmdty_consumed: jnp.ndarray  # [N]
    inventory: jnp.ndarray  # [N] inventory after each decision
    node_path: jnp.ndarray  # [N+1] node level visited per period




def _cont_interp(interpolation: str, uniform_grids: bool, cubic_solver):
    """Continuation interpolator for a single value row [G] at targets [...]:
    linear (uniform or general compare-count) or natural cubic (uniform
    grids only)."""
    if interpolation == "cubic":
        def f(grid, ev_row, targets):
            moments = interp.cubic_moments(grid, ev_row, cubic_solver)
            return interp.interp_vector_cubic(grid, ev_row, moments, targets)
        return f
    if uniform_grids:
        return interp.interp_vector
    return interp.interp_vector_general

@partial(
    jax.jit,
    static_argnames=(
        "num_extra_decisions", "terminal_fn", "ratchet_is_step", "interpolation",
        "uniform_grids",
    ),
)
def _tree_core(
    arrays: tp.Dict[str, jnp.ndarray],
    tree: tp.Dict[str, jnp.ndarray],
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
):
    grids = arrays["grids"]  # [N+1, G]
    n = grids.shape[0] - 1
    m = tree["spot"].shape[1]

    # Terminal values per (node, grid point) — TreeStorageValuation.cs:186-196.
    if terminal_fn is None:
        v_end = jnp.zeros((m, grids.shape[1]), grids.dtype)
    else:
        v_end = jnp.broadcast_to(
            jnp.asarray(
                terminal_fn(tree["spot"][n][:, None], grids[n][None, :]), grids.dtype
            ),
            (m, grids.shape[1]),
        )

    per_step = {
        "grid": grids[:n],
        "grid_next": grids[1:],
        "next_min": arrays["lower"][1:],
        "next_max": arrays["upper"][1:],
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
        "spot": tree["spot"][:n],  # [N, M]
        "transition": tree["transition"][:n],  # [N, M, M]
    }

    if interpolation not in ("linear", "cubic"):
        raise ValueError("interpolation must be 'linear' or 'cubic'.")
    cubic_solver = (
        interp.natural_cubic_solver(grids.shape[1])
        if interpolation == "cubic"
        else None
    )
    cont_interp = _cont_interp(interpolation, uniform_grids, cubic_solver)

    def backward_step(v_next, x):
        # Expected continuation rows per node (TreeStorageValuation.cs:325-330),
        # as one dense [M, M] x [M, G] matmul.
        # precision=HIGHEST: the GPU's default f32 matmul rounds operands to
        # TF32, and that error compounds over the backward induction; this
        # matrix is tiny so full f32 passes are free.
        ev = jnp.dot(
            x["transition"], v_next,
            preferred_element_type=v_next.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )

        grid_t = x["grid"]
        min_rate, max_rate = gridmod.ratchet_rates(
            x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, grid_t
        )
        decisions = gridmod.bang_bang_decisions(
            min_rate, max_rate, grid_t, x["loss_pcnt"], x["next_min"], x["next_max"],
            num_extra_decisions,
        )  # [G, D]
        loss = x["loss_pcnt"] * grid_t
        inv_after = grid_t[:, None] + decisions - loss[:, None]  # [G, D]

        pv, _consumed = immediate_pv(
            decisions[None, :, :],  # [1, G, D] broadcast over nodes
            grid_t[None, :, None],
            x["spot"][:, None, None],  # [M, 1, 1]
            x["df_settle"],
            x["df_flow"],
            x["inj_cost"],
            x["wdr_cost"],
            x["inj_pcnt"],
            x["wdr_pcnt"],
            x["inv_cost_rate"],
        )  # [M, G, D]
        # Per-node continuation interpolation: linear (the default; general
        # compare-count form for non-uniform user grids) or natural cubic
        # (the reference's NaturalCubicSplineInterpolatorFactory,
        # InterpolatorFactories/IInterpolatorFactory.cs:33-37, documented
        # there as occasionally poorly behaved).
        cont = jax.vmap(
            lambda ev_row: cont_interp(x["grid_next"], ev_row, inv_after)
        )(ev)  # [M, G, D]
        value = jnp.max(pv + cont, axis=-1)  # [M, G]
        return value, value

    v0, collected = jax.lax.scan(backward_step, v_end, per_step, reverse=True)
    # NPV = Σ_nodes q_0 x value at the single known starting inventory
    # (grid[0] is degenerate) — TreeStorageValuation.cs:272-280.
    npv = jnp.sum(tree["q0"] * v0[:, 0])
    values = jnp.concatenate([collected, v_end[None]], axis=0)  # [N+1, M, G]
    return TreeEngineResult(npv=npv, values=values)


def tree_valuation(
    compiled: CompiledStorage,
    tree: TrinomialTree,
    tree_offset: int,
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
    grid_calc=None,
) -> TreeEngineResult:
    """Run the tree DP.  ``tree_offset`` aligns the tree (built from the
    valuation period) with the active storage window.

    ``interpolation``: 'linear' (default) or 'cubic' (natural cubic spline in
    inventory — the reference's ``NaturalCubicSplineInterpolatorFactory``).
    ``grid_calc``: optional callable ``(lower, upper) -> grid points`` applied
    per period (the ``IDoubleStateSpaceGridCalc.GetGridPoints`` analog,
    IDoubleStateSpaceGridCalc.cs:32); cubic requires the uniform linspace
    grid."""
    if grid_calc is not None:
        if interpolation == "cubic":
            raise ValueError(
                "cubic interpolation requires the uniform linspace grid "
                "(grid_calc must be None)."
            )
        grids = gridmod.inventory_grids_custom(
            inventory_lower, inventory_upper, grid_calc
        )
        uniform_grids = gridmod.rows_uniform(grids)
    else:
        grids = gridmod.inventory_grids(
            inventory_lower, inventory_upper, num_grid_points
        )
        uniform_grids = True
    arrays = {
        "grids": jnp.asarray(grids, dtype),
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
    o = tree_offset
    num_periods = compiled.num_steps + 1
    tree_arrays = {
        "spot": jnp.asarray(tree.spot[o : o + num_periods], dtype),
        "transition": jnp.asarray(tree.transition[o : o + num_periods - 1], dtype),
        "q0": jnp.asarray(tree.q[o], dtype),
        "dest_centre": jnp.asarray(tree.dest_centre),
    }
    terminal_fn = compiled.engine_terminal_fn
    return _tree_core(
        arrays,
        tree_arrays,
        jnp.asarray(starting_inventory, dtype),
        num_extra_decisions,
        terminal_fn,
        compiled.ratchet_is_step,
        interpolation=interpolation,
        uniform_grids=uniform_grids,
    ), arrays, tree_arrays


@partial(
    jax.jit,
    static_argnames=(
        "num_extra_decisions", "terminal_fn", "ratchet_is_step", "interpolation",
        "uniform_grids",
    ),
)
def simulate_tree_decisions(
    arrays: tp.Dict[str, jnp.ndarray],
    tree: tp.Dict[str, jnp.ndarray],
    values: jnp.ndarray,  # [N+1, M, G] from the valuation
    transition_path: jnp.ndarray,  # [N] branch indices in {0, 1, 2}
    starting_inventory,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    interpolation: str = "linear",
    uniform_grids: bool = True,
) -> TreeSimulationResult:
    """Follow a path of branch choices through the tree, at each period taking
    the DP-optimal decision given the visited node and current inventory
    (TreeStorageValuation.cs:344-433).  ``interpolation``/``uniform_grids``
    must match the valuation that produced ``values`` so the simulator reads
    the same continuation surface."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    m = tree["spot"].shape[1]
    dtype = grids.dtype
    num_decisions = 2 * num_extra_decisions + 3
    cubic_solver = (
        interp.natural_cubic_solver(grids.shape[1])
        if interpolation == "cubic"
        else None
    )
    cont_interp = _cont_interp(interpolation, uniform_grids, cubic_solver)

    per_step = {
        "grid_next": grids[1:],
        "next_min": arrays["lower"][1:],
        "next_max": arrays["upper"][1:],
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
        "spot": tree["spot"][:n],
        "transition": tree["transition"][:n],
        "v_next": values[1:],  # [N, M, G]
        "branch": transition_path,
    }

    def step(carry, x):
        node, inventory, npv = carry
        spot = x["spot"][node]
        ev = jnp.dot(
            x["transition"][node], x["v_next"],
            preferred_element_type=dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # [G] expected continuation over branch outcomes
        min_rate, max_rate = gridmod.ratchet_rates(
            x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, inventory
        )
        decisions = gridmod.bang_bang_decisions(
            min_rate, max_rate, inventory, x["loss_pcnt"], x["next_min"], x["next_max"],
            num_extra_decisions,
        )  # [D]
        pv, consumed = immediate_pv(
            decisions, inventory, spot, x["df_settle"], x["df_flow"], x["inj_cost"],
            x["wdr_cost"], x["inj_pcnt"], x["wdr_pcnt"], x["inv_cost_rate"],
        )
        loss = x["loss_pcnt"] * inventory
        inv_after = inventory + decisions - loss
        cont = cont_interp(x["grid_next"], ev, inv_after)
        best = jnp.argmax(pv + cont, axis=-1)
        onehot = (best == jnp.arange(num_decisions)).astype(dtype)
        opt_pv = jnp.sum(pv * onehot)
        opt_decision = jnp.sum(decisions * onehot)
        opt_consumed = jnp.sum(consumed * onehot)
        new_inventory = inventory + opt_decision - loss
        # Node evolution along the chosen branch: centre destination +/- 1.
        dest = jnp.take(tree["dest_centre"], node) + x["branch"] - 1
        new_node = jnp.clip(dest, 0, m - 1)
        return (new_node, new_inventory, npv + opt_pv), (
            opt_decision, opt_consumed, new_inventory, new_node,
        )

    node0 = jnp.asarray(m // 2)
    inv0 = jnp.asarray(starting_inventory, dtype)
    (final_node, final_inv, npv), (decisions, consumed, inventory, nodes) = jax.lax.scan(
        step, (node0, inv0, jnp.zeros((), dtype)), per_step
    )
    if terminal_fn is not None:
        npv = npv + jnp.asarray(terminal_fn(tree["spot"][n][final_node], final_inv), dtype)
    return TreeSimulationResult(
        npv=npv,
        decisions=decisions,
        cmdty_consumed=consumed,
        inventory=inventory,
        node_path=jnp.concatenate([node0[None], nodes]),
    )
