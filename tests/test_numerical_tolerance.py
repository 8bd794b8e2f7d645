"""Resolution of the ``numerical_tolerance`` parameter.

The reference uses ``numericalTolerance`` in exactly two places:

1. ``StorageHelper.CalculateBangBangDecisionSet`` (StorageHelper.cs:122-165):
   when the constrained max-withdrawal/injection overshoots the next period's
   feasible band, a breach smaller than the tolerance is SNAPPED onto the band
   edge; a larger breach throws.  The branchless device kernel
   (``grid.bang_bang_decisions``) snaps unconditionally — equivalent to the
   reference with an infinite snap tolerance.  The throw branch can only be
   reached through band-reduction numerical inconsistency (the reference's own
   comment: "probably due to root finding in PolynomialInjectWithdrawConstraint")
   — in this framework the band reduction is closed-form float64 and the
   inventory grids are built strictly inside the reduced band, so a breach is
   always the tiny-root-finding kind the reference snaps anyway.

2. ``StorageHelper.BisectInventorySpace`` (StorageHelper.cs:280-314):
   equality-within-tolerance when locating an inventory between grid points
   for continuation interpolation.  The branchless ``ops.interp`` weights are
   exact at grid points (weight 0/1 bit-exactly) and clamp outside the grid,
   so no tolerance is needed to avoid an out-of-band error path.

These tests pin the equivalence on the edge cases the tolerance guards, so the
parameter is accepted for API parity and documented as a no-op.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from storage_tpu import grid as gridmod
from storage_tpu.ops import interp


def reference_bang_bang(min_rate, max_rate, inventory, loss, next_min, next_max,
                        tolerance):
    """Straight transcription of the reference's decision-set semantics
    (StorageHelper.cs:109-197), as the test oracle."""
    inv_after_loss = inventory - loss
    after_max_wdr = min_rate + inv_after_loss
    if after_max_wdr > next_max:
        if after_max_wdr - next_max < tolerance:
            yielded_w = next_max - inv_after_loss
        else:
            raise ValueError("Inventory constraints cannot be fulfilled.")
    elif after_max_wdr > next_min:
        yielded_w = min_rate
    else:
        yielded_w = next_min - inv_after_loss
    after_max_inj = max_rate + inv_after_loss
    if after_max_inj < next_min:
        if next_min - after_max_inj < tolerance:
            yielded_i = next_min - inv_after_loss
        else:
            raise ValueError("Inventory constraints cannot be fulfilled.")
    elif after_max_inj < next_max:
        yielded_i = max_rate
    else:
        yielded_i = next_max - inv_after_loss
    if yielded_w >= 0.0 or yielded_i <= 0.0:
        return [yielded_w, yielded_i]
    return [yielded_w, 0.0, yielded_i]


def framework_decisions(min_rate, max_rate, inventory, loss_pcnt, next_min, next_max):
    d = gridmod.bang_bang_decisions(
        jnp.asarray(min_rate), jnp.asarray(max_rate), jnp.asarray(inventory),
        jnp.asarray(loss_pcnt), jnp.asarray(next_min), jnp.asarray(next_max), 0,
    )
    return np.asarray(d)


class TestBangBangToleranceEquivalence:
    """Decision sets at/around the feasible-band edge match the reference."""

    def test_exact_band_edge_max_withdrawal(self):
        # inventoryAfterMaxWithdrawal == nextStepMaxInventory exactly: the
        # reference takes the unconstrained branch (strict >); so does the
        # framework's clip (w_target > next_max is False).
        inv, min_rate, max_rate = 800.0, -300.0, 100.0
        next_min, next_max = 0.0, 500.0  # 800 - 300 == 500 == next_max
        ref = reference_bang_bang(min_rate, max_rate, inv, 0.0, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, 0.0, next_min, next_max)
        assert ref[0] == -300.0
        assert ours[0] == pytest.approx(ref[0], abs=0.0)
        assert ours[-1] == pytest.approx(ref[-1], abs=0.0)

    def test_tiny_breach_is_snapped_like_reference(self):
        # Breach of 1e-13 (inside the reference's default 1e-12 tolerance):
        # both snap the withdrawal onto the band edge.
        inv, min_rate, max_rate = 800.0, -300.0 + 1e-13 + 500.0 - 500.0, 100.0
        next_max = 500.0 - 1e-13  # after-max-withdrawal overshoots by 1e-13
        next_min = 0.0
        ref = reference_bang_bang(min_rate, max_rate, inv, 0.0, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, 0.0, next_min, next_max)
        assert ref[0] == pytest.approx(next_max - inv, abs=0.0)
        assert ours[0] == pytest.approx(ref[0], abs=1e-9)

    def test_large_breach_snaps_where_reference_throws(self):
        # The documented deviation: a breach LARGER than tolerance throws in
        # the reference, snaps in the framework.  Unreachable through the
        # public API (grids are built inside the reduced band — pinned below)
        # but pinned here so the deviation is explicit.
        inv, min_rate, max_rate = 800.0, -100.0, 100.0
        next_min, next_max = 0.0, 500.0  # 800 - 100 = 700 > 500: breach 200
        with pytest.raises(ValueError):
            reference_bang_bang(min_rate, max_rate, inv, 0.0, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, 0.0, next_min, next_max)
        assert ours[0] == pytest.approx(next_max - inv)  # snapped

    def test_exact_band_edge_constrained_injection(self):
        # after-max-injection == next_max: constrained branch on both sides
        # yields the same volume (the two branches coincide at the edge).
        inv, min_rate, max_rate = 100.0, -50.0, 400.0
        next_min, next_max = 0.0, 500.0  # 100 + 400 == 500 == next_max
        ref = reference_bang_bang(min_rate, max_rate, inv, 0.0, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, 0.0, next_min, next_max)
        assert ours[-1] == pytest.approx(ref[-1], abs=0.0) == 400.0

    def test_forced_decision_snap(self):
        # Forced injection (cannot hold): min_rate + inv < next_min forces the
        # "withdrawal" endpoint up to next_min - inv; reference returns a
        # two-point set, framework pads slot 1 with the duplicated endpoint.
        inv, min_rate, max_rate = 0.0, -50.0, 400.0
        next_min, next_max = 100.0, 500.0
        ref = reference_bang_bang(min_rate, max_rate, inv, 0.0, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, 0.0, next_min, next_max)
        assert len(ref) == 2
        assert ours[0] == pytest.approx(ref[0], abs=0.0) == 100.0
        assert ours[1] == pytest.approx(ref[0], abs=0.0)  # duplicated endpoint
        assert ours[2] == pytest.approx(ref[1], abs=0.0) == 400.0

    def test_with_inventory_loss_at_edge(self):
        loss_pcnt = 0.02
        inv = 500.0
        loss = loss_pcnt * inv
        min_rate, max_rate = -(490.0 - loss), 100.0  # after-max-wdr == 490 - loss - ... == 0
        next_min, next_max = 0.0, 600.0
        ref = reference_bang_bang(min_rate, max_rate, inv, loss, next_min, next_max, 1e-12)
        ours = framework_decisions(min_rate, max_rate, inv, loss_pcnt, next_min, next_max)
        assert ours[0] == pytest.approx(ref[0], rel=1e-12)
        assert ours[-1] == pytest.approx(ref[-1], rel=1e-12)


class TestInterpolationNeedsNoTolerance:
    """``BisectInventorySpace``'s tolerance-equality has no analog: the
    branchless weights are exact at nodes and clamped outside."""

    def test_exact_grid_point_weight_is_exact(self):
        grid = jnp.asarray(np.linspace(0.0, 1000.0, 11))
        idx, w = interp.interp_weights(grid, jnp.asarray([300.0]))
        assert int(idx[0]) == 3
        assert float(w[0]) == 0.0

    def test_degenerate_constant_grid(self):
        # Single feasible inventory (band collapsed): constant grid; weights
        # must not divide by zero and interpolation returns the node value.
        grid = jnp.full((5,), 123.0)
        vals = jnp.asarray([7.0, 7.0, 7.0, 7.0, 7.0])
        out = interp.interp_vector(grid, vals, jnp.asarray(123.0))
        assert float(out) == pytest.approx(7.0)

    def test_clamps_outside_grid(self):
        grid = jnp.asarray(np.linspace(0.0, 100.0, 5))
        vals = jnp.asarray([0.0, 1.0, 2.0, 3.0, 4.0])
        below = interp.interp_vector(grid, vals, jnp.asarray(-1e-9))
        above = interp.interp_vector(grid, vals, jnp.asarray(100.0 + 1e-9))
        assert float(below) == pytest.approx(0.0)
        assert float(above) == pytest.approx(4.0)


class TestTypedExceptionParity:
    """Constraint-level inverse solvers raise the same typed exception as the
    band reduction (StorageHelper.cs:101-102)."""

    def test_piecewise_linear_inverse_raises_typed(self):
        from storage_tpu import InventoryConstraintsCannotBeFulfilledException
        from storage_tpu.constraints import PiecewiseLinearInjectWithdrawConstraint

        nodes = [(0.0, -10.0, 40.0), (1000.0, -50.0, 20.0)]
        c = PiecewiseLinearInjectWithdrawConstraint(nodes)
        # next_upper below anything reachable even by max withdrawal from the
        # lowest inventory: no solution.
        with pytest.raises(InventoryConstraintsCannotBeFulfilledException):
            c.inventory_space_upper_bound(-100.0, -50.0, 0.0, 1000.0, 0.0)

    def test_step_inverse_raises_typed(self):
        from storage_tpu import InventoryConstraintsCannotBeFulfilledException
        from storage_tpu.constraints import StepInjectWithdrawConstraint

        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -30.0, 30.0)]
        c = StepInjectWithdrawConstraint(nodes)
        with pytest.raises(InventoryConstraintsCannotBeFulfilledException):
            c.inventory_space_upper_bound(-100.0, -50.0, 0.0, 1000.0, 0.0)

    def test_ratcheted_facility_infeasible_raises_typed_both_paths(self):
        import pandas as pd
        from storage_tpu import (
            CmdtyStorage,
            InventoryConstraintsCannotBeFulfilledException,
            RatchetInterp,
        )
        from storage_tpu.grid import calculate_inventory_space

        # Must-be-empty storage that cannot be emptied: max withdrawal rate
        # too small over the remaining horizon.
        ratchets = [
            ("2021-01-01", [(0.0, -5.0, 50.0), (1000.0, -5.0, 50.0)]),
        ]
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-01-10", 1.2, 0.9,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        )
        for use_native in (False, None):
            with pytest.raises(InventoryConstraintsCannotBeFulfilledException):
                calculate_inventory_space(
                    storage, 900.0, pd.Period("2021-01-01", freq="D"),
                    use_native=use_native,
                )
