"""Facility model + constraint tests.

Coverage modelled on the reference's ``CmdtyStorageBuilderTest.cs`` /
``test_cmdty_storage.py`` wrapper-mapping tests and the constraint unit tests
(``PiecewiseLinearInjectWithdrawConstraintTest.cs`` etc.): constructor argument
validation, rate queries, cost queries, and the constraints' inverse problems.
"""
import numpy as np
import pandas as pd
import pytest

from storage_tpu import CmdtyStorage, RatchetInterp
from storage_tpu.constraints import (
    ConstantInjectWithdrawConstraint,
    PiecewiseLinearInjectWithdrawConstraint,
    PolynomialInjectWithdrawConstraint,
    StepInjectWithdrawConstraint,
)


def simple_storage(**kwargs):
    defaults = dict(
        freq="D",
        storage_start="2021-01-01",
        storage_end="2021-02-01",
        injection_cost=1.5,
        withdrawal_cost=0.8,
        min_inventory=0.0,
        max_inventory=1000.0,
        max_injection_rate=50.0,
        max_withdrawal_rate=70.0,
    )
    defaults.update(kwargs)
    return CmdtyStorage(**defaults)


class TestCmdtyStorageConstruction:
    def test_start_before_end_required(self):
        with pytest.raises(ValueError, match="before end"):
            simple_storage(storage_start="2021-02-01", storage_end="2021-01-01")

    def test_unsupported_freq_raises(self):
        with pytest.raises(ValueError, match="freq"):
            simple_storage(freq="W")

    def test_ratchets_and_min_inventory_mutually_exclusive(self):
        ratchets = [("2021-01-01", [(0.0, -70.0, 50.0), (1000.0, -70.0, 50.0)])]
        with pytest.raises(ValueError, match="min_inventory"):
            CmdtyStorage(
                "D",
                "2021-01-01",
                "2021-02-01",
                1.5,
                0.8,
                ratchets=ratchets,
                ratchet_interp=RatchetInterp.LINEAR,
                min_inventory=0.0,
            )

    def test_ratchet_interp_required_with_ratchets(self):
        ratchets = [("2021-01-01", [(0.0, -70.0, 50.0), (1000.0, -70.0, 50.0)])]
        with pytest.raises(ValueError, match="ratchet_interp"):
            CmdtyStorage("D", "2021-01-01", "2021-02-01", 1.5, 0.8, ratchets=ratchets)

    def test_ratchet_interp_without_ratchets_raises(self):
        with pytest.raises(ValueError, match="ratchet_interp"):
            simple_storage(ratchet_interp=RatchetInterp.LINEAR)

    def test_missing_max_inventory_raises(self):
        with pytest.raises(ValueError, match="max_inventory"):
            CmdtyStorage(
                "D", "2021-01-01", "2021-02-01", 1.5, 0.8,
                min_inventory=0.0, max_injection_rate=5.0, max_withdrawal_rate=5.0,
            )

    def test_step_ratchets_require_terminal_npv(self):
        ratchets = [("2021-01-01", [(0.0, -70.0, 50.0), (500.0, -70.0, 50.0), (1000.0, -70.0, 50.0)])]
        with pytest.raises(ValueError, match="terminal_storage_npv"):
            CmdtyStorage(
                "D", "2021-01-01", "2021-02-01", 1.5, 0.8,
                ratchets=ratchets, ratchet_interp=RatchetInterp.STEP,
            )

    def test_properties(self):
        storage = simple_storage()
        assert storage.freq == "D"
        assert storage.start == pd.Period("2021-01-01", freq="D")
        assert storage.end == pd.Period("2021-02-01", freq="D")
        assert storage.empty_at_end

    def test_terminal_npv_means_not_empty_at_end(self):
        storage = simple_storage(terminal_storage_npv=lambda price, inv: price * inv)
        assert not storage.empty_at_end
        assert storage.terminal_storage_npv(10.0, 5.0) == 50.0
        assert storage.max_inventory("2021-02-01") == 1000.0

    def test_must_be_empty_zeroes_end_max_inventory(self):
        storage = simple_storage()
        assert storage.max_inventory("2021-02-01") == 0.0
        assert storage.max_inventory("2021-01-31") == 1000.0


class TestCmdtyStorageQueries:
    def test_constant_rates(self):
        storage = simple_storage()
        rng = storage.inject_withdraw_range("2021-01-10", 500.0)
        assert rng.min_inject_withdraw_rate == -70.0
        assert rng.max_inject_withdraw_rate == 50.0

    def test_rates_zero_at_end_period(self):
        storage = simple_storage(terminal_storage_npv=lambda p, i: 0.0)
        rng = storage.inject_withdraw_range("2021-02-01", 500.0)
        assert rng == (0.0, 0.0)

    def test_inventory_validation(self):
        storage = simple_storage()
        with pytest.raises(ValueError, match="below minimum"):
            storage.inject_withdraw_range("2021-01-10", -1.0)
        with pytest.raises(ValueError, match="above maximum"):
            storage.inject_withdraw_range("2021-01-10", 1001.0)

    def test_series_valued_rates(self):
        idx = pd.period_range("2021-01-01", "2021-01-31", freq="D")
        inj = pd.Series(index=idx, data=np.linspace(10, 40, len(idx)))
        storage = simple_storage(max_injection_rate=inj)
        rng = storage.inject_withdraw_range("2021-01-01", 0.0)
        assert rng.max_inject_withdraw_rate == pytest.approx(10.0)

    def test_costs(self):
        storage = simple_storage(
            cmdty_consumed_inject=0.01,
            cmdty_consumed_withdraw=0.02,
            inventory_loss=0.001,
            inventory_cost=0.05,
        )
        assert storage.injection_cost("2021-01-05", 100.0, 10.0) == pytest.approx(15.0)
        assert storage.withdrawal_cost("2021-01-05", 100.0, 10.0) == pytest.approx(8.0)
        assert storage.cmdty_consumed_inject("2021-01-05", 100.0, 10.0) == pytest.approx(0.1)
        assert storage.cmdty_consumed_withdraw("2021-01-05", 100.0, 10.0) == pytest.approx(0.2)
        assert storage.inventory_pcnt_loss("2021-01-05") == pytest.approx(0.001)
        assert storage.inventory_cost("2021-01-05", 100.0) == pytest.approx(5.0)

    def test_ratchet_rates_interpolated(self):
        ratchets = [
            ("2021-01-01", [(0.0, -10.0, 40.0), (1000.0, -50.0, 20.0)]),
        ]
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01", 1.5, 0.8,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        )
        rng = storage.inject_withdraw_range("2021-01-10", 500.0)
        assert rng.min_inject_withdraw_rate == pytest.approx(-30.0)
        assert rng.max_inject_withdraw_rate == pytest.approx(30.0)

    def test_ratchets_forward_fill_in_time(self):
        ratchets = [
            ("2021-01-01", [(0.0, -10.0, 40.0), (1000.0, -10.0, 40.0)]),
            ("2021-01-15", [(0.0, -99.0, 88.0), (1000.0, -99.0, 88.0)]),
        ]
        storage = CmdtyStorage(
            "D", "2021-01-01", "2021-02-01", 1.5, 0.8,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        )
        assert storage.inject_withdraw_range("2021-01-14", 10.0).max_inject_withdraw_rate == 40.0
        assert storage.inject_withdraw_range("2021-01-15", 10.0).max_inject_withdraw_rate == 88.0
        assert storage.inject_withdraw_range("2021-01-31", 10.0).max_inject_withdraw_rate == 88.0


class TestConstraints:
    def test_constant_inverse_bounds(self):
        c = ConstantInjectWithdrawConstraint(-70.0, 50.0)
        # From inventory v: next in [v - 70, v + 50]; to be able to get down to
        # next_upper=500, v <= 570.
        assert c.inventory_space_upper_bound(0.0, 500.0, 0.0, 1000.0, 0.0) == pytest.approx(570.0)
        # To be able to reach next_lower=400 upward, v >= 350.
        assert c.inventory_space_lower_bound(400.0, 1000.0, 0.0, 1000.0, 0.0) == pytest.approx(350.0)
        # Clamped by current period physical limits.
        assert c.inventory_space_upper_bound(0.0, 990.0, 0.0, 1000.0, 0.0) == pytest.approx(1000.0)
        assert c.inventory_space_lower_bound(10.0, 1000.0, 0.0, 1000.0, 0.0) == pytest.approx(0.0)

    def test_constant_inverse_bounds_with_loss(self):
        c = ConstantInjectWithdrawConstraint(-70.0, 50.0)
        loss = 0.02
        ub = c.inventory_space_upper_bound(0.0, 500.0, 0.0, 1000.0, loss)
        assert ub * (1 - loss) - 70.0 == pytest.approx(500.0)

    def test_piecewise_linear_forward(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -50.0, 20.0)]
        c = PiecewiseLinearInjectWithdrawConstraint(nodes)
        rng = c.get_inject_withdraw_range(250.0)
        assert rng.min_inject_withdraw_rate == pytest.approx(-20.0)
        assert rng.max_inject_withdraw_rate == pytest.approx(35.0)

    def test_piecewise_linear_inverse_roundtrip(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -50.0, 20.0)]
        c = PiecewiseLinearInjectWithdrawConstraint(nodes)
        # Inverse-upper: find v such that v + min_rate(v) == next_upper.
        next_upper = 300.0
        v = c.inventory_space_upper_bound(0.0, next_upper, 0.0, 1000.0, 0.0)
        rng = c.get_inject_withdraw_range(v)
        assert v + rng.min_inject_withdraw_rate == pytest.approx(next_upper)
        # Inverse-lower: find v such that v + max_rate(v) == next_lower.
        next_lower = 700.0
        v = c.inventory_space_lower_bound(next_lower, 1000.0, 0.0, 1000.0, 0.0)
        rng = c.get_inject_withdraw_range(v)
        assert v + rng.max_inject_withdraw_rate == pytest.approx(next_lower)

    def test_piecewise_linear_no_solve_needed(self):
        nodes = [(0.0, -10.0, 40.0), (1000.0, -50.0, 20.0)]
        c = PiecewiseLinearInjectWithdrawConstraint(nodes)
        assert c.inventory_space_upper_bound(0.0, 2000.0, 0.0, 1000.0, 0.0) == 1000.0
        assert c.inventory_space_lower_bound(0.0, 2000.0, 0.0, 1000.0, 0.0) == 0.0

    def test_step_constraint_lookup(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -30.0, 30.0)]
        c = StepInjectWithdrawConstraint(nodes)
        assert c.get_inject_withdraw_range(499.0).max_inject_withdraw_rate == 40.0
        assert c.get_inject_withdraw_range(500.0).max_inject_withdraw_rate == 30.0
        assert c.get_inject_withdraw_range(1000.0).max_inject_withdraw_rate == 30.0
        with pytest.raises(ValueError, match="outside"):
            c.get_inject_withdraw_range(1001.0)

    def test_step_constraint_validation(self):
        with pytest.raises(ValueError, match="Top two"):
            StepInjectWithdrawConstraint([(0.0, -10.0, 40.0), (1000.0, -30.0, 30.0)])
        with pytest.raises(ValueError, match="cannot increase"):
            StepInjectWithdrawConstraint(
                [(0.0, -10.0, 20.0), (500.0, -10.0, 40.0), (1000.0, -10.0, 40.0)]
            )

    def test_step_inverse_roundtrip(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -30.0, 30.0)]
        c = StepInjectWithdrawConstraint(nodes)
        v = c.inventory_space_upper_bound(0.0, 300.0, 0.0, 1000.0, 0.0)
        rng = c.get_inject_withdraw_range(v)
        assert v + rng.min_inject_withdraw_rate == pytest.approx(300.0)

    def test_polynomial_exact_through_nodes(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -50.0, 10.0)]
        c = PolynomialInjectWithdrawConstraint(nodes)
        for inv, mn, mx in nodes:
            rng = c.get_inject_withdraw_range(inv)
            assert rng.min_inject_withdraw_rate == pytest.approx(mn, abs=1e-8)
            assert rng.max_inject_withdraw_rate == pytest.approx(mx, abs=1e-8)

    def test_polynomial_inverse_roundtrip(self):
        nodes = [(0.0, -10.0, 40.0), (500.0, -30.0, 30.0), (1000.0, -50.0, 10.0)]
        c = PolynomialInjectWithdrawConstraint(nodes)
        v = c.inventory_space_upper_bound(0.0, 400.0, 0.0, 1000.0, 0.0)
        rng = c.get_inject_withdraw_range(v)
        assert v + rng.min_inject_withdraw_rate == pytest.approx(400.0, abs=1e-6)


class TestEngineTerminalFn:
    """The engines take the terminal value as a jit static argument, so it
    must keep its identity across compilations of one facility."""

    def test_user_function_passes_through(self):
        from storage_tpu.facility import compile_storage

        terminal = lambda price, inv: price * inv  # noqa: E731
        storage = simple_storage(terminal_storage_npv=terminal)
        val = pd.Period("2021-01-05", freq="D")
        first = compile_storage(storage, val).engine_terminal_fn
        second = compile_storage(storage, val).engine_terminal_fn
        assert first is terminal and second is terminal

    def test_must_be_empty_has_none(self):
        from storage_tpu.facility import compile_storage

        compiled = compile_storage(simple_storage(), pd.Period("2021-01-05", freq="D"))
        assert compiled.must_be_empty_at_end
        assert compiled.engine_terminal_fn is None
