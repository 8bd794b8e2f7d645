"""End-to-end valuations at every advertised frequency.

``utils/periods.py:19-27`` advertises 15min / 30min / h / D / M / Q (the
reference freq map, ``utils.py:131-138``); daily and hourly already appear in
other tests, so this file drives an intrinsic + LSMC valuation through each of
the remaining frequencies.  Oracles: near-zero vol LSMC ==
intrinsic (the analytic collapse the reference leans on), plus a two-period
monthly facility whose intrinsic value is hand-computable.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import (
    CmdtyStorage,
    SimulationDataReturned,
    intrinsic_value,
    multi_factor_value,
)

F64 = jnp.float64


def _market(freq, start, end, rates_end, base=30.0, amp=10.0, cycles=2.0):
    idx = pd.period_range(start, end, freq=freq)
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=base + amp * np.sin(2 * np.pi * i * cycles / len(i)))
    # Interest rates are a flat scalar: the reference's series-based discounter
    # contract wants *daily*-indexed rates regardless of the facility freq.
    return fwd, 0.03


def _check_freq(freq, start, end, rates_end, num_sims=256):
    storage = CmdtyStorage(
        freq, start, end, 0.3, 0.2,
        min_inventory=0.0, max_inventory=5_000.0,
        max_injection_rate=400.0, max_withdrawal_rate=400.0,
    )
    fwd, rates = _market(freq, start, end, rates_end)
    intr = intrinsic_value(
        storage, start, 100.0, fwd, rates, None, num_inventory_grid_points=60,
        dtype=F64,
    )
    assert np.isfinite(intr.npv)
    assert intr.npv > 0  # the sinusoidal curve always offers a spread
    # Profile respects the physical rates and ends empty (must-be-empty).
    vols = intr.profile["inject_withdraw_volume"].to_numpy()
    assert np.all(vols <= 400.0 + 1e-9) and np.all(vols >= -400.0 - 1e-9)
    assert abs(intr.profile["inventory"].iloc[-1] + vols[-1]) < 1e-6

    vol_idx = pd.period_range(start, rates_end, freq=freq)
    factors = [(2.0, pd.Series(index=vol_idx, data=1e-6))]
    res = multi_factor_value(
        storage, start, 100.0, fwd, rates, None, factors, None, num_sims,
        "1 + x0", False, seed=4, fwd_sim_seed=5, num_inventory_grid_points=60,
        dtype=F64, sim_data_returned=SimulationDataReturned.NONE,
    )
    # Near-zero vol collapses LSMC onto the intrinsic value
    # (LsmcStorageValuationTest.cs:573-609).
    assert res.npv == pytest.approx(intr.npv, rel=5e-4)
    assert res.intrinsic_npv == pytest.approx(intr.npv, rel=1e-9)
    assert len(res.deltas) == len(fwd)


def test_monthly_facility_end_to_end():
    _check_freq("M", "2021-01", "2021-12", "2022-06")


def test_quarterly_facility_end_to_end():
    _check_freq("Q", "2021Q1", "2023Q4", "2024Q4")


def test_30min_facility_end_to_end():
    _check_freq("30min", "2021-06-01 00:00", "2021-06-03 00:00", "2021-06-05 00:00")


def test_15min_facility_end_to_end():
    _check_freq("15min", "2021-06-01 00:00", "2021-06-02 00:00", "2021-06-04 00:00")


def test_monthly_two_period_hand_computed():
    """Two-month storage, flat rates = 0: intrinsic = buy cheap month, sell
    expensive month, net of costs (hand-computable)."""
    storage = CmdtyStorage(
        "M", "2021-01", "2021-03", 0.5, 0.4,
        min_inventory=0.0, max_inventory=1_000.0,
        max_injection_rate=1_000.0, max_withdrawal_rate=1_000.0,
    )
    idx = pd.period_range("2021-01", "2021-03", freq="M")
    fwd = pd.Series(index=idx, data=[10.0, 25.0, 20.0])
    intr = intrinsic_value(storage, "2021-01", 0.0, fwd, 0.0, None, dtype=F64)
    # Inject 1000 in Jan at 10 (+0.5 cost), withdraw 1000 in Feb at 25
    # (-0.4 cost); empty by end (March is the final, decision-free period).
    expected = 1000.0 * (25.0 - 0.4 - 10.0 - 0.5)
    assert intr.npv == pytest.approx(expected, rel=1e-12)
