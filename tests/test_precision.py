"""f32 accuracy gate.

The bench and the default API dtype are float32, while the oracle/golden tests
run float64.  This pins the f32-vs-f64 divergence of the full valuation at a
mid-size configuration so a precision regression (e.g. a kernel change that
quietly drops accumulation precision) fails in CI rather than in a future
benchmark.

Both runs consume the SAME float64-simulated path panels through
``value_from_sims`` (the f32 run casts them once on ingestion), so the
difference isolates engine arithmetic: regression conditioning, interpolation,
decision near-ties.  (Before round 3 this test simulated separately per dtype;
normal draws are not dtype-aligned in JAX, so it was comparing two independent
Monte Carlo runs and its tight gates were luck of the seed pair.)
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import CmdtyStorage, SimulationDataReturned, value_from_sims
from storage_tpu.models.spot_sim import MultiFactorSpotSim


def _build_market():
    storage = CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(
        index=idx,
        data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
    )
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    factors = [
        (0.0, pd.Series(index=vol_idx, data=0.14)),
        (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
    ]
    return storage, val_date, fwd, rates, settle, factors


def _run(dtype, sims):
    storage, val_date, fwd, rates, settle, _ = _build_market()
    (spot_reg, fac_reg), (spot_val, fac_val) = sims
    return value_from_sims(
        storage, val_date, 0.0, fwd, rates, settle,
        spot_reg, spot_val, "1 + x0 + x0**2 + x1 + x1*x1", False,
        sim_factors_regress=fac_reg, sim_factors_valuation=fac_val,
        dtype=dtype, sim_data_returned=SimulationDataReturned.NONE,
    )


@pytest.fixture(scope="module")
def both():
    storage, val_date, fwd, rates, settle, factors = _build_market()
    periods = pd.period_range("2019-12-01", "2020-04-01", freq="D")
    curve = fwd.reindex(periods)

    def simulate(seed):
        sim = MultiFactorSpotSim(
            "D", factors, 0.64, val_date, curve, periods, seed=seed,
            dtype=jnp.float64,
        )
        return sim.simulate_with_factors(2048)

    sims = (simulate(11), simulate(13))
    return _run(jnp.float32, sims), _run(jnp.float64, sims)


def test_f32_npv_close_to_f64(both):
    res32, res64 = both
    # Identical paths: the only f32-vs-f64 differences are regression
    # conditioning and a handful of flipped near-tie decisions (a genuinely —
    # slightly — different lower-bound policy).  The gate is sized to catch
    # precision regressions an order of magnitude larger (e.g. single-pass
    # bf16 matmuls bias NPV by -1.4%, commit 16f65ad).
    assert res32.npv == pytest.approx(res64.npv, rel=2e-3)
    assert abs(res32.npv - res64.npv) < 0.5 * res64.val_sim_standard_error
    assert res32.val_sim_standard_error == pytest.approx(
        res64.val_sim_standard_error, rel=5e-3
    )
    assert res32.intrinsic_npv == pytest.approx(res64.intrinsic_npv, rel=1e-5)


def test_f32_deltas_close_to_f64(both):
    """Per-period deltas shift between adjacent near-indifferent days when f32
    coefficients flip decisions, so the gate is on aggregates — still an order
    of magnitude tighter than a real precision regression."""
    res32, res64 = both
    d32 = res32.deltas.to_numpy()
    d64 = res64.deltas.to_numpy()
    scale = np.abs(d64).max()
    assert abs(d32.sum() - d64.sum()) / abs(d64.sum()) < 0.03
    assert np.abs(d32 - d64).mean() < 0.05 * scale
    assert np.abs(d32 - d64).max() < 0.15 * scale


def test_f32_profile_close_to_f64(both):
    res32, res64 = both
    pv32 = res32.expected_profile["period_pv"].to_numpy()
    pv64 = res64.expected_profile["period_pv"].to_numpy()
    # Total expected PV is the NPV decomposition; it must track tightly.
    assert abs(pv32.sum() - pv64.sum()) / abs(pv64.sum()) < 3e-3
    for col in ("inventory", "inject_withdraw_volume"):
        a = res32.expected_profile[col].to_numpy()
        b = res64.expected_profile[col].to_numpy()
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).mean() < 0.05 * scale, f"profile column {col}"
        assert np.abs(a - b).max() < 0.15 * scale, f"profile column {col}"


def test_f32_trigger_prices_close_to_f64(both):
    res32, res64 = both
    for col in ("inject_trigger_price", "withdraw_trigger_price"):
        a = res32.trigger_prices[col].to_numpy()
        b = res64.trigger_prices[col].to_numpy()
        mask = ~np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[mask], b[mask], rtol=0.04,
                                   err_msg=f"trigger column {col}")
