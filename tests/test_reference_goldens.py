"""Cross-checks against the reference's recorded outputs.

Two sources of truth from ``/root/reference``:

1. **Golden CSVs** — per-period deltas / expected profile / intrinsic profile /
   trigger prices pinned by the reference's pinned-seed regression tests
   (``src/Cmdty.Storage.Python/tests/regression_test_data/{multi_factor_test-1,
   three_factor_test-1}/*.csv``, loader ``test_multi_factor.py:293-306``).
   The reference ran 500 Mersenne-Twister sims; this framework uses threefry,
   so agreement is statistical: we run 4096 sims (quartering our own noise)
   and assert per-period bands calibrated to the reference's 500-sim MC noise.
   A systematic per-period bias in any output series fails these tests.

2. **README worked examples** — the four headline numbers in BASELINE.md
   (78,175 Python 3F-seasonal; 10,827.21 C# intrinsic; 25,473.10 C# LSMC;
   24,799.09 C# trinomial; ``README.md:233-242,439,544,621``).

Notes on known deviations (documented in api_lsmc.py / grid.py):
* intrinsic profiles under the default linspace grids are compared in
  aggregate only: with a flat curve and monthly settlement, within-month
  injection timing is exactly value-tied, so equally-optimal schedules differ
  per-period.  Under ``grid_scheme="fixed_spacing"`` (the reference's grid
  layout) every near-tie resolves identically and the per-period profiles and
  intrinsic NPV match the goldens exactly (TestIntrinsicExactParity).
"""
import os.path as path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import (
    CmdtyStorage,
    RatchetInterp,
    SimulationDataReturned,
    intrinsic_value,
    multi_factor_value,
    three_factor_seasonal_value,
    trinomial_value,
)

F64 = jnp.float64
REG_DIR = "/root/reference/src/Cmdty.Storage.Python/tests/regression_test_data"
NUM_SIMS = 4096  # 500 in the reference; more sims here shrink *our* MC noise


def _load_goldens(folder):
    root = path.join(REG_DIR, folder)
    deltas = pd.read_csv(
        path.join(root, "deltas.csv"), header=None, index_col=0, parse_dates=True
    ).iloc[:, 0]
    deltas.index = deltas.index.to_period("D")

    def frame(name):
        df = pd.read_csv(path.join(root, name), index_col=0, parse_dates=True)
        df.index = df.index.to_period("D")
        return df

    return {
        "deltas": deltas,
        "expected_profile": frame("expected_profile.csv"),
        "intrinsic_profile": frame("intrinsic_profile.csv"),
        "trigger_prices": frame("trigger_prices.csv"),
    }


def _reg_facility():
    # test_multi_factor.py:46-50
    return CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def _reg_market():
    # test_multi_factor.py:52-71: piecewise-flat curve, 3% rates, settle 20th
    # of next month.
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(
        index=idx,
        data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
    )
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return val_date, fwd, rates, settle


@pytest.fixture(scope="module")
def two_factor():
    val_date, fwd, rates, settle = _reg_market()
    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    res = multi_factor_value(
        _reg_facility(), val_date, 0.0, fwd, rates, settle,
        [(0.0, pd.Series(index=vol_idx, data=0.14)),
         (16.2, pd.Series(index=vol_idx.copy(), data=1.15))],
        0.64, NUM_SIMS, "1 + x0 + x0**2 + x1 + x1*x1", False,
        seed=11, fwd_sim_seed=11,  # same sims both passes, as the goldens did
        dtype=F64, sim_data_returned=SimulationDataReturned.NONE,
    )
    return res, _load_goldens("multi_factor_test-1"), 21_405.34  # ref 500-sim SE


@pytest.fixture(scope="module")
def three_factor():
    val_date, fwd, rates, settle = _reg_market()
    res = three_factor_seasonal_value(
        _reg_facility(), val_date, 0.0, fwd, rates, settle,
        spot_mean_reversion=16.2, spot_vol=1.15, long_term_vol=0.14,
        seasonal_vol=0.18, num_sims=NUM_SIMS,
        basis_funcs="1 + x_st + x_sw + x_lt + x_st**2 + x_sw**2 + x_lt**2",
        discount_deltas=False, seed=11, fwd_sim_seed=11, dtype=F64,
        sim_data_returned=SimulationDataReturned.NONE,
    )
    return res, _load_goldens("three_factor_test-1"), 18_459.70


def _check_against_goldens(res, goldens, ref_se):
    """Band magnitudes are ~2x the divergence observed at calibration
    (dominated by the reference's 500-sim noise; per-period maxima by decision
    timing flips on near-tie days of the piecewise-flat curve)."""
    active = goldens["deltas"].index
    # --- deltas: per-period + no systematic bias.
    ours_d = res.deltas.reindex(active).to_numpy()
    ref_d = goldens["deltas"].to_numpy()
    scale = np.abs(ref_d).max()
    assert np.abs(ours_d - ref_d).mean() < 0.10 * scale
    assert np.abs(ours_d - ref_d).max() < 0.80 * scale
    assert abs(np.mean(ours_d - ref_d)) < 0.015 * scale  # systematic bias gate

    # --- expected profile.
    prof, ref_prof = res.expected_profile, goldens["expected_profile"]
    pd.testing.assert_index_equal(prof.index, ref_prof.index)
    for col, mean_band, max_band in (
        ("inventory", 0.04, 0.12),
        ("inject_withdraw_volume", 0.08, 0.80),
        ("net_volume", 0.08, 0.80),
        ("period_pv", 0.02, 0.15),
    ):
        o = prof[col].to_numpy()
        g = ref_prof[col].to_numpy()
        s = max(np.abs(g).max(), 1.0)
        assert np.abs(o - g).mean() < mean_band * s, col
        assert np.abs(o - g).max() < max_band * s, col
    for col in ("cmdty_consumed", "inventory_loss"):
        np.testing.assert_array_equal(prof[col].to_numpy(), 0.0)
        np.testing.assert_array_equal(ref_prof[col].to_numpy(), 0.0)
    # Expected PV decomposition sums to the NPV — must track within MC error.
    assert abs(prof["period_pv"].sum() - ref_prof["period_pv"].sum()) < 2 * ref_se

    # --- intrinsic profile: aggregate agreement only (within-month injection
    # timing is exactly value-tied under monthly settlement; see module doc).
    intr, ref_intr = res.intrinsic_profile, goldens["intrinsic_profile"]
    assert abs(intr["period_pv"].sum() - ref_intr["period_pv"].sum()) < 2e-3 * abs(
        ref_intr["period_pv"].sum()
    )
    injected = intr["inject_withdraw_volume"].clip(lower=0).sum()
    ref_injected = ref_intr["inject_withdraw_volume"].clip(lower=0).sum()
    assert injected == pytest.approx(ref_injected, rel=0.05)
    # Net volume over the horizon is zero both ways (must-be-empty storage).
    assert abs(intr["inject_withdraw_volume"].sum()) < 1e-6 * ref_injected
    assert abs(ref_intr["inject_withdraw_volume"].sum()) < 1e-6 * ref_injected

    # --- trigger prices.
    trig, ref_trig = res.trigger_prices, goldens["trigger_prices"]
    for col, ours_col, max_band in (
        ("inject_trigger_price", trig["inject_trigger_price"], 0.03),
        # MC band at 500 sims; 0.065 observed after the round-3 RNG re-layout
        # (a boundary period's expected inventory shifts the trigger volume).
        ("withdraw_volume", trig["withdraw_volume"], 0.08),
        # Same-named column, same semantics (round 5): the price one
        # increment from the alternative, compared DIRECTLY to the golden.
        ("withdraw_trigger_price", trig["withdraw_trigger_price"], 0.04),
    ):
        o = ours_col.to_numpy()
        g = ref_trig[col].to_numpy()
        both = ~(np.isnan(o) | np.isnan(g))
        assert (np.isnan(o) != np.isnan(g)).sum() <= 2, col  # boundary periods
        s = np.abs(g[both]).max()
        assert np.abs(o[both] - g[both]).max() < max_band * s, col
    # inject_volume: identical except for decision-timing boundary periods.
    o = trig["inject_volume"].to_numpy()
    g = ref_trig["inject_volume"].to_numpy()
    both = ~(np.isnan(o) | np.isnan(g))
    assert np.abs(o[both] - g[both]).mean() < 0.02 * np.abs(g[both]).max()
    # The max-volume withdraw price (beyond-reference extra column) must
    # equal the last point of each period's withdraw trigger profile.
    maxvol = trig["withdraw_max_volume_price"].to_numpy()
    prof_last = np.array([
        (tp.withdraw_triggers[-1].price if len(tp.withdraw_triggers) else np.nan)
        for tp in res.trigger_profiles
    ])
    both = ~(np.isnan(maxvol) | np.isnan(prof_last))
    np.testing.assert_allclose(maxvol[both], prof_last[both], rtol=1e-6)


class TestGoldenCsvCrossChecks:
    def test_two_factor_npv(self, two_factor):
        res, _, ref_se = two_factor
        assert abs(res.npv - 1_780_380.7581833513) < 2 * ref_se

    def test_two_factor_series(self, two_factor):
        res, goldens, ref_se = two_factor
        _check_against_goldens(res, goldens, ref_se)

    def test_three_factor_npv(self, three_factor):
        res, _, ref_se = three_factor
        assert abs(res.npv - 1_766_460.137569665) < 2 * ref_se

    def test_three_factor_series(self, three_factor):
        res, goldens, ref_se = three_factor
        _check_against_goldens(res, goldens, ref_se)


class TestReadmeBaselines:
    """The four worked-example outputs of BASELINE.md rows 1-3."""

    def test_python_three_factor_seasonal_example(self):
        # README.md:195-242: ratcheted 1-yr storage, 2,000 sims, seed 12.
        ratchets = [
            ("2021-04-01", [(0.0, -150.0, 250.0), (2000.0, -200.0, 175.0),
                            (5000.0, -260.0, 155.0), (7000.0, -275.0, 132.0)]),
            ("2022-10-01", [(0.0, -130.0, 260.0), (2000.0, -190.0, 190.0),
                            (5000.0, -230.0, 165.0), (7000.0, -245.0, 148.0)]),
        ]
        storage = CmdtyStorage(
            "D", "2021-04-01", "2022-04-01", 0.01, 0.025,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        )
        monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
        monthly_fwd = [16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22,
                       17.32, 17.66, 17.59, 16.81, 15.36, 14.49, 14.28, 14.25,
                       14.32, 14.33, 15.30, 16.58, 16.64, 16.79, 16.64, 15.90,
                       14.63]
        fwd_curve = pd.Series(data=monthly_fwd, index=monthly_index).resample("D").ffill()
        rates_pillars = pd.PeriodIndex(
            freq="D", data=["2021-04-25", "2021-06-01", "2021-08-01", "2021-12-01",
                            "2022-04-01", "2022-12-01", "2023-12-01"])
        ir_curve = pd.Series(
            data=[0.005, 0.006, 0.0072, 0.0087, 0.0101, 0.0115, 0.0126],
            index=rates_pillars,
        ).resample("D").asfreq("D").interpolate(method="linear")

        def settlement_rule(delivery_date):
            return (delivery_date.asfreq("M").asfreq("D", "end") + 20).start_time.date()

        res = three_factor_seasonal_value(
            storage, "2021-04-25", 1500.0, fwd_curve, ir_curve, settlement_rule,
            spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30,
            seasonal_vol=0.19, num_sims=2000, seed=12,
            basis_funcs="1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st",
            discount_deltas=True, dtype=F64,
            sim_data_returned=SimulationDataReturned.NONE,
        )
        # Reference: 78,175 / 40,976 / 37,199 at 2,000 MT sims — both sides
        # carry ~SE of MC noise (ours observed ~626).
        band = 2 * np.sqrt(2) * res.val_sim_standard_error
        assert abs(res.npv - 78_175) < band
        assert res.intrinsic_npv == pytest.approx(40_976, abs=2.0)  # deterministic
        assert abs(res.extrinsic_npv - 37_199) < band

    @staticmethod
    def _csharp_ratcheted_storage():
        # README.md:358-396 / samples LsmcThreeFactor + Trinomial Program.cs.
        ratchets = [
            ("2019-09-01", [(0.0, -44.85, 56.8), (100.0, -45.01, 54.5),
                            (300.0, -45.78, 52.01), (600.0, -46.17, 51.9),
                            (800.0, -46.99, 50.8), (1000.0, -47.12, 50.01)]),
            ("2019-09-20", [(0.0, -31.41, 48.33), (100.0, -31.85, 43.05),
                            (300.0, -31.68, 41.22), (600.0, -32.78, 40.08),
                            (800.0, -33.05, 39.74), (1000.0, -34.80, 38.51)]),
        ]
        return CmdtyStorage(
            "D", "2019-09-01", "2019-10-01", 0.48, 0.74,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        )

    @staticmethod
    def _step_curve(start):
        idx = pd.period_range(start, "2019-10-01", freq="D")
        return pd.Series(
            index=idx,
            data=[56.6 if p <= pd.Period("2019-09-22", freq="D") else 56.6 + 87.81
                  for p in idx],
        )

    def test_csharp_intrinsic_example(self):
        # README.md:330-440 / samples Intrinsic Program.cs: simple storage,
        # no discounting, grid spacing 10 over [0, 1100.74] ~ 112 points.
        storage = CmdtyStorage(
            "D", "2019-09-01", "2019-10-01", 0.48, 0.74,
            min_inventory=0.0, max_inventory=1100.74,
            max_injection_rate=5.26, max_withdrawal_rate=14.74,
        )

        def settle_5th_next_month(period):
            m = period.asfreq("M") + 1
            return m.asfreq("D", "start").start_time.date().replace(day=5)

        res = intrinsic_value(
            storage, "2019-09-15", 50.0, self._step_curve("2019-09-15"), 0.0,
            settle_5th_next_month, num_inventory_grid_points=112, dtype=F64,
        )
        assert res.npv == pytest.approx(10_827.21, abs=0.02)

    def test_csharp_lsmc_example(self):
        # README.md:447-545: 3F-seasonal LSMC over the ratcheted storage,
        # reference 500 MT sims -> 25,473.10.  We run 2,000 sims: combined MC
        # band = 2*sqrt(SE_ours^2 + SE_ref^2) with SE_ref ~ 2*SE_ours.
        def settle_20th_next_month(period):
            m = period.asfreq("M") + 1
            return m.asfreq("D", "start").start_time.date().replace(day=20)

        res = three_factor_seasonal_value(
            self._csharp_ratcheted_storage(), "2019-08-29", 50.0,
            self._step_curve("2019-09-01"), 0.055, settle_20th_next_month,
            spot_mean_reversion=90.6, spot_vol=0.7, long_term_vol=0.17,
            seasonal_vol=0.32, num_sims=2000, seed=11,
            basis_funcs="1 + x0 + x0**2 + x0**3 + s", discount_deltas=False,
            num_inventory_grid_points=50, dtype=F64,
            sim_data_returned=SimulationDataReturned.NONE,
        )
        band = 2 * np.sqrt(5) * res.val_sim_standard_error
        assert abs(res.npv - 25_473.10) < band

    def test_csharp_trinomial_example(self):
        # README.md:552-622: 1F tree, seasonal spot vols, mr 5.5, dt=1/365.
        vols = {
            "2019-09-15": 0.975, "2019-09-16": 0.97, "2019-09-17": 0.96,
            "2019-09-18": 0.91, "2019-09-19": 0.89, "2019-09-20": 0.895,
            "2019-09-21": 0.891, "2019-09-22": 0.89, "2019-09-23": 0.875,
            "2019-09-24": 0.872, "2019-09-25": 0.871, "2019-09-26": 0.870,
            "2019-09-27": 0.869, "2019-09-28": 0.868, "2019-09-29": 0.867,
            "2019-09-30": 0.866, "2019-10-01": 0.8655,
        }
        spot_vol = pd.Series(
            {pd.Period(k, freq="D"): v for k, v in vols.items()}
        ).sort_index()
        spot_vol.index = pd.PeriodIndex(spot_vol.index, freq="D")

        npv = trinomial_value(
            self._csharp_ratcheted_storage(), "2019-09-15", 50.0,
            self._step_curve("2019-09-15"), spot_vol, 5.5, 1.0 / 365.0, 0.025,
            lambda period: pd.Timestamp("2019-10-20").date(),
            num_inventory_grid_points=101, dtype=F64,
        )
        assert npv == pytest.approx(24_799.09, rel=5e-4)


class TestIntrinsicExactParity:
    """Per-period intrinsic-profile equality with the reference: under
    ``grid_scheme="fixed_spacing"`` (the reference's
    FixedSpacingStateSpaceGridCalc layout) the DP resolves every within-month
    near-tie identically, so decisions, per-period PVs and the NPV match the
    golden CSVs exactly — not just in aggregate."""

    @pytest.mark.parametrize("folder", ["multi_factor_test-1", "three_factor_test-1"])
    def test_fixed_spacing_reproduces_reference_per_period(self, folder):
        goldens = _load_goldens(folder)
        val_date, fwd, rates, settle = _reg_market()
        res = intrinsic_value(
            _reg_facility(), val_date, 0.0, fwd, interest_rates=rates,
            settlement_rule=settle, dtype=jnp.float64,
            grid_scheme="fixed_spacing",
        )
        ref = goldens["intrinsic_profile"]
        ours = res.profile.reindex(ref.index)
        np.testing.assert_allclose(
            ours["inject_withdraw_volume"].to_numpy(),
            ref["inject_withdraw_volume"].to_numpy(), atol=1e-9,
        )
        np.testing.assert_allclose(
            ours["period_pv"].to_numpy(), ref["period_pv"].to_numpy(), atol=1e-6,
        )
        np.testing.assert_allclose(
            ours["inventory"].to_numpy(), ref["inventory"].to_numpy(), atol=1e-6,
        )
        # Reference pinned intrinsic NPV (test_multi_factor.py:102) — exact.
        assert res.npv == pytest.approx(1_703_773.0757192627, rel=1e-12)
