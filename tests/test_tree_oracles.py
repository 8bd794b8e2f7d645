"""Tree-engine oracle parity with the reference test suite.

Named counterparts of the reference oracles:

* ``TreeStorageValuationTest.Calculate_StorageLooksLikeCallOptions_NpvEqualsBlack76``
  — storage contorted into forced-exercise windows priced through the *tree
  engine* against closed-form Black-76;
* degenerate intrinsic tree == trivial intrinsic calc
  (``WithIntrinsicTree``, TreeStorageValuationExtensions.cs:104-124);
* ``LsmcStorageValuationTest.Calculate_OneFactorStorageWithRatchets_
  NpvApproximatelyEqualsTrinomialNpv`` (:455-481, reference band 0.1%) and the
  simple variant (:425-451, 0.03%) at 65,536 sims;
* ``Calculate_OneFactorZeroMeanReversionSimpleStorage/StorageWithRatchets_
  NpvApproximatelyEqualsIntrinsicNpv`` (:530-567, reference band 3%);
* deep-ITM ``trinomial_deltas`` == intrinsic withdrawal profile
  (reference ``test_trinomial.py:154-199``).

Fixtures mirror ``LsmcStorageValuationTest.cs:55-200``: daily storage
2019-08-03..2020-04-01, max withdraw 850 / inject 625 / inventory 52,500
(+ a piecewise-linear ratcheted variant), val date 2019-08-29, inventory
5,685, sinusoidal forward curve 53.5 + 24.6 sin, flat 5.5% rates, settle 20th
of next month, 1-factor OU (mean reversion 12.5, vol 0.95), basis 1+s+s**2+s**3.
All tolerances here are within a 0.5% slack except
where the tree's own lattice bias is the binding error (documented inline).
"""
import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from scipy.stats import norm

from storage_tpu import (
    CmdtyStorage,
    RatchetInterp,
    SimulationDataReturned,
    intrinsic_value,
    multi_factor_value,
    trinomial_deltas,
    trinomial_value,
)

F64 = jnp.float64

START, END = "2019-08-03", "2020-04-01"
VAL_DATE = "2019-08-29"
INVENTORY = 5_685.0
MEAN_REVERSION = 12.5
SPOT_VOL = 0.95
RATE = 0.055
NUM_SIMS = 65_536


def simple_storage():
    return CmdtyStorage(
        "D", START, END, 1.25, 0.93, min_inventory=0.0, max_inventory=52_500.0,
        max_injection_rate=625.0, max_withdrawal_rate=850.0,
    )


def ratcheted_storage():
    # LsmcStorageValuationTest.cs:96-125.
    ratchets = [
        (START, [(0.0, -702.7, 650.0), (15_000.0, -785.0, 552.5),
                 (30_000.0, -790.6, 512.8), (40_000.0, -825.6, 498.6),
                 (52_500.0, -850.4, 480.0)]),
        ("2020-02-01", [(0.0, -645.35, 650.0), (13_000.0, -656.0, 552.5),
                        (28_000.0, -689.6, 512.8), (42_000.0, -701.06, 498.6),
                        (52_500.0, -718.04, 480.0)]),
    ]
    return CmdtyStorage(
        "D", START, END, 1.25, 0.93, ratchets=ratchets,
        ratchet_interp=RatchetInterp.LINEAR,
    )


def market():
    idx = pd.period_range(VAL_DATE, END, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=53.5 + np.sin(2 * np.pi / 365.0 * i) * 24.6)
    vols = pd.Series(index=idx.copy(), data=SPOT_VOL)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return fwd, vols, settle


def run_lsmc(storage, mean_reversion=MEAN_REVERSION, num_sims=NUM_SIMS):
    fwd, vols, settle = market()
    return multi_factor_value(
        storage, VAL_DATE, INVENTORY, fwd, RATE, settle,
        [(mean_reversion, vols)], None, num_sims, "1 + s + s**2 + s**3",
        False, seed=11, fwd_sim_seed=22, num_inventory_grid_points=100,
        dtype=F64, sim_data_returned=SimulationDataReturned.NONE,
    )


class TestLsmcAgreesWithTree:
    """LSMC vs 1F trinomial at 65,536 sims (SE ~ 0.15%).  Reference bands
    0.03% / 0.1% with shared-RNG infrastructure; ours is an independent-RNG
    statistical comparison, so the gate is 2.5 reported standard errors plus
    a 0.3% absolute band (the round-3 RNG re-layout landed the simple case
    at +1.8 SE — a legitimate draw, not a bias; the systematic-bias gates
    live in test_reference_goldens)."""

    def test_simple_storage(self):
        fwd, vols, settle = market()
        tree_npv = trinomial_value(
            simple_storage(), VAL_DATE, INVENTORY, fwd, vols, MEAN_REVERSION,
            1 / 365.0, RATE, settle, num_inventory_grid_points=500, dtype=F64,
        )
        res = run_lsmc(simple_storage())
        assert abs(res.npv - tree_npv) < 2.5 * res.val_sim_standard_error
        assert abs(res.npv - tree_npv) / tree_npv < 3e-3

    def test_ratcheted_storage(self):
        fwd, vols, settle = market()
        tree_npv = trinomial_value(
            ratcheted_storage(), VAL_DATE, INVENTORY, fwd, vols, MEAN_REVERSION,
            1 / 365.0, RATE, settle, num_inventory_grid_points=500, dtype=F64,
        )
        res = run_lsmc(ratcheted_storage())
        assert abs(res.npv - tree_npv) < 2.5 * res.val_sim_standard_error
        assert abs(res.npv - tree_npv) / tree_npv < 3e-3


class TestZeroMeanReversionLsmcNearIntrinsic:
    """With zero mean reversion the driftless-lognormal spot gives the storage
    almost pure intrinsic value over this horizon (reference band 3%; observed
    -0.42% here at 65,536 sims — pinned at 1%)."""

    @pytest.mark.parametrize("make_storage", [simple_storage, ratcheted_storage])
    def test_near_intrinsic(self, make_storage):
        fwd, _vols, settle = market()
        res = run_lsmc(make_storage(), mean_reversion=0.0)
        intr = intrinsic_value(
            make_storage(), VAL_DATE, INVENTORY, fwd, RATE, settle,
            num_inventory_grid_points=100, dtype=F64,
        )
        assert abs(res.npv - intr.npv) / intr.npv < 0.01
        # LSMC adds (weakly positive) extrinsic value minus MC noise.
        assert res.npv > intr.npv - 3 * res.val_sim_standard_error


class TestIntrinsicTreeDegenerate:
    def test_intrinsic_tree_equals_intrinsic_engine(self):
        """The single-node 'intrinsic tree' through the tree engine equals the
        trivial intrinsic calc (TreeStorageValuationExtensions.cs:104-124).
        Both use G=100 linear-interp DP; they differ only in backward-value vs
        forward-sum accounting (interp error ~3e-4 at G=100, shrinking with
        grid refinement)."""
        from storage_tpu.engines import tree as tree_engine
        from storage_tpu.models.trinomial_tree import build_intrinsic_tree
        from storage_tpu.valuation_inputs import prepare_valuation
        from storage_tpu.utils import periods as pu

        storage = ratcheted_storage()
        fwd, _vols, settle = market()
        inputs = prepare_valuation(storage, VAL_DATE, INVENTORY, fwd, RATE, settle)
        val_p = pu.to_period(VAL_DATE, "D")
        tree = build_intrinsic_tree(
            fwd.reindex(pu.period_index(val_p, storage.end)).to_numpy()
        )
        offset = (inputs.periods[0] - val_p).n
        result, _, _ = tree_engine.tree_valuation(
            inputs.compiled, tree, offset, inputs.starting_inventory, inputs.fwd,
            inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
            inputs.inventory_upper, num_grid_points=100, dtype=F64,
        )
        intr = intrinsic_value(
            storage, VAL_DATE, INVENTORY, fwd, RATE, settle,
            num_inventory_grid_points=100, dtype=F64,
        )
        assert float(result.npv) == pytest.approx(intr.npv, rel=1e-3)


class TestTreeStorageLikeCallsBlack76:
    """Storage contorted into three forced-exercise windows priced through the
    TREE engine vs closed-form Black-76 (the tree counterpart of the LSMC
    oracle; reference ``TreeStorageValuationTest.Calculate_StorageLooksLike
    CallOptions_NpvEqualsBlack76``).  The tree is deterministic, so the band
    is pure lattice+grid discretization error."""

    VAL_DATE = "2019-08-29"
    MEAN_REVERSION = 16.5
    INTEREST_RATE = 0.09
    OPTIONS = [
        ("2019-12-15", 1200.0, 0.0, "2020-01-20"),
        ("2020-01-20", 800.0, 2.0, "2020-02-18"),
        ("2020-03-31", 900.0, 2.8, "2020-04-22"),
    ]

    def test_npv_matches_black76(self):
        idx = pd.period_range(self.VAL_DATE, "2020-04-01", freq="D")
        i = np.arange(len(idx))
        fwd = pd.Series(index=idx, data=53.5 + np.sin(2 * np.pi / 365.0 * i) * 24.6)
        vol = pd.Series(index=idx.copy(), data=0.78 + np.sin(2 * np.pi / 365.0 * i) * 0.35)
        total_notional = sum(o[1] for o in self.OPTIONS)
        settle_map = {
            "2019-12": "2020-01-20", "2020-01": "2020-02-18",
            "2020-02": "2020-03-21", "2020-03": "2020-04-22",
        }

        def settlement_rule(period):
            return pd.Timestamp(settle_map[str(period.asfreq('M'))]).date()

        def zero_rates(day):
            return (day, [(0.0, 0.0, 0.0), (total_notional, 0.0, 0.0)])

        ratchets = [zero_rates("2019-12-01")]
        strikes = {}
        wdr_cost = pd.Series(
            index=pd.period_range("2019-12-01", "2020-03-31", freq="D"), data=0.0
        )
        for expiry, notional, premium, _settle in self.OPTIONS:
            p = pd.Period(expiry, freq="D")
            strikes[p] = float(fwd[p]) + premium
            ratchets.append(
                (expiry, [(0.0, -notional, 0.0), (total_notional, -notional, 0.0)])
            )
            ratchets.append(zero_rates((p + 1).strftime("%Y-%m-%d")))
            wdr_cost[p] = strikes[p]

        storage = CmdtyStorage(
            "D", "2019-12-01", "2020-04-01", 0.0, wdr_cost,
            ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
            terminal_storage_npv=lambda price, inv: 0.0,
            cost_settlement_rule=settlement_rule,
        )
        tree_npv = trinomial_value(
            storage, self.VAL_DATE, total_notional, fwd, vol, self.MEAN_REVERSION,
            1 / 365.0, self.INTEREST_RATE, settlement_rule,
            num_inventory_grid_points=500, dtype=F64,
        )

        val_day = pd.Timestamp(self.VAL_DATE).date()
        expected = 0.0
        for expiry, notional, _premium, settle_d in self.OPTIONS:
            p = pd.Period(expiry, freq="D")
            t = (pd.Timestamp(expiry).date() - val_day).days / 365.0
            t_settle = (pd.Timestamp(settle_d).date() - val_day).days / 365.0
            df = math.exp(-self.INTEREST_RATE * t_settle)
            one_factor_var = (1 - math.exp(-2 * self.MEAN_REVERSION * t)) / (
                2 * self.MEAN_REVERSION
            )
            iv = float(vol[p]) * math.sqrt(one_factor_var / t)
            vrt = iv * math.sqrt(t)
            d1 = (math.log(float(fwd[p]) / strikes[p]) + iv**2 / 2 * t) / vrt
            d2 = d1 - vrt
            expected += df * (
                float(fwd[p]) * norm.cdf(d1) - strikes[p] * norm.cdf(d2)
            ) * notional
        assert tree_npv == pytest.approx(expected, rel=5e-3)


class TestDeepItmTrinomialDeltas:
    def test_withdraw_window_delta_equals_intrinsic_volume(self):
        """Deep-ITM storage (spot jumps 23.87 -> 150.32): the withdrawal-window
        delta equals the intrinsic withdrawal volume 700 x 20 days (reference
        ``test_trinomial.py:154-199``, band 0.05%; observed -0.004%)."""
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
        vols = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=1.15)

        def settle(period):
            return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

        deltas = trinomial_deltas(
            storage, val_date, 0.0, fwd, vols, 14.5, 1 / 365.0, 0.0, settle,
            fwd_contracts=[("2019-12-01", "2020-03-11"), ("2020-03-12", "2020-04-01")],
            num_inventory_grid_points=500, dtype=F64,
        )
        expected_withdraw_delta = 700.0 * 20
        assert deltas[1] == pytest.approx(expected_withdraw_delta, rel=5e-4)
        # The injection-window delta offsets it (buy low / sell high).
        assert deltas[0] < 0
