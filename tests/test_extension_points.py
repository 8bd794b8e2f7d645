"""Open extension points:

* user-supplied per-period grids via ``grid_calc`` — the
  ``IDoubleStateSpaceGridCalc.GetGridPoints`` analog
  (IDoubleStateSpaceGridCalc.cs:32) — on the intrinsic, tree and LSMC engines;
* natural-cubic continuation interpolation in the tree engine (the
  ``NaturalCubicSplineInterpolatorFactory`` option,
  InterpolatorFactories/IInterpolatorFactory.cs:33);
* per-period MIXED ratchet interpolation (per-period constraint objects of
  any type, CmdtyStorage.cs:41-50) via ``(period, nodes, interp)`` ratchet
  entries, lowered to staircase linear tables when step and continuous mix.
"""
import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp

from storage_tpu import (
    CmdtyStorage, RatchetInterp, intrinsic_value, multi_factor_value,
    trinomial_value,
)

F64 = jnp.float64


def _storage(**kw):
    return CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", 0.8, 0.6,
        min_inventory=0.0, max_inventory=1500.0,
        max_injection_rate=60.0, max_withdrawal_rate=80.0,
        **kw,
    )


def _market():
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    i = np.arange(len(idx))
    return pd.Series(index=idx, data=25.0 + 5.0 * np.sin(2 * np.pi * i / 30.0))


class TestGridCalc:
    def test_intrinsic_linspace_equivalent_grid_calc_matches(self):
        fwd = _market()
        base = intrinsic_value(_storage(), "2021-01-01", 700.0, fwd, 0.03,
                               None, num_inventory_grid_points=50, dtype=F64)
        res = intrinsic_value(
            _storage(), "2021-01-01", 700.0, fwd, 0.03, None, dtype=F64,
            grid_calc=lambda lo, hi: np.linspace(lo, hi, 50),
        )
        assert res.npv == pytest.approx(base.npv, rel=1e-12)

    def test_intrinsic_nonuniform_grid_calc(self):
        fwd = _market()

        def dense_near_bottom(lo, hi):
            u = np.linspace(0.0, 1.0, 60) ** 2
            return lo + (hi - lo) * u

        res = intrinsic_value(
            _storage(), "2021-01-01", 700.0, fwd, 0.03, None, dtype=F64,
            grid_calc=dense_near_bottom,
        )
        dense = intrinsic_value(_storage(), "2021-01-01", 700.0, fwd, 0.03,
                                None, num_inventory_grid_points=400, dtype=F64)
        assert res.npv == pytest.approx(dense.npv, rel=2e-3)

    def test_lsmc_grid_calc_uniform_and_nonuniform(self):
        fwd = _market()
        factors = [(8.0, pd.Series(0.7, index=fwd.index.copy()))]
        kwargs = dict(seed=5, fwd_sim_seed=6, dtype=F64)
        base = multi_factor_value(
            _storage(), "2021-01-01", 700.0, fwd, 0.03, None, factors, None,
            128, "1 + s + x0", False, num_inventory_grid_points=40, **kwargs)
        uniform = multi_factor_value(
            _storage(), "2021-01-01", 700.0, fwd, 0.03, None, factors, None,
            128, "1 + s + x0", False,
            grid_calc=lambda lo, hi: np.linspace(lo, hi, 40), **kwargs)
        # A uniform custom grid takes the identical fast path.
        assert uniform.npv == pytest.approx(base.npv, rel=1e-12)

        def nonuniform(lo, hi):
            u = np.linspace(0.0, 1.0, 40) ** 1.5
            return lo + (hi - lo) * u

        res = multi_factor_value(
            _storage(), "2021-01-01", 700.0, fwd, 0.03, None, factors, None,
            128, "1 + s + x0", False, grid_calc=nonuniform, **kwargs)
        # Same sims, different quadrature: NPV within grid-resolution error.
        assert np.isfinite(res.npv)
        assert res.npv == pytest.approx(base.npv, rel=5e-3)

    def test_grid_calc_validation(self):
        fwd = _market()
        with pytest.raises(ValueError, match="sorted"):
            intrinsic_value(
                _storage(), "2021-01-01", 700.0, fwd, 0.03, None, dtype=F64,
                grid_calc=lambda lo, hi: np.array([hi, lo]),
            )
        with pytest.raises(ValueError, match="feasible band"):
            intrinsic_value(
                _storage(), "2021-01-01", 700.0, fwd, 0.03, None, dtype=F64,
                grid_calc=lambda lo, hi: np.array([lo - 100.0, hi]),
            )


class TestTreeCubic:
    def _value(self, **kw):
        fwd = _market()
        vol = pd.Series(0.6, index=fwd.index.copy())
        return trinomial_value(
            _storage(), "2021-01-01", 700.0, fwd, vol, 10.0, 1.0 / 365,
            0.03, None, num_inventory_grid_points=40, dtype=F64, **kw)

    def test_cubic_close_to_linear(self):
        lin = self._value()
        cub = self._value(interpolation="cubic")
        assert np.isfinite(cub)
        # Different quadratures of the same continuation surface.
        assert cub == pytest.approx(lin, rel=5e-3)

    def test_cubic_converges_with_grid(self):
        # At a dense grid the interpolator choice stops mattering.
        fwd = _market()
        vol = pd.Series(0.6, index=fwd.index.copy())
        lin = trinomial_value(
            _storage(), "2021-01-01", 700.0, fwd, vol, 10.0, 1.0 / 365,
            0.03, None, num_inventory_grid_points=300, dtype=F64)
        cub = trinomial_value(
            _storage(), "2021-01-01", 700.0, fwd, vol, 10.0, 1.0 / 365,
            0.03, None, num_inventory_grid_points=300, dtype=F64,
            interpolation="cubic")
        assert cub == pytest.approx(lin, rel=2e-4)

    def test_tree_grid_calc(self):
        base = self._value()
        res = self._value(grid_calc=lambda lo, hi: np.linspace(lo, hi, 40))
        assert res == pytest.approx(base, rel=1e-12)
        with pytest.raises(ValueError, match="cubic"):
            self._value(interpolation="cubic",
                        grid_calc=lambda lo, hi: np.linspace(lo, hi, 40))


class TestMixedRatchetInterp:
    NODES_A = [(0.0, -80.0, 60.0), (700.0, -90.0, 50.0), (1500.0, -90.0, 50.0)]
    NODES_B = [(0.0, -70.0, 55.0), (800.0, -85.0, 45.0), (1500.0, -85.0, 45.0)]

    def _mixed(self):
        return CmdtyStorage(
            "D", "2021-01-01", "2021-03-01", 0.8, 0.6,
            ratchets=[
                ("2021-01-01", self.NODES_A, RatchetInterp.LINEAR),
                ("2021-02-01", self.NODES_B, RatchetInterp.STEP),
            ],
            ratchet_interp=RatchetInterp.LINEAR,
            terminal_storage_npv=lambda price, inv: 0.0,
        )

    def test_mixed_facility_compiles_and_values(self):
        fwd = _market()
        res = intrinsic_value(self._mixed(), "2021-01-01", 700.0, fwd, 0.03,
                              None, num_inventory_grid_points=50, dtype=F64)
        assert np.isfinite(res.npv)
        factors = [(8.0, pd.Series(0.7, index=fwd.index.copy()))]
        lsmc = multi_factor_value(
            self._mixed(), "2021-01-01", 700.0, fwd, 0.03, None, factors,
            None, 128, "1 + s + x0", False, seed=3, fwd_sim_seed=4,
            num_inventory_grid_points=40, dtype=F64)
        assert np.isfinite(lsmc.npv)

    def test_staircase_matches_exact_step_all_step_facility(self):
        """The staircase lowering reproduces an all-STEP facility's valuation
        (exact off the 2^-22 jump windows)."""
        fwd = _market()

        def build(stair):
            s = CmdtyStorage(
                "D", "2021-01-01", "2021-03-01", 0.8, 0.6,
                ratchets=[("2021-01-01", self.NODES_B)],
                ratchet_interp=RatchetInterp.STEP,
                terminal_storage_npv=lambda price, inv: 0.0,
            )
            if stair:
                # Force the mixed-mode lowering path.
                from storage_tpu import constraints as con

                orig = s._constraints[0]
                tab = orig.table(0.0, 1500.0, step_interp_as_linear_nodes=True)
                assert tab[3] is False and len(tab[0]) > len(self.NODES_B)
            return s

        exact = intrinsic_value(build(False), "2021-01-01", 700.0, fwd, 0.03,
                                None, num_inventory_grid_points=50, dtype=F64)
        mixed = CmdtyStorage(
            "D", "2021-01-01", "2021-03-01", 0.8, 0.6,
            ratchets=[
                ("2021-01-01", self.NODES_B, RatchetInterp.STEP),
                # A continuous entry that never activates mixing-by-period
                # differences in rates: same nodes, linear far segment.
                ("2021-02-25", self.NODES_B, RatchetInterp.STEP),
            ],
            ratchet_interp=RatchetInterp.STEP,
            terminal_storage_npv=lambda price, inv: 0.0,
        )
        same = intrinsic_value(mixed, "2021-01-01", 700.0, fwd, 0.03, None,
                               num_inventory_grid_points=50, dtype=F64)
        assert same.npv == pytest.approx(exact.npv, rel=1e-12)


class TestTreeNonUniformGrid:
    def test_nonuniform_tree_grid_calc_converges(self):
        """A non-uniform tree grid must use the general interpolation (a
        uniform-arithmetic lookup on these grids would silently misprice)."""
        fwd = _market()
        vol = pd.Series(0.6, index=fwd.index.copy())

        def bottom_heavy(lo, hi):
            u = np.linspace(0.0, 1.0, 60) ** 2
            return lo + (hi - lo) * u

        res = trinomial_value(
            _storage(), "2021-01-01", 700.0, fwd, vol, 10.0, 1.0 / 365,
            0.03, None, dtype=F64, grid_calc=bottom_heavy)
        dense = trinomial_value(
            _storage(), "2021-01-01", 700.0, fwd, vol, 10.0, 1.0 / 365,
            0.03, None, num_inventory_grid_points=400, dtype=F64)
        assert res == pytest.approx(dense, rel=2e-3)


def test_grid_calc_accepts_raw_arrays():
    """grid_calc may be a pre-built [num_periods, G] array (the raw
    user-supplied-grid form of IDoubleStateSpaceGridCalc)."""
    from storage_tpu.valuation_inputs import prepare_valuation
    from storage_tpu import grid as gridmod

    fwd = _market()
    inputs = prepare_valuation(_storage(), "2021-01-01", 700.0, fwd, 0.03, None)
    n = len(inputs.inventory_lower)
    raw = np.stack([
        np.linspace(inputs.inventory_lower[t], inputs.inventory_upper[t], 50)
        for t in range(n)
    ])
    base = intrinsic_value(_storage(), "2021-01-01", 700.0, fwd, 0.03, None,
                           num_inventory_grid_points=50, dtype=F64)
    res = intrinsic_value(_storage(), "2021-01-01", 700.0, fwd, 0.03, None,
                          dtype=F64, grid_calc=raw)
    assert res.npv == pytest.approx(base.npv, rel=1e-12)
    with pytest.raises(ValueError, match="one row per period"):
        gridmod.inventory_grids_custom(
            inputs.inventory_lower, inputs.inventory_upper, raw[:3])
