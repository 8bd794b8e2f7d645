"""Polynomial ratchets: device-table error control and end-to-end valuations
(reference PolynomialInjectWithdrawConstraint.cs:35-157).

The reference evaluates the exact fitted polynomial everywhere with robust
root finding.  This framework's device kernels consume piecewise-linear node
tables, so the polynomial is sampled adaptively: to float32 exactness of the
rate scale when that fits the 129-node budget, else as tightly as
the budget allows — with the realised error bound computable and asserted
against measured error here, and end-to-end LSMC + intrinsic valuations
pinned against a near-exact dense table.
"""
import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp

from storage_tpu import CmdtyStorage, intrinsic_value, multi_factor_value
from storage_tpu.constraints import PolynomialInjectWithdrawConstraint

F64 = jnp.float64

NODES = [
    (0.0, -160.0, 250.0),
    (500.0, -180.0, 260.0),
    (1000.0, -250.0, 220.0),
    (1500.0, -310.0, 140.0),
]


class TestTableErrorControl:
    def test_measured_error_within_bound(self):
        c = PolynomialInjectWithdrawConstraint(NODES)
        lo, hi = 0.0, 1500.0
        inv, mn, mx, _ = c.table(lo, hi)
        bound = c.table_error_bound(lo, hi)
        probe = np.linspace(lo, hi, 20011)
        lerp_min = np.interp(probe, inv, mn)
        lerp_max = np.interp(probe, inv, mx)
        err = max(
            np.max(np.abs(lerp_min - c._min_poly(probe))),
            np.max(np.abs(lerp_max - c._max_poly(probe))),
        )
        assert err <= bound * (1 + 1e-9)
        # The bound itself is tiny relative to the rate scale (~310): far
        # below any physically meaningful rate resolution.
        assert bound < 1e-2

    def test_affine_polynomial_is_exact_with_two_nodes(self):
        c = PolynomialInjectWithdrawConstraint(
            [(0.0, -100.0, 200.0), (1000.0, -300.0, 100.0)]
        )
        inv, mn, mx, _ = c.table(0.0, 1000.0)
        assert len(inv) == 2
        assert c.table_error_bound(0.0, 1000.0) == 0.0

    def test_override_still_honoured(self):
        c = PolynomialInjectWithdrawConstraint(NODES, num_table_points=513)
        inv, _, _, _ = c.table(0.0, 1500.0)
        assert len(inv) == 513

    def test_adaptive_cap(self):
        c = PolynomialInjectWithdrawConstraint(NODES)
        inv, _, _, _ = c.table(0.0, 1500.0)
        assert 2 <= len(inv) <= 129


def _poly_storage(num_table_points=None):
    from storage_tpu import RatchetInterp

    storage = CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", 0.8, 0.6,
        ratchets=[("2021-01-01", [(i, mn, mx) for i, mn, mx in NODES])],
        ratchet_interp=RatchetInterp.POLYNOMIAL,
    )
    if num_table_points is not None:
        for c in storage._constraints:
            c._num_table_points = num_table_points
    return storage


def _market():
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=25.0 + 5.0 * np.sin(2 * np.pi * i / 30.0))
    return fwd


class TestEndToEnd:
    """Adaptive-table valuations agree with a near-exact 1025-point table
    (pure-XLA CPU paths handle any width) to far below MC/grid resolution."""

    def test_intrinsic_polynomial_facility(self):
        fwd = _market()
        res = intrinsic_value(
            _poly_storage(), "2021-01-01", 700.0, fwd, 0.03, None,
            num_inventory_grid_points=60, dtype=F64,
        )
        dense = intrinsic_value(
            _poly_storage(num_table_points=1025), "2021-01-01", 700.0, fwd,
            0.03, None, num_inventory_grid_points=60, dtype=F64,
        )
        assert np.isfinite(res.npv) and res.npv > 0
        assert res.npv == pytest.approx(dense.npv, rel=1e-7)

    def test_lsmc_polynomial_facility(self):
        fwd = _market()
        factors = [(8.0, pd.Series(0.7, index=fwd.index.copy()))]
        kwargs = dict(
            seed=11, fwd_sim_seed=13, num_inventory_grid_points=40, dtype=F64,
        )
        res = multi_factor_value(
            _poly_storage(), "2021-01-01", 700.0, fwd, 0.03, None,
            factors, None, 128, "1 + s + x0", False, **kwargs,
        )
        dense = multi_factor_value(
            _poly_storage(num_table_points=1025), "2021-01-01", 700.0, fwd,
            0.03, None, factors, None, 128, "1 + s + x0", False, **kwargs,
        )
        assert np.isfinite(res.npv)
        # The LSMC lower-bound estimator must not sit materially below the
        # intrinsic floor (it can dip within MC noise at 128 sims).
        assert res.npv > res.intrinsic_npv - 2 * res.val_sim_standard_error
        assert res.npv == pytest.approx(dense.npv, rel=1e-6)
        # Table differences of ~1e-3 in the rates can flip a single path's
        # argmax, moving one period's delta by O(rate/num_sims) ≈ 2.4 at
        # 128 sims — compare at that resolution.
        pd.testing.assert_series_equal(
            res.deltas, dense.deltas, rtol=1e-3, atol=5.0
        )
