"""Hourly-horizon stress: 10k+ decision steps through the native band reducer
and the LSMC engine.

The C++ inventory-space reducer exists precisely to make hourly-granularity
horizons cheap (native/storage_native.cpp:10-11; the algorithm mirrors
StorageHelper.CalculateInventorySpace, reference StorageHelper.cs:39-107).
These tests pin (a) native == Python band equality at 10k+ steps with
ratchets, (b) that the native path is fast enough for interactive use, and
(c) an end-to-end hourly LSMC valuation at 10k+ steps collapsing onto the
intrinsic value under near-zero vol (the reference's degenerate-model oracle
pattern, LsmcStorageValuationTest.cs:573-609, at hourly scale).
"""
import time

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import CmdtyStorage, RatchetInterp, intrinsic_value, multi_factor_value
from storage_tpu import grid as gridmod
from storage_tpu.facility import compile_storage
from storage_tpu.native import load as load_native
from storage_tpu.utils import periods as pu

F64 = jnp.float64

# 2021-01-01 00:00 .. 2022-03-01 00:00 hourly = 10,176 decision steps.
START, END = "2021-01-01 00:00", "2022-03-01 00:00"


def hourly_storage():
    return CmdtyStorage(
        "h", START, END, 0.01, 0.02,
        ratchets=[
            (START, [(0.0, -8.0, 12.0), (40_000.0, -10.0, 9.0), (90_000.0, -14.0, 6.0)]),
        ],
        ratchet_interp=RatchetInterp.LINEAR,
    )


def hourly_market():
    idx = pd.period_range(START, END, freq="h")
    i = np.arange(len(idx))
    # Daily cycle + seasonal swing: value comes from both frequencies.
    data = 25.0 + 3.0 * np.sin(2 * np.pi * i / 24.0) + 5.0 * np.sin(2 * np.pi * i / (24 * 365.0))
    return pd.Series(index=idx, data=data)


class TestNativeBandReduction10k:
    def test_native_matches_python_at_10k_steps(self):
        storage = hourly_storage()
        compiled = compile_storage(storage, pu.to_period(START, "h"))
        assert compiled.num_steps >= 10_000

        t0 = time.perf_counter()
        lo_n, hi_n = gridmod.calculate_inventory_space(
            storage, 30_000.0, START, use_native=True
        )
        t_native = time.perf_counter() - t0

        lo_p, hi_p = gridmod.calculate_inventory_space(
            storage, 30_000.0, START, use_native=False
        )

        # Short horizons match bit-exactly (test_native.py); at 10k+ steps the
        # C++ compiler's FMA contraction can differ from numpy by one ULP in
        # the accumulated band, so pin to 1e-14 relative instead.
        np.testing.assert_allclose(np.asarray(lo_n), np.asarray(lo_p), rtol=1e-14, atol=1e-9)
        np.testing.assert_allclose(np.asarray(hi_n), np.asarray(hi_p), rtol=1e-14, atol=1e-9)
        # Interactive-use bound: the native reducer must handle 10k+ ratcheted
        # steps well under a second (it typically takes ~a millisecond).
        assert t_native < 1.0, f"native reducer too slow: {t_native:.3f}s"

    def test_native_reducer_is_available(self):
        # The stress test above silently falling back to Python would defeat
        # its purpose — pin that the library actually loads.
        assert load_native() is not None


class TestHourlyLsmc10k:
    def test_low_vol_hourly_lsmc_close_to_intrinsic(self):
        storage = hourly_storage()
        fwd = hourly_market()
        vol_idx = pd.period_range(START, END, freq="h")
        factors = [(0.5, pd.Series(index=vol_idx, data=1e-5))]

        t0 = time.perf_counter()
        res = multi_factor_value(
            storage, START, 10_000.0, fwd, 0.0, None, factors, None,
            num_sims=64, basis_funcs="1 + x0", discount_deltas=False,
            seed=5, fwd_sim_seed=7, num_inventory_grid_points=20, dtype=F64,
        )
        elapsed = time.perf_counter() - t0

        assert res.npv == pytest.approx(res.intrinsic_npv, rel=2e-3)
        assert np.isfinite(res.val_sim_standard_error)
        assert len(res.deltas) == len(fwd)
        # Runtime pin: 10k+ steps end-to-end (compile + run, CPU or GPU)
        # must stay practical; fails loudly if per-step overhead regresses.
        assert elapsed < 600.0, f"hourly LSMC took {elapsed:.0f}s"

    def test_hourly_intrinsic_10k_steps(self):
        storage = hourly_storage()
        fwd = hourly_market()
        res = intrinsic_value(
            storage, START, 10_000.0, fwd, 0.0, None,
            num_inventory_grid_points=20, dtype=F64,
        )
        assert res.npv > 0
        assert len(res.profile) == len(fwd)
