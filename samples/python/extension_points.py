"""Extension-point walkthrough: custom inventory grids, cubic tree
interpolation, per-period mixed ratchet interpolation, and error-controlled
polynomial ratchets.

These are the analogs of the reference's open interfaces:
``IDoubleStateSpaceGridCalc`` (grid schemes), ``IInterpolatorFactory``
(continuation interpolation) and per-period ``IInjectWithdrawConstraint``
objects (CmdtyStorage.cs:41-50).

Run: python samples/python/extension_points.py
"""
import numpy as np
import pandas as pd

from storage_tpu import (
    CmdtyStorage, RatchetInterp, intrinsic_value, multi_factor_value,
    trinomial_value,
)

idx = pd.period_range("2025-04-01", "2026-06-01", freq="D")
fwd = pd.Series(22.0 + 6.0 * np.cos(2 * np.pi * (idx.dayofyear / 365.0)), index=idx)
rates = 0.03

# ---- Per-period MIXED ratchet interpolation: linear profile for summer,
# step-constrained winter (each ratchet entry may carry its own interp).
storage = CmdtyStorage(
    "D", "2025-04-01", "2026-04-01", 0.01, 0.025,
    ratchets=[
        ("2025-04-01",
         [(0.0, -30.9, 25.5), (800.0, -32.0, 22.0), (1500.0, -34.0, 18.0)],
         RatchetInterp.LINEAR),
        ("2025-10-01",
         [(0.0, -35.0, 20.0), (700.0, -40.0, 15.0), (1500.0, -40.0, 15.0)],
         RatchetInterp.STEP),
    ],
    ratchet_interp=RatchetInterp.LINEAR,
    terminal_storage_npv=lambda price, inventory: 0.0,
)

iv = intrinsic_value(storage, "2025-04-01", 300.0, fwd, rates, None)
print(f"mixed-ratchet intrinsic NPV: {iv.npv:,.2f}")

# ---- Custom per-period inventory grids: concentrate points near empty,
# where the value function kinks hardest.  Uniform rows keep the Pallas
# decision kernel; non-uniform rows (like this one) take the general-interp path.
def bottom_heavy_grid(lower, upper):
    u = np.linspace(0.0, 1.0, 100) ** 1.5
    return lower + (upper - lower) * u


res = multi_factor_value(
    storage, "2025-04-01", 300.0, fwd, rates, None,
    [(10.0, pd.Series(0.8, index=fwd.index.copy()))], None,
    8192, "1 + s + s**2 + x0", False, seed=11, fwd_sim_seed=12,
    grid_calc=bottom_heavy_grid,
)
print(f"LSMC NPV on the custom grid:  {res.npv:,.2f} "
      f"(SE {res.val_sim_standard_error:,.2f})")

# ---- Cubic continuation interpolation in the trinomial tree (the
# reference's NaturalCubicSplineInterpolatorFactory; linear is the default
# and cubic is documented there as occasionally poorly behaved).
vol = pd.Series(0.7, index=fwd.index.copy())
lin = trinomial_value(storage, "2025-04-01", 300.0, fwd, vol, 14.5, 1 / 365,
                      rates, None)
cub = trinomial_value(storage, "2025-04-01", 300.0, fwd, vol, 14.5, 1 / 365,
                      rates, None, interpolation="cubic")
print(f"tree NPV linear/cubic:        {lin:,.2f} / {cub:,.2f}")

# ---- Polynomial ratchets: the device table is sampled adaptively so the
# piecewise-linear error stays below f32 resolution of the rate scale
# (bounded by table_error_bound when the 129-node kernel budget binds).
from storage_tpu.constraints import PolynomialInjectWithdrawConstraint

poly = PolynomialInjectWithdrawConstraint(
    [(0.0, -30.0, 26.0), (500.0, -33.0, 24.0), (1000.0, -38.0, 19.0),
     (1500.0, -40.0, 15.0)]
)
print(f"polynomial table error bound over [0, 1500]: "
      f"{poly.table_error_bound(0.0, 1500.0):.2e}")
