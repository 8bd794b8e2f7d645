"""Discounting and settlement-date handling.

The reference discounts every cash flow with an Act/365 continuously-compounded
rate looked up on the cash-flow date (``StorageHelper.cs:251-276``), with the
settlement date of each delivery period given by a user ``settlement_rule``
callable (``multi_factor.py:103-105``).  This build precomputes, per active
step, the discount factors needed by the engines so no date logic exists on
device.
"""
from __future__ import annotations

import datetime as _dt
import typing as tp

import numpy as np
import pandas as pd

from . import periods as pu


def act365_discount_factor(
    present_day: _dt.date, cash_flow_day: _dt.date, rate: float
) -> float:
    """exp(-r * days/365); 1.0 for cash flows on/before the present day
    (reference ``StorageHelper.cs:262-273``)."""
    offset = pu.day_offset(present_day, cash_flow_day)
    if offset <= 0:
        return 1.0
    return float(np.exp(-offset / 365.0 * rate))


class Discounter:
    """Act/365 continuously-compounded discounter from a daily interest-rate series.

    Rates are looked up on the cash-flow date; a missing date raises, mirroring
    ``StorageHelper.CreateAct65ContCompDiscounterFromSeries`` (StorageHelper.cs:251-259).
    """

    def __init__(self, interest_rates: tp.Union[float, pd.Series]):
        if np.isscalar(interest_rates):
            self._flat: tp.Optional[float] = float(interest_rates)
            self._series = None
        else:
            if not isinstance(interest_rates, pd.Series):
                raise TypeError("interest_rates must be a scalar or pandas Series.")
            self._flat = None
            series = interest_rates
            if isinstance(series.index, pd.PeriodIndex):
                if series.index.freqstr != "D":
                    series = series.copy()
                    series.index = series.index.asfreq("D")
            else:
                series = series.copy()
                series.index = pd.PeriodIndex(series.index, freq="D")
            self._series = series

    def rate(self, cash_flow_day: _dt.date) -> float:
        if self._flat is not None:
            return self._flat
        key = pd.Period(cash_flow_day, freq="D")
        try:
            value = self._series.loc[key]
        except KeyError:
            raise ValueError(f"No interest rate provided for {cash_flow_day}.")
        if pd.isna(value):
            raise ValueError(f"No interest rate provided for {cash_flow_day}.")
        return float(value)

    def discount_factor(self, present_day: _dt.date, cash_flow_day: _dt.date) -> float:
        if pu.day_offset(present_day, cash_flow_day) <= 0:
            return 1.0
        return act365_discount_factor(present_day, cash_flow_day, self.rate(cash_flow_day))


SettlementRule = tp.Callable[[pd.Period], _dt.date]


def settlement_days(
    active_periods: pd.PeriodIndex, settlement_rule: tp.Optional[SettlementRule]
) -> tp.List[_dt.date]:
    """Settlement date per period; default = period start day."""
    if settlement_rule is None:
        return [pu.period_start_date(p) for p in active_periods]
    days = []
    for p in active_periods:
        d = settlement_rule(p)
        if isinstance(d, pd.Timestamp):
            d = d.date()
        elif isinstance(d, pd.Period):
            d = pu.period_start_date(d)
        elif isinstance(d, _dt.datetime):
            d = d.date()
        days.append(d)
    return days


def discount_factors_for_periods(
    val_day: _dt.date,
    active_periods: pd.PeriodIndex,
    settlement_rule: tp.Optional[SettlementRule],
    discounter: Discounter,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(df_settle[t], df_flow[t]) per active period.

    ``df_settle`` discounts the commodity sale/purchase cash flow settled on
    ``settlement_rule(period)``; ``df_flow`` discounts operating-cost cash flows
    that the reference books on the period's first day
    (``CmdtyStorage.cs:334-341,552-557``).
    """
    settle = settlement_days(active_periods, settlement_rule)
    df_settle = np.array(
        [discounter.discount_factor(val_day, d) for d in settle], dtype=np.float64
    )
    df_flow = np.array(
        [
            discounter.discount_factor(val_day, pu.period_start_date(p))
            for p in active_periods
        ],
        dtype=np.float64,
    )
    return df_settle, df_flow


def log_linear_discount_factors(
    val_day,
    rate_curve: pd.Series,
) -> tp.Callable[[_dt.date], float]:
    """Discount-factor function from a SPARSE rate curve by log-linear
    interpolation of discount factors between the provided pillar dates
    (the Excel add-in's curve handling, StorageExcelHelper.cs:294).

    ``rate_curve`` is indexed by pillar dates (anything pandas can coerce to
    daily periods) holding continuously-compounded Act/365 zero rates.  The
    returned function interpolates ln(DF) linearly in calendar days between
    pillars and extrapolates flat-rate beyond the last pillar.
    """
    if not isinstance(rate_curve, pd.Series) or len(rate_curve) == 0:
        raise ValueError("rate_curve must be a non-empty pandas Series.")
    idx = rate_curve.index
    if isinstance(idx, pd.PeriodIndex):
        days = [pu.period_start_date(p.asfreq("D")) for p in idx]
    else:
        days = [pd.Period(d, freq="D").start_time.date() for d in idx]
    val_day = pd.Period(val_day, freq="D").start_time.date()
    pillars = sorted(zip(days, rate_curve.values))
    pillar_days = [d for d, _ in pillars]
    log_dfs = [
        -float(r) * max(pu.day_offset(val_day, d), 0) / 365.0 for d, r in pillars
    ]
    offsets = [pu.day_offset(val_day, d) for d in pillar_days]

    def discount_factor(cash_flow_day: _dt.date) -> float:
        if isinstance(cash_flow_day, (pd.Timestamp, _dt.datetime)):
            cash_flow_day = cash_flow_day.date() if hasattr(cash_flow_day, "date") else cash_flow_day
        t = pu.day_offset(val_day, cash_flow_day)
        if t <= 0:
            return 1.0
        if t <= offsets[0]:
            # Before the first pillar: flat rate from the first pillar.
            return float(np.exp(log_dfs[0] * t / max(offsets[0], 1)))
        if t >= offsets[-1]:
            # Beyond the last pillar: flat-rate extrapolation.
            rate = -log_dfs[-1] / max(offsets[-1], 1)
            return float(np.exp(-rate * t))
        hi = int(np.searchsorted(offsets, t))
        lo = hi - 1
        w = (t - offsets[lo]) / (offsets[hi] - offsets[lo])
        return float(np.exp(log_dfs[lo] * (1 - w) + log_dfs[hi] * w))

    return discount_factor
