"""Calendar/period utilities.

The reference library builds typed period arithmetic on ``Cmdty.TimePeriodValueTypes``
(``Day``, ``Month``, ``Hour``, ... — see reference ``utils.py:131-138`` for the freq map).
This design instead keeps pandas ``Period``/``PeriodIndex`` strictly at the API
boundary and converts everything to integer step indices plus precomputed ``float64``
day-count / year-fraction arrays before any device code runs.
"""
from __future__ import annotations

import datetime as _dt
import typing as tp

import numpy as np
import pandas as pd

# Mirrors the supported frequencies of the reference (utils.py:131-138):
# 15/30 minutes, hour, day, month, quarter. Keys are normalised pandas freq strings.
SUPPORTED_FREQS: tp.Dict[str, str] = {
    "15min": "15min",
    "30min": "30min",
    "H": "h",
    "h": "h",
    "D": "D",
    "M": "M",
    "Q": "Q",
}

_DAYS_PER_YEAR = 365.0


def normalise_freq(freq: str) -> str:
    """Map a user-supplied freq string onto the pandas freq used internally."""
    if freq not in SUPPORTED_FREQS:
        raise ValueError(
            f"freq parameter value of '{freq}' not supported. Supported values: "
            f"{sorted(set(SUPPORTED_FREQS))}."
        )
    return SUPPORTED_FREQS[freq]


PeriodSpec = tp.Union[str, _dt.date, _dt.datetime, pd.Period, pd.Timestamp]


def to_period(value: PeriodSpec, freq: str) -> pd.Period:
    """Convert a date-like spec to a pandas Period of the given (normalised) freq."""
    if isinstance(value, pd.Period):
        if value.freqstr != pd.Period("2020", freq=freq).freqstr:
            return value.asfreq(freq)
        return value
    return pd.Period(value, freq=freq)


def period_index(start: pd.Period, end: pd.Period) -> pd.PeriodIndex:
    """Inclusive period range [start, end]."""
    return pd.period_range(start=start, end=end, freq=start.freqstr)


def period_offset(period: pd.Period, base: pd.Period) -> int:
    """Number of periods from ``base`` to ``period`` (same freq).

    Neither ``(p1 - p2).n`` nor raw ordinal differences count *periods* for
    multiple-unit frequencies: pandas returns/stores minutes for 15min/30min
    periods.  The ordinal difference divided by the frequency multiple
    (``freq.n``: 15/30 for the intraday freqs, 1 for h/D/M/Q) is the period
    count at every supported frequency.
    """
    return (period.ordinal - base.ordinal) // base.freq.n


def period_start_date(period: pd.Period) -> _dt.date:
    return period.start_time.date()


def day_offset(from_date: _dt.date, to_date: _dt.date) -> int:
    return (to_date - from_date).days


def act365(from_date: _dt.date, to_date: _dt.date) -> float:
    """Act/365 year fraction (reference ``time_func.py`` / TimeFunctions.Act365)."""
    return day_offset(from_date, to_date) / _DAYS_PER_YEAR


def act365_times(base: PeriodSpec, periods: pd.PeriodIndex) -> np.ndarray:
    """Year fractions from ``base`` to the start of each period in ``periods``."""
    if isinstance(base, pd.Period):
        base_date = period_start_date(base)
    elif isinstance(base, (pd.Timestamp, _dt.datetime)):
        base_date = base.date() if hasattr(base, "date") else base
    elif isinstance(base, _dt.date):
        base_date = base
    else:
        base_date = pd.Timestamp(base).date()
    return np.array(
        [act365(base_date, period_start_date(p)) for p in periods], dtype=np.float64
    )


def series_on_index(
    value: tp.Union[float, int, pd.Series],
    index: pd.PeriodIndex,
    name: str,
    allow_none: bool = False,
) -> np.ndarray:
    """Broadcast a scalar, or align a pandas Series, onto ``index`` → float64 array.

    Mirrors the scalar-or-Series polymorphism of the reference Python API
    (``cmdty_storage.py:60-76``): a Series must cover the whole index.
    """
    if value is None:
        if allow_none:
            return np.zeros(len(index), dtype=np.float64)
        raise ValueError(f"{name} must not be None.")
    if np.isscalar(value):
        return np.full(len(index), float(value), dtype=np.float64)
    if not isinstance(value, pd.Series):
        raise TypeError(f"{name} must be a scalar or pandas Series.")
    try:
        aligned = value.reindex(index)
    except Exception as exc:  # pragma: no cover - defensive
        raise ValueError(f"{name} series could not be aligned to the storage periods: {exc}")
    if aligned.isna().any():
        missing = aligned.index[aligned.isna()][0]
        raise ValueError(f"{name} time series does not cover period {missing}.")
    return aligned.to_numpy(dtype=np.float64)
