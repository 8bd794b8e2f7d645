"""Host-streamed user-supplied sim panels.

BASELINE.md milestone 5 includes 1M user-supplied sim paths on one chip:
materialised panels at that scale (~11.7 GB f32) exceed device HBM, so when
the panel footprint crosses the streaming threshold ``value_from_sims`` keeps
the panels host-side (numpy) and the chunked driver segment-feeds seg_len-step
slices to the device — the user-panel analog of the internally-simulated
streamed engine.  Reference panel ingestion: SpotSimResultsFromPanels.cs:36-117.
"""
import logging
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_lsmc import reg_market, simple_reg_storage  # noqa: E402

from storage_tpu import SimulationDataReturned, multi_factor_value, value_from_sims  # noqa: E402

F64 = jnp.float64


@pytest.fixture
def panels():
    val_date, fwd, rates, settle = reg_market()
    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    factors = [
        (0.0, pd.Series(index=vol_idx, data=0.14)),
        (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
    ]
    res = multi_factor_value(
        simple_reg_storage(), val_date, 0.0, fwd, rates, settle, factors,
        0.64, 128, "1 + x0 + x0**2 + x1", False, seed=11, fwd_sim_seed=13,
        dtype=F64, sim_data_returned=SimulationDataReturned.ALL,
    )
    kwargs = dict(
        sim_spot_regress=res.sim_spot_regress,
        sim_spot_valuation=res.sim_spot_valuation,
        sim_factors_regress=res.sim_factors_regress,
        sim_factors_valuation=res.sim_factors_valuation,
    )
    return val_date, fwd, rates, settle, kwargs


def _value(val_date, fwd, rates, settle, kwargs, **extra):
    return value_from_sims(
        simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
        basis_funcs="1 + x0 + x0**2 + x1", discount_deltas=False, dtype=F64,
        **kwargs, **extra,
    )


def test_host_streamed_matches_materialised(panels, monkeypatch, caplog):
    val_date, fwd, rates, settle, kwargs = panels
    baseline = _value(val_date, fwd, rates, settle, kwargs)

    from storage_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    with caplog.at_level(logging.INFO, logger="storage_tpu.multi_factor"):
        streamed = _value(val_date, fwd, rates, settle, kwargs)
    assert any("host-streamed" in r.message for r in caplog.records)
    assert streamed.npv == pytest.approx(baseline.npv, rel=1e-12)
    pd.testing.assert_series_equal(streamed.deltas, baseline.deltas)
    pd.testing.assert_frame_equal(
        streamed.expected_profile, baseline.expected_profile
    )
    pd.testing.assert_frame_equal(
        streamed.trigger_prices, baseline.trigger_prices
    )


def test_host_streamed_rejects_sim_data(panels, monkeypatch):
    val_date, fwd, rates, settle, kwargs = panels
    from storage_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    with pytest.raises(ValueError, match="do not fit device memory"):
        _value(val_date, fwd, rates, settle, kwargs,
               sim_data_returned=SimulationDataReturned.ALL)


def test_host_streamed_adjoint_matches_pathwise(panels, monkeypatch):
    """Adjoint deltas over host-streamed panels (path-chunked sweep,
    lsmc_ad_deltas_path_chunked): identical to the pathwise series of the
    materialised run."""
    val_date, fwd, rates, settle, kwargs = panels
    pathwise = _value(val_date, fwd, rates, settle, kwargs)

    from storage_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    adj = _value(val_date, fwd, rates, settle, kwargs, deltas_method="adjoint")
    assert adj.npv == pytest.approx(pathwise.npv, rel=1e-12)
    np.testing.assert_allclose(
        adj.deltas.to_numpy(), pathwise.deltas.to_numpy(), rtol=1e-9, atol=1e-9
    )


def test_path_chunked_adjoint_chunking_invariant(panels, monkeypatch):
    """The path-chunked sweep is invariant to the chunk split (incl. a ragged
    last chunk): gradients decompose over sims once the regression payload is
    fixed."""
    val_date, fwd, rates, settle, kwargs = panels
    from storage_tpu.parallel import mesh as pmesh
    from storage_tpu.engines import lsmc as lsmc_engine

    calls = []
    orig = lsmc_engine.lsmc_ad_deltas_path_chunked

    def spy(*args, **kw):
        kw["chunk_sims"] = 37  # 128 sims -> 3 full chunks + ragged 17
        out = orig(*args, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    baseline = _value(val_date, fwd, rates, settle, kwargs, deltas_method="adjoint")
    monkeypatch.setattr(lsmc_engine, "lsmc_ad_deltas_path_chunked", spy)
    chunked = _value(val_date, fwd, rates, settle, kwargs, deltas_method="adjoint")
    assert calls, "path-chunked sweep was not used"
    np.testing.assert_allclose(
        chunked.deltas.to_numpy(), baseline.deltas.to_numpy(),
        rtol=1e-9, atol=1e-9,
    )


def test_host_streamed_with_progress(panels, monkeypatch):
    """Interactivity composes with host streaming (same chunked driver)."""
    val_date, fwd, rates, settle, kwargs = panels
    from storage_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    fractions = []
    res = _value(val_date, fwd, rates, settle, kwargs,
                 on_progress_update=fractions.append)
    assert np.isfinite(res.npv)
    assert len(fractions) >= 122 / 16
    assert fractions[-1] == 1.0


def test_gate_uses_full_footprint_when_paths_do_not_divide_devices(monkeypatch):
    """A path count that does not divide the local mesh falls back to
    single-device execution downstream, so the host-stream gate must compare
    the FULL panel footprint (not footprint/n_devices) against the
    threshold."""
    import jax

    from storage_tpu.api_lsmc import _host_stream_panels, _panel_gb
    from storage_tpu.parallel import mesh as pmesh

    n_dev = len(jax.devices())
    assert n_dev > 1  # conftest provides 8 virtual devices
    s = 8 * 100 + 3  # not divisible by 8
    spot = np.zeros((5, s), np.float64)
    factors = np.zeros((5, 1, s), np.float64)
    footprint = _panel_gb(spot, factors, jnp.float64) * 2**30
    # Threshold between footprint/n_dev and footprint: per-device footprint
    # passes, full footprint does not -> must still host-stream.
    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", int(footprint / 2))
    assert _host_stream_panels(spot, factors, jnp.float64)
    # Divisible count at the same threshold: sharded path can hold it.
    s2 = 8 * 104
    spot2 = np.zeros((5, s2), np.float64)
    factors2 = np.zeros((5, 1, s2), np.float64)
    assert not _host_stream_panels(spot2, factors2, jnp.float64)
