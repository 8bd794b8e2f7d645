"""Per-segment progress callbacks and cooperative cancellation.

The reference fires ``OnProgressUpdate`` once per backward and forward period
and polls its CancellationToken at the same granularity
(LsmcStorageValuation.cs:343-345,521).  This framework's compiled scans cannot
call the host, so interactive runs (a progress callback or cancellation poll
registered) execute host-chunked: 16-step segments dispatched from Python with
a callback between segments — N/16-granularity progress and cancellation that
aborts mid-backward.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_lsmc import reg_market, simple_reg_storage  # noqa: E402
from test_sharding import build_case  # noqa: E402

from storage_tpu import multi_factor_value  # noqa: E402
from storage_tpu.engines import lsmc as lsmc_engine  # noqa: E402
from storage_tpu.jobs import JobCancelledError  # noqa: E402

F64 = jnp.float64


def _factors(val_date):
    vol_idx = pd.period_range(val_date, "2020-06-01", freq="D")
    return [
        (0.0, pd.Series(index=vol_idx, data=0.14)),
        (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
    ]


def _run(**kwargs):
    val_date, fwd, rates, settle = reg_market()
    return multi_factor_value(
        simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
        _factors(val_date), 0.64, 128, "1 + x0 + x0**2 + x1", False,
        seed=11, fwd_sim_seed=11, dtype=F64, **kwargs
    )


class TestSegmentProgress:
    def test_progress_granularity_at_least_n_over_16(self):
        # 122 decision steps -> ceil(122/16) = 8 backward + 8 forward
        # segments, plus the phase-boundary updates.
        fractions = []
        _run(on_progress_update=fractions.append)
        assert len(fractions) >= 122 / 16
        assert fractions == sorted(fractions)  # monotone
        assert fractions[-1] == 1.0
        # Both passes reported: fractions inside (0.3, 0.7] (backward) and
        # (0.7, 0.9] (forward).
        assert any(0.3 < f <= 0.7 for f in fractions)
        assert any(0.7 < f <= 0.9 for f in fractions)

    def test_chunked_matches_unchunked_results(self):
        baseline = _run()
        fractions = []
        chunked = _run(on_progress_update=fractions.append)
        assert chunked.npv == pytest.approx(baseline.npv, rel=1e-12)
        pd.testing.assert_series_equal(chunked.deltas, baseline.deltas)
        pd.testing.assert_frame_equal(
            chunked.expected_profile, baseline.expected_profile
        )

    def test_chunked_engine_matches_streamed_engine(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        keys = (jax.random.key(7), jax.random.key(9))
        plain = lsmc_engine.lsmc_core_streamed(
            arrays, sim_inputs, *keys, jnp.arange(64), inv0, monomials,
            0, False, None, False, axis_name=None, seg_len=16,
        )
        calls = []
        chunked = lsmc_engine.lsmc_core_streamed_chunked(
            arrays, sim_inputs, *keys, jnp.arange(64), inv0, monomials,
            0, False, None, False, seg_len=16,
            segment_cb=lambda *a: calls.append(a),
        )
        for k in ("npv", "standard_error", "deltas", "profile_pv",
                  "backward_npv"):
            np.testing.assert_allclose(
                np.asarray(chunked[k]), np.asarray(plain[k]), rtol=1e-12,
                err_msg=k,
            )
        # 40 steps, seg 16: 3 backward + 3 forward segments.
        assert len(calls) == 6
        assert calls[0][2] == 3  # total segments per pass


class TestCancellation:
    def test_cancel_aborts_mid_backward(self):
        seen = []

        def poll():
            # Allow the simulation/intrinsic phases, then cancel on the
            # first poll after backward segments start reporting.
            return any(0.3 < f < 0.7 for f in seen)

        def on_progress(f):
            seen.append(f)

        with pytest.raises(JobCancelledError):
            _run(on_progress_update=on_progress, cancellation_poll=poll)
        # Aborted mid-backward: no forward-pass (>0.7) progress ever fired.
        assert not any(f > 0.7 for f in seen)

    def test_no_cancel_completes(self):
        res = _run(cancellation_poll=lambda: False)
        assert np.isfinite(res.npv)


class TestMaterialisedChunked:
    """Per-segment progress/cancellation for materialised
    and user-supplied-sims runs (reference per-period polling,
    LsmcStorageValuation.cs:343-345,521)."""

    def test_chunked_engine_matches_lsmc_core(self):
        from storage_tpu.models.spot_sim import simulate_ou_paths

        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        ids = jnp.arange(64)
        reg = simulate_ou_paths(
            jax.random.key(7), ids, sim_inputs["decay"], sim_inputs["chol"],
            sim_inputs["vols"], sim_inputs["half_var"], sim_inputs["fwd"])
        val = simulate_ou_paths(
            jax.random.key(9), ids, sim_inputs["decay"], sim_inputs["chol"],
            sim_inputs["vols"], sim_inputs["half_var"], sim_inputs["fwd"])
        plain = lsmc_engine.lsmc_core(
            arrays, reg.spot, reg.factors, val.spot, val.factors, inv0,
            monomials, 0, False, None, False, axis_name=None)
        calls = []
        chunked = lsmc_engine.lsmc_core_chunked(
            arrays, reg.spot, reg.factors, val.spot, val.factors, inv0,
            monomials, 0, False, None, False, seg_len=16,
            segment_cb=lambda *a: calls.append(a))
        for k in ("npv", "standard_error", "deltas", "profile_pv",
                  "backward_npv"):
            np.testing.assert_allclose(
                np.asarray(chunked[k]), np.asarray(plain[k]), rtol=1e-12,
                err_msg=k)
        # 40 steps, seg 16: 3 backward + 3 forward segments.
        assert len(calls) == 6
        assert calls[0][2] == 3

    def test_value_from_sims_progress_and_cancel(self):
        from storage_tpu import value_from_sims

        val_date, fwd, rates, settle = reg_market()
        base = _run(sim_data_returned="ALL")
        kwargs = dict(
            sim_spot_regress=base.sim_spot_regress,
            sim_spot_valuation=base.sim_spot_valuation,
            sim_factors_regress=base.sim_factors_regress,
            sim_factors_valuation=base.sim_factors_valuation,
        )
        fractions = []
        res = value_from_sims(
            simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
            basis_funcs="1 + x0 + x0**2 + x1", discount_deltas=False,
            dtype=F64, on_progress_update=fractions.append, **kwargs)
        # Reference-granularity progress: >= ceil(122/16) segment ticks per
        # pass, monotone, final 1.0 — and identical numbers.
        assert len(fractions) >= 122 / 16
        assert fractions == sorted(fractions)
        assert fractions[-1] == 1.0
        assert any(0.3 < f <= 0.7 for f in fractions)
        assert any(0.7 < f <= 0.9 for f in fractions)
        baseline = value_from_sims(
            simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
            basis_funcs="1 + x0 + x0**2 + x1", discount_deltas=False,
            dtype=F64, **kwargs)
        assert res.npv == pytest.approx(baseline.npv, rel=1e-12)
        pd.testing.assert_series_equal(res.deltas, baseline.deltas)

        # Cooperative cancellation aborts mid-backward.
        seen = []
        with pytest.raises(JobCancelledError):
            value_from_sims(
                simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
                basis_funcs="1 + x0 + x0**2 + x1", discount_deltas=False,
                dtype=F64, on_progress_update=seen.append,
                cancellation_poll=lambda: any(0.3 < f < 0.7 for f in seen),
                **kwargs)
        assert not any(f > 0.7 for f in seen)

    def test_materialised_sim_data_run_gets_segment_progress(self):
        """An internally-simulated run that materialises per-sim panels
        (sim_data_returned=ALL) now also gets per-segment granularity."""
        fractions = []
        res = _run(sim_data_returned="ALL", on_progress_update=fractions.append)
        assert len(fractions) >= 122 / 16
        assert fractions[-1] == 1.0
        baseline = _run(sim_data_returned="ALL")
        assert res.npv == pytest.approx(baseline.npv, rel=1e-12)
        pd.testing.assert_frame_equal(res.sim_inventory, baseline.sim_inventory)


class TestMultiDeviceChunked:
    """Interactive (host-chunked) execution no longer
    costs a multi-device host its sharding — each segment dispatches
    shard_map'd over the local path mesh."""

    def test_chunked_mesh_engages_and_matches_sharded(self, monkeypatch):
        """512 sims on the 8-virtual-device mesh: the per-segment shard_map
        path must engage (spied) and reproduce the non-interactive sharded
        valuation exactly."""
        from storage_tpu.engines import lsmc as lsmc_engine

        calls = {"bwd": 0, "fwd": 0}
        orig_bwd = lsmc_engine._ChunkedMeshCalls.bwd_seg_streamed
        orig_fwd = lsmc_engine._ChunkedMeshCalls.fwd_seg_streamed

        def spy_bwd(self, *a, **k):
            calls["bwd"] += 1
            return orig_bwd(self, *a, **k)

        def spy_fwd(self, *a, **k):
            calls["fwd"] += 1
            return orig_fwd(self, *a, **k)

        monkeypatch.setattr(lsmc_engine._ChunkedMeshCalls, "bwd_seg_streamed", spy_bwd)
        monkeypatch.setattr(lsmc_engine._ChunkedMeshCalls, "fwd_seg_streamed", spy_fwd)

        fractions = []
        interactive = self._run(512, on_progress_update=fractions.append)
        assert calls["bwd"] >= 122 // 16 and calls["fwd"] >= 122 // 16
        assert fractions[-1] == 1.0
        baseline = self._run(512)
        assert interactive.npv == pytest.approx(baseline.npv, rel=1e-12)
        pd.testing.assert_series_equal(interactive.deltas, baseline.deltas)
        pd.testing.assert_frame_equal(
            interactive.trigger_prices, baseline.trigger_prices
        )

    @staticmethod
    def _run(num_sims, **kwargs):
        val_date, fwd, rates, settle = reg_market()
        return multi_factor_value(
            simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
            _factors(val_date), 0.64, num_sims, "1 + x0 + x0**2 + x1", False,
            seed=11, fwd_sim_seed=11, dtype=F64, **kwargs
        )

    def test_nondivisible_path_count_falls_back(self):
        """A path count that does not divide the mesh keeps the single-device
        chunked path (same results, just unsharded)."""
        fractions = []
        res = self._run(100, on_progress_update=fractions.append)
        baseline = self._run(100)
        assert fractions[-1] == 1.0
        assert res.npv == pytest.approx(baseline.npv, rel=1e-12)


def test_checkpoint_composes_with_multi_device_interactive(tmp_path):
    """checkpoint_path + progress callback on the 8-device mesh: the
    regression payload flows out of the per-segment shard_map (replicated
    out_specs) and the persisted checkpoint reprices to the same NPV."""
    import numpy as np

    from storage_tpu.checkpoint import RegressionCheckpoint

    path = str(tmp_path / "ck.npz")
    val_date, fwd, rates, settle = reg_market()
    fractions = []
    res = multi_factor_value(
        simple_reg_storage(), val_date, 0.0, fwd, rates, settle,
        _factors(val_date), 0.64, 512, "1 + x0 + x0**2 + x1", False,
        seed=11, fwd_sim_seed=11, dtype=F64,
        on_progress_update=fractions.append, checkpoint_path=path,
    )
    assert fractions[-1] == 1.0
    ckpt = RegressionCheckpoint.load(path)
    assert np.isfinite(res.npv)
    assert ckpt.regression["coeffs"].ndim == 3
