"""Streamed (in-scan path regeneration) vs materialised engine equivalence.

The streamed engine (``lsmc_core_streamed``) must reproduce the materialised
engine (``simulate_ou_paths`` + ``lsmc_core``): the per-(step, path) counter
RNG regenerates the same draws, the segment regeneration replays the
simulator's own forward recursion from checkpoints (never the unstable
reverse recursion), and the decision/regression logic is shared code.
Agreement is to ~1e-8 relative (one-ULP matmul-lowering differences between
scan and eager contexts, amplified through the regression solve); any real
divergence in the segmentation or clamping logic shows up at O(1).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_sharding import build_case  # noqa: E402

from storage_tpu.engines import lsmc as lsmc_engine
from storage_tpu.models.spot_sim import simulate_ou_paths

F64 = jnp.float64

RESULT_KEYS = (
    "npv", "standard_error", "backward_npv", "deltas", "profile_inventory",
    "profile_inject_withdraw", "profile_pv", "trigger_inject_prices",
    "max_withdraw_volume",
)


def _run_materialised(arrays, sim_inputs, monomials, inv0, num_sims=64,
                      terminal_fn=None, **core_kwargs):
    reg = simulate_ou_paths(
        jax.random.key(7), jnp.arange(num_sims), sim_inputs["decay"],
        sim_inputs["chol"], sim_inputs["vols"], sim_inputs["half_var"],
        sim_inputs["fwd"],
    )
    val = simulate_ou_paths(
        jax.random.key(9), jnp.arange(num_sims), sim_inputs["decay"],
        sim_inputs["chol"], sim_inputs["vols"], sim_inputs["half_var"],
        sim_inputs["fwd"],
    )
    return lsmc_engine.lsmc_core(
        arrays, reg.spot, reg.factors, val.spot, val.factors, inv0,
        monomials, 0, False, terminal_fn, False, axis_name=None, **core_kwargs
    )


def _run_streamed(arrays, sim_inputs, monomials, inv0, num_sims=64,
                  terminal_fn=None, seg_len=16, **core_kwargs):
    return lsmc_engine.lsmc_core_streamed(
        arrays, sim_inputs, jax.random.key(7), jax.random.key(9),
        jnp.arange(num_sims), inv0, monomials, 0, False, terminal_fn, False,
        axis_name=None, seg_len=seg_len, **core_kwargs
    )


def _assert_equivalent(mat, str_, rtol=1e-8):
    # Same draws, same recursion: the only divergence source is a one-ULP
    # difference in the OU matmul between the bulk simulator's scan and the
    # streamed per-step recursion (different XLA dot lowerings), amplified
    # ~1e-10 relative through the regression solve.  Any real logic error
    # (wrong draws, mis-sliced segment, broken clamp) diverges at O(1).
    for k in RESULT_KEYS:
        np.testing.assert_allclose(
            np.asarray(str_[k]), np.asarray(mat[k]), rtol=rtol, atol=1e-6,
            equal_nan=True, err_msg=k,
        )


class TestStreamedEquivalence:
    @pytest.mark.parametrize("seg_len", [1, 7, 16, 40, 64])
    def test_xla_path_bit_equivalent_all_segment_lengths(self, seg_len):
        # 40 steps: seg_len 7 leaves a ragged tail of 5, 16 a tail of 8,
        # 40 exactly one segment, 64 clamps to n.
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        mat = _run_materialised(arrays, sim_inputs, monomials, inv0)
        stream = _run_streamed(
            arrays, sim_inputs, monomials, inv0, seg_len=seg_len
        )
        _assert_equivalent(mat, stream)

    def test_with_terminal_value(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        terminal = lambda price, inv: price * inv * 0.5  # noqa: E731
        mat = _run_materialised(
            arrays, sim_inputs, monomials, inv0, terminal_fn=terminal
        )
        stream = _run_streamed(
            arrays, sim_inputs, monomials, inv0, terminal_fn=terminal
        )
        _assert_equivalent(mat, stream)

    def test_regression_payload_matches(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        mat = _run_materialised(
            arrays, sim_inputs, monomials, inv0, return_regression=True
        )
        stream = _run_streamed(
            arrays, sim_inputs, monomials, inv0, seg_len=13,
            return_regression=True,
        )
        for k in ("regression_mean", "regression_std", "regression_coeffs"):
            # Step 0 is the valuation date: all design columns are
            # deterministic, the ridge system is degenerate and its solution
            # is not unique — predictions agree but raw coefficients depend
            # on sub-ULP input noise.  Compare from step 1.
            np.testing.assert_allclose(
                np.asarray(stream[k])[1:], np.asarray(mat[k])[1:], rtol=1e-8,
                atol=1e-8, err_msg=k,
            )

    def test_same_sims_reuses_regression_stream(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        res = lsmc_engine.lsmc_core_streamed(
            arrays, sim_inputs, jax.random.key(7), jax.random.key(9),
            jnp.arange(64), inv0, monomials, 0, False, None, False,
            axis_name=None, same_sims=True,
        )
        # Same sims => backward and forward NPV estimates coincide closely
        # (the forward pass replays the backward policy on the same paths).
        assert float(res["npv"]) == pytest.approx(
            float(res["backward_npv"]), rel=5e-2
        )

    def test_fused_pallas_interpret_equivalent(self):
        from storage_tpu.ops import decision_kernel

        F32 = jnp.float32
        inputs, arrays, sim_inputs, monomials = build_case(dtype=F32)
        inv0 = jnp.asarray(inputs.starting_inventory, F32)
        with decision_kernel.interpret_mode():
            mat = _run_materialised(
                arrays, sim_inputs, monomials, inv0, num_sims=256,
                use_pallas=True,
            )
            stream = _run_streamed(
                arrays, sim_inputs, monomials, inv0, num_sims=256,
                seg_len=16, use_pallas=True,
            )
        # f32: one-ULP state divergence flips a few near-tie decisions at
        # 256 sims (~0.1% NPV); the f64 tests above pin the tight bound.
        for k in ("npv", "standard_error", "backward_npv"):
            np.testing.assert_allclose(
                np.asarray(stream[k]), np.asarray(mat[k]), rtol=5e-3,
                err_msg=k,
            )


class TestShardedStreaming:
    def test_sharded_stream_matches_materialised(self):
        from storage_tpu.parallel import mesh as pmesh

        inputs, arrays, sim_inputs, monomials = build_case()
        mesh = pmesh.make_mesh(4)

        def run(stream):
            return pmesh.sharded_lsmc_core(
                mesh, arrays, sim_inputs, jax.random.key(7), jax.random.key(9),
                256, inputs.starting_inventory, monomials,
                num_extra_decisions=0, discount_deltas=False, terminal_fn=None,
                ratchet_is_step=False, stream=stream, seg_len=16,
            )

        mat, stream = run(False), run(True)
        _assert_equivalent(mat, stream)

    def test_footprint_autoselect_threshold(self):
        from storage_tpu.parallel import mesh as pmesh

        # 2 sets x (N+1) x S x (F+1) x itemsize; the CPU reports no memory
        # limit, so the fallback constant applies.
        threshold = pmesh.default_stream_threshold()
        assert threshold == pmesh.STREAM_THRESHOLD_FALLBACK_BYTES
        assert pmesh._panel_bytes(365, 1_048_576, 3, 4) > threshold
        assert pmesh._panel_bytes(365, 262_144, 3, 4) < threshold


class TestStreamingEdgeCoverage:
    def test_antithetic_streamed_matches_materialised(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        inv0 = jnp.asarray(inputs.starting_inventory, F64)
        reg = simulate_ou_paths(
            jax.random.key(7), jnp.arange(64), sim_inputs["decay"],
            sim_inputs["chol"], sim_inputs["vols"], sim_inputs["half_var"],
            sim_inputs["fwd"], antithetic=True,
        )
        mat = lsmc_engine.lsmc_core(
            arrays, reg.spot, reg.factors, reg.spot, reg.factors, inv0,
            monomials, 0, False, None, False, axis_name=None,
        )
        stream = lsmc_engine.lsmc_core_streamed(
            arrays, sim_inputs, jax.random.key(7), jax.random.key(7),
            jnp.arange(64), inv0, monomials, 0, False, None, False,
            axis_name=None, seg_len=16, antithetic=True, same_sims=True,
        )
        _assert_equivalent(mat, stream)

    def test_hourly_scale_segmentation_smoke(self):
        """~1 month of hourly steps (720) through the streamed engine at a
        non-dividing segment length: exercises deep outer scans + a ragged
        tail at a horizon 18x the default bench, on tiny shapes."""
        import pandas as pd

        from storage_tpu import CmdtyStorage
        from storage_tpu.basis import parse_basis_functions
        from storage_tpu.models import multi_factor as mf
        from storage_tpu.parallel import mesh as pmesh
        from storage_tpu.valuation_inputs import prepare_valuation

        start = pd.Period("2021-01-01 00:00", freq="h")
        storage = CmdtyStorage(
            "h", start, start + 720, 0.1, 0.1,
            min_inventory=0.0, max_inventory=2_000.0,
            max_injection_rate=40.0, max_withdrawal_rate=40.0,
        )
        idx = pd.period_range(start, storage.end, freq="h")
        i = np.arange(len(idx))
        fwd = pd.Series(index=idx, data=25.0 + 3.0 * np.sin(2 * np.pi * i / 24.0))
        inputs = prepare_valuation(storage, start, 100.0, fwd, 0.02, None)
        vol = pd.Series(index=idx.copy(), data=1.0)
        pre = mf.simulation_precompute(
            [(40.0, vol)], None, inputs.val_day, list(inputs.periods), "h"
        )
        from storage_tpu.engines import lsmc as L

        arrays = L.build_engine_arrays(
            inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
            inputs.inventory_lower, inputs.inventory_upper, 10, F64,
        )
        sim_inputs = pmesh.sim_inputs_from_precompute(pre, inputs.fwd, F64)
        monomials = tuple(parse_basis_functions("1 + s + x0"))
        res = L.lsmc_core_streamed(
            arrays, sim_inputs, jax.random.key(3), jax.random.key(5),
            jnp.arange(16), jnp.asarray(inputs.starting_inventory, F64),
            monomials, 0, False, None, False, axis_name=None, seg_len=48,
        )
        assert np.isfinite(float(res["npv"]))
        assert res["deltas"].shape == (721,)
