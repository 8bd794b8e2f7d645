"""Path-sharding tests on the virtual 8-device CPU mesh.

The key property (SURVEY.md §4.3): valuation results are invariant to the
shard count — counter-based RNG keyed by global path id plus psum'd
regression moments and reductions mean a 1-device and an 8-device mesh
compute the same numbers up to reduction-order float noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import CmdtyStorage
from storage_tpu.basis import parse_basis_functions
from storage_tpu.engines import lsmc as lsmc_engine
from storage_tpu.models import multi_factor as mf
from storage_tpu.parallel import mesh as pmesh
from storage_tpu.valuation_inputs import prepare_valuation

F64 = jnp.float64


def build_case(num_steps=40, num_grid=30, dtype=F64):
    storage = CmdtyStorage(
        "D", "2021-01-01", pd.Period("2021-01-01", freq="D") + num_steps, 0.9, 0.7,
        min_inventory=0.0, max_inventory=5_000.0,
        max_injection_rate=300.0, max_withdrawal_rate=300.0,
    )
    idx = pd.period_range("2021-01-01", storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 30.0))
    inputs = prepare_valuation(storage, "2021-01-01", 100.0, fwd, 0.02, None)
    vol_curve = pd.Series(index=idx.copy(), data=0.8)
    lt_curve = pd.Series(index=idx.copy(), data=0.2)
    pre = mf.simulation_precompute(
        [(10.0, vol_curve), (0.0, lt_curve)], 0.4, inputs.val_day,
        list(inputs.periods), "D",
    )
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, num_grid, dtype,
    )
    sim_inputs = pmesh.sim_inputs_from_precompute(pre, inputs.fwd, dtype)
    monomials = tuple(parse_basis_functions("1 + x0 + x0**2 + x1 + s"))
    return inputs, arrays, sim_inputs, monomials


def run_on_mesh(n_devices, num_sims=256, return_sim_data=False):
    inputs, arrays, sim_inputs, monomials = build_case()
    mesh = pmesh.make_mesh(n_devices)
    return pmesh.sharded_lsmc_core(
        mesh, arrays, sim_inputs,
        jax.random.key(7), jax.random.key(9), num_sims,
        inputs.starting_inventory, monomials,
        num_extra_decisions=0, discount_deltas=False, terminal_fn=None,
        ratchet_is_step=False, return_sim_data=return_sim_data,
    )


class TestShardCountInvariance:
    def test_npv_invariant_across_shard_counts(self):
        results = {n: run_on_mesh(n) for n in (1, 2, 8)}
        base = float(results[1]["npv"])
        for n in (2, 8):
            assert float(results[n]["npv"]) == pytest.approx(base, rel=1e-9)
            np.testing.assert_allclose(
                np.asarray(results[n]["deltas"]), np.asarray(results[1]["deltas"]),
                rtol=1e-8, atol=1e-10,
            )
            np.testing.assert_allclose(
                np.asarray(results[n]["profile_inventory"]),
                np.asarray(results[1]["profile_inventory"]),
                rtol=1e-8,
            )

    def test_standard_error_invariant(self):
        r1, r8 = run_on_mesh(1), run_on_mesh(8)
        assert float(r8["standard_error"]) == pytest.approx(
            float(r1["standard_error"]), rel=1e-9
        )

    def test_per_sim_panels_cover_all_paths(self):
        r = run_on_mesh(8, num_sims=256, return_sim_data=True)
        inv = np.asarray(r["sim_inventory"])
        assert inv.shape[1] == 256
        # First row is the common starting inventory for every path/shard.
        np.testing.assert_allclose(inv[0], 100.0)

    def test_sharded_matches_single_device_engine(self):
        """The shard_map path equals a direct single-device engine call on the
        same simulated paths."""
        inputs, arrays, sim_inputs, monomials = build_case()
        from storage_tpu.models.spot_sim import simulate_ou_paths

        reg = simulate_ou_paths(
            jax.random.key(7), jnp.arange(256), sim_inputs["decay"],
            sim_inputs["chol"], sim_inputs["vols"], sim_inputs["half_var"],
            sim_inputs["fwd"],
        )
        val = simulate_ou_paths(
            jax.random.key(9), jnp.arange(256), sim_inputs["decay"],
            sim_inputs["chol"], sim_inputs["vols"], sim_inputs["half_var"],
            sim_inputs["fwd"],
        )
        direct = lsmc_engine.lsmc_core(
            arrays, reg.spot, reg.factors, val.spot, val.factors,
            jnp.asarray(inputs.starting_inventory, F64), monomials, 0, False,
            None, False, axis_name=None,
        )
        sharded = run_on_mesh(8)
        assert float(sharded["npv"]) == pytest.approx(float(direct["npv"]), rel=1e-9)

    def test_fused_pallas_path_shard_invariant(self):
        """The Pallas decision kernel (interpret mode) under shard_map: the
        per-step moments psum must make the regression — and therefore every
        reduced output — invariant to the shard count."""
        from storage_tpu.ops import decision_kernel

        F32 = jnp.float32

        def run(n_devices, num_sims=1024):
            inputs, arrays, sim_inputs, monomials = build_case(dtype=F32)
            mesh = pmesh.make_mesh(n_devices)
            with decision_kernel.interpret_mode():
                return pmesh.sharded_lsmc_core(
                    mesh, arrays, sim_inputs,
                    jax.random.key(7), jax.random.key(9), num_sims,
                    inputs.starting_inventory, monomials,
                    num_extra_decisions=0, discount_deltas=False,
                    terminal_fn=None, ratchet_is_step=False,
                    use_pallas=True,
                )

        r1, r8 = run(1), run(8)
        # f32 reduction order differs across shard counts (psum of per-shard
        # moments), which can also flip near-tie decisions on a handful of
        # the 1024 sims; the psum'd moment path must still agree to f32
        # accumulation + tie-flip noise.
        assert float(r8["npv"]) == pytest.approx(float(r1["npv"]), rel=5e-4)
        np.testing.assert_allclose(
            np.asarray(r8["deltas"]), np.asarray(r1["deltas"]), rtol=1e-3,
            atol=2e-2 * float(np.max(np.abs(np.asarray(r1["deltas"])))),
        )

    def test_num_sims_not_divisible_raises(self):
        inputs, arrays, sim_inputs, monomials = build_case()
        mesh = pmesh.make_mesh(8)
        with pytest.raises(ValueError, match="multiple of the mesh"):
            pmesh.sharded_lsmc_core(
                mesh, arrays, sim_inputs, jax.random.key(0), jax.random.key(1),
                100, 0.0, monomials, 0, False, None, False,
            )

    def test_pad_num_sims(self):
        assert pmesh.pad_num_sims(100, 8) == 104
        assert pmesh.pad_num_sims(96, 8) == 96
