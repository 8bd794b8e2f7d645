"""LsmcValuationParameters builder, cancellation, basis combinators, and the
device-sharded user-sims path."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import (
    CmdtyStorage,
    JobCancelledError,
    LsmcValuationParameters,
    ONE, S, X0, X1,
    SimulationDataReturned,
    lsmc_value,
    multi_factor_value,
)

F64 = jnp.float64


def simple_storage():
    return CmdtyStorage(
        "D", "2019-12-01", "2020-01-10", 1.23, 0.98,
        min_inventory=0.0, max_inventory=10_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def market():
    val_date = "2019-11-20"
    idx = pd.period_range(val_date, "2020-01-10", freq="D")
    fwd = pd.Series(index=idx, data=np.linspace(23.0, 28.0, len(idx)))
    rates = pd.Series(index=pd.period_range(val_date, "2020-03-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return val_date, fwd, rates, settle


def factors_2f(val_date):
    vol_idx = pd.period_range(val_date, "2020-03-01", freq="D")
    return [
        (0.0, pd.Series(index=vol_idx, data=0.14)),
        (16.2, pd.Series(index=vol_idx.copy(), data=1.15)),
    ]


class TestParametersObject:
    def _params_builder(self, num_sims=256, basis="1 + x0 + x0**2 + x1 + x1*x1"):
        val_date, fwd, rates, settle = market()
        return (
            LsmcValuationParameters.builder()
            .with_storage(simple_storage())
            .with_val_date(val_date)
            .with_inventory(0.0)
            .with_forward_curve(fwd)
            .with_interest_rates(rates)
            .with_settlement_rule(settle)
            .with_basis_funcs(basis)
            .with_dtype(F64)
            .simulate_with_multi_factor_model(
                factors_2f(val_date), 0.64, num_sims=num_sims, seed=11, fwd_sim_seed=11
            )
        )

    def test_matches_function_api(self):
        val_date, fwd, rates, settle = market()
        expected = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, rates, settle,
            factors_2f(val_date), 0.64, 256, "1 + x0 + x0**2 + x1 + x1*x1",
            False, seed=11, fwd_sim_seed=11, dtype=F64,
        )
        got = lsmc_value(self._params_builder().build())
        assert got.npv == pytest.approx(expected.npv, rel=1e-12)
        pd.testing.assert_series_equal(got.deltas, expected.deltas)

    def test_missing_required_fields_raise(self):
        builder = LsmcValuationParameters.builder().with_inventory(1.0)
        with pytest.raises(ValueError, match="missing required fields"):
            builder.build()

    def test_cancellation(self):
        calls = []

        def poll():
            calls.append(True)
            return len(calls) > 1  # cancel on the second phase boundary

        params = (
            self._params_builder().with_cancellation_poll(poll).build()
        )
        with pytest.raises(JobCancelledError):
            lsmc_value(params)

    def test_combinator_basis_matches_string(self):
        string_res = lsmc_value(self._params_builder().build())
        comb = ONE + X0 + X0**2 + X1 + X1 * X1
        comb_res = lsmc_value(
            self._params_builder(basis=comb).build()
        )
        assert comb_res.npv == pytest.approx(string_res.npv, rel=1e-12)

    def test_sim_data_flags_via_builder(self):
        params = (
            self._params_builder()
            .with_sim_data_returned("none")
            .build()
        )
        res = lsmc_value(params)
        assert res.sim_spot_regress.empty
        assert res.sim_inventory.empty
        assert np.isfinite(res.npv)

    def test_checkpoint_routing_via_builder(self, tmp_path):
        """with_checkpoint_path persists the regression payload; forward-only
        re-pricing from the checkpoint against the SAME valuation sims must
        reproduce the NPV (the backward pass never re-runs)."""
        from storage_tpu.checkpoint import RegressionCheckpoint, revalue_from_checkpoint

        path = str(tmp_path / "reg.npz")
        # The valuation-sim panels are fed back below, so request them
        # explicitly (the default is NONE, matching the C# builder's zero
        # flag).
        params = (
            self._params_builder()
            .with_checkpoint_path(path)
            .with_sim_data_returned("all")
            .build()
        )
        res = lsmc_value(params)

        ckpt = RegressionCheckpoint.load(path)
        spot_val = jnp.asarray(res.sim_spot_valuation.to_numpy(), F64)
        fac_frames = res.sim_factors_valuation
        fac_val = jnp.stack(
            [jnp.asarray(f.to_numpy(), F64) for f in fac_frames], axis=1
        )
        fwd_res = revalue_from_checkpoint(ckpt, spot_val, fac_val)
        assert float(fwd_res["npv"]) == pytest.approx(res.npv, rel=1e-12)

    def test_checkpoint_requires_string_basis(self, tmp_path):
        comb = ONE + X0 + X0**2 + X1 + X1 * X1
        params = (
            self._params_builder(basis=comb)
            .with_checkpoint_path(str(tmp_path / "reg.npz"))
            .build()
        )
        with pytest.raises(ValueError, match="basis_funcs as a string"):
            lsmc_value(params)

    def test_spot_combinator_in_function_api(self):
        val_date, fwd, rates, settle = market()
        s_str = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, rates, settle,
            factors_2f(val_date), 0.64, 128, "1 + s + s**2", False,
            seed=7, fwd_sim_seed=7, dtype=F64,
        )
        s_comb = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, rates, settle,
            factors_2f(val_date), 0.64, 128, ONE + S + S**2, False,
            seed=7, fwd_sim_seed=7, dtype=F64,
        )
        assert s_comb.npv == pytest.approx(s_str.npv, rel=1e-12)


class TestShardedFromSims:
    def test_multi_device_api_matches_single_device(self):
        """num_sims divisible by the 8 virtual devices -> the public API path
        shards; results must match the unsharded engine within f64 noise."""
        val_date, fwd, rates, settle = market()
        kwargs = dict(
            interest_rates=rates, settlement_rule=settle,
            factors=factors_2f(val_date), factor_corrs=0.64,
            basis_funcs="1 + x0 + x0**2 + x1", discount_deltas=False,
            seed=11, fwd_sim_seed=11, dtype=F64,
        )
        sharded = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=512, **kwargs
        )
        # 500 is not divisible by 8 -> single-device fallback; different sims,
        # so only check statistical closeness.
        single = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=500, **kwargs
        )
        assert np.isfinite(sharded.npv)
        assert abs(sharded.npv - single.npv) < 4 * max(
            sharded.val_sim_standard_error, single.val_sim_standard_error
        )


class TestGenericBasisFunctions:
    """User-callable basis functions (BasisFunction.cs:30 delegate analog /
    BasisFunctions.Generic, BasisFunctions.cs:92): arbitrary columns thread
    through the whole LSMC stack, forcing the XLA engine path."""

    def test_design_matrix_matches_hand_built(self):
        from storage_tpu.basis import coerce_basis_functions, design_matrix, generic

        spot = jnp.asarray(np.linspace(10.0, 30.0, 16))
        factors = jnp.stack([jnp.linspace(-1.0, 1.0, 16), jnp.linspace(0.0, 2.0, 16)])
        entries = coerce_basis_functions(
            coerce_basis_functions("1 + s + x1")
            + [generic(lambda s_, x_: jnp.exp(-x_[0]), num_factors=1, label="exp(-x0)")]
        )
        dm = np.asarray(design_matrix(tuple(entries), spot, factors))
        assert dm.shape == (16, 4)
        np.testing.assert_allclose(dm[:, 0], 1.0)
        np.testing.assert_allclose(dm[:, 1], np.asarray(spot))
        np.testing.assert_allclose(dm[:, 2], np.asarray(factors[1]))
        np.testing.assert_allclose(dm[:, 3], np.exp(-np.asarray(factors[0])), rtol=1e-6)

    def test_mixed_list_of_builders_generics_and_literals_coerces(self):
        """A plain list mixing builder atoms, generics, bare callables, raw
        Monomials, and the literal 1 coerces like the equivalent +-sum
        (the docstring's 'mixable in a list' contract)."""
        from storage_tpu.basis import (
            Monomial, ONE, S, X0, coerce_basis_functions, generic,
        )

        g = generic(lambda s_, x_: jnp.exp(-x_[0]), num_factors=1, label="e")
        bare = lambda s_, x_: s_ * s_ * s_  # noqa: E731
        entries = coerce_basis_functions(
            [ONE, S, S ** 2, X0, Monomial(0, ((1, 1),)), g, bare]
        )
        assert len(entries) == 7
        assert entries[:5] == list(
            coerce_basis_functions(ONE + S + S ** 2 + X0 + Monomial(0, ((1, 1),)))
        )
        assert entries[5] is g
        # Repeated terms across mixed forms still raise.
        with pytest.raises(ValueError, match="repeated"):
            coerce_basis_functions([ONE, S, 1])

    def test_generic_replicating_monomial_is_exact(self):
        """A callable computing s*x0 must value identically (f64) to the
        monomial s*x0 — same design matrix, same regression."""
        from storage_tpu import generic

        val_date, fwd, rates, settle = market()
        common = dict(
            interest_rates=rates, settlement_rule=settle,
            factors=factors_2f(val_date), factor_corrs=0.64,
            discount_deltas=False, seed=11, fwd_sim_seed=11, dtype=F64,
        )
        mono = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=256,
            basis_funcs="1 + x0 + s*x0", **common,
        )
        from storage_tpu.basis import coerce_basis_functions

        entries = coerce_basis_functions("1 + x0") + [
            generic(lambda s_, x_: s_ * x_[0], num_factors=1, label="s*x0")
        ]
        gen = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=256,
            basis_funcs=entries, **common,
        )
        assert gen.npv == pytest.approx(mono.npv, rel=1e-10)
        pd.testing.assert_series_equal(gen.deltas, mono.deltas)

    def test_exp_indicator_basis_within_2_se(self):
        """An exp/indicator basis on a case where both bases are adequate:
        NPV within 2 MC standard errors of the monomial run."""
        from storage_tpu import generic

        val_date, fwd, rates, settle = market()
        common = dict(
            interest_rates=rates, settlement_rule=settle,
            factors=factors_2f(val_date), factor_corrs=0.64,
            discount_deltas=False, seed=11, fwd_sim_seed=11, dtype=F64,
        )
        mono = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=1024,
            basis_funcs="1 + x0 + x0**2 + x1 + x1*x1", **common,
        )
        exp_ind = [
            generic(lambda s_, x_: jnp.ones_like(s_), label="1"),
            generic(lambda s_, x_: x_[0], num_factors=1, label="x0"),
            generic(lambda s_, x_: jnp.exp(x_[0]), num_factors=1, label="exp(x0)"),
            generic(lambda s_, x_: jnp.exp(-x_[0]), num_factors=1, label="exp(-x0)"),
            generic(
                lambda s_, x_: (x_[1] > 0).astype(s_.dtype), num_factors=2,
                label="1{x1>0}",
            ),
            generic(lambda s_, x_: x_[1], num_factors=2, label="x1"),
        ]
        gen = multi_factor_value(
            simple_storage(), val_date, 0.0, fwd, num_sims=1024,
            basis_funcs=exp_ind, **common,
        )
        tol = 2 * max(mono.val_sim_standard_error, gen.val_sim_standard_error)
        assert abs(gen.npv - mono.npv) <= tol

    def test_combinator_mixing_with_generic(self):
        from storage_tpu import generic
        from storage_tpu.basis import GenericBasisFunction, coerce_basis_functions

        g = generic(lambda s_, x_: jnp.tanh(x_[0]), num_factors=1)
        mixed = ONE + X0 + g
        entries = coerce_basis_functions(mixed)
        assert len(entries) == 3
        assert isinstance(entries[2], GenericBasisFunction)

    def test_num_factors_validated(self):
        from storage_tpu import generic

        val_date, fwd, rates, settle = market()
        too_many = [generic(lambda s_, x_: x_[2], num_factors=3, label="x2")]
        with pytest.raises(ValueError, match="factor x2"):
            multi_factor_value(
                simple_storage(), val_date, 0.0, fwd, rates, settle,
                factors_2f(val_date), 0.64, 64, too_many, False,
                seed=1, dtype=F64,
            )

    def test_checkpoint_rejects_non_string_basis(self, tmp_path):
        from storage_tpu import generic

        val_date, fwd, rates, settle = market()
        with pytest.raises(ValueError, match="checkpoint_path requires"):
            multi_factor_value(
                simple_storage(), val_date, 0.0, fwd, rates, settle,
                factors_2f(val_date), 0.64, 64,
                [generic(lambda s_, x_: jnp.ones_like(s_))], False,
                seed=1, dtype=F64, checkpoint_path=str(tmp_path / "ck.npz"),
            )
