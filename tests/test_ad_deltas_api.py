"""Public adjoint-delta API (``deltas_method="adjoint"``).

The adjoint method reverse-mode-differentiates the whole valuation in the
forward curve.  Under the multi-factor model (spot = forward x stochastic
term) the a.e. gradient with the bang-bang policy held fixed reduces exactly
to the reference's hand-derived pathwise formula
(LsmcStorageValuation.cs:513-518) — the policy argmax contributes zero
gradient (envelope theorem) and the inventory path is locally insensitive to
the curve.  These tests pin that identity (machine-precision agreement is the
validation of the pathwise estimator) and the defining derivative property
against finite differences.  AD's value over pathwise is generality: it stays
correct for price models where spot is NOT forward-proportional and for
terminal/inventory-cost structures the hand formula ignores.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from storage_tpu import (
    CmdtyStorage,
    RatchetInterp,
    SimulationDataReturned,
    multi_factor_value,
)
from storage_tpu.lsmc_params import LsmcValuationParameters, lsmc_value

F64 = jnp.float64


def ratcheted_storage():
    ratchets = [
        ("2020-01-01", [(0.0, -300.0, 420.0), (2_000.0, -400.0, 300.0),
                        (5_000.0, -480.0, 200.0)]),
    ]
    return CmdtyStorage(
        "D", "2020-01-01", "2020-02-15", 0.6, 0.4,
        ratchets=ratchets, ratchet_interp=RatchetInterp.LINEAR,
        cmdty_consumed_inject=0.01,
    )


def market():
    idx = pd.period_range("2020-01-01", "2020-02-15", freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 7.0 * np.sin(2 * np.pi * i / 46.0))
    return fwd


def run(fwd, deltas_method="pathwise", discount_deltas=True):
    vol_idx = pd.period_range("2020-01-01", "2020-03-15", freq="D")
    return multi_factor_value(
        ratcheted_storage(), "2020-01-01", 800.0, fwd, 0.04, None,
        [(9.0, pd.Series(index=vol_idx, data=0.8))], None, 512,
        "1 + s + x0 + x0**2", discount_deltas, seed=7, fwd_sim_seed=8,
        num_inventory_grid_points=40, dtype=F64,
        sim_data_returned=SimulationDataReturned.NONE,
        deltas_method=deltas_method,
    )


@pytest.fixture(scope="module")
def both():
    fwd = market()
    return run(fwd, "pathwise"), run(fwd, "adjoint")


def test_npv_and_other_outputs_unchanged(both):
    pathwise, adjoint = both
    assert adjoint.npv == pytest.approx(pathwise.npv, rel=1e-12)
    assert adjoint.val_sim_standard_error == pathwise.val_sim_standard_error
    pd.testing.assert_frame_equal(adjoint.expected_profile, pathwise.expected_profile)


def test_adjoint_deltas_match_finite_difference(both):
    """Defining property: AD delta == dNPV/dF(t) (same seeds make the central
    difference deterministic).  Near decision boundaries the FD picks up
    discrete policy-switch jumps of the regressed argmax which the a.e.
    gradient correctly excludes, so each candidate period is first checked
    for h-STABILITY (central differences at h and 3h agreeing) and unstable
    periods are skipped; at least two periods must qualify."""
    _pathwise, adjoint = both
    fwd = market()
    h = 1e-3
    candidates = [
        pd.Period(d, freq="D")
        for d in ("2020-01-05", "2020-01-12", "2020-01-20", "2020-01-27")
    ]
    checked = 0
    for p in candidates:
        def fd_at(step):
            bump = pd.Series(0.0, index=fwd.index)
            bump[p] = step
            return (run(fwd + bump).npv - run(fwd - bump).npv) / (2 * step)

        fd1, fd3 = fd_at(h), fd_at(3 * h)
        if abs(fd1 - fd3) > max(0.01 * abs(fd1), 1.0):
            continue  # policy-switch jump inside the stencil
        assert adjoint.deltas[p] == pytest.approx(fd1, rel=1e-3, abs=0.05)
        checked += 1
    assert checked >= 2, "too few h-stable periods to validate the gradient"


def test_adjoint_equals_pathwise_under_multifactor_model(both):
    """Under spot = forward x stochastic term, AD through the full valuation
    reduces exactly to the pathwise formula (argmax switches carry zero a.e.
    gradient; decision volumes depend on the curve only through those
    switches).  Machine-precision agreement on a ratcheted facility is a
    strong mutual validation of both estimators."""
    pathwise, adjoint = both
    np.testing.assert_allclose(
        adjoint.deltas.to_numpy(), pathwise.deltas.to_numpy(),
        rtol=1e-9, atol=1e-9,
    )


def test_builder_routes_deltas_method():
    fwd = market()
    vol_idx = pd.period_range("2020-01-01", "2020-03-15", freq="D")
    params = (
        LsmcValuationParameters.builder()
        .with_storage(ratcheted_storage()).with_val_date("2020-01-01")
        .with_inventory(800.0).with_forward_curve(fwd)
        .with_interest_rates(0.04).with_basis_funcs("1 + s + x0 + x0**2")
        .with_discount_deltas(True).with_grid_points(40).with_dtype(F64)
        .with_deltas_method("adjoint")
        .with_sim_data_returned(SimulationDataReturned.NONE)
        .simulate_with_multi_factor_model(
            [(9.0, pd.Series(index=vol_idx, data=0.8))], None, 512, seed=7,
            fwd_sim_seed=8,
        )
        .build()
    )
    res = lsmc_value(params)
    direct = run(fwd, "adjoint")
    pd.testing.assert_series_equal(res.deltas, direct.deltas)

    with pytest.raises(ValueError, match="deltas_method"):
        LsmcValuationParameters.builder().with_deltas_method("bogus")


def test_adjoint_sharded_remat_at_bench_scale_sims():
    """262,144 sims on the 8-device CPU mesh: the sharded,
    segment-rematerialised adjoint sweep must agree with the pathwise
    estimator at bench-scale path counts with bounded memory.  Short horizon/small grid keep CPU wall time reasonable — the
    scale axis under test is the path count the AD tape must survive."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax
    from test_sharding import build_case

    from storage_tpu.parallel import mesh as pmesh

    inputs, arrays, sim_inputs, monomials = build_case(num_steps=12, num_grid=10)
    num_sims = 262_144
    mesh = pmesh.make_mesh(8)
    pathwise = pmesh.sharded_lsmc_core(
        mesh, arrays, sim_inputs, jax.random.key(3), jax.random.key(5),
        num_sims, inputs.starting_inventory, monomials,
        num_extra_decisions=0, discount_deltas=True, terminal_fn=None,
        ratchet_is_step=False, stream=True, seg_len=5,
    )
    npv_ad, deltas_ad = pmesh.sharded_ad_deltas(
        mesh, arrays, sim_inputs, jax.random.key(3), jax.random.key(5),
        num_sims, inputs.starting_inventory, monomials,
        num_extra_decisions=0, discount_deltas=True, terminal_fn=None,
        ratchet_is_step=False, seg_len=5,
    )
    assert float(npv_ad) == pytest.approx(float(pathwise["npv"]), rel=1e-9)
    np.testing.assert_allclose(
        np.asarray(deltas_ad), np.asarray(pathwise["deltas"]), rtol=1e-6,
        atol=1e-8 * float(np.abs(np.asarray(pathwise["deltas"])).max()),
    )


def test_adjoint_with_nonuniform_grid_calc_matches_pathwise():
    """Non-uniform user grids (general searchsorted+gather interpolation) are
    fully differentiable: adjoint == pathwise on the same custom grid."""

    def dense_near_bottom(lo, hi):
        u = np.linspace(0.0, 1.0, 40) ** 2
        return lo + (hi - lo) * u

    fwd = market()
    vol_idx = pd.period_range("2020-01-01", "2020-03-15", freq="D")
    kwargs = dict(
        interest_rates=0.04, settlement_rule=None,
        factors=[(9.0, pd.Series(index=vol_idx, data=0.8))], factor_corrs=None,
        num_sims=512, basis_funcs="1 + s + x0 + x0**2", discount_deltas=True,
        seed=7, fwd_sim_seed=8, num_inventory_grid_points=40, dtype=F64,
        grid_calc=dense_near_bottom,
    )
    pathwise = multi_factor_value(
        ratcheted_storage(), "2020-01-01", 800.0, fwd, **kwargs
    )
    adjoint = multi_factor_value(
        ratcheted_storage(), "2020-01-01", 800.0, fwd,
        deltas_method="adjoint", **kwargs,
    )
    assert adjoint.npv == pytest.approx(pathwise.npv, rel=1e-12)
    np.testing.assert_allclose(
        adjoint.deltas.to_numpy(), pathwise.deltas.to_numpy(),
        rtol=1e-9, atol=1e-9,
    )


def test_adjoint_with_generic_basis_matches_pathwise():
    """The adjoint composes with generic (callable) basis functions: the
    differentiated forward evaluates the same user columns, and the envelope
    identity adjoint == pathwise holds unchanged (docs/API.md claim)."""
    import jax.numpy as jnp

    from storage_tpu import generic

    basis = [
        generic(lambda s, x: jnp.ones_like(s), label="1"),
        generic(lambda s, x: s, label="s"),
        generic(lambda s, x: x[0], num_factors=1, label="x0"),
        generic(lambda s, x: jnp.exp(x[0]), num_factors=1, label="exp(x0)"),
    ]
    fwd = market()
    vol_idx = pd.period_range("2020-01-01", "2020-03-15", freq="D")
    kwargs = dict(
        interest_rates=0.04, settlement_rule=None,
        factors=[(9.0, pd.Series(index=vol_idx, data=0.8))], factor_corrs=None,
        num_sims=512, basis_funcs=basis, discount_deltas=True,
        seed=7, fwd_sim_seed=8, num_inventory_grid_points=40, dtype=F64,
    )
    pathwise = multi_factor_value(
        ratcheted_storage(), "2020-01-01", 800.0, fwd, **kwargs
    )
    adjoint = multi_factor_value(
        ratcheted_storage(), "2020-01-01", 800.0, fwd,
        deltas_method="adjoint", **kwargs,
    )
    assert adjoint.npv == pytest.approx(pathwise.npv, rel=1e-12)
    np.testing.assert_allclose(
        adjoint.deltas.to_numpy(), pathwise.deltas.to_numpy(),
        rtol=1e-9, atol=1e-9,
    )
