"""Pallas decision-update kernel: interpret-mode equivalence on the CPU.

The kernel (ops/decision_kernel.py) must reproduce the XLA backward body
(same anti-foresight argmax, first decision wins ties).  Its compiled GPU
form is compared with the same body at the benchmark's width by
``chip_smoke.py``; the kernel *logic*, its masking of ragged blocks and the
engine's choice of body are pinned here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from storage_tpu.basis import generic, parse_basis_functions
from storage_tpu.engines import lsmc as lsmc_engine
from storage_tpu.ops import decision_kernel
from storage_tpu.ops.interp import interp_weights

MONOMIALS = tuple(parse_basis_functions("1 + s + s**2 + x0 + x1 + x0*x1"))


def _step_inputs(g, d, s, dtype, degenerate_next_grid=False, seed=7):
    """One backward step's body inputs, shaped as the engine builds them."""
    rng = np.random.default_rng(seed)
    grid = jnp.linspace(0.0, 1000.0, g, dtype=dtype)
    grid_next = jnp.zeros(g, dtype) if degenerate_next_grid else grid
    targets = grid[:, None] + jnp.asarray(
        rng.uniform(-120.0, 120.0, (g, d)), dtype
    )
    idx_lo, w_hi = interp_weights(grid_next, targets)
    x = {
        "spot": jnp.asarray(rng.uniform(10.0, 50.0, s), dtype),
        "factors": jnp.asarray(rng.normal(0.0, 1.0, (2, s)), dtype),
        "idx_lo": idx_lo,
        "w_hi": w_hi,
        "prep_a": jnp.asarray(rng.normal(0.0, 2.0, (g, d)), dtype),
        "prep_b": jnp.asarray(rng.normal(0.0, 20.0, (g, d)), dtype),
    }
    v_act_next = jnp.asarray(
        rng.normal(100.0, 30.0, (g, s)) + 3.0 * np.arange(g)[:, None], dtype
    )
    return v_act_next, x


def _run_body(v_act_next, x, num_decisions, use_pallas):
    body = lsmc_engine._backward_body(
        MONOMIALS, (num_decisions - 3) // 2, None, use_pallas
    )
    if use_pallas:
        with decision_kernel.interpret_mode():
            return body(v_act_next, x)
    return body(v_act_next, x)


def _assert_same_values(got, want, dtype):
    rtol = 2e-5 if dtype == jnp.float32 else 1e-10
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol * 100.0
    )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("num_decisions", [3, 5, 7])
@pytest.mark.parametrize("g,s", [(100, 300), (37, 517)])
def test_kernel_matches_xla_body(g, s, num_decisions, dtype):
    """Ragged grid rows (G not a multiple of the row block) and ragged sims
    (S not a multiple of the sim block) both land in masked blocks."""
    v_act_next, x = _step_inputs(g, num_decisions, s, dtype)
    want, payload_x = _run_body(v_act_next, x, num_decisions, use_pallas=False)
    got, payload_k = _run_body(v_act_next, x, num_decisions, use_pallas=True)
    assert got.shape == (g, s) and got.dtype == dtype
    _assert_same_values(got, want, dtype)
    # The regression payload does not depend on the decision body.
    for k in payload_x:
        np.testing.assert_array_equal(np.asarray(payload_k[k]), np.asarray(payload_x[k]))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
def test_kernel_degenerate_next_grid(dtype):
    """A must-be-empty next period collapses the next grid to one point:
    every target interpolates at row 0 with weight 0."""
    v_act_next, x = _step_inputs(24, 3, 200, dtype, degenerate_next_grid=True)
    assert int(jnp.max(x["idx_lo"])) == 0
    want, _ = _run_body(v_act_next, x, 3, use_pallas=False)
    got, _ = _run_body(v_act_next, x, 3, use_pallas=True)
    _assert_same_values(got, want, dtype)


@pytest.mark.parametrize("block_g,block_s", [(4, 64), (16, 128), (2, 512)])
def test_kernel_block_shapes_agree(block_g, block_s):
    """Every block shape covers the panel exactly once: results do not
    depend on the tiling."""
    g, s, d = 37, 300, 5
    v_act_next, x = _step_inputs(g, d, s, jnp.float64)
    dm = lsmc_engine.design_matrix(MONOMIALS, x["spot"], x["factors"])
    coeffs = jnp.asarray(np.random.default_rng(1).normal(0, 5, (len(MONOMIALS), g)))
    ci = lsmc_engine._interp_coeffs(coeffs, x)
    args = (v_act_next, dm.T, x["spot"], ci, x["idx_lo"], x["w_hi"],
            x["prep_a"], x["prep_b"])
    ref = decision_kernel.decision_update(*args, interpret=True)
    got = decision_kernel.pallas_update(
        *args, interpret=True, block=(block_g, block_s)
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


class TestResolver:
    def test_default_is_xla_off_gpu(self):
        assert jax.default_backend() == "cpu"
        assert not lsmc_engine.resolve_use_pallas(None, jnp.float32)
        assert not lsmc_engine.resolve_use_pallas(None, jnp.float64)

    @pytest.mark.parametrize("dtype,expected", [(jnp.float32, True), (jnp.float64, False)],
                             ids=["f32", "f64"])
    def test_default_on_gpu_is_f32_only(self, monkeypatch, dtype, expected):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert lsmc_engine.resolve_use_pallas(None, dtype) is expected

    def test_explicit_request_without_gpu_raises(self):
        with pytest.raises(ValueError, match="needs a GPU"):
            lsmc_engine.resolve_use_pallas(True, jnp.float32)
        assert lsmc_engine.resolve_use_pallas(False, jnp.float32) is False

    def test_explicit_request_in_interpret_mode(self):
        assert not decision_kernel.available()
        with decision_kernel.interpret_mode():
            assert decision_kernel.available()
            assert lsmc_engine.resolve_use_pallas(True, jnp.float32) is True
        assert not decision_kernel.interpreting()

    def test_interpret_mode_traces_do_not_leak(self):
        """The flag is read at trace time; a trace made inside the mode is
        not served to a call outside it, nor the reverse."""
        @jax.jit
        def f(x):
            return x + (1.0 if decision_kernel.interpreting() else 0.0)

        assert float(f(1.0)) == 1.0
        with decision_kernel.interpret_mode():
            assert float(f(1.0)) == 2.0
        assert float(f(1.0)) == 1.0

    def test_generic_basis_and_nonuniform_grids_keep_xla(self):
        mixed = MONOMIALS + (generic(lambda s, x: jnp.exp(x[0]), num_factors=1),)
        assert lsmc_engine._kernel_eligible(True, MONOMIALS)
        assert not lsmc_engine._kernel_eligible(True, mixed)
        assert not lsmc_engine._kernel_eligible(True, MONOMIALS, uniform_grids=False)
        assert not lsmc_engine._kernel_eligible(False, MONOMIALS)


def test_fit_continuation_singular_fallback():
    """A singular design matrix (duplicate columns, zero ridge) must fall back
    to the cross-sim mean instead of returning NaN coefficients — the failure
    that silently zeroed the value function at large sim counts."""
    from storage_tpu.ops.regression import fit_continuation

    s, g = 64, 4
    rng = np.random.default_rng(3)
    col = rng.normal(0.0, 1.0, s)
    x = jnp.asarray(np.stack([np.ones(s), col, col], axis=1))  # exactly collinear
    y = jnp.asarray(rng.normal(50.0, 10.0, (s, g)))
    coeffs = fit_continuation(x, y, ridge=0.0)
    assert bool(jnp.all(jnp.isfinite(coeffs)))
    np.testing.assert_allclose(
        np.asarray(coeffs[0]), np.asarray(y.mean(axis=0)), rtol=1e-6
    )
    np.testing.assert_allclose(np.asarray(coeffs[1:]), 0.0, atol=1e-12)


@pytest.mark.parametrize("n", [1000, 4096])
def test_constant_column_standardises_to_zero(n):
    """Every state column is one value on all paths on the valuation date.
    Its rounded mean is off by ulps; standardising must still give exactly
    zero, and a forward-pass spot one ulp away must stay near zero, not
    jump to ±1 (the sign of an ulp-sized std)."""
    from storage_tpu.ops.regression import column_stats, fit_continuation

    c = np.float32(29.982643)
    rng = np.random.default_rng(0)
    x = jnp.stack([jnp.ones(n, jnp.float32), jnp.full(n, c), jnp.full(n, c * c),
                   jnp.asarray(rng.normal(size=n), jnp.float32)], axis=1)
    assert float(jnp.sum(x[:, 1]) / n) != float(c)  # the rounding at stake
    mean, std = column_stats(x)
    x_std = (x - mean) / std
    np.testing.assert_array_equal(np.asarray(x_std[:, 1:3]), 0.0)
    coeffs = fit_continuation(x_std, jnp.asarray(rng.normal(50.0, 5.0, (n, 2)), jnp.float32))
    np.testing.assert_array_equal(np.asarray(coeffs[1:3]), 0.0)
    c_next = np.nextafter(c, np.float32(100.0))
    row = (jnp.asarray([1.0, c_next, c_next * c_next, 0.0], jnp.float32) - mean) / std
    assert float(jnp.max(jnp.abs(row[1:3]))) < 1e-3
