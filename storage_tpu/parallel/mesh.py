"""Path-parallel LSMC over a device mesh.

The distributed dimension of the framework (the reference is strictly
single-process — SURVEY.md §2.2/§5.8): Monte Carlo paths are sharded across a
1-D ``jax.sharding.Mesh``; the only cross-shard communication is

* the per-step regression moments psum ([B,B] + [B,G], B ~ 10) inside the
  backward scan, and
* the final NPV / SE / delta / profile mean-reductions,

all wired through the engines' ``axis_name`` parameter.  Every shard solves
the same tiny [B,B] system redundantly — cheaper than sharding the solve.
Path identity is global (counter-based RNG keyed by global path id), so
results are invariant to the shard count; the tests pin this.

Simulation happens *inside* ``shard_map``: each shard draws only its own path
block, so the full path panel never exists unsharded.
"""
from __future__ import annotations

import logging
import os
import typing as tp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..basis import Monomial
from ..engines import lsmc as lsmc_engine
from ..models.multi_factor import SimulationPrecompute
from ..models.spot_sim import simulate_ou_paths

AXIS = "paths"

logger = logging.getLogger("storage_tpu.parallel")

# Streaming auto-select threshold: materialised dual-sim path panels larger
# than this stream instead (in-scan regeneration).  Materialised skips the
# warmup RNG sweep when the panels fit; streaming holds no path panels at
# all.  The default is a fixed share of the device memory JAX may use (one
# quarter: the value panel, the engine's temporaries and a second valuation
# need the rest); where the device reports no limit (the CPU) it is the
# constant below.  ``STORAGE_TPU_STREAM_THRESHOLD_BYTES`` overrides both.
STREAM_THRESHOLD_ENV = "STORAGE_TPU_STREAM_THRESHOLD_BYTES"
STREAM_THRESHOLD_FRACTION = 0.25
STREAM_THRESHOLD_FALLBACK_BYTES = 4 << 30


def default_stream_threshold(device=None) -> int:
    """Panel bytes above which valuations stream: the env override, else
    ``STREAM_THRESHOLD_FRACTION`` of the device's ``bytes_limit``, else
    ``STREAM_THRESHOLD_FALLBACK_BYTES``."""
    env = os.environ.get(STREAM_THRESHOLD_ENV)
    if env:
        return int(env)
    try:
        device = device if device is not None else jax.devices()[0]
        stats = device.memory_stats() or {}
    except Exception:  # noqa: BLE001 - backends without memory stats
        stats = {}
    limit = stats.get("bytes_limit")
    if not limit:
        return STREAM_THRESHOLD_FALLBACK_BYTES
    return int(limit * STREAM_THRESHOLD_FRACTION)


# Resolved on first use (reading device memory initialises the backend,
# which must not happen at import); tests and callers may assign an int.
STREAM_THRESHOLD_BYTES: tp.Optional[int] = None


def stream_threshold_bytes() -> int:
    global STREAM_THRESHOLD_BYTES
    if STREAM_THRESHOLD_BYTES is None:
        STREAM_THRESHOLD_BYTES = default_stream_threshold()
    return STREAM_THRESHOLD_BYTES


def _panel_bytes(num_steps: int, s_local: int, num_factors: int, itemsize: int,
                 num_sets: int = 2) -> int:
    """HBM footprint of the materialised sim-panel sets ([N+1, S] spot +
    [N+1, F, S] factors per set; regression + valuation = 2 sets, or 1 when
    same_sims reuses the regression panels)."""
    return num_sets * (num_steps + 1) * s_local * (num_factors + 1) * itemsize



# Engine result keys and their shard_map output shardings — shared by both
# sharded entry points so a new engine output is added in ONE place (a
# missing key produces a shard_map output-structure mismatch).
_SHARDED_SIM_KEYS = frozenset({
    "sim_inventory", "sim_inject_withdraw", "sim_cmdty_consumed",
    "sim_inventory_loss", "sim_net_volume", "sim_pv",
})
_RESULT_KEYS = (
    "npv", "standard_error", "backward_npv", "deltas", "profile_inventory",
    "profile_inject_withdraw", "profile_cmdty_consumed",
    "profile_inventory_loss", "profile_pv", "trigger_inject_volumes",
    "trigger_inject_prices", "trigger_withdraw_volumes",
    "trigger_withdraw_prices", "max_inject_volume",
    "max_inject_trigger_price", "max_withdraw_volume",
    "max_withdraw_trigger_price", "withdraw_max_volume_price",
)


def _build_out_specs(return_sim_data: bool, return_regression: bool):
    """Reduced outputs are replicated; per-sim panels keep their path shard;
    the regression payload is identical on every shard after the moments
    psum."""
    out_specs = {k: P() for k in _RESULT_KEYS}
    if return_sim_data:
        for k in _SHARDED_SIM_KEYS:
            out_specs[k] = P(None, AXIS)
    if return_regression:
        for k in ("regression_mean", "regression_std", "regression_coeffs"):
            out_specs[k] = P()
    return out_specs


def _log_execution(mesh: tp.Optional[Mesh], use_pallas: bool, num_sims: int,
                   stream: bool = False):
    """Record which execution path a valuation takes (device count, the
    backward decision body, streamed or materialised paths), so a user can
    tell why a run is slower than the benchmark (the Pallas decision kernel
    engages by default only for f32 on a GPU)."""
    n_dev = 1 if mesh is None else mesh.devices.size
    logger.info(
        "LSMC execution: %d device(s), %d sims, decision body=%s, paths=%s",
        n_dev, num_sims, "pallas-triton" if use_pallas else "xla",
        "streamed" if stream else "materialised",
    )


def make_mesh(num_devices: tp.Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over paths.  ``num_devices`` defaults to all local devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (AXIS,))


def pad_num_sims(num_sims: int, num_devices: int) -> int:
    """Round the path count up to a multiple of the mesh size."""
    return -(-num_sims // num_devices) * num_devices


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "s_local", "monomials", "num_extra_decisions", "discount_deltas",
        "terminal_fn", "ratchet_is_step", "antithetic", "same_sims",
        "return_sim_data", "use_pallas", "stream", "seg_len",
        "return_regression",
    ),
)
def _sharded_lsmc_jit(
    arrays,
    sim_inputs,
    reg_key,
    val_key,
    inv0,
    *,
    mesh: Mesh,
    s_local: int,
    monomials,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    antithetic: bool,
    same_sims: bool,
    return_sim_data: bool,
    use_pallas: bool,
    stream: bool = False,
    seg_len: int = 16,
    return_regression: bool = False,
):
    # A 1-device mesh needs no collectives: pass axis_name=None so the
    # engine's psums drop out (identity on one shard either way).
    eff_axis = AXIS if mesh.devices.size > 1 else None

    def shard_fn(arrays, sim_inputs, reg_key, val_key, inv0):
        shard = jax.lax.axis_index(AXIS)
        path_ids = shard * s_local + jnp.arange(s_local)
        if stream:
            # In-scan regeneration: no [N, S] path panels exist on any shard
            # (lsmc_core_streamed); identical draws to the materialised path.
            return lsmc_engine.lsmc_core_streamed(
                arrays, sim_inputs, reg_key, val_key, path_ids, inv0,
                monomials, num_extra_decisions, discount_deltas, terminal_fn,
                ratchet_is_step, axis_name=eff_axis, use_pallas=use_pallas,
                seg_len=seg_len,
                antithetic=antithetic, same_sims=same_sims,
                return_regression=return_regression,
            )
        reg = simulate_ou_paths(
            reg_key, path_ids, sim_inputs["decay"], sim_inputs["chol"],
            sim_inputs["vols"], sim_inputs["half_var"], sim_inputs["fwd"],
            antithetic=antithetic,
        )
        if same_sims:
            val = reg
        else:
            val = simulate_ou_paths(
                val_key, path_ids, sim_inputs["decay"], sim_inputs["chol"],
                sim_inputs["vols"], sim_inputs["half_var"], sim_inputs["fwd"],
                antithetic=antithetic,
            )
        return lsmc_engine.lsmc_core(
            arrays, reg.spot, reg.factors, val.spot, val.factors, inv0,
            monomials, num_extra_decisions, discount_deltas, terminal_fn,
            ratchet_is_step, axis_name=eff_axis, return_sim_data=return_sim_data,
            use_pallas=use_pallas, return_regression=return_regression,
        )

    out_specs = _build_out_specs(return_sim_data, return_regression)

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return mapped(arrays, sim_inputs, reg_key, val_key, inv0)


def sharded_lsmc_core(
    mesh: Mesh,
    arrays: tp.Dict[str, jnp.ndarray],
    sim_inputs: tp.Dict[str, jnp.ndarray],
    reg_key,
    val_key,
    num_sims: int,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    antithetic: bool = False,
    same_sims: bool = False,
    return_sim_data: bool = False,
    use_pallas: tp.Optional[bool] = None,
    stream: tp.Optional[bool] = None,
    seg_len: int = 16,
    return_regression: bool = False,
):
    """LSMC with paths sharded over ``mesh``; returns the engine result dict
    with reduced outputs replicated and per-sim panels path-sharded.

    ``sim_inputs`` holds the OU simulation arrays (decay/chol/vols/half_var/fwd)
    from ``multi_factor.simulation_precompute``; ``same_sims`` reuses the
    regression paths for valuation (the pinned-seed regression-test setup).
    The underlying jit caches on (mesh, shapes, static config), so repeated
    valuations with fresh keys or curves do not recompile.

    ``stream`` selects in-scan path regeneration (no [N, S] panels in HBM —
    the 1M-paths/chip mode); default on whenever per-sim panels are not
    requested.  Results are identical to the materialised path (same RNG
    stream; pinned by tests/test_streaming.py).  ``seg_len`` is the backward
    checkpoint segment length.
    """
    n_dev = mesh.devices.size
    if num_sims % n_dev != 0:
        raise ValueError(
            f"num_sims ({num_sims}) must be a multiple of the mesh size ({n_dev}); "
            f"use pad_num_sims."
        )
    s_local = num_sims // n_dev
    resolved_pallas = lsmc_engine._kernel_eligible(
        lsmc_engine.resolve_use_pallas(use_pallas, arrays["grids"].dtype),
        monomials,
    )
    if stream is None:
        n_steps = arrays["grids"].shape[0] - 1
        footprint = _panel_bytes(
            n_steps, s_local, sim_inputs["decay"].shape[1],
            jnp.dtype(arrays["grids"].dtype).itemsize,
            num_sets=1 if same_sims else 2,
        )
        stream = not return_sim_data and footprint > stream_threshold_bytes()
    if stream and return_sim_data:
        raise ValueError(
            "Per-sim panels require materialised paths; pass stream=False "
            "or return_sim_data=False."
        )
    inv0 = jnp.asarray(starting_inventory, arrays["grids"].dtype)
    if len({d.process_index for d in mesh.devices.flat}) > 1:
        # Multi-process mesh: every jit input must be a global array.  The
        # inputs are host-replicated by construction (same curves, same
        # seeds on every process); path identity comes from axis_index, so
        # each process simulates exactly its own global path block.
        from . import distributed as dist

        if return_sim_data:
            raise ValueError(
                "Per-sim panels are not available in multi-process runs."
            )
        arrays, sim_inputs, inv0 = dist.replicate_to_global(
            (arrays, sim_inputs, inv0), mesh
        )
        reg_key = dist.replicate_key(reg_key, mesh)
        val_key = dist.replicate_key(val_key, mesh)
    _log_execution(mesh, resolved_pallas, num_sims, stream=bool(stream))
    return _sharded_lsmc_jit(
        arrays, sim_inputs, reg_key, val_key, inv0,
        mesh=mesh, s_local=s_local, monomials=monomials,
        num_extra_decisions=num_extra_decisions, discount_deltas=discount_deltas,
        terminal_fn=terminal_fn, ratchet_is_step=ratchet_is_step,
        antithetic=antithetic, same_sims=same_sims,
        return_sim_data=return_sim_data,
        use_pallas=resolved_pallas,
        stream=bool(stream), seg_len=seg_len,
        return_regression=return_regression,
    )


def sim_inputs_from_precompute(pre: SimulationPrecompute, fwd: np.ndarray, dtype):
    return {
        "decay": jnp.asarray(pre.decay, dtype),
        "chol": jnp.asarray(pre.chol, dtype),
        "vols": jnp.asarray(pre.vols, dtype),
        "half_var": jnp.asarray(pre.half_var, dtype),
        "fwd": jnp.asarray(fwd, dtype),
    }


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "monomials", "num_extra_decisions", "discount_deltas",
        "terminal_fn", "ratchet_is_step", "return_sim_data", "use_pallas",
        "return_regression", "uniform_grids",
    ),
)
def _sharded_from_sims_jit(
    arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
    *, mesh, monomials, num_extra_decisions, discount_deltas, terminal_fn,
    ratchet_is_step, return_sim_data, use_pallas, return_regression=False,
    uniform_grids=True,
):
    eff_axis = AXIS if mesh.devices.size > 1 else None

    def shard_fn(arrays, spot_reg, factors_reg, spot_val, factors_val, inv0):
        return lsmc_engine.lsmc_core(
            arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
            monomials, num_extra_decisions, discount_deltas, terminal_fn,
            ratchet_is_step, axis_name=eff_axis, return_sim_data=return_sim_data,
            use_pallas=use_pallas, return_regression=return_regression,
            uniform_grids=uniform_grids,
        )

    out_specs = _build_out_specs(return_sim_data, return_regression)

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, AXIS), P(None, None, AXIS), P(None, AXIS),
            P(None, None, AXIS), P(),
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return mapped(arrays, spot_reg, factors_reg, spot_val, factors_val, inv0)


def lsmc_core_from_sims(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_reg, factors_reg, spot_val, factors_val,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    return_sim_data: bool = False,
    use_pallas: tp.Optional[bool] = None,
    mesh: tp.Optional[Mesh] = None,
    return_regression: bool = False,
    uniform_grids: bool = True,
):
    """LSMC over pre-simulated path panels ([N+1, S] / [N+1, F, S]), sharding
    the sim axis across all local devices when possible (the distributed analog
    of the reference's user-supplied-sims path, SpotSimResultsFromPanels.cs:36-117).

    Falls back to single-device execution when only one device is present or
    the sim count does not divide the mesh; results are invariant to that
    choice up to f32 reduction-order noise.  ``return_regression`` adds the
    per-step regression payload (replicated) to the result for checkpointing.
    """
    num_sims = spot_reg.shape[1]
    multiprocess = jax.process_count() > 1
    if mesh is None:
        devices = jax.devices()
        if len(devices) > 1 and num_sims % len(devices) == 0:
            mesh = make_mesh()
    inv0 = jnp.asarray(starting_inventory, arrays["grids"].dtype)
    resolved_pallas = lsmc_engine._kernel_eligible(
        lsmc_engine.resolve_use_pallas(use_pallas, arrays["grids"].dtype),
        monomials, uniform_grids,
    )
    if multiprocess:
        # Host-replicated inputs must become global arrays to feed a jit that
        # spans processes; sim panels are expected to be globally sharded
        # already (distributed.host_local_sims_to_global).
        from . import distributed as dist

        if mesh is None:
            mesh = dist.global_mesh()
        if return_sim_data:
            raise ValueError(
                "Per-sim panels are not available in multi-process runs: each "
                "process only holds its own path shard. Use "
                "sim_data_returned=SimulationDataReturned.NONE."
            )
        arrays, inv0 = dist.replicate_to_global((arrays, inv0), mesh)
    if mesh is None or mesh.devices.size == 1 or num_sims % mesh.devices.size != 0:
        if multiprocess:
            # Globally-sharded panels cannot run the eager single-device
            # engine (non-addressable shards fail far from the cause);
            # mirror sharded_lsmc_core's explicit error.
            raise ValueError(
                f"num_sims ({num_sims}) must be a multiple of the global "
                f"mesh size in multi-process runs; use pad_num_sims."
            )
        _log_execution(None, resolved_pallas, num_sims)
        return lsmc_engine.lsmc_core(
            arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
            monomials, num_extra_decisions, discount_deltas, terminal_fn,
            ratchet_is_step, axis_name=None, return_sim_data=return_sim_data,
            use_pallas=resolved_pallas,
            return_regression=return_regression, uniform_grids=uniform_grids,
        )
    _log_execution(mesh, resolved_pallas, num_sims)
    return _sharded_from_sims_jit(
        arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
        mesh=mesh, monomials=monomials,
        num_extra_decisions=num_extra_decisions, discount_deltas=discount_deltas,
        terminal_fn=terminal_fn, ratchet_is_step=ratchet_is_step,
        return_sim_data=return_sim_data,
        use_pallas=resolved_pallas,
        return_regression=return_regression, uniform_grids=uniform_grids,
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "s_local", "monomials", "num_extra_decisions",
        "discount_deltas", "terminal_fn", "ratchet_is_step", "seg_len",
        "antithetic", "same_sims", "use_pallas",
    ),
)
def _sharded_ad_deltas_jit(
    arrays, sim_inputs, reg_key, val_key, inv0,
    *, mesh, s_local, monomials, num_extra_decisions, discount_deltas,
    terminal_fn, ratchet_is_step, seg_len=16, antithetic=False,
    same_sims=False, use_pallas=False,
):
    # eff_axis: a 1-device mesh needs no collectives (matches the other
    # jit wrappers).
    eff_axis = AXIS if mesh.devices.size > 1 else None

    def shard_fn(arrays, sim_inputs, reg_key, val_key, inv0):
        shard = jax.lax.axis_index(AXIS)
        path_ids = shard * s_local + jnp.arange(s_local)
        npv, grad_local = lsmc_engine.lsmc_npv_and_ad_deltas_streamed(
            arrays, sim_inputs, reg_key, val_key, path_ids, inv0,
            monomials, num_extra_decisions, discount_deltas, terminal_fn,
            ratchet_is_step, axis_name=eff_axis, seg_len=seg_len,
            antithetic=antithetic, same_sims=same_sims,
            use_pallas=use_pallas,
        )
        # Both are pmean-reduced across shards inside the engine function
        # (the gradient is computed collective-free per shard and averaged
        # explicitly — see lsmc_npv_and_ad_deltas_streamed), so they arrive
        # replicated.
        return npv, grad_local

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return mapped(arrays, sim_inputs, reg_key, val_key, inv0)


def sharded_ad_deltas(
    mesh: Mesh,
    arrays: tp.Dict[str, jnp.ndarray],
    sim_inputs: tp.Dict[str, jnp.ndarray],
    reg_key,
    val_key,
    num_sims: int,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    seg_len: int = 16,
    antithetic: bool = False,
    same_sims: bool = False,
):
    """Path-sharded adjoint-delta sweep: streamed sims + segment remat per
    shard (lsmc_npv_and_ad_deltas_streamed), gradients psum'd across the
    mesh.  Memory per shard is bounded by segment-boundary carries
    ([N/seg_len, G, S_local]) — usable at bench scale.
    Returns (npv, deltas [N+1]) replicated."""
    n_dev = mesh.devices.size
    if num_sims % n_dev != 0:
        raise ValueError(
            f"num_sims ({num_sims}) must be a multiple of the mesh size ({n_dev})."
        )
    inv0 = jnp.asarray(starting_inventory, arrays["grids"].dtype)
    if len({d.process_index for d in mesh.devices.flat}) > 1:
        # Multi-process global mesh: inputs are
        # host-replicated by construction; lift them to global arrays so the
        # shard_map spans processes.  Path identity comes from axis_index, so
        # every process differentiates exactly its own global path block and
        # the explicit pmean replicates the gradient.
        from . import distributed as dist

        arrays, sim_inputs, inv0 = dist.replicate_to_global(
            (arrays, sim_inputs, inv0), mesh
        )
        reg_key = dist.replicate_key(reg_key, mesh)
        val_key = dist.replicate_key(val_key, mesh)
    return _sharded_ad_deltas_jit(
        arrays, sim_inputs, reg_key, val_key,
        inv0,
        mesh=mesh, s_local=num_sims // n_dev, monomials=monomials,
        num_extra_decisions=num_extra_decisions,
        discount_deltas=discount_deltas, terminal_fn=terminal_fn,
        ratchet_is_step=ratchet_is_step, seg_len=seg_len,
        antithetic=antithetic, same_sims=same_sims,
        use_pallas=lsmc_engine.resolve_use_pallas(None, arrays["grids"].dtype),
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "monomials", "num_extra_decisions", "discount_deltas",
        "terminal_fn", "ratchet_is_step", "use_pallas", "uniform_grids",
    ),
)
def _sharded_ad_from_sims_jit(
    arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
    *, mesh, monomials, num_extra_decisions, discount_deltas, terminal_fn,
    ratchet_is_step, use_pallas, uniform_grids=True,
):
    eff_axis = AXIS if mesh.devices.size > 1 else None

    def shard_fn(arrays, spot_reg, factors_reg, spot_val, factors_val, inv0):
        # Backward with globally psum'd moments (replicated payload), then a
        # collective-free per-shard forward grad, pmean'd explicitly — the
        # lsmc_npv_and_ad_deltas_streamed structure, over panel inputs.
        # Spot -> stochastic part per SHARD (an eager global division would
        # transiently materialise two extra full panels on one device).
        fwd = arrays["fwd"]
        stoch_val = spot_val / fwd[:, None]
        _v0, regression = lsmc_engine.lsmc_backward(
            arrays, spot_reg, factors_reg, monomials, num_extra_decisions,
            terminal_fn, ratchet_is_step, eff_axis, use_pallas=use_pallas,
            uniform_grids=uniform_grids,
        )
        regression = jax.tree.map(jax.lax.stop_gradient, regression)
        npv_local, grad_local = lsmc_engine._forward_value_and_grad(
            arrays, regression, stoch_val, factors_val, inv0, monomials,
            num_extra_decisions, terminal_fn, ratchet_is_step, None,
            uniform_grids=uniform_grids,
        )
        if eff_axis is not None:
            # Equal shard sizes: global mean PV / gradient are plain means.
            npv_local = jax.lax.pmean(npv_local, eff_axis)
            grad_local = jax.lax.pmean(grad_local, eff_axis)
        return lsmc_engine._undiscount_deltas(
            arrays, npv_local, grad_local, discount_deltas
        )

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, AXIS), P(None, None, AXIS), P(None, AXIS),
            P(None, None, AXIS), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return mapped(arrays, spot_reg, factors_reg, spot_val, factors_val, inv0)


def sharded_ad_deltas_from_sims(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_reg, factors_reg, spot_val, factors_val,
    starting_inventory,
    monomials,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    mesh: tp.Optional[Mesh] = None,
    uniform_grids: bool = True,
):
    """Adjoint deltas over pre-simulated panels, path-sharded across local
    devices or a multi-process global mesh (including multi-host
    ``value_from_sims_host_local`` panels).
    In multi-process runs the panels must already be global arrays
    (distributed.host_local_sims_to_global).  Returns (npv, deltas [N+1])
    replicated."""
    num_sims = spot_reg.shape[1]
    multiprocess = jax.process_count() > 1
    if mesh is None:
        if multiprocess:
            from . import distributed as dist

            mesh = dist.global_mesh()
        elif len(jax.devices()) > 1 and num_sims % len(jax.devices()) == 0:
            mesh = make_mesh()
    inv0 = jnp.asarray(starting_inventory, arrays["grids"].dtype)
    if multiprocess:
        from . import distributed as dist

        arrays, inv0 = dist.replicate_to_global((arrays, inv0), mesh)
    if mesh is None or mesh.devices.size == 1 or num_sims % mesh.devices.size != 0:
        if multiprocess:
            raise ValueError(
                f"num_sims ({num_sims}) must be a multiple of the global "
                f"mesh size in multi-process runs; use pad_num_sims."
            )
        fwd = arrays["fwd"]
        stoch_reg = spot_reg / fwd[:, None]
        stoch_val = spot_val / fwd[:, None]
        return lsmc_engine.lsmc_npv_and_ad_deltas(
            arrays, stoch_reg, factors_reg, stoch_val, factors_val, inv0,
            monomials, num_extra_decisions, discount_deltas, terminal_fn,
            ratchet_is_step,
            use_pallas=lsmc_engine.resolve_use_pallas(None, arrays["grids"].dtype),
            uniform_grids=uniform_grids,
        )
    resolved_pallas = lsmc_engine._kernel_eligible(
        lsmc_engine.resolve_use_pallas(None, arrays["grids"].dtype),
        monomials, uniform_grids,
    )
    return _sharded_ad_from_sims_jit(
        arrays, spot_reg, factors_reg, spot_val, factors_val, inv0,
        mesh=mesh, monomials=monomials,
        num_extra_decisions=num_extra_decisions,
        discount_deltas=discount_deltas, terminal_fn=terminal_fn,
        ratchet_is_step=ratchet_is_step, use_pallas=resolved_pallas,
        uniform_grids=uniform_grids,
    )
