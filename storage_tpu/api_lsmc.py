"""LSMC public API: ``three_factor_seasonal_value``, ``multi_factor_value``,
``value_from_sims`` — mirroring the reference entry points
(``multi_factor.py:99-208``) with pandas at the boundary and the jax engine
inside.

Deviations (documented; see also ``engines/lsmc.py``):
* Monte Carlo draws are threefry counter-based, so NPVs match the reference
  statistically (within MC standard error), not bit-wise.
* ``on_progress_update``: when a progress callback or cancellation poll is
  registered, the valuation runs host-chunked (16-step segments dispatched
  from Python), firing per segment — N/16-granularity progress and
  cancellation that aborts mid-pass, the practical analog of the reference's
  per-period polling (LsmcStorageValuation.cs:343-345,521).  Without
  callbacks the scans stay fully fused on device.
* ``withdraw_trigger_price`` follows the reference exactly: the price at the
  withdrawal volume ONE INCREMENT from the alternative decision
  (``withdrawTriggerPrices[0]`` of the reversed volume scan,
  LsmcStorageValuation.cs:576-584) — so frames diff cleanly against
  cmdty/storage output.  The price at the MAX withdrawal volume (consistent
  with the inject side's semantics) is kept under the additional
  ``withdraw_max_volume_price`` column (also the last point of each period's
  ``trigger_profiles`` withdraw profile).
"""
from __future__ import annotations

import logging
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from . import basis as basis_mod
from .api import profile_data_frame, IntrinsicValuationResults, DEFAULT_NUM_GRID_POINTS
from .engines import intrinsic as intrinsic_engine
from .engines import lsmc as lsmc_engine
from .facility import CmdtyStorage
from .models import multi_factor as mf
from .models.spot_sim import simulate_ou_paths
from .parallel.mesh import lsmc_core_from_sims
from .profiling import Stopwatches
from .results import (
    MultiFactorValuationResults,
    SimulationDataReturned,
    TriggerPricePoint,
    TriggerPriceProfile,
)
from .utils import discount as dsc
from .utils import periods as pu
from .valuation_inputs import ValuationInputs, prepare_valuation

logger = logging.getLogger("storage_tpu.multi_factor")

ProgressCallback = tp.Optional[tp.Callable[[float], None]]


def three_factor_seasonal_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    num_sims: int,
    basis_funcs: str,
    discount_deltas: bool,
    seed: tp.Optional[int] = None,
    fwd_sim_seed: tp.Optional[int] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update: ProgressCallback = None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=jnp.float32,
    antithetic: bool = False,
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
) -> MultiFactorValuationResults:
    """3-factor seasonal LSMC valuation (reference ``multi_factor.py:99-135``).

    Basis functions may reference the factors as ``x_st``/``x_lt``/``x_sw`` or
    ``x0``/``x1``/``x2``.  ``deltas_method``: see ``multi_factor_value``.
    """
    freq = cmdty_storage.freq
    end_period = cmdty_storage.end
    val_period = pu.to_period(val_date, cmdty_storage.start.freqstr)
    factors, factor_corrs = mf.create_3_factor_seasonal_params(
        freq, spot_mean_reversion, spot_vol, long_term_vol, seasonal_vol,
        val_period, end_period,
    )
    return multi_factor_value(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates,
        settlement_rule, factors, factor_corrs, num_sims, basis_funcs,
        discount_deltas, seed=seed, fwd_sim_seed=fwd_sim_seed,
        extra_decisions=extra_decisions,
        num_inventory_grid_points=num_inventory_grid_points,
        numerical_tolerance=numerical_tolerance,
        on_progress_update=on_progress_update,
        sim_data_returned=sim_data_returned, dtype=dtype, antithetic=antithetic,
        cancellation_poll=cancellation_poll,
        deltas_method=deltas_method,
        checkpoint_path=checkpoint_path,
        grid_calc=grid_calc,
    )


def multi_factor_value(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    factors: tp.Collection[mf.FactorType],
    factor_corrs: mf.FactorCorrsType,
    num_sims: int,
    basis_funcs: str,
    discount_deltas: bool,
    seed: tp.Optional[int] = None,
    fwd_sim_seed: tp.Optional[int] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update: ProgressCallback = None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=jnp.float32,
    antithetic: bool = False,
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
) -> MultiFactorValuationResults:
    """General multi-factor LSMC valuation (reference ``multi_factor.py:138-168``).

    ``deltas_method`` selects the delta estimator reported in ``deltas``:

    * ``"pathwise"`` (default) — the reference's hand-derived pathwise formula
      (LsmcStorageValuation.cs:513-518), which assumes spot = forward x
      stochastic term and a policy insensitive to the bump;
    * ``"adjoint"`` — reverse-mode AD of the full valuation with respect to
      the forward curve (one extra backward sweep; envelope-theorem gradient
      through the bang-bang argmax).  Under the multi-factor model it
      reproduces the pathwise series to machine precision (pinned by
      tests/test_ad_deltas_api.py) — its value is generality: it stays exact
      for price models where spot is not forward-proportional and for
      terminal-value/inventory-cost structures outside the hand formula's
      assumptions, and it is the natural extension point for sensitivities
      to other curve inputs.

    ``sim_data_returned`` defaults to ``NONE`` — the reference's own stated
    intent (multi_factor.py:118 "TODO ... change this to default to NONE")
    and what lets default calls run the streamed fast path; request
    panels explicitly to feed ``value_from_sims``.
    """
    factor_corrs = mf.validate_multi_factor_params(factors, factor_corrs)

    def _sim_setup(inputs: ValuationInputs):
        pre = mf.simulation_precompute(
            factors, factor_corrs, inputs.val_day, list(inputs.periods), cmdty_storage.freq
        )
        sim_inputs = {
            "decay": jnp.asarray(pre.decay, dtype),
            "chol": jnp.asarray(pre.chol, dtype),
            "vols": jnp.asarray(pre.vols, dtype),
            "half_var": jnp.asarray(pre.half_var, dtype),
            "fwd": jnp.asarray(inputs.fwd, dtype),
        }
        reg_key = jax.random.key(0 if seed is None else int(seed))
        if fwd_sim_seed is None:
            # Independent stream derived from the regression seed
            # (reference generates a fresh Mersenne-Twister continuation).
            val_key = jax.random.fold_in(reg_key, 0x5EED)
        else:
            val_key = jax.random.key(int(fwd_sim_seed))
        same_sims = fwd_sim_seed is not None and int(fwd_sim_seed) == int(
            0 if seed is None else seed
        )
        return sim_inputs, reg_key, val_key, same_sims

    def sims_provider(inputs: ValuationInputs):
        si, reg_key, val_key, same_sims = _sim_setup(inputs)
        path_ids = jnp.arange(num_sims)
        reg = simulate_ou_paths(
            reg_key, path_ids, si["decay"], si["chol"], si["vols"],
            si["half_var"], si["fwd"], antithetic=antithetic,
        )
        if same_sims:
            val = reg
        else:
            val = simulate_ou_paths(
                val_key, path_ids, si["decay"], si["chol"], si["vols"],
                si["half_var"], si["fwd"], antithetic=antithetic,
            )
        return (reg.spot, reg.factors), (val.spot, val.factors)

    def stream_provider(inputs: ValuationInputs):
        si, reg_key, val_key, same_sims = _sim_setup(inputs)
        return si, reg_key, val_key, same_sims, num_sims

    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates,
        settlement_rule, sims_provider, basis_funcs, discount_deltas,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, sim_data_returned, dtype,
        cancellation_poll=cancellation_poll, deltas_method=deltas_method,
        checkpoint_path=checkpoint_path,
        stream_provider=stream_provider, antithetic=antithetic,
        grid_calc=grid_calc,
    )


def value_from_sims(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    sim_spot_regress: pd.DataFrame,
    sim_spot_valuation: pd.DataFrame,
    basis_funcs: str,
    discount_deltas: bool,
    sim_factors_regress: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    sim_factors_valuation: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update: ProgressCallback = None,
    sim_data_returned: SimulationDataReturned = SimulationDataReturned.NONE,
    dtype=jnp.float32,
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
) -> MultiFactorValuationResults:
    """Valuation from user-supplied spot/factor simulations (reference
    ``multi_factor.py:171-208`` / ``SpotSimResultsFromPanels.cs:36-117``).
    DataFrames are period-indexed [periods x sims] and must cover the active
    storage window."""

    def sims_provider(inputs: ValuationInputs):
        reg = _frames_to_sims(sim_spot_regress, sim_factors_regress, inputs, "regress", dtype)
        val = _frames_to_sims(
            sim_spot_valuation, sim_factors_valuation, inputs, "valuation", dtype
        )
        if reg[0].shape[1] != val[0].shape[1]:
            raise ValueError(
                "Regression and valuation simulations must have the same number of sims."
            )
        return reg, val

    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates,
        settlement_rule, sims_provider, basis_funcs, discount_deltas,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, sim_data_returned, dtype,
        cancellation_poll=cancellation_poll, deltas_method=deltas_method,
        checkpoint_path=checkpoint_path,
        grid_calc=grid_calc,
    )


def value_from_sims_host_local(
    cmdty_storage: CmdtyStorage,
    val_date: pu.PeriodSpec,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: tp.Union[float, pd.Series],
    settlement_rule: tp.Optional[dsc.SettlementRule],
    sim_spot_regress: pd.DataFrame,
    sim_spot_valuation: pd.DataFrame,
    basis_funcs: str,
    discount_deltas: bool,
    sim_factors_regress: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    sim_factors_valuation: tp.Optional[tp.Iterable[pd.DataFrame]] = None,
    extra_decisions: tp.Optional[int] = None,
    num_inventory_grid_points: int = DEFAULT_NUM_GRID_POINTS,
    numerical_tolerance: float = 1e-12,
    on_progress_update: ProgressCallback = None,
    dtype=jnp.float32,
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    grid_calc=None,
) -> MultiFactorValuationResults:
    """Multi-host ``value_from_sims``: the sim DataFrames are THIS PROCESS's
    block of paths; blocks from all processes form the global panel (process
    p owns global sims [p*S_local, (p+1)*S_local)).

    Per-host row validation mirrors ``SpotSimResultsFromPanels.cs:56-72``
    (period coverage, matching regression/valuation sim counts); cross-host
    validation asserts every process contributes identically-shaped blocks.
    Requires ``storage_tpu.parallel.distributed.initialize`` to have run in
    every process.  Per-sim panels are not returned (each process only holds
    its own shard), so there is no ``sim_data_returned`` parameter.
    """
    from .parallel import distributed as dist

    def sims_provider(inputs: ValuationInputs):
        reg = _frames_to_sims(sim_spot_regress, sim_factors_regress, inputs, "regress", dtype)
        val = _frames_to_sims(
            sim_spot_valuation, sim_factors_valuation, inputs, "valuation", dtype
        )
        if reg[0].shape[1] != val[0].shape[1]:
            raise ValueError(
                "Regression and valuation simulations must have the same number of sims."
            )
        mesh = dist.global_mesh()
        spot_reg, fac_reg = dist.host_local_sims_to_global(reg[0], reg[1], mesh)
        spot_val, fac_val = dist.host_local_sims_to_global(val[0], val[1], mesh)
        return (spot_reg, fac_reg), (spot_val, fac_val)

    return _lsmc_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates,
        settlement_rule, sims_provider, basis_funcs, discount_deltas,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, SimulationDataReturned.NONE, dtype,
        cancellation_poll=cancellation_poll, deltas_method=deltas_method,
        checkpoint_path=checkpoint_path,
        grid_calc=grid_calc,
    )


def _frames_to_sims(spot_frame, factor_frames, inputs: ValuationInputs, label, dtype):
    """User panels stay HOST-side numpy (at the target dtype): small panels
    transfer wholesale at the next jit boundary as before, while panels too
    large for device HBM are segment-fed by the host-streamed driver
    (``value_from_sims`` at the 1M-path scale — BASELINE.md milestone 5)."""
    periods = inputs.periods
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    spot = _align_frame(spot_frame, periods, f"sim_spot_{label}")
    factor_frames = list(factor_frames) if factor_frames is not None else []
    factors = [
        _align_frame(f, periods, f"sim_factors_{label}[{i}]")
        for i, f in enumerate(factor_frames)
    ]
    spot_arr = np.asarray(spot, np_dtype)
    if factors:
        fac_arr = np.asarray(np.stack(factors, axis=1), np_dtype)  # [P, F, S]
    else:
        fac_arr = np.zeros((spot_arr.shape[0], 0, spot_arr.shape[1]), np_dtype)
    return spot_arr, fac_arr


def _align_frame(frame: pd.DataFrame, periods: pd.PeriodIndex, name: str) -> np.ndarray:
    if not isinstance(frame.index, pd.PeriodIndex):
        frame = frame.copy()
        frame.index = pd.PeriodIndex(frame.index, freq=periods.freqstr)
    missing = periods.difference(frame.index)
    if len(missing) > 0:
        raise ValueError(f"{name} does not contain a row for period {missing[0]}.")
    return frame.reindex(periods).to_numpy(dtype=np.float64)


def _grids_uniform(grids) -> bool:
    """True when every period's grid row is evenly spaced (within f32-scale
    tolerance) — such custom grids keep the fast uniform-interp kernels."""
    from .grid import rows_uniform

    return rows_uniform(grids)


def _panel_gb(spot_reg, factors_reg, dtype) -> float:
    """Total f-dtype bytes of both sim sets' spot+factor panels, in GB."""
    n, s = spot_reg.shape
    f = factors_reg.shape[1]
    return 2 * (1 + f) * n * s * jnp.dtype(dtype).itemsize / 2**30


def _host_stream_panels(spot_reg, factors_reg, dtype) -> bool:
    """True when materialising the sim panels on device would exceed the
    streaming threshold (parallel.mesh.stream_threshold_bytes) — the panels
    then stay host-side numpy and the chunked driver segment-feeds them.
    Multi-process runs shard panels across hosts instead.

    The gate is PER-DEVICE footprint (matching the internally-simulated
    auto-select in parallel/mesh.py) — but only when the path count divides
    the local device count, because a non-divisible count falls back to
    single-device execution downstream (parallel/mesh.py), which must then
    hold the WHOLE panel set."""
    if jax.process_count() > 1:
        return False
    from .parallel.mesh import stream_threshold_bytes

    n_dev = len(jax.devices())
    if spot_reg.shape[1] % n_dev != 0:
        n_dev = 1  # sharded path cannot engage; gate on the full footprint
    per_device = _panel_gb(spot_reg, factors_reg, dtype) * 2**30 / n_dev
    return per_device > stream_threshold_bytes()


def _lsmc_calc(
    storage: CmdtyStorage,
    val_date,
    inventory,
    fwd_curve,
    interest_rates,
    settlement_rule,
    sims_provider,
    basis_funcs: str,
    discount_deltas: bool,
    extra_decisions,
    num_grid_points: int,
    numerical_tolerance: float,
    on_progress_update: ProgressCallback,
    sim_data_returned: SimulationDataReturned,
    dtype,
    cancellation_poll: tp.Optional[tp.Callable[[], bool]] = None,
    deltas_method: str = "pathwise",
    checkpoint_path: tp.Optional[str] = None,
    stream_provider=None,
    antithetic: bool = False,
    grid_calc=None,
) -> MultiFactorValuationResults:
    # Accepted for API parity; a documented no-op.  The reference uses it to
    # tolerance-snap bang-bang decisions and grid bisection
    # (StorageHelper.cs:122-165,280-314); the branchless engine snaps
    # unconditionally and interpolates exactly — equivalence pinned by
    # tests/test_numerical_tolerance.py.
    del numerical_tolerance
    if checkpoint_path is not None and not isinstance(basis_funcs, str):
        raise ValueError(
            "checkpoint_path requires basis_funcs as a string (checkpoints "
            "persist the basis DSL, not combinator objects)."
        )
    if deltas_method not in ("pathwise", "adjoint"):
        raise ValueError(
            f"deltas_method must be 'pathwise' or 'adjoint', got {deltas_method!r}."
        )
    sim_data_returned = SimulationDataReturned.coerce(sim_data_returned)
    # Compare normalised pandas freqs, not the user string: "Q" normalises to
    # "Q-DEC", "H" to "h" (reference check multi_factor.py:215-216).
    if isinstance(fwd_curve, pd.Series) and isinstance(
        fwd_curve.index, pd.PeriodIndex
    ) and storage.start.freqstr != fwd_curve.index.freqstr:
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")

    # Degenerate cases: expired storage and valuation on the end period return
    # zero/terminal-value results with empty series, mirroring the reference's
    # guard clauses (LsmcStorageValuation.cs:64-87).
    val_period = pu.to_period(val_date, storage.start.freqstr)
    if val_period > storage.end:
        return _degenerate_results(0.0, storage.freq)
    if val_period == storage.end:
        if storage.empty_at_end:
            if inventory > 0:
                raise ValueError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return _degenerate_results(0.0, storage.freq)
        curve = fwd_curve
        if not isinstance(curve.index, pd.PeriodIndex):
            curve = curve.copy()
            curve.index = pd.PeriodIndex(curve.index, freq=storage.start.freqstr)
        price = float(curve[val_period])
        return _degenerate_results(
            float(storage.terminal_storage_npv(price, float(inventory))), storage.freq
        )

    def progress(x: float):
        # Cooperative cancellation, polled at phase boundaries (the analog of
        # the reference's per-step CancellationToken checks,
        # LsmcStorageValuation.cs:345,521 — device scans cannot poll Python).
        if cancellation_poll is not None and cancellation_poll():
            from .jobs import JobCancelledError

            raise JobCancelledError("Valuation cancelled.")
        if on_progress_update is not None:
            on_progress_update(x)

    monomials = tuple(basis_mod.coerce_basis_functions(basis_funcs))
    if basis_mod.has_generic(monomials):
        # Generic basis functions keep the backward pass on the XLA body
        # (identical results; BasisFunctions.cs:92 analog).
        logger.info(
            "Generic basis function(s) present (%s): valuation uses the XLA "
            "engine path instead of the Pallas decision kernel.",
            ", ".join(str(m) for m in monomials if isinstance(m, basis_mod.GenericBasisFunction)),
        )
    stopwatches = Stopwatches()
    with stopwatches.time("prepare_inputs"):
        inputs = prepare_valuation(
            storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule
        )

    wants_sim_data = bool(
        sim_data_returned
        & (
            SimulationDataReturned.INVENTORY
            | SimulationDataReturned.INJECT_WITHDRAW_VOLUME
            | SimulationDataReturned.CMDTY_CONSUMED
            | SimulationDataReturned.INVENTORY_LOSS
            | SimulationDataReturned.NET_VOLUME
            | SimulationDataReturned.PV
        )
    )
    wants_path_panels = bool(
        sim_data_returned
        & (
            SimulationDataReturned.SPOT_REGRESS
            | SimulationDataReturned.SPOT_VALUATION
            | SimulationDataReturned.FACTORS_REGRESS
            | SimulationDataReturned.FACTORS_VALUATION
        )
    )
    # Streamed execution (in-scan path regeneration, no [N, S] panels in HBM)
    # whenever nothing forces materialisation; identical results either way
    # (same RNG stream, tests/test_streaming.py).
    use_stream = (
        stream_provider is not None
        and not wants_sim_data
        and not wants_path_panels
        and grid_calc is None  # custom grids take the materialised general-interp path
    )

    logger.info("Simulating price paths.")
    spot_reg = factors_reg = spot_val = factors_val = None
    stream_cfg = None
    with stopwatches.time("path_simulation"):
        if use_stream:
            # Host-side OU precompute only; draws happen inside the scans.
            stream_cfg = stream_provider(inputs)
            num_factors = int(stream_cfg[0]["decay"].shape[1])
        else:
            (spot_reg, factors_reg), (spot_val, factors_val) = sims_provider(inputs)
            num_factors = int(factors_reg.shape[1])
    num_factors_needed = basis_mod.num_factors_required(monomials)
    if num_factors_needed > num_factors:
        raise ValueError(
            f"Basis functions reference factor x{num_factors_needed - 1} but only "
            f"{num_factors} factors are simulated."
        )
    progress(0.2)

    logger.info("Calculating intrinsic value.")
    with stopwatches.time("intrinsic_valuation"):
        intrinsic_res = intrinsic_engine.intrinsic_valuation(
            inputs.compiled, inputs.starting_inventory, inputs.fwd, inputs.df_settle,
            inputs.df_flow, inputs.inventory_lower, inputs.inventory_upper,
            num_grid_points=num_grid_points, dtype=dtype, grid_calc=grid_calc,
        )
    intrinsic_profile = profile_data_frame(
        inputs.periods, intrinsic_res.inventory, intrinsic_res.inject_withdraw,
        intrinsic_res.cmdty_consumed, intrinsic_res.inventory_loss,
        intrinsic_res.period_pv,
    )
    progress(0.3)

    logger.info("Calculating LSMC value.")
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, num_grid_points, dtype,
        grid_calc=grid_calc,
    )
    # Custom grids whose rows are all evenly spaced keep the fast uniform
    # (arithmetic-position, kernel-eligible) interpolation; anything else
    # takes the general-interp XLA path.
    uniform_grids = grid_calc is None or _grids_uniform(arrays["grids"])
    terminal_fn = inputs.compiled.engine_terminal_fn
    interactive = (
        (on_progress_update is not None or cancellation_poll is not None)
        and jax.process_count() == 1  # host-chunked loops are per-process
    )
    chunked_mesh = None
    if interactive and len(jax.devices()) > 1:
        # Host-chunked interactive drivers dispatch each seg_len-step segment
        # shard_map'd over the local path mesh, so progress/cancellation no
        # longer costs a multi-chip host its sharding (the drivers fall back
        # to one device only when the path count does not divide the mesh).
        from .parallel import mesh as pmesh

        chunked_mesh = pmesh.make_mesh()
    host_stream_used = False

    def segment_cb(phase, done, total):
        # Backward weighted ~2/3 of the compute phase like the reference
        # (LsmcStorageValuation.cs:48,164,387); cap at the 0.9 phase mark
        # (f64 rounding).
        frac = done / max(total, 1)
        part = 0.4 * frac if phase == "backward" else 0.4 + 0.2 * frac
        progress(min(0.3 + part, 0.9))

    with stopwatches.time("lsmc_backward_forward"):
        if use_stream and interactive:
            # Host-chunked streamed execution: the scans run in 16-step
            # segments dispatched from the host, so progress fires per
            # segment and cancellation aborts mid-pass with bounded latency
            # (the analog of the reference's per-period polling,
            # LsmcStorageValuation.cs:343-345,521).  Backward is weighted
            # ~2/3 of the compute phase like the reference (:48,164,387).
            sim_inputs, reg_key, val_key, same_sims, num_sims = stream_cfg
            result = lsmc_engine.lsmc_core_streamed_chunked(
                arrays, sim_inputs, reg_key, val_key, jnp.arange(num_sims),
                inputs.starting_inventory, monomials,
                int(extra_decisions or 0), bool(discount_deltas), terminal_fn,
                inputs.compiled.ratchet_is_step,
                use_pallas=lsmc_engine.resolve_use_pallas(
                    None, arrays["grids"].dtype
                ),
                antithetic=antithetic,
                same_sims=same_sims,
                return_regression=checkpoint_path is not None,
                segment_cb=segment_cb,
                mesh=chunked_mesh,
            )
        elif use_stream:
            from .parallel import mesh as pmesh

            sim_inputs, reg_key, val_key, same_sims, num_sims = stream_cfg
            if jax.process_count() > 1:
                # Multi-host internally-simulated valuation: global mesh over
                # every process's devices; sharded_lsmc_core replicates the
                # host-identical inputs and each process simulates its own
                # global path block (path ids from axis_index).
                from .parallel import distributed as dist

                mesh = dist.global_mesh()
            else:
                n_dev = len(jax.devices())
                mesh = (
                    pmesh.make_mesh() if num_sims % n_dev == 0
                    else pmesh.make_mesh(1)
                )
            result = pmesh.sharded_lsmc_core(
                mesh, arrays, sim_inputs, reg_key, val_key, num_sims,
                inputs.starting_inventory, monomials,
                int(extra_decisions or 0), bool(discount_deltas), terminal_fn,
                inputs.compiled.ratchet_is_step, antithetic=antithetic,
                same_sims=same_sims, stream=None,  # footprint auto-select
                return_regression=checkpoint_path is not None,
            )
        elif interactive or _host_stream_panels(spot_reg, factors_reg, dtype):
            # Materialised host-chunked execution: per-16-step progress/cancellation granularity (reference
            # per-period polling, LsmcStorageValuation.cs:343-345,521), and —
            # when the panels exceed the device-memory threshold — host
            # SEGMENT FEEDING: user panels stay in host RAM (numpy) and only
            # seg_len-step slices ever transfer, so a 1M-path
            # ``value_from_sims`` fits one chip like the internally-simulated
            # streamed path does (BASELINE.md milestone 5; panel analog
            # SpotSimResultsFromPanels.cs:36-117).
            num_sims = spot_reg.shape[1]
            host_stream = _host_stream_panels(spot_reg, factors_reg, dtype)
            if host_stream:
                host_stream_used = True
                if wants_sim_data or wants_path_panels:
                    raise ValueError(
                        "sim_data_returned panels do not fit device memory at "
                        "this path count; pass SimulationDataReturned.NONE."
                    )
                logger.info(
                    "LSMC execution: user panels host-streamed in segments "
                    "(%.1f GB of panels, %d sims).",
                    _panel_gb(spot_reg, factors_reg, dtype), num_sims,
                )

            result = lsmc_engine.lsmc_core_chunked(
                arrays, spot_reg, factors_reg, spot_val, factors_val,
                inputs.starting_inventory, monomials,
                int(extra_decisions or 0), bool(discount_deltas), terminal_fn,
                inputs.compiled.ratchet_is_step,
                use_pallas=lsmc_engine.resolve_use_pallas(
                    None, arrays["grids"].dtype
                ),
                return_sim_data=wants_sim_data,
                return_regression=checkpoint_path is not None
                or (deltas_method == "adjoint" and host_stream),
                segment_cb=segment_cb if interactive else None,
                uniform_grids=uniform_grids,
                # Host-streamed panels segment-feed from host RAM one device
                # at a time; the local mesh engages only for device-resident
                # interactive runs.
                mesh=None if host_stream else chunked_mesh,
            )
        else:
            result = lsmc_core_from_sims(
                arrays, spot_reg, factors_reg, spot_val, factors_val,
                inputs.starting_inventory,
                monomials, int(extra_decisions or 0), bool(discount_deltas), terminal_fn,
                inputs.compiled.ratchet_is_step,
                return_sim_data=wants_sim_data,
                return_regression=checkpoint_path is not None,
                uniform_grids=uniform_grids,
            )
        result = {k: np.asarray(v) for k, v in result.items() if v is not None}
    # Backward->forward regression payload (the artifact the reference keeps
    # in regressCoeffsBuilder, LsmcStorageValuation.cs:159,360): consumed by
    # checkpoints and by the host-streamed adjoint sweep.
    regression_payload = None
    if "regression_mean" in result:
        regression_payload = {
            "mean": result.pop("regression_mean"),
            "std": result.pop("regression_std"),
            "coeffs": result.pop("regression_coeffs"),
        }
    if checkpoint_path is not None:
        # Persist the hand-off so later forward-only re-pricings skip the
        # backward induction (checkpoint.py).  The payload is replicated
        # after the moments psum, so in multi-process runs only rank 0
        # writes — concurrent writes to a shared path would corrupt the npz.
        from .checkpoint import make_checkpoint

        if jax.process_index() == 0:
            make_checkpoint(
                {k: np.asarray(v) for k, v in arrays.items()}, regression_payload,
                basis_funcs, inputs.starting_inventory, int(extra_decisions or 0),
                bool(discount_deltas), inputs.compiled.ratchet_is_step,
                must_be_empty_at_end=terminal_fn is None,
            ).save(checkpoint_path)
    if deltas_method == "adjoint":
        # One reverse-mode sweep through the whole valuation; replaces the
        # pathwise delta series (NPV itself is unchanged: same sims, same
        # policy).
        logger.info("Calculating adjoint (AD) deltas.")
        with stopwatches.time("adjoint_deltas"):
            if use_stream:
                # Sharded + segment-rematerialised sweep: streamed sims, AD
                # tape bounded by segment-boundary carries, per-shard grads
                # averaged across the mesh (parallel.mesh.sharded_ad_deltas;
                # the differentiated graph is collective-free per shard, so
                # the same wrapper runs unchanged on the multi-process global
                # mesh).
                from .parallel import mesh as pmesh

                sim_inputs, reg_key, val_key, same_sims, num_sims = stream_cfg
                if jax.process_count() > 1:
                    from .parallel import distributed as dist

                    ad_mesh = dist.global_mesh()
                else:
                    n_dev = len(jax.devices())
                    ad_mesh = (
                        pmesh.make_mesh() if num_sims % n_dev == 0
                        else pmesh.make_mesh(1)
                    )
                _npv_ad, deltas_ad = pmesh.sharded_ad_deltas(
                    ad_mesh, arrays, sim_inputs, reg_key, val_key, num_sims,
                    inputs.starting_inventory, monomials,
                    int(extra_decisions or 0), bool(discount_deltas),
                    terminal_fn, inputs.compiled.ratchet_is_step,
                    antithetic=antithetic, same_sims=same_sims,
                )
            elif jax.process_count() > 1:
                # Multi-host user panels (value_from_sims_host_local): the
                # panels are global path-sharded arrays; backward with psum'd
                # moments, collective-free per-shard forward grad, explicit
                # pmean (parallel.mesh.sharded_ad_deltas_from_sims).
                from .parallel import distributed as dist
                from .parallel import mesh as pmesh

                _npv_ad, deltas_ad = pmesh.sharded_ad_deltas_from_sims(
                    arrays, spot_reg, factors_reg, spot_val, factors_val,
                    inputs.starting_inventory, monomials,
                    int(extra_decisions or 0), bool(discount_deltas),
                    terminal_fn, inputs.compiled.ratchet_is_step,
                    mesh=dist.global_mesh(), uniform_grids=uniform_grids,
                )
            elif host_stream_used:
                # Host-resident panels too large for device memory: the
                # gradient decomposes over path chunks once the regression
                # payload (from the host-chunked backward above) is fixed —
                # value_and_grad per device-sized chunk, averaged
                # (lsmc_ad_deltas_path_chunked).
                _npv_ad, deltas_ad = lsmc_engine.lsmc_ad_deltas_path_chunked(
                    arrays, regression_payload, spot_val, factors_val,
                    inputs.starting_inventory, monomials,
                    int(extra_decisions or 0), bool(discount_deltas),
                    terminal_fn, inputs.compiled.ratchet_is_step,
                    uniform_grids=uniform_grids,
                )
            else:
                # Materialised panels: path-sharded over the local devices
                # when the sim count divides the mesh (single-device
                # fallback inside), mirroring the pricing run's sharding.
                from .parallel import mesh as pmesh

                _npv_ad, deltas_ad = pmesh.sharded_ad_deltas_from_sims(
                    arrays, spot_reg, factors_reg, spot_val, factors_val,
                    inputs.starting_inventory, monomials,
                    int(extra_decisions or 0), bool(discount_deltas),
                    terminal_fn, inputs.compiled.ratchet_is_step,
                    uniform_grids=uniform_grids,
                )
            result["deltas"] = np.asarray(deltas_ad)
    logger.info(
        "LSMC complete. Forward NPV %.2f (backward %.2f).",
        result["npv"], result["backward_npv"],
    )
    progress(0.9)

    periods = inputs.periods
    active = periods[:-1]
    deltas = pd.Series(data=result["deltas"].astype(np.float64), index=periods)
    expected_profile = profile_data_frame(
        periods, result["profile_inventory"], result["profile_inject_withdraw"],
        result["profile_cmdty_consumed"], result["profile_inventory_loss"],
        result["profile_pv"],
    )
    trigger_prices = pd.DataFrame(
        {
            "inject_volume": result["max_inject_volume"].astype(np.float64),
            "inject_trigger_price": result["max_inject_trigger_price"].astype(np.float64),
            "withdraw_volume": result["max_withdraw_volume"].astype(np.float64),
            # Reference semantics (LsmcStorageValuation.cs:584): the price at
            # the withdrawal volume one increment from the alternative.
            "withdraw_trigger_price": result["max_withdraw_trigger_price"].astype(np.float64),
            # Beyond-reference extra: the price at the max withdrawal volume.
            "withdraw_max_volume_price": result["withdraw_max_volume_price"].astype(np.float64),
        },
        index=active,
    )
    profiles = []
    for t in range(len(active)):
        inj = [
            TriggerPricePoint(float(v), float(p))
            for v, p in zip(result["trigger_inject_volumes"][t], result["trigger_inject_prices"][t])
            if not (np.isnan(v) or np.isnan(p))
        ]
        wdr = [
            TriggerPricePoint(float(v), float(p))
            for v, p in zip(
                result["trigger_withdraw_volumes"][t], result["trigger_withdraw_prices"][t]
            )
            if not (np.isnan(v) or np.isnan(p))
        ]
        profiles.append(TriggerPriceProfile(inj, wdr))
    trigger_profiles = pd.Series(data=profiles, index=active)

    def panel(flag: SimulationDataReturned, data, index) -> pd.DataFrame:
        if not (sim_data_returned & flag) or data is None:
            return pd.DataFrame()
        if isinstance(data, jax.Array) and not data.is_fully_addressable:
            raise ValueError(
                "Per-sim panels are not available in multi-process runs; use "
                "sim_data_returned=SimulationDataReturned.NONE."
            )
        return pd.DataFrame(data=np.asarray(data, dtype=np.float64), index=index)

    # Factor panels are converted lazily: np.asarray on a multi-process
    # path-sharded array would touch non-addressable shards.  (Streamed runs
    # never materialise them; the flags gating their return are off there.)
    if sim_data_returned & SimulationDataReturned.FACTORS_REGRESS:
        fac_reg_np = np.asarray(factors_reg)
        factor_frames_reg = tuple(
            panel(SimulationDataReturned.FACTORS_REGRESS, fac_reg_np[:, i, :], periods)
            for i in range(factors_reg.shape[1])
        )
    else:
        factor_frames_reg = tuple(pd.DataFrame() for _ in range(num_factors))
    if sim_data_returned & SimulationDataReturned.FACTORS_VALUATION:
        fac_val_np = np.asarray(factors_val)
        factor_frames_val = tuple(
            panel(SimulationDataReturned.FACTORS_VALUATION, fac_val_np[:, i, :], periods)
            for i in range(factors_val.shape[1])
        )
    else:
        factor_frames_val = tuple(pd.DataFrame() for _ in range(num_factors))

    out = MultiFactorValuationResults(
        npv=float(result["npv"]),
        val_sim_standard_error=float(result["standard_error"]),
        deltas=deltas,
        expected_profile=expected_profile,
        intrinsic_npv=float(intrinsic_res.npv),
        intrinsic_profile=intrinsic_profile,
        sim_spot_regress=panel(SimulationDataReturned.SPOT_REGRESS, spot_reg, periods),
        sim_spot_valuation=panel(SimulationDataReturned.SPOT_VALUATION, spot_val, periods),
        sim_factors_regress=factor_frames_reg,
        sim_factors_valuation=factor_frames_val,
        sim_inventory=panel(
            SimulationDataReturned.INVENTORY, result.get("sim_inventory"), periods
        ),
        sim_inject_withdraw=panel(
            SimulationDataReturned.INJECT_WITHDRAW_VOLUME,
            result.get("sim_inject_withdraw"), active,
        ),
        sim_cmdty_consumed=panel(
            SimulationDataReturned.CMDTY_CONSUMED, result.get("sim_cmdty_consumed"), active
        ),
        sim_inventory_loss=panel(
            SimulationDataReturned.INVENTORY_LOSS, result.get("sim_inventory_loss"), active
        ),
        sim_net_volume=panel(
            SimulationDataReturned.NET_VOLUME, result.get("sim_net_volume"), active
        ),
        sim_pv=panel(SimulationDataReturned.PV, result.get("sim_pv"), periods),
        trigger_prices=trigger_prices,
        trigger_profiles=trigger_profiles,
    )
    logger.info("LSMC phase profile:\n%s", stopwatches.report())
    progress(1.0)
    return out


def _degenerate_results(npv: float, freq: str) -> MultiFactorValuationResults:
    """Zero/terminal-value results with empty series/frames for expired or
    end-period valuations (LsmcStorageValuationResults.CreateExpiredResults /
    CreateEndPeriodResults, LsmcStorageValuationResults.cs:60-105)."""
    empty_idx = pd.PeriodIndex([], freq=freq)
    empty_series = pd.Series(index=empty_idx, dtype=np.float64)
    empty_frame = pd.DataFrame(index=empty_idx)
    return MultiFactorValuationResults(
        npv=float(npv),
        val_sim_standard_error=0.0,
        deltas=empty_series,
        expected_profile=empty_frame,
        intrinsic_npv=float(npv),
        intrinsic_profile=empty_frame,
        sim_spot_regress=pd.DataFrame(),
        sim_spot_valuation=pd.DataFrame(),
        sim_factors_regress=(),
        sim_factors_valuation=(),
        sim_inventory=pd.DataFrame(),
        sim_inject_withdraw=pd.DataFrame(),
        sim_cmdty_consumed=pd.DataFrame(),
        sim_inventory_loss=pd.DataFrame(),
        sim_net_volume=pd.DataFrame(),
        sim_pv=pd.DataFrame(),
        trigger_prices=empty_frame,
        trigger_profiles=empty_series.copy(),
    )
