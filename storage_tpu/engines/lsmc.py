"""Least-Squares Monte Carlo storage valuation engine.

Accelerator re-design of ``LsmcStorageValuation.Calculate``
(reference ``LsmcValuation/LsmcStorageValuation.cs:57-657``):

* backward induction is a single ``lax.scan`` over time; per step the design
  matrix of basis monomials is built on device, continuation values for all
  inventory-grid points are regressed at once via standardised normal
  equations + Cholesky ([B,S]x[S,G] matmuls replace the reference's
  per-step MKL QR), and the bang-bang decision argmax runs over
  (grid x decisions x sims) with the reference's anti-foresight trick: argmax
  on REGRESSED values, realising the ACTUAL simulated continuation
  (LsmcStorageValuation.cs:310-336);
* the dual-simulation lower-bound estimator: regression sims drive the
  backward pass, an independent valuation-sim set drives the forward pass
  re-using the saved regression coefficients (LsmcStorageValuation.cs:352-415);
* the forward pass is a second scan carrying per-path inventory, producing
  NPV, standard error, pathwise deltas (:513-518), expected profiles and
  trigger prices (:523-592);
* all cross-path communication is a handful of tiny psums (design-matrix
  moments [B,B]/[B,G] per step + final mean reductions), so paths shard
  across a device mesh with `shard_map` (see ``parallel/mesh.py``).

Special-casing the valuation period is unnecessary here: when the valuation
date is the first active period, the simulated spot for that period is exactly
the forward price (OU step of zero time) and all factor columns are constant,
so the standardised ridge regression automatically degenerates to the
cross-sim mean — the behaviour the reference implements by hand at
LsmcStorageValuation.cs:174-185.

Known deviations from the reference, by design:
* Results are statistically, not bit-wise, comparable (threefry RNG vs
  Mersenne-Twister; linspace grids vs global-spacing grids) — acceptance is
  "NPV within 2 MC standard errors" per BASELINE.md.
* The reference adds a *cumulative running sum* of terminal values into
  ``pvBySim`` (LsmcStorageValuation.cs:601-609), which mis-states per-sim PV
  whenever the storage may be non-empty at end (invisible in its tests, which
  all use must-be-empty storage). This engine adds each sim's own terminal
  value.
* The forward-pass terminal PV uses the valuation sims' end-period spot, not
  the regression sims' (LsmcStorageValuation.cs:598 uses regression sims even
  though the forward pass runs on valuation sims).
"""
from __future__ import annotations

import typing as tp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import grid as gridmod
from ..basis import Monomial, design_matrix, has_generic
from ..facility import CompiledStorage
from ..ops import interp
from ..ops import decision_kernel
from ..models import spot_sim as spot_sim_mod
from ..ops.regression import column_stats, fit_continuation, predict

NUM_TRIGGER_PRICE_VOLUMES = 10  # LsmcStorageValuation.cs:383


def resolve_use_pallas(use_pallas: tp.Optional[bool], dtype) -> bool:
    """Whether the backward decision update runs the Pallas kernel
    (ops/decision_kernel).  By default: on a GPU for float32 runs; f64
    validation runs and the CPU keep the XLA body.  An explicit request
    where the kernel cannot run raises.  The engine entry points further
    keep generic bases and non-uniform grids on the XLA body."""
    if use_pallas is None:
        return jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float32
    if use_pallas and not decision_kernel.available():
        raise ValueError(
            f"use_pallas=True: the decision kernel needs a GPU backend "
            f"(have {jax.default_backend()!r})."
        )
    return bool(use_pallas)


def _kernel_eligible(use_pallas: bool, monomials, uniform_grids: bool = True) -> bool:
    """Generic basis functions and non-uniform grids keep the XLA body."""
    return bool(use_pallas) and uniform_grids and not has_generic(monomials)


def _pmean(x, axis_name):
    if axis_name is None:
        return x
    return jax.lax.pmean(x, axis_name)


def _psum(x, axis_name):
    if axis_name is None:
        return x
    return jax.lax.psum(x, axis_name)


def _global_mean_over_sims(x, axis_name):
    """Mean over the sims axis (last), reduced across path shards."""
    local_sum = jnp.sum(x, axis=-1)
    local_n = x.shape[-1]
    total = _psum(local_sum, axis_name)
    count = _psum(jnp.asarray(local_n, x.dtype), axis_name)
    return total / count


def _decision_cashflow_coeffs(decisions, x):
    """Per-decision immediate-PV decomposition: pv = a * spot + b (spot-independent
    parts in b).  Shapes follow ``decisions``."""
    is_inject = decisions > 0.0
    abs_d = jnp.abs(decisions)
    consumed = jnp.where(is_inject, x["inj_pcnt"], x["wdr_pcnt"]) * abs_d
    cost_npv = jnp.where(is_inject, x["inj_cost"], x["wdr_cost"]) * abs_d * x["df_flow"]
    a = -(decisions + consumed) * x["df_settle"]
    return a, -cost_npv, consumed


def _backward_per_step(arrays: tp.Dict[str, jnp.ndarray]) -> tp.Dict[str, jnp.ndarray]:
    """Per-step facility/discount arrays feeding the backward scan ([N, ...])."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    return {
        "grid": grids[:n],
        "grid_next": grids[1:],
        "next_min": arrays["lower"][1:],
        "next_max": arrays["upper"][1:],
        "df_settle": arrays["df_settle"],
        "df_flow": arrays["df_flow"],
        "inj_cost": arrays["inj_cost"],
        "wdr_cost": arrays["wdr_cost"],
        "inj_pcnt": arrays["inj_pcnt"],
        "wdr_pcnt": arrays["wdr_pcnt"],
        "loss_pcnt": arrays["loss_pcnt"],
        "inv_cost_rate": arrays["inv_cost_rate"],
        "ratchet_inv": arrays["ratchet_inv"],
        "ratchet_min": arrays["ratchet_min"],
        "ratchet_max": arrays["ratchet_max"],
    }


def _terminal_values(terminal_fn, spot_end, grid_end, num_grid, num_sims, dtype):
    """Terminal storage values per (grid point, sim) — LsmcStorageValuation.cs:110-131."""
    if terminal_fn is None:
        return jnp.zeros((num_grid, num_sims), dtype)
    # Broadcast: user terminal functions may return scalars or ignore args.
    return jnp.broadcast_to(
        jnp.asarray(terminal_fn(spot_end[None, :], grid_end[:, None]), dtype),
        (num_grid, num_sims),
    )


def _backward_prep_one(x, num_extra_decisions: int, ratchet_is_step: bool,
                       uniform_grids: bool = True):
    """Coefficient-INDEPENDENT per-step preparation: decision set,
    interpolation indices/weights and the immediate-PV decomposition.  None
    of this depends on the scan carry, so it is vmapped over ALL steps before
    the backward scan, keeping ~30 small [G, D]-sized ops per step out of the
    sequential loop."""
    grid_t = x["grid"]
    min_rate, max_rate = gridmod.ratchet_rates(
        x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, grid_t
    )
    decisions = gridmod.bang_bang_decisions(
        min_rate, max_rate, grid_t, x["loss_pcnt"], x["next_min"], x["next_max"],
        num_extra_decisions,
    )  # [G, D]
    loss = x["loss_pcnt"] * grid_t  # [G]
    inv_after = grid_t[:, None] + decisions - loss[:, None]  # [G, D]
    weights_fn = (
        interp.interp_weights if uniform_grids else interp.interp_weights_general
    )
    idx_lo, w_hi = weights_fn(x["grid_next"], inv_after)  # [G, D]
    a, b, _consumed = _decision_cashflow_coeffs(decisions, x)  # [G, D]
    inv_cost_npv = x["inv_cost_rate"] * grid_t * x["df_flow"]  # [G]
    b = b - inv_cost_npv[:, None]
    return {"idx_lo": idx_lo, "w_hi": w_hi, "prep_a": a, "prep_b": b}


def _backward_prep_all(per_step, num_extra_decisions: int, ratchet_is_step: bool,
                       uniform_grids: bool = True):
    """Vectorise ``_backward_prep_one`` over the step axis ([N, ...] arrays)."""
    keys = (
        "grid", "grid_next", "next_min", "next_max", "df_settle", "df_flow",
        "inj_cost", "wdr_cost", "inj_pcnt", "wdr_pcnt", "loss_pcnt",
        "inv_cost_rate", "ratchet_inv", "ratchet_min", "ratchet_max",
    )
    sub = {k: per_step[k] for k in keys}
    return jax.vmap(
        lambda x: _backward_prep_one(
            x, num_extra_decisions, ratchet_is_step, uniform_grids,
        )
    )(sub)


def _interp_coeffs(coeffs, x):
    """Regressed continuation at every (grid, decision) target inventory:
    interpolate in COEFFICIENT space (linear interp commutes with the linear
    model) — replaces a per-decision gather+lerp over [G, S] fitted values."""
    idx_lo, w_hi = x["idx_lo"], x["w_hi"]
    return coeffs[:, idx_lo] * (1 - w_hi) + coeffs[:, idx_lo + 1] * w_hi  # [B, G, D]


def decision_update_xla(v_act_next, dm_std, spot, ci, idx_lo, w_hi, a, b):
    """The backward decision update as plain XLA: ``best_act`` [G, S].

    ``v_act_next`` [G_next, S] next-period values, ``dm_std`` [S, B] the
    standardised design matrix, ``ci`` [B, G, D] regression coefficients at
    the (grid, decision) target inventories, ``idx_lo``/``w_hi`` [G, D] their
    interpolation on the next grid, ``a``/``b`` [G, D] the immediate-PV
    decomposition.  The reference for ``ops/decision_kernel``."""
    # HIGHEST: the argmax compares near-equal continuations, and the GPU's
    # default f32 matmul (TF32) moves them by more than the gaps.
    pred = jnp.einsum(
        "sb,bgd->gds", dm_std, ci, precision=jax.lax.Precision.HIGHEST
    )  # [G, D, S]
    best_reg = None
    best_act = None
    # Unrolled loop over the (small, static) decision axis: running argmax on
    # regressed values, realising actual values (the anti-foresight trick,
    # LsmcStorageValuation.cs:327-335) without materialising [G, D, S] twice.
    # Initialising from decision 0 (not -inf) keeps ties/non-finite
    # comparisons on the first decision, matching the Pallas kernel.
    for d in range(idx_lo.shape[1]):
        lo = idx_lo[:, d]
        w = w_hi[:, d][:, None]
        c_act_d = v_act_next[lo] * (1 - w) + v_act_next[lo + 1] * w  # [G, S]
        imm = a[:, d][:, None] * spot[None, :] + b[:, d][:, None]
        val_reg = imm + pred[:, d, :]
        val_act = imm + c_act_d
        if d == 0:
            best_reg, best_act = val_reg, val_act
        else:
            better = val_reg > best_reg
            best_reg = jnp.where(better, val_reg, best_reg)
            best_act = jnp.where(better, val_act, best_act)
    return best_act


def _backward_body(
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    axis_name: tp.Optional[str],
    use_pallas: bool,
):
    """The backward-step closure shared by the materialised, streamed and
    host-chunked scans.  It takes ``(v_act_next, x)`` where ``x`` holds the
    per-step facility scalars, the precomputed prep fields
    (``_backward_prep_all``) and the simulated ``spot`` [S] / ``factors``
    [F, S] for the step, and returns the step's values [G, S] and its
    regression payload.  ``num_extra_decisions`` is implied by the prep
    fields' decision axis."""
    del num_extra_decisions

    def body(v_act_next, x):
        # Regression of next-period value on this period's state
        # (LsmcStorageValuation.cs:191-212, via normal equations).
        dm = design_matrix(monomials, x["spot"], x["factors"])  # [S, B]
        mean, std = column_stats(dm, axis_name)
        dm_std = (dm - mean) / std
        coeffs = fit_continuation(dm_std, v_act_next.T, axis_name)  # [B, G]
        ci = _interp_coeffs(coeffs, x)  # [B, G, D]
        args = (x["spot"], ci, x["idx_lo"], x["w_hi"], x["prep_a"], x["prep_b"])
        if use_pallas:
            best_act = decision_kernel.decision_update_auto(
                v_act_next, dm_std.T, *args
            )
        else:
            best_act = decision_update_xla(v_act_next, dm_std, *args)
        return best_act, {"mean": mean, "std": std, "coeffs": coeffs}

    return body


def lsmc_backward(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_reg: jnp.ndarray,  # [N+1, S]
    factors_reg: jnp.ndarray,  # [N+1, F, S]
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str],
    use_pallas: bool = False,
    uniform_grids: bool = True,
):
    """Backward induction over materialised path panels.  Returns (v0 [G, S]
    values at the first period, regression payload dict of stacked per-step
    arrays [N, ...])."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1

    v_end = _terminal_values(
        terminal_fn, spot_reg[n], grids[n], grids.shape[1], spot_reg.shape[1],
        grids.dtype,
    )
    per_step = _backward_per_step(arrays)
    per_step.update(_backward_prep_all(
        per_step, num_extra_decisions, ratchet_is_step, uniform_grids,
    ))
    per_step["spot"] = spot_reg[:n]
    per_step["factors"] = factors_reg[:n]
    body = _backward_body(monomials, num_extra_decisions, axis_name, use_pallas)
    return jax.lax.scan(body, v_end, per_step, reverse=True)


# ------------------------------------------------------------- streamed sims
#
# At 1M paths the [N+1, S] spot plus [N+1, F, S] factor panels of two sim
# sets take ~11.7 GB f32 (1M x 366); past ``parallel.mesh``'s threshold the
# engine does not materialise them.  The per-(step, path) counter RNG
# (models/spot_sim.step_normals) lets the scans regenerate any step's draws in
# place, so the streamed engine holds no path panels at all:
#
# * the FORWARD pass carries the OU factor state [S, F] and regenerates each
#   step's spot on the fly — a trivial carry extension;
# * the BACKWARD pass runs in reverse time, and the OU recursion cannot be
#   reversed stably (the inverse map amplifies f32 rounding by e^{alpha*T} —
#   ~1e7 for the daily gas config), so it uses SEGMENTED CHECKPOINTING: a
#   warmup sweep stores the factor state entering every K-step segment
#   ([ceil(N/K), S, F], ~140 MB at 1M paths, K=32), and the backward scan
#   regenerates each segment forward from its checkpoint with EXACTLY the
#   simulator's own recursion — so streamed and materialised valuations agree
#   bit-for-bit (pinned by tests/test_streaming.py).
#
# HBM high-water at 1M paths: the [G, S] value panel (~400 MB) plus one
# [K, S, F+1] segment panel (~130 MB) — capacity is set by the value panel,
# not the paths.


class StreamedSims(tp.NamedTuple):
    """Inputs for in-scan path regeneration: the OU precompute arrays
    (per simulated period), the RNG base key and this shard's global path ids."""

    decay: jnp.ndarray  # [N+1, F]
    chol: jnp.ndarray  # [N+1, F, F]
    vols: jnp.ndarray  # [N+1, F]
    half_var: jnp.ndarray  # [N+1]
    fwd: jnp.ndarray  # [N+1] simulation forward curve
    key: jax.Array
    path_ids: jnp.ndarray  # [S_local]


def _stream_step_arrays(stream: StreamedSims, n: int) -> tp.Dict[str, jnp.ndarray]:
    """Per-step simulation parameters for steps 0..n-1."""
    return {
        "t_idx": jnp.arange(n),
        "sim_decay": stream.decay[:n],
        "sim_chol": stream.chol[:n],
        "sim_fwd": stream.fwd[:n],
        "sim_hv": stream.half_var[:n],
        "sim_vols": stream.vols[:n],
    }


def _stream_draw(stream: StreamedSims, t, antithetic: bool):
    f = stream.decay.shape[1]
    return spot_sim_mod.step_normals(
        stream.key, t, stream.path_ids, f, antithetic, stream.decay.dtype
    )


def _stream_scan_draws(stream: StreamedSims, t_idx, antithetic: bool):
    """Bulk draws for a contiguous block of steps, packaged for in-scan
    consumption: returns ``(xs_extra, get_z)`` where ``xs_extra`` joins the
    scan xs and ``get_z(carry_free_xs_slice)`` yields the step's [F, S]
    draws.  f32 uses the block-half layout (no word-interleave pass over
    the whole panel — spot_sim.draw_normal_halves); f64 words never straddle
    blocks, so the assembled [T, F, S] panel is free of relayout anyway."""
    f = stream.decay.shape[1]
    dtype = stream.decay.dtype
    if jnp.dtype(dtype) == jnp.float64:
        zs = spot_sim_mod.multi_step_normals(
            stream.key, t_idx[0], t_idx.shape[0], stream.path_ids, f,
            antithetic, dtype,
        )
        return zs, lambda z_slice, t: z_slice
    z1, z2, b0 = spot_sim_mod.draw_normal_halves(
        stream.key, t_idx[0], t_idx.shape[0], stream.path_ids, f, antithetic,
        dtype,
    )
    return t_idx, lambda t_slice, t: spot_sim_mod.step_z_from_halves(
        z1, z2, b0, t, f
    )


def _stream_terminal_state(stream: StreamedSims, x_nm1, n: int, antithetic: bool):
    """Advance the factor state one final step to the end period and price it."""
    z_n = _stream_draw(stream, jnp.asarray(n), antithetic)
    x_n = spot_sim_mod.ou_step(x_nm1, z_n, stream.decay[n], stream.chol[n])
    spot_n = spot_sim_mod.spot_from_state(
        x_n, stream.fwd[n], stream.half_var[n], stream.vols[n]
    )
    return x_n, spot_n


def _stream_warmup(stream: StreamedSims, n: int, seg_len: int, antithetic: bool):
    """One forward sweep of the OU recursion, emitting the state ENTERING each
    full K-step segment (checkpoints [m, S, F]) plus the state entering the
    ragged tail and the final state x_{n-1}."""
    m, r = n // seg_len, n % seg_len
    s = stream.path_ids.shape[0]
    f = stream.decay.shape[1]
    dtype = stream.decay.dtype
    x0 = jnp.zeros((f, s), dtype)

    def chain(x, xs):
        t_idx, d_seg, c_seg = xs
        z_xs, get_z = _stream_scan_draws(stream, t_idx, antithetic)

        def body(xc, one):
            z_or_t, t, d_k, c_k = one
            z = get_z(z_or_t, t)
            return spot_sim_mod.ou_step(xc, z, d_k, c_k), None

        x_out, _ = jax.lax.scan(body, x, (z_xs, t_idx, d_seg, c_seg))
        return x_out

    steps = (jnp.arange(n), stream.decay[:n], stream.chol[:n])
    full = jax.tree.map(lambda a: a[: m * seg_len].reshape((m, seg_len) + a.shape[1:]), steps)
    ragged = jax.tree.map(lambda a: a[m * seg_len :], steps)

    def warm_seg(x, seg_xs):
        return chain(x, seg_xs), x  # emit the segment ENTRY state

    if m > 0:
        x_tail, checkpoints = jax.lax.scan(warm_seg, x0, full)
    else:
        x_tail, checkpoints = x0, jnp.zeros((0, f, s), dtype)
    ragged_entry = x_tail
    x_last = chain(x_tail, ragged) if r > 0 else x_tail  # x_{n-1}
    return checkpoints, ragged_entry, x_last


def _regen_segment(stream: StreamedSims, entry_state, seg, antithetic: bool):
    """Regenerate one segment's spot [L, S] and factors [L, F, S] forward from
    its checkpoint (bit-identical to the simulator's own recursion)."""

    z_xs, get_z = _stream_scan_draws(stream, seg["t_idx"], antithetic)

    def body(x, one):
        z_or_t, one = one
        z = get_z(z_or_t, one["t_idx"])
        x_new = spot_sim_mod.ou_step(x, z, one["sim_decay"], one["sim_chol"])
        spot = spot_sim_mod.spot_from_state(
            x_new, one["sim_fwd"], one["sim_hv"], one["sim_vols"]
        )
        return x_new, (spot, x_new)

    _, (spot_seg, fac_seg) = jax.lax.scan(body, entry_state, (z_xs, seg))
    return spot_seg, fac_seg


def _process_backward_segment(stream, carry, entry_state, seg, body,
                              antithetic: bool):
    """Regenerate one segment's paths and run the backward body over it
    (shared by the fully-jitted scan-over-segments and the host-chunked
    progress/cancellation driver)."""
    spot_seg, fac_seg = _regen_segment(stream, entry_state, seg, antithetic)
    seg = dict(seg)
    seg["spot"] = spot_seg
    seg["factors"] = fac_seg
    return jax.lax.scan(body, carry, seg, reverse=True)


def lsmc_backward_streamed(
    arrays: tp.Dict[str, jnp.ndarray],
    stream: StreamedSims,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str],
    use_pallas: bool = False,
    seg_len: int = 16,
    antithetic: bool = False,
    remat: bool = False,
):
    """Backward induction with in-scan path regeneration (no [N, S] panels).
    Bit-identical to ``lsmc_backward`` fed ``simulate_ou_paths`` output.

    ``remat`` wraps each segment in ``jax.checkpoint`` so reverse-mode AD
    through the scan stores only segment-boundary carries ([N/K, G, S])
    instead of every step's residuals — the memory bound that makes the
    adjoint-delta sweep feasible at bench scale."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    seg_len = max(1, min(seg_len, n))
    m, r = n // seg_len, n % seg_len
    num_grid = grids.shape[1]
    s = stream.path_ids.shape[0]
    dtype = grids.dtype

    body = _backward_body(monomials, num_extra_decisions, axis_name, use_pallas)

    checkpoints, ragged_entry, x_last = _stream_warmup(
        stream, n, seg_len, antithetic
    )
    _, spot_end = _stream_terminal_state(stream, x_last, n, antithetic)
    carry = _terminal_values(terminal_fn, spot_end, grids[n], num_grid, s, dtype)

    per_step = _backward_per_step(arrays)
    per_step.update(_backward_prep_all(
        per_step, num_extra_decisions, ratchet_is_step,
    ))
    per_step.update(_stream_step_arrays(stream, n))
    full_steps = jax.tree.map(
        lambda a: a[: m * seg_len].reshape((m, seg_len) + a.shape[1:]), per_step
    )
    ragged_steps = jax.tree.map(lambda a: a[m * seg_len :], per_step)

    def process_segment(carry, entry_state, seg):
        return _process_backward_segment(
            stream, carry, entry_state, seg, body, antithetic,
        )

    if remat:
        process_segment = jax.checkpoint(process_segment, prevent_cse=False)

    reg_ragged = None
    if r > 0:
        carry, reg_ragged = process_segment(carry, ragged_entry, ragged_steps)

    if m > 0:
        def outer_body(carry, seg_xs):
            entry_state, seg = seg_xs
            return process_segment(carry, entry_state, seg)

        carry, reg_full = jax.lax.scan(
            outer_body, carry, (checkpoints, full_steps), reverse=True,
        )
        # [m, K, ...] -> [m*K, ...]
        reg_full = jax.tree.map(
            lambda a: a.reshape((m * seg_len,) + a.shape[2:]), reg_full
        )
    else:
        reg_full = None

    if reg_full is None:
        regression = reg_ragged
    elif reg_ragged is None:
        regression = reg_full
    else:
        regression = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), reg_full, reg_ragged
        )
    return carry, regression


def _trigger_outputs(x, xbar, expected_inventory, ratchet_is_step: bool,
                     num_extra_decisions: int, dtype, uniform_grids: bool = True):
    """Per-step trigger-price outputs at the expected inventory
    (LsmcStorageValuation.cs:523-592).  ``x`` carries the step scalars,
    ``xbar`` the cross-sim mean standardised design row."""
    num_tv = NUM_TRIGGER_PRICE_VOLUMES
    cbar = jnp.dot(xbar, x["coeffs"], precision=jax.lax.Precision.HIGHEST)  # [G_next]
    e_loss = x["loss_pcnt"] * expected_inventory
    e_min_rate, e_max_rate = gridmod.ratchet_rates(
        x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step,
        expected_inventory,
    )
    e_decisions = gridmod.bang_bang_decisions(
        e_min_rate, e_max_rate, expected_inventory, x["loss_pcnt"], x["next_min"],
        x["next_max"], num_extra_decisions,
    )  # [D]

    def side(selector_max: bool):
        if selector_max:  # inject side
            extreme = jnp.max(e_decisions)
            nonneg = jnp.where(e_decisions >= 0, e_decisions, jnp.inf)
            alternative = jnp.min(nonneg)
            active = (extreme > 0) & (extreme > alternative)
        else:  # withdraw side
            extreme = jnp.min(e_decisions)
            nonpos = jnp.where(e_decisions <= 0, e_decisions, -jnp.inf)
            alternative = jnp.max(nonpos)
            active = (extreme < 0) & (extreme < alternative)

        def pv_parts(volume):
            is_inject = volume > 0.0
            abs_v = jnp.abs(volume)
            consumed_v = jnp.where(is_inject, x["inj_pcnt"], x["wdr_pcnt"]) * abs_v
            cost_v = (
                jnp.where(is_inject, x["inj_cost"], x["wdr_cost"]) * abs_v * x["df_flow"]
            )
            iv = (
                interp.interp_vector if uniform_grids
                else interp.interp_vector_general
            )
            cont_v = iv(
                x["grid_next"], cbar, expected_inventory + volume - e_loss
            )
            return cont_v, cost_v, consumed_v

        alt_cont, alt_cost, alt_consumed = pv_parts(alternative)
        j = jnp.arange(1, num_tv + 1, dtype=dtype)
        volumes = alternative + j * (extreme - alternative) / num_tv  # ends at extreme
        cont_v, cost_v, consumed_v = pv_parts(volumes)
        # Price making the trigger volume indifferent to the alternative
        # (CalcTriggerPrice, LsmcStorageValuation.cs:704-723).
        denom = x["df_settle"] * (volumes - alternative + consumed_v - alt_consumed)
        prices = ((cont_v - alt_cont) - (cost_v - alt_cost)) / denom
        nan = jnp.asarray(jnp.nan, dtype)
        volumes = jnp.where(active, volumes, nan)
        prices = jnp.where(active, prices, nan)
        return (
            volumes, prices,
            jnp.where(active, extreme, nan),
            jnp.where(active, prices[-1], nan),  # price at the max volume
            jnp.where(active, prices[0], nan),   # price nearest the alternative
        )

    inj_volumes, inj_prices, max_inj_vol, max_inj_price, _inj_near = side(True)
    wdr_volumes, wdr_prices, max_wdr_vol, wdr_maxvol_price, wdr_near_price = side(False)
    return {
        "inj_volumes": inj_volumes,
        "inj_prices": inj_prices,
        "wdr_volumes": wdr_volumes,
        "wdr_prices": wdr_prices,
        "max_inj_vol": max_inj_vol,
        # Inject: the reference's MaxInjectTriggerPrice IS the max-volume
        # point (the last entry of the ascending volume scan,
        # LsmcStorageValuation.cs:556).
        "max_inj_price": max_inj_price,
        "max_wdr_vol": max_wdr_vol,
        # Withdraw: the reference reports the price at the volume ONE
        # INCREMENT from the alternative (withdrawTriggerPrices[0] of the
        # reversed scan, LsmcStorageValuation.cs:584) in the like-named
        # column; the max-volume figure is kept under a distinct key.
        "max_wdr_price": wdr_near_price,
        "wdr_maxvol_price": wdr_maxvol_price,
    }


def _forward_per_step(
    arrays: tp.Dict[str, jnp.ndarray],
    regression: tp.Dict[str, jnp.ndarray],
) -> tp.Dict[str, jnp.ndarray]:
    """Per-step facility/regression arrays feeding the forward scan."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    return {
        "grid_next": grids[1:],
        "next_min": arrays["lower"][1:],
        "next_max": arrays["upper"][1:],
        "fwd": arrays["fwd"][:n],
        "df_settle": arrays["df_settle"],
        "df_flow": arrays["df_flow"],
        "inj_cost": arrays["inj_cost"],
        "wdr_cost": arrays["wdr_cost"],
        "inj_pcnt": arrays["inj_pcnt"],
        "wdr_pcnt": arrays["wdr_pcnt"],
        "loss_pcnt": arrays["loss_pcnt"],
        "inv_cost_rate": arrays["inv_cost_rate"],
        "ratchet_inv": arrays["ratchet_inv"],
        "ratchet_min": arrays["ratchet_min"],
        "ratchet_max": arrays["ratchet_max"],
        "mean": regression["mean"],
        "std": regression["std"],
        "coeffs": regression["coeffs"],
    }


def _forward_body(
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str],
    return_sim_data: bool,
    dtype,
    uniform_grids: bool = True,
):
    """The forward-step closure shared by the materialised and streamed
    scans.  It takes ``(carry, x)`` with carry (inventory [S], pv [S]) and
    ``x`` holding per-step arrays plus ``spot`` [S] and ``factors`` [F, S]."""
    num_decisions = 2 * num_extra_decisions + 3

    def forward_step(carry, x):
        inventory, pv = carry  # [S], [S]

        dm = design_matrix(monomials, x["spot"], x["factors"])  # [S, B]
        dm_std = (dm - x["mean"]) / x["std"]
        c_reg = predict(dm_std, x["coeffs"])  # [S, G_next]

        min_rate, max_rate = gridmod.ratchet_rates(
            x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step, inventory
        )
        decisions = gridmod.bang_bang_decisions(
            min_rate, max_rate, inventory, x["loss_pcnt"], x["next_min"], x["next_max"],
            num_extra_decisions,
        )  # [S, D]
        loss = x["loss_pcnt"] * inventory  # [S]
        inv_after = inventory[:, None] + decisions - loss[:, None]  # [S, D]
        per_sim_interp = (
            interp.interp_per_sim if uniform_grids
            else interp.interp_per_sim_general
        )
        cont = per_sim_interp(x["grid_next"], c_reg, inv_after)  # [S, D]

        a, b, consumed = _decision_cashflow_coeffs(decisions, x)  # [S, D]
        inv_cost_npv = x["inv_cost_rate"] * inventory * x["df_flow"]  # [S]
        imm = a * x["spot"][:, None] + b - inv_cost_npv[:, None]  # [S, D]

        total = imm + cont
        best = jnp.argmax(total, axis=1)  # [S]
        # One-hot contraction over the small decision axis.
        onehot = (best[:, None] == jnp.arange(num_decisions)).astype(imm.dtype)
        take = lambda arr: jnp.sum(arr * onehot, axis=1)
        opt_decision = take(decisions)
        opt_consumed = take(consumed)
        opt_imm = take(imm)
        new_inventory = take(inv_after)
        new_pv = pv + opt_imm

        # Pathwise delta (LsmcStorageValuation.cs:513-518): assumes
        # spot = forward x stochastic factor.
        disc = x["df_settle"] if discount_deltas else jnp.ones_like(x["df_settle"])
        delta = (
            _global_mean_over_sims(-(opt_decision + opt_consumed) * x["spot"], axis_name)
            / x["fwd"]
            * disc
        )

        expected_inventory = _global_mean_over_sims(inventory, axis_name)
        profile = (
            expected_inventory,
            _global_mean_over_sims(opt_decision, axis_name),
            _global_mean_over_sims(opt_consumed, axis_name),
            _global_mean_over_sims(loss, axis_name),
            _global_mean_over_sims(opt_imm, axis_name),
        )

        # ---- Trigger prices at the expected inventory (LsmcStorageValuation.cs:523-592).
        # Mean continuation per grid point = (mean standardised design row) @
        # coeffs — no [S, G] reduction needed.
        xbar = _global_mean_over_sims(dm_std.T, axis_name)  # [B]
        outputs = {
            "delta": delta,
            "profile": profile,
            **_trigger_outputs(
                x, xbar, expected_inventory, ratchet_is_step,
                num_extra_decisions, dtype, uniform_grids,
            ),
        }
        if return_sim_data:
            outputs["sim"] = {
                "inventory": inventory,
                "inject_withdraw": opt_decision,
                "cmdty_consumed": opt_consumed,
                "inventory_loss": loss,
                "pv": opt_imm,
            }
        return (new_inventory, new_pv), outputs

    return forward_step


def _forward_finalise(
    outputs,
    final_inventory,
    pv_by_sim,
    spot_end,  # [S] end-period spot (for the terminal value)
    terminal_fn,
    axis_name,
    return_sim_data: bool,
    s_local: int,
    dtype,
):
    """Terminal value, NPV/SE reductions and result assembly shared by the
    materialised and streamed forward passes."""
    # Terminal period PV for non-empty storage (corrected semantics; see module
    # docstring re LsmcStorageValuation.cs:594-612).
    if terminal_fn is not None:
        terminal_pv = jnp.broadcast_to(
            jnp.asarray(terminal_fn(spot_end, final_inventory), dtype),
            final_inventory.shape,
        )
        pv_by_sim = pv_by_sim + terminal_pv
        end_pv = _global_mean_over_sims(terminal_pv, axis_name)
    else:
        terminal_pv = jnp.zeros_like(pv_by_sim)
        end_pv = jnp.zeros((), dtype)

    npv = _global_mean_over_sims(pv_by_sim, axis_name)
    # Sample standard error across all shards (ddof=1, StorageHelper uses the
    # sample standard deviation — LsmcStorageValuation.cs:618).
    count = _psum(jnp.asarray(s_local, dtype), axis_name)
    sq_sum = _psum(jnp.sum((pv_by_sim - npv) ** 2), axis_name)
    standard_error = jnp.sqrt(sq_sum / (count - 1.0)) / jnp.sqrt(count)

    expected_final_inventory = _global_mean_over_sims(final_inventory, axis_name)
    prof_inv, prof_dec, prof_cons, prof_loss, prof_pv = outputs["profile"]
    zero = jnp.zeros((1,), dtype)
    profile_inventory = jnp.concatenate([prof_inv, expected_final_inventory[None]])
    profile_dec = jnp.concatenate([prof_dec, zero])
    profile_cons = jnp.concatenate([prof_cons, zero])
    profile_loss = jnp.concatenate([prof_loss, zero])
    profile_pv = jnp.concatenate([prof_pv, end_pv[None]])
    deltas = jnp.concatenate([outputs["delta"], zero])

    sim_panels = {}
    if return_sim_data:
        sim = outputs["sim"]
        sim_panels = {
            "sim_inventory": jnp.concatenate([sim["inventory"], final_inventory[None]], axis=0),
            "sim_inject_withdraw": sim["inject_withdraw"],
            "sim_cmdty_consumed": sim["cmdty_consumed"],
            "sim_inventory_loss": sim["inventory_loss"],
            "sim_net_volume": -sim["inject_withdraw"] - sim["cmdty_consumed"],
            "sim_pv": jnp.concatenate([sim["pv"], terminal_pv[None]], axis=0),
        }

    return {
        "npv": npv,
        "standard_error": standard_error,
        "deltas": deltas,
        "profile_inventory": profile_inventory,
        "profile_inject_withdraw": profile_dec,
        "profile_cmdty_consumed": profile_cons,
        "profile_inventory_loss": profile_loss,
        "profile_pv": profile_pv,
        "trigger_inject_volumes": outputs["inj_volumes"],
        "trigger_inject_prices": outputs["inj_prices"],
        "trigger_withdraw_volumes": outputs["wdr_volumes"],
        "trigger_withdraw_prices": outputs["wdr_prices"],
        "max_inject_volume": outputs["max_inj_vol"],
        "max_inject_trigger_price": outputs["max_inj_price"],
        "max_withdraw_volume": outputs["max_wdr_vol"],
        "max_withdraw_trigger_price": outputs["max_wdr_price"],
        "withdraw_max_volume_price": outputs["wdr_maxvol_price"],
        **sim_panels,
    }


def lsmc_forward(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_val: jnp.ndarray,  # [N+1, S]
    factors_val: jnp.ndarray,  # [N+1, F, S]
    regression: tp.Dict[str, jnp.ndarray],  # stacked [N, ...] from the backward pass
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str],
    return_sim_data: bool,
    uniform_grids: bool = True,
):
    """Forward simulation over materialised path panels."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    dtype = grids.dtype
    s_local = spot_val.shape[1]

    per_step = _forward_per_step(arrays, regression)
    per_step["spot"] = spot_val[:n]
    per_step["factors"] = factors_val[:n]

    body = _forward_body(
        monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
        axis_name, return_sim_data, dtype, uniform_grids=uniform_grids,
    )

    inv0 = jnp.full((s_local,), jnp.asarray(starting_inventory, dtype))
    pv0 = jnp.zeros((s_local,), dtype)
    (final_inventory, pv_by_sim), outputs = jax.lax.scan(body, (inv0, pv0), per_step)
    return _forward_finalise(
        outputs, final_inventory, pv_by_sim, spot_val[n], terminal_fn,
        axis_name, return_sim_data, s_local, dtype,
    )


def _stream_forward_segment_scan(stream, carry, seg, body, antithetic):
    """Scan one streamed-forward segment: bulk-draw the whole segment's
    normals in ONE hash call (per-step draws inside the scan SEQUENTIALISE
    the threefry hashing), then step
    the OU state alongside the inventory/pv carry.  Values are bit-identical
    to per-step drawing.  Shared by the fully-jitted forward scan and the
    host-chunked segment driver so the two streamed forward bodies cannot
    diverge (the backward pass shares _process_backward_segment for the
    same reason)."""
    z_xs, get_z = _stream_scan_draws(stream, seg["t_idx"], antithetic)

    def streamed_body(c, one):
        z_or_t, x = one
        inventory, pv, x_state = c
        z = get_z(z_or_t, x["t_idx"])
        x_new = spot_sim_mod.ou_step(x_state, z, x["sim_decay"], x["sim_chol"])
        x = dict(x)
        x["spot"] = spot_sim_mod.spot_from_state(
            x_new, x["sim_fwd"], x["sim_hv"], x["sim_vols"]
        )
        x["factors"] = x_new  # [F, S] state layout
        (new_inventory, new_pv), outputs = body((inventory, pv), x)
        return (new_inventory, new_pv, x_new), outputs

    return jax.lax.scan(streamed_body, carry, (z_xs, seg))


def lsmc_forward_streamed(
    arrays: tp.Dict[str, jnp.ndarray],
    stream: StreamedSims,
    regression: tp.Dict[str, jnp.ndarray],
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str],
    antithetic: bool = False,
    remat: bool = False,
    seg_len: int = 16,
):
    """Forward simulation with in-scan path regeneration: the scan carries the
    OU factor state and prices each step on the fly, so no [N, S] valuation
    panels exist.  Bit-identical to ``lsmc_forward`` fed ``simulate_ou_paths``
    output.  Per-sim panels are unavailable by construction
    (``return_sim_data`` is materialised-only).  ``remat`` chunks the scan
    into ``seg_len``-step segments wrapped in ``jax.checkpoint`` (AD tape
    bounded by segment-boundary carries)."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    dtype = grids.dtype
    s_local = stream.path_ids.shape[0]
    f = stream.decay.shape[1]

    per_step = _forward_per_step(arrays, regression)
    per_step.update(_stream_step_arrays(stream, n))

    body = _forward_body(
        monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
        axis_name, False, dtype,
    )

    def seg_scan_plain(carry, seg_xs):
        return _stream_forward_segment_scan(stream, carry, seg_xs, body, antithetic)

    inv0 = jnp.full((s_local,), jnp.asarray(starting_inventory, dtype))
    pv0 = jnp.zeros((s_local,), dtype)
    x0 = jnp.zeros((f, s_local), dtype)
    seg = max(1, min(seg_len, n))
    m, r = n // seg, n % seg
    seg_scan = (
        jax.checkpoint(seg_scan_plain, prevent_cse=False) if remat
        else seg_scan_plain
    )
    full = jax.tree.map(
        lambda a: a[: m * seg].reshape((m, seg) + a.shape[1:]), per_step
    )
    ragged = jax.tree.map(lambda a: a[m * seg :], per_step)
    carry = (inv0, pv0, x0)
    ys_full = None
    if m > 0:
        carry, ys_full = jax.lax.scan(seg_scan, carry, full)
        ys_full = jax.tree.map(
            lambda a: a.reshape((m * seg,) + a.shape[2:]), ys_full
        )
    ys_ragged = None
    if r > 0:
        carry, ys_ragged = seg_scan(carry, ragged)
    if ys_full is None:
        outputs = ys_ragged
    elif ys_ragged is None:
        outputs = ys_full
    else:
        outputs = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), ys_full, ys_ragged
        )
    final_inventory, pv_by_sim, x_last = carry
    _, spot_end = _stream_terminal_state(stream, x_last, n, antithetic)
    return _forward_finalise(
        outputs, final_inventory, pv_by_sim, spot_end, terminal_fn,
        axis_name, False, s_local, dtype,
    )


@partial(
    jax.jit,
    static_argnames=(
        "monomials",
        "num_extra_decisions",
        "discount_deltas",
        "terminal_fn",
        "ratchet_is_step",
        "axis_name",
        "return_sim_data",
        "use_pallas",
        "return_regression",
        "uniform_grids",
    ),
)
def lsmc_core(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_reg: jnp.ndarray,
    factors_reg: jnp.ndarray,
    spot_val: jnp.ndarray,
    factors_val: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str] = None,
    return_sim_data: bool = False,
    use_pallas: bool = False,
    return_regression: bool = False,
    uniform_grids: bool = True,
) -> tp.Dict[str, jnp.ndarray]:
    use_pallas = _kernel_eligible(use_pallas, monomials, uniform_grids)
    v0, regression = lsmc_backward(
        arrays, spot_reg, factors_reg, monomials, num_extra_decisions, terminal_fn,
        ratchet_is_step, axis_name, use_pallas=use_pallas,
        uniform_grids=uniform_grids,
    )
    result = lsmc_forward(
        arrays, spot_val, factors_val, regression, starting_inventory, monomials,
        num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step, axis_name,
        return_sim_data, uniform_grids=uniform_grids,
    )
    # Backward (upper-ish) estimate: mean over sims of the first-period values at
    # the known starting inventory (grid[0] is degenerate) — LsmcStorageValuation.cs:623.
    result["backward_npv"] = _global_mean_over_sims(v0[0], axis_name)
    if return_regression:
        # Per-step regression payload (the backward->forward hand-off the
        # reference keeps in regressCoeffsBuilder, LsmcStorageValuation.cs:159)
        # — identical on every path shard after the moments psum, so it is a
        # replicated output; used to persist RegressionCheckpoints.
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result


@partial(
    jax.jit,
    static_argnames=(
        "monomials",
        "num_extra_decisions",
        "discount_deltas",
        "terminal_fn",
        "ratchet_is_step",
        "axis_name",
        "use_pallas",
        "return_regression",
        "seg_len",
        "antithetic",
        "same_sims",
    ),
)
def lsmc_core_streamed(
    arrays: tp.Dict[str, jnp.ndarray],
    sim_inputs: tp.Dict[str, jnp.ndarray],  # decay/chol/vols/half_var/fwd [N+1,...]
    reg_key: jax.Array,
    val_key: jax.Array,
    path_ids: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str] = None,
    use_pallas: bool = False,
    return_regression: bool = False,
    seg_len: int = 16,
    antithetic: bool = False,
    same_sims: bool = False,
) -> tp.Dict[str, jnp.ndarray]:
    """Full LSMC valuation with in-scan path regeneration: the only [·, S]
    array alive across steps is the value panel [G, S] — no spot/factor
    panels.
    Dual-sim estimator as in ``lsmc_core``: ``reg_key`` drives the backward
    regression sims, ``val_key`` the independent forward valuation sims
    (``same_sims`` reuses the regression stream)."""
    use_pallas = _kernel_eligible(use_pallas, monomials)
    reg_stream = StreamedSims(
        decay=sim_inputs["decay"], chol=sim_inputs["chol"],
        vols=sim_inputs["vols"], half_var=sim_inputs["half_var"],
        fwd=sim_inputs["fwd"], key=reg_key, path_ids=path_ids,
    )
    val_stream = reg_stream._replace(key=reg_key if same_sims else val_key)
    v0, regression = lsmc_backward_streamed(
        arrays, reg_stream, monomials, num_extra_decisions, terminal_fn,
        ratchet_is_step, axis_name, use_pallas=use_pallas, seg_len=seg_len,
        antithetic=antithetic,
    )
    result = lsmc_forward_streamed(
        arrays, val_stream, regression, starting_inventory, monomials,
        num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        axis_name, antithetic=antithetic,
    )
    result["backward_npv"] = _global_mean_over_sims(v0[0], axis_name)
    if return_regression:
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result


@partial(
    jax.jit,
    static_argnames=(
        "monomials", "num_extra_decisions", "discount_deltas", "terminal_fn",
        "ratchet_is_step", "axis_name", "use_pallas", "uniform_grids",
    ),
)
def lsmc_npv_and_ad_deltas(
    arrays: tp.Dict[str, jnp.ndarray],
    stoch_reg: jnp.ndarray,  # [N+1, S] spot / forward (stochastic part)
    factors_reg: jnp.ndarray,
    stoch_val: jnp.ndarray,
    factors_val: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str] = None,
    use_pallas: bool = False,
    uniform_grids: bool = True,
):
    """NPV and deltas by automatic differentiation through the valuation.

    The pathwise assumption of the reference (spot = forward x stochastic
    factor, LsmcStorageValuation.cs:514-517) is made explicit: the simulated
    spot is reconstructed as ``fwd[t] * stoch[t]`` inside the differentiated
    graph, and d(NPV)/d(fwd) is one reverse-mode sweep.  The bang-bang argmax
    policy is almost-everywhere constant, so AD yields the envelope-theorem
    gradient — under this model it reduces EXACTLY to the reference's
    hand-derived pathwise formula (pinned by tests/test_ad_deltas_api.py);
    its value is generality: the sweep stays exact for price models where
    spot is not forward-proportional and for terminal-value structures the
    hand formula ignores.  Returns (npv, deltas [N+1]) with deltas
    undiscounted unless ``discount_deltas`` (delta scaling mirrors the
    pathwise series: last entry 0).

    Structure mirrors the streamed variant: the BACKWARD pass runs outside
    ``value_and_grad`` (its regression payload only reaches the NPV through
    the gradient-dead argmax, so it is ``stop_gradient``-ed) — which both
    shrinks the tape and lets it use the Pallas decision kernel.
    """
    use_pallas = _kernel_eligible(use_pallas, monomials, uniform_grids)
    fwd = arrays["fwd"]
    spot_reg = fwd[:, None] * stoch_reg
    v0, regression = lsmc_backward(
        arrays, spot_reg, factors_reg, monomials, num_extra_decisions,
        terminal_fn, ratchet_is_step, axis_name, use_pallas=use_pallas,
        uniform_grids=uniform_grids,
    )
    regression = jax.tree.map(jax.lax.stop_gradient, regression)
    # The differentiated forward runs COLLECTIVE-FREE per shard and the
    # value/gradient are pmean'd explicitly: differentiating through
    # psum/pmean under shard_map has an ill-defined transpose (the streamed
    # variant documents the shard-count-dependent gradients an earlier
    # version produced).  Equal shard sizes make the explicit means exact.
    npv_local, grad_local = _forward_value_and_grad(
        arrays, regression, stoch_val, factors_val, starting_inventory,
        monomials, num_extra_decisions, terminal_fn, ratchet_is_step,
        None, uniform_grids=uniform_grids,
    )
    npv = _pmean(npv_local, axis_name)
    grad_fwd = _pmean(grad_local, axis_name)
    return _undiscount_deltas(arrays, npv, grad_fwd, discount_deltas)


def _forward_value_and_grad(
    arrays, regression, stoch_val, factors_val, starting_inventory, monomials,
    num_extra_decisions, terminal_fn, ratchet_is_step, axis_name,
    uniform_grids: bool = True,
):
    """``(npv, d npv / d fwd)`` of the forward pass with a FIXED (already
    ``stop_gradient``-ed) regression payload: the shared adjoint core for
    the materialised, path-chunked, and mesh-sharded sweeps.  The general
    (non-uniform-grid) interpolation path is searchsorted + gather — fully
    differentiable, so ``uniform_grids=False`` composes."""
    fwd = arrays["fwd"]

    def npv_of_fwd(fwd_v):
        arr = dict(arrays)
        arr["fwd"] = fwd_v
        spot_val = fwd_v[:, None] * stoch_val
        result = lsmc_forward(
            arr, spot_val, factors_val, regression, starting_inventory,
            monomials, num_extra_decisions, False, terminal_fn,
            ratchet_is_step, axis_name, False, uniform_grids=uniform_grids,
        )
        return result["npv"]

    return jax.value_and_grad(npv_of_fwd)(fwd)


def _undiscount_deltas(arrays, npv, grad_fwd, discount_deltas: bool):
    if discount_deltas:
        # value_and_grad discounts to the valuation date already.
        return npv, grad_fwd
    # The reference's DiscountDeltas=False divides the discount back out.
    fwd = arrays["fwd"]
    df = jnp.concatenate([arrays["df_settle"], jnp.ones((1,), fwd.dtype)])
    return npv, grad_fwd / df


@partial(
    jax.jit,
    static_argnames=(
        "monomials", "num_extra_decisions", "terminal_fn", "ratchet_is_step",
        "uniform_grids",
    ),
)
def _forward_ad_chunk_jit(
    arrays, regression, spot_val_chunk, factors_val_chunk, starting_inventory,
    monomials, num_extra_decisions, terminal_fn, ratchet_is_step,
    uniform_grids: bool = True,
):
    """One path chunk of the host-fed adjoint sweep: reconstruct the
    stochastic part, differentiate the forward pass, return the chunk's
    (npv, grad) pair."""
    stoch_val = spot_val_chunk / arrays["fwd"][:, None]
    return _forward_value_and_grad(
        arrays, regression, stoch_val, factors_val_chunk, starting_inventory,
        monomials, num_extra_decisions, terminal_fn, ratchet_is_step,
        None, uniform_grids=uniform_grids,
    )


def lsmc_ad_deltas_path_chunked(
    arrays: tp.Dict[str, jnp.ndarray],
    regression: tp.Dict[str, np.ndarray],  # mean/std/coeffs from the backward
    spot_val: np.ndarray,      # [N+1, S] HOST numpy valuation spot panel
    factors_val: np.ndarray,   # [N+1, F, S] HOST numpy
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    uniform_grids: bool = True,
    chunk_sims: int = 65536,
):
    """Adjoint deltas over HOST-RESIDENT user panels too large for device
    memory (the ``value_from_sims`` host-streamed scale): the NPV is a mean
    over sims and the regression payload is fixed, so the gradient decomposes
    over path chunks — run ``value_and_grad`` of the forward pass per
    device-sized chunk fed from numpy, and average.  Memory is bounded by one
    chunk's panels plus its AD tape; results are identical (f-dtype mean
    associativity aside) to the materialised sweep.  Completes the adjoint
    matrix for host-streamed panels."""
    n_total = spot_val.shape[1]
    dtype = arrays["grids"].dtype
    inv0 = jnp.asarray(starting_inventory, dtype)
    regression = {k: jnp.asarray(v) for k, v in regression.items()}
    npv_sum = None
    grad_sum = None
    done = 0
    while done < n_total:
        take = min(chunk_sims, n_total - done)
        spot_c = jnp.asarray(spot_val[:, done : done + take], dtype)
        fac_c = jnp.asarray(factors_val[:, :, done : done + take], dtype)
        npv_c, grad_c = _forward_ad_chunk_jit(
            arrays, regression, spot_c, fac_c, inv0, monomials,
            num_extra_decisions, terminal_fn, ratchet_is_step,
            uniform_grids=uniform_grids,
        )
        w = float(take)
        npv_sum = npv_c * w if npv_sum is None else npv_sum + npv_c * w
        grad_sum = grad_c * w if grad_sum is None else grad_sum + grad_c * w
        done += take
    npv = npv_sum / n_total
    grad_fwd = grad_sum / n_total
    return _undiscount_deltas(arrays, npv, grad_fwd, discount_deltas)


@partial(
    jax.jit,
    static_argnames=(
        "monomials", "num_extra_decisions", "discount_deltas", "terminal_fn",
        "ratchet_is_step", "axis_name", "seg_len", "antithetic", "same_sims",
        "use_pallas",
    ),
)
def lsmc_npv_and_ad_deltas_streamed(
    arrays: tp.Dict[str, jnp.ndarray],
    sim_inputs: tp.Dict[str, jnp.ndarray],
    reg_key: jax.Array,
    val_key: jax.Array,
    path_ids: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    axis_name: tp.Optional[str] = None,
    seg_len: int = 16,
    antithetic: bool = False,
    same_sims: bool = False,
    use_pallas: bool = False,
):
    """Adjoint deltas with streamed sims and segment rematerialisation
    (the sharded, memory-bounded adjoint sweep).

    Structure: the BACKWARD pass runs un-differentiated with globally psum'd
    moments (the policy is exactly gradient-dead: the forward NPV depends on
    the regression payload only through the discrete argmax, so AD through it
    contributes zero a.e. — the envelope argument the materialised
    ``lsmc_npv_and_ad_deltas`` relies on implicitly).  ``value_and_grad``
    then runs over the FORWARD pass only, per shard with no collectives in
    the differentiated graph (``axis_name=None``, regression payload
    ``stop_gradient``-ed), and value/gradient are pmean'd explicitly — this
    sidesteps the ill-defined transpose of collectives under ``shard_map``
    (an earlier version differentiated through psums and produced
    shard-count-dependent gradients).  The forward curve enters the graph as
    the simulation curve (spot_t = fwd_t·exp(x·σ − ½V), so d spot/d fwd =
    spot/fwd exactly — the reference's pathwise assumption,
    LsmcStorageValuation.cs:514-517, holds by construction).  Segment
    ``jax.checkpoint`` bounds the AD tape to segment-boundary carries.  The
    backward pass may use the Pallas decision kernel (no gradient flows
    through it)."""
    use_pallas = _kernel_eligible(use_pallas, monomials)
    inv0 = jnp.asarray(starting_inventory, arrays["grids"].dtype)
    fwd = sim_inputs["fwd"]

    reg_stream = StreamedSims(
        decay=sim_inputs["decay"], chol=sim_inputs["chol"],
        vols=sim_inputs["vols"], half_var=sim_inputs["half_var"],
        fwd=fwd, key=reg_key, path_ids=path_ids,
    )
    val_stream = reg_stream._replace(key=reg_key if same_sims else val_key)
    # The backward pass sits OUTSIDE value_and_grad (its payload is
    # stop_gradient-ed below), so it may run the Pallas decision kernel and
    # prices with the same body as the pricing run.
    _v0, regression = lsmc_backward_streamed(
        arrays, reg_stream, monomials, num_extra_decisions, terminal_fn,
        ratchet_is_step, axis_name, use_pallas=use_pallas, seg_len=seg_len,
        antithetic=antithetic,
    )
    regression = jax.tree.map(jax.lax.stop_gradient, regression)

    def local_npv(fwd_v):
        arr = dict(arrays)
        arr["fwd"] = fwd_v
        result = lsmc_forward_streamed(
            arr, val_stream._replace(fwd=fwd_v), regression, inv0, monomials,
            num_extra_decisions, False, terminal_fn, ratchet_is_step,
            axis_name=None, antithetic=antithetic, remat=True, seg_len=seg_len,
        )
        return result["npv"]  # this shard's local mean PV

    npv_local, grad_local = jax.value_and_grad(local_npv)(fwd)
    # Equal shard sizes (enforced by the mesh wrapper): global mean PV and
    # its gradient are the plain across-shard means.
    npv = _pmean(npv_local, axis_name)
    grad_fwd = _pmean(grad_local, axis_name)
    return _undiscount_deltas(arrays, npv, grad_fwd, discount_deltas)


def build_engine_arrays(
    compiled: CompiledStorage,
    fwd: np.ndarray,
    df_settle: np.ndarray,
    df_flow: np.ndarray,
    inventory_lower: np.ndarray,
    inventory_upper: np.ndarray,
    num_grid_points: int,
    dtype,
    grid_calc=None,
) -> tp.Dict[str, jnp.ndarray]:
    if grid_calc is not None:
        # User per-period grids (IDoubleStateSpaceGridCalc.cs:32 analog).
        grids = gridmod.inventory_grids_custom(
            inventory_lower, inventory_upper, grid_calc
        )
    else:
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
    return {
        "grids": jnp.asarray(grids, dtype),
        "fwd": jnp.asarray(fwd, dtype),
        "lower": jnp.asarray(inventory_lower, dtype),
        "upper": jnp.asarray(inventory_upper, dtype),
        "df_settle": jnp.asarray(df_settle, dtype),
        "df_flow": jnp.asarray(df_flow, dtype),
        "inj_cost": jnp.asarray(compiled.inj_cost, dtype),
        "wdr_cost": jnp.asarray(compiled.wdr_cost, dtype),
        "inj_pcnt": jnp.asarray(compiled.inj_consumed_pcnt, dtype),
        "wdr_pcnt": jnp.asarray(compiled.wdr_consumed_pcnt, dtype),
        "loss_pcnt": jnp.asarray(compiled.loss_pcnt, dtype),
        "inv_cost_rate": jnp.asarray(compiled.inv_cost_rate, dtype),
        "ratchet_inv": jnp.asarray(compiled.ratchet_inv, dtype),
        "ratchet_min": jnp.asarray(compiled.ratchet_min, dtype),
        "ratchet_max": jnp.asarray(compiled.ratchet_max, dtype),
    }


# ---------------------------------------------------- host-chunked execution
#
# Reference-granularity progress + cancellation (LsmcStorageValuation.cs
# :343-345,521 polls once per period; a compiled scan cannot call the host).
# The streamed engine's segment structure makes a host-driven variant cheap:
# the backward/forward scans execute segment-by-segment from Python, with the
# host invoking a callback between segments — progress every ``seg_len``
# steps and cooperative cancellation with bounded latency, at the cost of one
# dispatch per segment (~23 dispatches for the daily benchmark; no measurable
# slowdown, pinned by tests/test_progress_cancellation.py).


@partial(jax.jit, static_argnames=("seg_len", "antithetic"))
def _stream_warmup_jit(stream: StreamedSims, seg_len: int, antithetic: bool):
    n = stream.decay.shape[0] - 1
    seg_len = max(1, min(seg_len, n))
    return _stream_warmup(stream, n, seg_len, antithetic)


@partial(jax.jit, static_argnames=("terminal_fn", "antithetic"))
def _backward_init_streamed_jit(
    arrays, stream: StreamedSims, x_last, *, terminal_fn, antithetic,
):
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    s = stream.path_ids.shape[0]
    _, spot_end = _stream_terminal_state(stream, x_last, n, antithetic)
    return _terminal_values(
        terminal_fn, spot_end, grids[n], grids.shape[1], s, grids.dtype
    )


_BWD_SEG_STATICS = (
    "monomials", "num_extra_decisions", "axis_name", "use_pallas", "antithetic",
)


@partial(jax.jit, static_argnames=_BWD_SEG_STATICS)
def _backward_segment_chunk_jit(
    stream: StreamedSims, carry, entry_state, seg,
    *, monomials, num_extra_decisions, axis_name, use_pallas, antithetic,
):
    body = _backward_body(monomials, num_extra_decisions, axis_name, use_pallas)
    return _process_backward_segment(
        stream, carry, entry_state, seg, body, antithetic,
    )


_FWD_SEG_STATICS = (
    "monomials", "num_extra_decisions", "discount_deltas", "ratchet_is_step",
    "axis_name", "antithetic",
)


@partial(jax.jit, static_argnames=_FWD_SEG_STATICS)
def _forward_segment_chunk_jit(
    stream: StreamedSims, carry, seg,
    *, monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
    axis_name, antithetic,
):
    body = _forward_body(
        monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
        axis_name, False, carry[0].dtype,
    )
    return _stream_forward_segment_scan(stream, carry, seg, body, antithetic)


# ------------------- multi-device host-chunked execution
#
# The host-chunked drivers dispatch one jitted call per seg_len-step segment.
# On a multi-device host each segment call is wrapped in a shard_map over the
# local 1-D path mesh: carries with a trailing sim axis stay device-sharded
# between segments, per-step parameters are replicated, and the engine bodies
# run with axis_name = the mesh axis so the regression reductions psum exactly
# as in the non-chunked sharded path.

_MESH_AXIS = "paths"  # == parallel.mesh.AXIS (literal: avoids a module cycle)


class _ChunkedMeshCalls:
    """shard_map-per-segment wrappers for the host-chunked drivers."""

    def __init__(self, mesh):
        from jax.sharding import PartitionSpec

        self.mesh = mesh
        self.P = PartitionSpec
        ax = _MESH_AXIS
        self.stream_spec = StreamedSims(
            decay=self.P(), chol=self.P(), vols=self.P(), half_var=self.P(),
            fwd=self.P(), key=self.P(), path_ids=self.P(ax),
        )
        self.row_spec = self.P(ax)          # [S]
        self.state_spec = self.P(None, ax)  # [F, S] / [G, S]

    def _map(self, fn, in_specs, out_specs):
        return jax.shard_map(
            fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )

    # ---- streamed driver -------------------------------------------------
    def warmup(self, stream, seg_len, antithetic):
        P, ax = self.P, _MESH_AXIS
        fn = lambda st: _stream_warmup_jit(st, seg_len, antithetic)
        return self._map(
            fn, (self.stream_spec,),
            (P(None, None, ax), self.state_spec, self.state_spec),
        )(stream)

    def init_streamed(self, arrays, stream, x_last, **statics):
        fn = lambda arr, st, xl: _backward_init_streamed_jit(arr, st, xl, **statics)
        return self._map(
            fn, (self.P(), self.stream_spec, self.state_spec), self.state_spec
        )(arrays, stream, x_last)

    def bwd_seg_streamed(self, stream, carry, entry, seg, **statics):
        fn = lambda st, c, e, sg: _backward_segment_chunk_jit(st, c, e, sg, **statics)
        return self._map(
            fn,
            (self.stream_spec, self.state_spec, self.state_spec, self.P()),
            (self.state_spec, self.P()),
        )(stream, carry, entry, seg)

    def fwd_seg_streamed(self, stream, carry, seg, **statics):
        fwd_carry_spec = (self.row_spec, self.row_spec, self.state_spec)
        fn = lambda st, c, sg: _forward_segment_chunk_jit(st, c, sg, **statics)
        return self._map(
            fn, (self.stream_spec, fwd_carry_spec, self.P()),
            (fwd_carry_spec, self.P()),
        )(stream, carry, seg)

    # ---- materialised driver ---------------------------------------------
    def _mat_seg_spec(self, seg):
        P, ax = self.P, _MESH_AXIS
        return {
            k: (
                P(None, ax) if k == "spot"
                else P(None, None, ax) if k == "factors"
                else P()
            )
            for k in seg
        }

    def bwd_seg_mat(self, carry, seg, **statics):
        fn = lambda c, sg: _backward_segment_chunk_mat_jit(c, sg, **statics)
        return self._map(
            fn, (self.state_spec, self._mat_seg_spec(seg)),
            (self.state_spec, self.P()),
        )(carry, seg)

    def fwd_seg_mat(self, carry, seg, **statics):
        P, ax = self.P, _MESH_AXIS
        fwd_carry_spec = (self.row_spec, self.row_spec)
        fn = lambda c, sg: _forward_segment_chunk_mat_jit(c, sg, **statics)
        # Per-sim panel outputs (the optional "sim" subtree) keep their path
        # shard; every reduced output is replicated.  The output STRUCTURE is
        # axis-independent, so eval_shape runs with the collectives disabled
        # (tracing a psum outside shard_map would fail on the unbound axis).
        out_spec = getattr(self, "_fwd_mat_out_spec", None)
        if out_spec is None:
            shape_statics = dict(statics, axis_name=None)
            out_shape = jax.eval_shape(
                lambda c, sg: _forward_segment_chunk_mat_jit(c, sg, **shape_statics),
                carry, seg,
            )[1]
            out_spec = {
                k: (P(None, ax) if k == "sim" else P()) for k in out_shape
            }
            self._fwd_mat_out_spec = out_spec
        return self._map(
            fn, (fwd_carry_spec, self._mat_seg_spec(seg)),
            (fwd_carry_spec, out_spec),
        )(carry, seg)


def _resolve_chunked_mesh(mesh, num_sims: int):
    """A usable per-segment mesh: multi-device, paths divide the mesh, and
    single-process (the chunked drivers dispatch from one host)."""
    if (
        mesh is None
        or mesh.devices.size <= 1
        or num_sims % mesh.devices.size != 0
        or jax.process_count() > 1
    ):
        return None
    return mesh


def lsmc_core_streamed_chunked(
    arrays: tp.Dict[str, jnp.ndarray],
    sim_inputs: tp.Dict[str, jnp.ndarray],
    reg_key: jax.Array,
    val_key: jax.Array,
    path_ids: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    use_pallas: bool = False,
    seg_len: int = 16,
    antithetic: bool = False,
    same_sims: bool = False,
    return_regression: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    mesh=None,
) -> tp.Dict[str, jnp.ndarray]:
    """``lsmc_core_streamed`` with host-driven segments: identical numbers
    (same RNG stream, same segment regeneration, same bodies — pinned by
    tests/test_progress_cancellation.py), plus ``segment_cb(phase, done,
    total)`` fired after every ``seg_len``-step segment of the backward and
    forward passes.  Raising from the callback aborts the valuation between
    segments (cooperative cancellation with ≤ seg_len steps of latency).
    Single-process; with a multi-device ``mesh`` every segment runs
    shard_map'd over the local path mesh (see _ChunkedMeshCalls)."""
    use_pallas = _kernel_eligible(use_pallas, monomials)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    seg_len = max(1, min(seg_len, n))
    m, r = n // seg_len, n % seg_len
    total = m + (1 if r else 0)
    dtype = grids.dtype
    s_local = path_ids.shape[0]
    mesh = _resolve_chunked_mesh(mesh, s_local)
    mcalls = _ChunkedMeshCalls(mesh) if mesh is not None else None
    eff_axis = _MESH_AXIS if mcalls is not None else None

    reg_stream = StreamedSims(
        decay=sim_inputs["decay"], chol=sim_inputs["chol"],
        vols=sim_inputs["vols"], half_var=sim_inputs["half_var"],
        fwd=sim_inputs["fwd"], key=reg_key, path_ids=path_ids,
    )
    val_stream = reg_stream._replace(key=reg_key if same_sims else val_key)

    def tick(phase, done):
        if segment_cb is not None:
            segment_cb(phase, done, total)

    # ---- backward, latest segment first.
    init_statics = dict(terminal_fn=terminal_fn, antithetic=antithetic)
    if mcalls is not None:
        checkpoints, ragged_entry, x_last = mcalls.warmup(
            reg_stream, seg_len, antithetic
        )
        carry = mcalls.init_streamed(arrays, reg_stream, x_last, **init_statics)
    else:
        checkpoints, ragged_entry, x_last = _stream_warmup_jit(
            reg_stream, seg_len, antithetic
        )
        carry = _backward_init_streamed_jit(
            arrays, reg_stream, x_last, **init_statics
        )
    per_step = _backward_per_step(arrays)
    per_step.update(_backward_prep_all(
        per_step, num_extra_decisions, ratchet_is_step,
    ))
    per_step.update(_stream_step_arrays(reg_stream, n))
    statics = dict(
        monomials=monomials, num_extra_decisions=num_extra_decisions,
        axis_name=eff_axis, use_pallas=use_pallas, antithetic=antithetic,
    )
    bwd_call = (
        mcalls.bwd_seg_streamed if mcalls is not None
        else _backward_segment_chunk_jit
    )
    reg_chunks: tp.List[tp.Any] = [None] * total
    done = 0
    if r > 0:
        seg = jax.tree.map(lambda a: a[m * seg_len :], per_step)
        carry, reg_chunks[total - 1] = bwd_call(
            reg_stream, carry, ragged_entry, seg, **statics
        )
        done += 1
        tick("backward", done)
    for i in reversed(range(m)):
        seg = jax.tree.map(lambda a: a[i * seg_len : (i + 1) * seg_len], per_step)
        carry, reg_chunks[i] = bwd_call(
            reg_stream, carry, checkpoints[i], seg, **statics
        )
        done += 1
        tick("backward", done)
    regression = jax.tree.map(
        lambda *chunks: jnp.concatenate(chunks, axis=0), *reg_chunks
    )
    v0 = carry

    # ---- forward, segments in time order.
    fper = _forward_per_step(arrays, regression)
    fper.update(_stream_step_arrays(val_stream, n))
    fstatics = dict(
        monomials=monomials, num_extra_decisions=num_extra_decisions,
        discount_deltas=discount_deltas, ratchet_is_step=ratchet_is_step,
        axis_name=eff_axis, antithetic=antithetic,
    )
    fwd_call = (
        mcalls.fwd_seg_streamed if mcalls is not None
        else _forward_segment_chunk_jit
    )
    inv0 = jnp.full((s_local,), jnp.asarray(starting_inventory, dtype))
    fcarry = (inv0, jnp.zeros((s_local,), dtype),
              jnp.zeros((sim_inputs["decay"].shape[1], s_local), dtype))
    out_chunks = []
    done = 0
    for i in range(m):
        seg = jax.tree.map(lambda a: a[i * seg_len : (i + 1) * seg_len], fper)
        fcarry, outs = fwd_call(val_stream, fcarry, seg, **fstatics)
        out_chunks.append(outs)
        done += 1
        tick("forward", done)
    if r > 0:
        seg = jax.tree.map(lambda a: a[m * seg_len :], fper)
        fcarry, outs = fwd_call(val_stream, fcarry, seg, **fstatics)
        out_chunks.append(outs)
        done += 1
        tick("forward", done)
    outputs = jax.tree.map(
        lambda *chunks: jnp.concatenate(chunks, axis=0), *out_chunks
    )
    final_inventory, pv_by_sim, x_last_f = fcarry
    _, spot_end = _stream_terminal_state(val_stream, x_last_f, n, antithetic)
    result = _forward_finalise(
        outputs, final_inventory, pv_by_sim, spot_end, terminal_fn,
        None, False, s_local, dtype,
    )
    result["backward_npv"] = _global_mean_over_sims(v0[0], None)
    if return_regression:
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result


# ------------------------------ host-chunked execution, materialised panels
#
# The segment drivers above cover streamed (internally simulated) runs; a
# ``value_from_sims`` call — or any materialised valuation — with a progress
# callback runs the SAME scan bodies over host-sliced panel segments, so it
# is polled every segment and cancellable mid-pass like the reference (which
# polls every period on every path, LsmcStorageValuation.cs:343-345,521).
# Results are identical to ``lsmc_core`` (same per-step arithmetic; scan
# partitioning does not change it — pinned by
# tests/test_progress_cancellation.py).


_BWD_MAT_STATICS = ("monomials", "num_extra_decisions", "axis_name", "use_pallas")


@partial(jax.jit, static_argnames=_BWD_MAT_STATICS)
def _backward_segment_chunk_mat_jit(
    carry, seg, *, monomials, num_extra_decisions, axis_name, use_pallas,
):
    body = _backward_body(monomials, num_extra_decisions, axis_name, use_pallas)
    return jax.lax.scan(body, carry, seg, reverse=True)


@partial(
    jax.jit,
    static_argnames=(
        "monomials", "num_extra_decisions", "discount_deltas",
        "ratchet_is_step", "axis_name", "return_sim_data", "uniform_grids",
    ),
)
def _forward_segment_chunk_mat_jit(
    carry, seg,
    *, monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
    axis_name, return_sim_data, uniform_grids=True,
):
    body = _forward_body(
        monomials, num_extra_decisions, discount_deltas, ratchet_is_step,
        axis_name, return_sim_data, carry[0].dtype, uniform_grids=uniform_grids,
    )
    return jax.lax.scan(body, carry, seg)


def lsmc_core_chunked(
    arrays: tp.Dict[str, jnp.ndarray],
    spot_reg: jnp.ndarray,    # [N+1, S]
    factors_reg: jnp.ndarray, # [N+1, F, S]
    spot_val: jnp.ndarray,
    factors_val: jnp.ndarray,
    starting_inventory,
    monomials: tp.Tuple[Monomial, ...],
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    use_pallas: bool = False,
    seg_len: int = 16,
    return_sim_data: bool = False,
    return_regression: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    mesh=None,
) -> tp.Dict[str, jnp.ndarray]:
    """``lsmc_core`` with host-driven segments over materialised panels
    (internally simulated with per-sim data requested, or user-supplied sims
    via ``value_from_sims``): ``segment_cb(phase, done, total)`` fires after
    every ``seg_len``-step segment of both passes, and raising from the
    callback aborts between segments.  Single-process; with a multi-device
    ``mesh`` every segment runs shard_map'd over the local path mesh (see
    _ChunkedMeshCalls)."""
    use_pallas = _kernel_eligible(use_pallas, monomials, uniform_grids)
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    seg_len = max(1, min(seg_len, n))
    m, r = n // seg_len, n % seg_len
    total = m + (1 if r else 0)
    dtype = grids.dtype
    s_local = spot_reg.shape[1]
    mesh = _resolve_chunked_mesh(mesh, s_local)
    mcalls = _ChunkedMeshCalls(mesh) if mesh is not None else None
    eff_axis = _MESH_AXIS if mcalls is not None else None

    def tick(phase, done):
        if segment_cb is not None:
            segment_cb(phase, done, total)

    statics = dict(
        monomials=monomials, num_extra_decisions=num_extra_decisions,
        axis_name=eff_axis, use_pallas=use_pallas,
    )
    carry = _terminal_values(
        terminal_fn, spot_reg[n], grids[n], grids.shape[1], s_local, dtype
    )
    per_step = _backward_per_step(arrays)
    per_step.update(_backward_prep_all(
        per_step, num_extra_decisions, ratchet_is_step, uniform_grids,
    ))
    per_step["spot"] = spot_reg[:n]
    per_step["factors"] = factors_reg[:n]

    bwd_call = (
        mcalls.bwd_seg_mat if mcalls is not None
        else _backward_segment_chunk_mat_jit
    )
    reg_chunks: tp.List[tp.Any] = [None] * total
    done = 0
    bounds = [(m * seg_len, n)] if r > 0 else []
    bounds += [(i * seg_len, (i + 1) * seg_len) for i in reversed(range(m))]
    for lo, hi in bounds:
        seg = jax.tree.map(lambda a: a[lo:hi], per_step)
        carry, reg_chunks[lo // seg_len] = bwd_call(carry, seg, **statics)
        done += 1
        tick("backward", done)
    regression = jax.tree.map(
        lambda *chunks: jnp.concatenate(chunks, axis=0), *reg_chunks
    )
    v0 = carry

    fper = _forward_per_step(arrays, regression)
    fper["spot"] = spot_val[:n]
    fper["factors"] = factors_val[:n]
    fstatics = dict(
        monomials=monomials, num_extra_decisions=num_extra_decisions,
        discount_deltas=discount_deltas, ratchet_is_step=ratchet_is_step,
        axis_name=eff_axis, return_sim_data=return_sim_data,
        uniform_grids=uniform_grids,
    )
    fwd_call = (
        mcalls.fwd_seg_mat if mcalls is not None
        else _forward_segment_chunk_mat_jit
    )
    inv0 = jnp.full((s_local,), jnp.asarray(starting_inventory, dtype))
    fcarry = (inv0, jnp.zeros((s_local,), dtype))
    out_chunks = []
    done = 0
    for i in range(m):
        seg = jax.tree.map(lambda a: a[i * seg_len : (i + 1) * seg_len], fper)
        fcarry, outs = fwd_call(fcarry, seg, **fstatics)
        out_chunks.append(outs)
        done += 1
        tick("forward", done)
    if r > 0:
        seg = jax.tree.map(lambda a: a[m * seg_len :], fper)
        fcarry, outs = fwd_call(fcarry, seg, **fstatics)
        out_chunks.append(outs)
        done += 1
        tick("forward", done)
    outputs = jax.tree.map(
        lambda *chunks: jnp.concatenate(chunks, axis=0), *out_chunks
    )
    final_inventory, pv_by_sim = fcarry
    result = _forward_finalise(
        outputs, final_inventory, pv_by_sim, spot_val[n], terminal_fn,
        None, return_sim_data, s_local, dtype,
    )
    result["backward_npv"] = _global_mean_over_sims(v0[0], None)
    if return_regression:
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result
