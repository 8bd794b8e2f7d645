"""Pallas (Triton) kernel for the LSMC backward decision update.

The backward step's hot loop (reference ``LsmcStorageValuation.cs:240-338``)
evaluates, for every (inventory grid point g, decision d, simulation s):

    val_reg[g,d,s] = immediate_pv[g,d](spot[s]) + regressed_continuation[g,d,s]
    val_act[g,d,s] = immediate_pv[g,d](spot[s]) + actual_continuation[g,d,s]
    best_act[g,s]  = val_act[g, argmax_d val_reg[g,d,s], s]

The XLA body (``engines/lsmc.decision_update_xla``) writes the regressed continuations
``pred`` [G, D, S] to device memory through a K = B matmul, reads them back
and gathers rows of the [G, S] value panel 2·D times.  This kernel does the
whole update for one (grid-row tile x sim tile) block in registers:

* the regressed continuation is B FMAs per element against the block's
  design-matrix rows (K ≈ 9 is far too small for tensor cores);
* the actual continuation gathers rows ``lo`` and ``lo + 1`` of the value
  panel by pointer — for a tile of adjacent grid rows they are adjacent
  panel rows, so most of them come from L2;
* a running argmax on regressed values realises the actual value, first
  decision winning ties (LsmcStorageValuation.cs:310-336), exactly as the
  XLA body does;
* ``best_act`` is written once; no [G, D, S] temporary exists.

Blocks read panel rows that other blocks write, so the output is a fresh
buffer (no input/output aliasing).  Grid rows are the fast grid axis so the
blocks of one sim tile run together and share their panel rows in L2.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NUM_WARPS = 4


def block_shape(num_decisions: int):
    """(grid-row block, sim block), powers of two as Triton requires.  From a
    sweep on an H100 at G = 100, S = 262,144 (PERF.md): (8 x 128) ran fastest
    with three decisions, (4 x 256) with five."""
    return (8, 128) if num_decisions <= 3 else (4, 256)


_state = threading.local()


@contextlib.contextmanager
def interpret_mode():
    """Run the kernel through the Pallas interpreter (tests on the CPU).

    The flag is read while an engine is traced and is no part of any jit
    cache key, so the caches are cleared on the way in and out: no trace
    made in one mode is served to a call in the other."""
    prev = getattr(_state, "interpret", False)
    if not prev:
        jax.clear_caches()
    _state.interpret = True
    try:
        yield
    finally:
        _state.interpret = prev
        if not prev:
            jax.clear_caches()


def interpreting() -> bool:
    return getattr(_state, "interpret", False)


def available() -> bool:
    """Whether the kernel can run here: compiled on a GPU, or interpreted."""
    return interpreting() or jax.default_backend() == "gpu"


def _kernel(v_ref, dm_ref, spot_ref, ci_ref, lo_ref, w_ref, a_ref, b_ref,
            out_ref, *, num_grid: int, num_sims: int, num_decisions: int,
            num_basis: int, block_g: int, block_s: int):
    g0 = pl.program_id(0) * block_g
    s0 = pl.program_id(1) * block_s
    gi = g0 + jnp.arange(block_g, dtype=jnp.int32)
    si = s0 + jnp.arange(block_s, dtype=jnp.int32)
    g_in = gi < num_grid
    s_in = si < num_sims
    gc = jnp.minimum(gi, num_grid - 1)  # rows past G repeat row G-1, unstored
    mask = g_in[:, None] & s_in[None, :]

    spot = plgpu.load(spot_ref.at[si], mask=s_in, other=0.0)  # [Ts]
    dm = [
        plgpu.load(dm_ref.at[k, si], mask=s_in, other=0.0)[None, :]
        for k in range(num_basis)
    ]

    best_reg = best_act = None
    for d in range(num_decisions):
        pred = ci_ref[d, 0, gc][:, None] * dm[0]
        for k in range(1, num_basis):
            pred = pred + ci_ref[d, k, gc][:, None] * dm[k]
        imm = a_ref[d, gc][:, None] * spot[None, :] + b_ref[d, gc][:, None]
        lo = lo_ref[d, gc][:, None]
        w = w_ref[d, gc][:, None]
        v_lo = plgpu.load(v_ref.at[lo, si[None, :]], mask=mask, other=0.0)
        v_hi = plgpu.load(v_ref.at[lo + 1, si[None, :]], mask=mask, other=0.0)
        val_reg = imm + pred
        val_act = imm + (v_lo * (1 - w) + v_hi * w)
        if d == 0:
            best_reg, best_act = val_reg, val_act
        else:
            better = val_reg > best_reg
            best_reg = jnp.where(better, val_reg, best_reg)
            best_act = jnp.where(better, val_act, best_act)
    plgpu.store(
        out_ref.at[pl.ds(g0, block_g), pl.ds(s0, block_s)], best_act, mask=mask
    )


def pallas_update(v_act_next, dm_std_t, spot, ci, idx_lo, w_hi, a, b, *,
                  interpret: bool, block: tuple[int, int]) -> jnp.ndarray:
    """The kernel call for an explicit (grid-row, sim) ``block``, unjitted;
    ``decision_update`` takes its block from ``block_shape``."""
    block_g, block_s = block
    g, num_decisions = idx_lo.shape
    num_basis, s = dm_std_t.shape
    dtype = v_act_next.dtype
    kernel = functools.partial(
        _kernel, num_grid=g, num_sims=s, num_decisions=num_decisions,
        num_basis=num_basis, block_g=block_g, block_s=block_s,
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((g, s), dtype),
        grid=(pl.cdiv(g, block_g), pl.cdiv(s, block_s)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="lsmc_decision_update",
    )(
        v_act_next,
        dm_std_t,
        spot,
        jnp.transpose(ci, (2, 0, 1)).astype(dtype),  # [D, B, G]
        idx_lo.T.astype(jnp.int32),
        w_hi.T.astype(dtype),
        a.T.astype(dtype),
        b.T.astype(dtype),
    )


@functools.partial(jax.jit, static_argnames=("interpret",))
def decision_update(
    v_act_next: jnp.ndarray,  # [G_next, S] next-period actual values
    dm_std_t: jnp.ndarray,    # [B, S] standardised design matrix
    spot: jnp.ndarray,        # [S]
    ci: jnp.ndarray,          # [B, G, D] coefficients at the target inventories
    idx_lo: jnp.ndarray,      # [G, D] lower next-grid index of each target
    w_hi: jnp.ndarray,        # [G, D] weight of row idx_lo + 1
    a: jnp.ndarray,           # [G, D] immediate-pv spot coefficient
    b: jnp.ndarray,           # [G, D] immediate-pv constant
    interpret: bool = False,
) -> jnp.ndarray:
    """``best_act`` [G, S]: the same values as the XLA body's decision loop."""
    return pallas_update(
        v_act_next, dm_std_t, spot, ci, idx_lo, w_hi, a, b,
        interpret=interpret, block=block_shape(idx_lo.shape[1]),
    )


def decision_update_auto(*args):
    """``decision_update`` compiled for the GPU, or interpreted when a test
    has asked for it with ``interpret_mode()``."""
    return decision_update(*args, interpret=interpreting())
