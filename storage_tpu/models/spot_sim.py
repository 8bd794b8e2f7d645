"""Exact-step multi-factor OU spot price simulation on device.

Replaces the reference's CPU Mersenne-Twister simulator
(``Cmdty.Core.Simulation.MultiFactor.MultiFactorSpotPriceSimulator``, consumed
at LsmcValuationParameters.cs:179-181) with a counter-based design: draws are
addressed by (base_key, global_path_id, step, factor), mapped entirely onto
the threefry COUNTER space — counter pair (path_id, step·blocks+j) under the
fixed base key (``step_normals``) — so simulations are bit-identical for any
shard count or device layout (the shard-invariance tests pin this), any
single step's draws regenerate in isolation (the streamed engine's
foundation), and bulk draws over all steps collapse into one hash call.
OU transitions use the exact discrete-step covariance (no Euler error),
precomputed on host in float64 (``multi_factor.simulation_precompute``).
"""
from __future__ import annotations

import typing as tp
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
# Binding the threefry primitive directly takes the (hi, lo) counter pair as
# two operands (private to JAX; present in the installed 0.9 line).
from jax._src.prng import threefry2x32_p as _threefry2x32_p

from . import multi_factor as mf
from ..utils import periods as pu


class SpotSimResults(tp.NamedTuple):
    """Device-side simulation output: analog of ``ISpotSimResults``
    (surface per SpotSimResultsFromPanels.cs:77-109)."""

    spot: jnp.ndarray  # [P, S]
    factors: jnp.ndarray  # [P, F, S]

    @property
    def num_sims(self) -> int:
        return self.spot.shape[1]

    @property
    def num_steps(self) -> int:
        return self.spot.shape[0]

    @property
    def num_factors(self) -> int:
        return self.factors.shape[1]


def _bits_to_normal(bits_hi, bits_lo, dtype):
    """uint32 random word(s) → standard normal via the inverse-CDF map
    √2·erfinv(u), u uniform on (−1, 1) — the same transform JAX's
    ``random.normal`` uses.  f32 consumes one word per draw, f64 two."""
    if jnp.dtype(dtype) == jnp.float64:
        v = bits_hi.astype(jnp.uint64) << 32 | bits_lo.astype(jnp.uint64)
        mantissa = v >> 12 | jnp.uint64(0x3FF0000000000000)
        x = jax.lax.bitcast_convert_type(mantissa, jnp.float64) - 1.0  # [0, 1)
        lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
    else:
        mantissa = bits_hi >> 9 | jnp.uint32(0x3F800000)
        x = jax.lax.bitcast_convert_type(mantissa, jnp.float32) - 1.0  # [0, 1)
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = jnp.maximum(x * 2.0 - 1.0, lo)  # (−1, 1), erfinv-safe
    return (np.sqrt(2.0) * jax.lax.erf_inv(u)).astype(dtype)


def _blocks_per_step(f: int, dtype) -> int:
    """threefry_2x32 blocks consumed per (path, step) in the SINGLE-step draw:
    each block yields two 32-bit words; f32 draws need one word each (an odd
    F straddles a block boundary, so one fetched word may belong to the
    neighbouring step), f64 two (one block per factor, never straddling)."""
    return f if jnp.dtype(dtype) == jnp.float64 else (f + 1) // 2


def _hash_counter_pairs(key, hi, lo):
    """Raw block words from explicit counter addressing: one threefry_2x32
    block per (hi, lo) counter pair under the FIXED base key.  jax's
    threefry_2x32 pairs element i of the first array half with element i of
    the second, so concatenating [hi, lo] makes every hash depend only on
    the counter VALUES — independent of batch layout (the subset/shard-
    invariance property) — and a single primitive call covers any set of
    (path, step) draws (per-step fold_in + vmap-over-keys hashes per key
    instead of in one call).  ``hi``/``lo`` any equal shape; returns
    two word arrays of that shape."""
    key_pair = jax.random.key_data(key)
    # Bind the primitive with the (hi, lo) operands directly: identical
    # values to the public API's concat/split form (pinned by
    # tests/test_rng_kernel.py), but the broadcasted counter arrays fuse
    # into the hash kernel instead of materialising a concatenated copy.
    out = _threefry2x32_p.bind(key_pair[0], key_pair[1], hi, lo)
    return out[0], out[1]


def step_normals(
    key: jax.Array,
    step: jnp.ndarray,  # scalar int step index
    path_ids: jnp.ndarray,  # [S] global path indices
    num_factors: int,
    antithetic: bool,
    dtype,
) -> jnp.ndarray:
    """Standard-normal draws z[t] for one step, [F, S] (the engines' factor
    layout).

    The RNG identity is (base_key, path, step, factor), mapped onto the
    threefry counter space by GLOBAL WORD INDEX: draw (step, factor) is word
    ``W = step·F + factor`` of path ``path_id`` (f32; f64 uses block
    ``step·F + factor`` whole).  Any step's draws recompute in isolation from
    the global path ids — the property behind both shard-count invariance and
    the streamed engine's in-scan regeneration — and
    bulk draws over many steps collapse into one optimally-packed hash call
    (``multi_step_normals``: S·F/2 hashes per step, no padding waste)."""
    ids = (path_ids // 2 if antithetic else path_ids).astype(jnp.uint32)
    s = ids.shape[0]
    f = num_factors
    if jnp.dtype(dtype) == jnp.float64:
        blocks = jnp.uint32(step) * jnp.uint32(f) + jnp.arange(f, dtype=jnp.uint32)
        w1, w2 = _hash_counter_pairs(
            key,
            jnp.broadcast_to(ids[None, :], (f, s)),
            jnp.broadcast_to(blocks[:, None], (f, s)),
        )
        z = _bits_to_normal(w1, w2, dtype)  # [F, S]
    else:
        # Words W = step·F + [0..F) span blocks ⌊W/2⌋: fetch Kb = F//2 + 1
        # blocks from B0 = ⌊step·F/2⌋ (static count; one fetched word may be
        # unused) and select each factor's word by parity r = (step·F) % 2.
        kb = f // 2 + 1
        w0 = jnp.uint32(step) * jnp.uint32(f)
        b0 = w0 // jnp.uint32(2)
        blocks = b0 + jnp.arange(kb, dtype=jnp.uint32)
        w1, w2 = _hash_counter_pairs(
            key,
            jnp.broadcast_to(ids[None, :], (kb, s)),
            jnp.broadcast_to(blocks[:, None], (kb, s)),
        )  # [Kb, S] each
        words = jnp.stack([w1, w2], axis=1).reshape(2 * kb, s)
        r = (w0 % jnp.uint32(2)).astype(jnp.int32)
        rows = []
        for fi in range(f):
            # local word index = fi + r ∈ {fi, fi+1}
            rows.append(jnp.where(r == 0, words[fi], words[fi + 1]))
        z = _bits_to_normal(jnp.stack(rows, axis=0), None, dtype)  # [F, S]
    if antithetic:
        sign = jnp.where(path_ids % 2 == 0, 1.0, -1.0).astype(dtype)
        return z * sign[None, :]
    return z


def draw_normal_halves(
    key: jax.Array,
    start_step,  # scalar int: first step of the contiguous range
    num_steps: int,  # static range length T
    path_ids: jnp.ndarray,  # [S]
    num_factors: int,
    antithetic: bool,
    dtype,
):
    """f32 bulk draws WITHOUT the word-interleave pass: returns
    (z1, z2) [nb, S] — the normal-transformed first/second words of blocks
    b0..b0+nb-1 with b0 = (start·F)//2 — plus the traced b0 offset.  The
    normal transform is per-word, so values are identical to
    ``multi_step_normals``; consumers assemble each step's [F, S] slice with
    ``step_z_from_halves`` (a few small row reads instead of interleaving
    the whole panel)."""
    assert jnp.dtype(dtype) != jnp.float64
    ids = (path_ids // 2 if antithetic else path_ids).astype(jnp.uint32)
    t, f, s = int(num_steps), num_factors, ids.shape[0]
    nw = t * f
    nb = nw // 2 + 1
    start = jnp.asarray(start_step).astype(jnp.uint32)
    b0 = (start * jnp.uint32(f)) // jnp.uint32(2)
    blocks = b0 + jnp.arange(nb, dtype=jnp.uint32)
    w1, w2 = _hash_counter_pairs(
        key,
        jnp.broadcast_to(ids[None, :], (nb, s)),
        jnp.broadcast_to(blocks[:, None], (nb, s)),
    )
    z1 = _bits_to_normal(w1, None, dtype)
    z2 = _bits_to_normal(w2, None, dtype)
    if antithetic:
        sign = jnp.where(path_ids % 2 == 0, 1.0, -1.0).astype(dtype)
        z1 = z1 * sign[None, :]
        z2 = z2 * sign[None, :]
    return z1, z2, b0


def step_z_from_halves(z1, z2, b0, step, num_factors: int):
    """Assemble step ``step``'s [F, S] draws from the block-half normals of
    ``draw_normal_halves``.  Word W = step·F + i lives at row W//2 − b0, half
    W%2; with traced ``step`` both parities are handled by a 2-way select
    over statically-indexed rows."""
    f = num_factors
    m = jnp.asarray(step).astype(jnp.uint32) * jnp.uint32(f)
    r0 = m // jnp.uint32(2) - b0
    p_odd = (m % jnp.uint32(2)).astype(jnp.bool_)
    width = f // 2 + 1
    s1 = jax.lax.dynamic_slice_in_dim(z1, r0.astype(jnp.int32), width, axis=0)
    s2 = jax.lax.dynamic_slice_in_dim(z2, r0.astype(jnp.int32), width, axis=0)

    def pick(q, i):
        off, half = (q + i) // 2, (q + i) % 2
        return (s1 if half == 0 else s2)[off]

    rows = [jnp.where(p_odd, pick(1, i), pick(0, i)) for i in range(f)]
    return jnp.stack(rows, axis=0)  # [F, S]


def multi_step_normals(
    key: jax.Array,
    start_step,  # scalar int: first step of the contiguous range
    num_steps: int,  # static range length T
    path_ids: jnp.ndarray,  # [S]
    num_factors: int,
    antithetic: bool,
    dtype,
) -> jnp.ndarray:
    """[T, F, S] draws for steps start..start+T-1 — bit-identical to stacking
    ``step_normals``, hashed in ONE optimally-packed threefry call
    (consecutive (step, factor) words share blocks, so the bulk sweep costs
    exactly S·T·F/2 hashes; per-step drawing inside a ``lax.scan``
    additionally sequentialises the hashing)."""
    ids = (path_ids // 2 if antithetic else path_ids).astype(jnp.uint32)
    t, f, s = int(num_steps), num_factors, ids.shape[0]
    start = jnp.asarray(start_step).astype(jnp.uint32)
    if jnp.dtype(dtype) == jnp.float64:
        nb = t * f
        blocks = start * jnp.uint32(f) + jnp.arange(nb, dtype=jnp.uint32)
        w1, w2 = _hash_counter_pairs(
            key,
            jnp.broadcast_to(ids[None, :], (nb, s)),
            jnp.broadcast_to(blocks[:, None], (nb, s)),
        )
        z = _bits_to_normal(w1, w2, dtype).reshape(t, f, s)
    else:
        nw = t * f
        nb = nw // 2 + 1  # +1 covers a straddled first/last block
        w0 = start * jnp.uint32(f)
        blocks = w0 // jnp.uint32(2) + jnp.arange(nb, dtype=jnp.uint32)
        w1, w2 = _hash_counter_pairs(
            key,
            jnp.broadcast_to(ids[None, :], (nb, s)),
            jnp.broadcast_to(blocks[:, None], (nb, s)),
        )  # [nb, S]
        words = jnp.stack([w1, w2], axis=1).reshape(2 * nb, s)
        if isinstance(start_step, int) and (start_step * f) % 2 == 0:
            # Aligned static start (the bulk simulator's t0=0 case): skip the
            # dynamic-slice pass over the word panel.
            words = words[:nw]
        else:
            r = (w0 % jnp.uint32(2)).astype(jnp.int32)
            words = jax.lax.dynamic_slice_in_dim(words, r, nw, axis=0)
        z = _bits_to_normal(words, None, dtype).reshape(t, f, s)
    if antithetic:
        sign = jnp.where(path_ids % 2 == 0, 1.0, -1.0).astype(dtype)
        return z * sign[None, None, :]
    return z


# The simulator's contractions (K = F) run at HIGHEST: the GPU's default
# f32 matmul rounds operands to TF32, which would perturb every path, and
# the streamed engines must reproduce the bulk simulator's values.
_HIGHEST = jax.lax.Precision.HIGHEST


def ou_step(x, z, decay_k, chol_k):
    """One exact OU transition in the engines' [F, S] layout:
    x_k = decay_k ⊙ x_{k-1} + L_k z_k."""
    return x * decay_k[:, None] + jnp.dot(
        chol_k, z, preferred_element_type=x.dtype, precision=_HIGHEST
    )


def spot_from_state(x, fwd_k, half_var_k, vols_k):
    """ln S_k = ln F_k − half_var_k + vols_k·x, per path ([F, S] → [S])."""
    return jnp.exp(
        jnp.log(fwd_k) - half_var_k
        + jnp.dot(vols_k, x, preferred_element_type=x.dtype, precision=_HIGHEST)
    )


@partial(jax.jit, static_argnames=("antithetic",))
def simulate_ou_paths(
    key: jax.Array,
    path_ids: jnp.ndarray,  # [S] global path indices (shard-invariant RNG identity)
    decay: jnp.ndarray,  # [P, F]
    chol: jnp.ndarray,  # [P, F, F]
    vols: jnp.ndarray,  # [P, F]
    half_var: jnp.ndarray,  # [P]
    fwd: jnp.ndarray,  # [P]
    antithetic: bool = False,
) -> SpotSimResults:
    """Simulate factor states and spot prices for the given paths.

    x_i(t_k) = decay[k,i]·x_i(t_{k-1}) + (L_k z_k)_i with z_k ~ N(0, I);
    ln S_k = ln F_k − half_var[k] + Σ_i vols[k,i]·x_i(t_k).

    Draws use the per-(step, path, factor) counter addressing of
    ``step_normals`` — identical values to the streamed engines' in-scan
    regeneration — hashed in ONE bulk call (``multi_step_normals``: per-step
    drawing inside the scan would sequentialise the hashing)."""
    p, f = decay.shape
    dtype = decay.dtype
    if jnp.dtype(dtype) == jnp.float64:
        zs = multi_step_normals(key, 0, p, path_ids, f, antithetic, dtype)

        def step(x, inputs):
            z_k, decay_k, chol_k = inputs
            x_new = ou_step(x, z_k, decay_k, chol_k)
            return x_new, x_new

        xs_in = (zs, decay, chol)
    else:
        # f32: skip the word-interleave relayout — assemble each step's draw
        # from the block-half normals inside the scan (identical values).
        z1, z2, b0 = draw_normal_halves(key, 0, p, path_ids, f, antithetic, dtype)

        def step(x, inputs):
            k, decay_k, chol_k = inputs
            z_k = step_z_from_halves(z1, z2, b0, k, f)
            x_new = ou_step(x, z_k, decay_k, chol_k)
            return x_new, x_new

        xs_in = (jnp.arange(p), decay, chol)

    s = path_ids.shape[0]
    x0 = jnp.zeros((f, s), dtype=dtype)
    _, xs = jax.lax.scan(step, x0, xs_in)  # [P, F, S]
    # Spot assembly in ONE fused pass over the whole panel (computing it
    # per-step inside the scan would sequentialise the elementwise work).  Same contraction order as spot_from_state, so the
    # streamed engines' per-step pricing is numerically identical.
    log_spot = (
        jnp.log(fwd)[:, None] - half_var[:, None]
        + jnp.einsum("pfs,pf->ps", xs, vols, precision=_HIGHEST)
    )
    return SpotSimResults(spot=jnp.exp(log_spot), factors=xs)


class MultiFactorSpotSim:
    """Pythonic simulator facade, mirroring the reference ``MultiFactorSpotSim``
    (multi_factor_spot_sim.py:39-88): constructed from factors + correlations +
    forward curve + periods to simulate; ``simulate(num_sims)`` returns a
    DataFrame of spot prices [periods x sims].

    The RNG is threefry counter-based rather than Mersenne-Twister, so pinned
    seeds are reproducible within this framework but (necessarily) not
    bit-matched to the reference — accuracy acceptance is statistical.
    """

    def __init__(
        self,
        freq: str,
        factors: tp.Collection[mf.FactorType],
        factor_corrs: mf.FactorCorrsType,
        current_date,
        fwd_curve: tp.Union[pd.Series, tp.Dict],
        sim_periods: tp.Iterable,
        seed: tp.Optional[int] = None,
        antithetic: bool = False,
        dtype=jnp.float32,
    ):
        pandas_freq = pu.normalise_freq(freq)
        self._freq = pandas_freq
        periods = [
            p if isinstance(p, pd.Period) else pd.Period(p, freq=pandas_freq)
            for p in sim_periods
        ]
        self._periods = periods
        pre = mf.simulation_precompute(factors, factor_corrs, current_date, periods, freq)
        if isinstance(fwd_curve, pd.Series):
            fwd_vals = []
            curve = fwd_curve.copy()
            if not isinstance(curve.index, pd.PeriodIndex):
                curve.index = pd.PeriodIndex(curve.index, freq=pandas_freq)
            for p in periods:
                if p not in curve.index:
                    raise ValueError(f"Forward curve has no point for period {p}.")
                fwd_vals.append(float(curve[p]))
        else:
            lookup = {
                (k if isinstance(k, pd.Period) else pd.Period(k, freq=pandas_freq)): float(v)
                for k, v in fwd_curve.items()
            }
            fwd_vals = []
            for p in periods:
                if p not in lookup:
                    raise ValueError(f"Forward curve has no point for period {p}.")
                fwd_vals.append(lookup[p])
        self._dtype = dtype
        self._decay = jnp.asarray(pre.decay, dtype)
        self._chol = jnp.asarray(pre.chol, dtype)
        self._vols = jnp.asarray(pre.vols, dtype)
        self._half_var = jnp.asarray(pre.half_var, dtype)
        self._fwd = jnp.asarray(np.array(fwd_vals), dtype)
        self._key = jax.random.key(0 if seed is None else int(seed))
        self._antithetic = antithetic

    def simulate(self, num_sims: int) -> pd.DataFrame:
        res = simulate_ou_paths(
            self._key,
            jnp.arange(num_sims),
            self._decay,
            self._chol,
            self._vols,
            self._half_var,
            self._fwd,
            antithetic=self._antithetic,
        )
        return pd.DataFrame(
            data=np.asarray(res.spot),
            index=pd.PeriodIndex(self._periods, freq=self._freq),
        )

    def simulate_with_factors(self, num_sims: int) -> tp.Tuple[pd.DataFrame, tp.List[pd.DataFrame]]:
        """Spot frame plus one frame per Markov factor (for ``value_from_sims``)."""
        res = simulate_ou_paths(
            self._key,
            jnp.arange(num_sims),
            self._decay,
            self._chol,
            self._vols,
            self._half_var,
            self._fwd,
            antithetic=self._antithetic,
        )
        index = pd.PeriodIndex(self._periods, freq=self._freq)
        spot = pd.DataFrame(data=np.asarray(res.spot), index=index)
        factors = [
            pd.DataFrame(data=np.asarray(res.factors[:, i, :]), index=index.copy())
            for i in range(res.num_factors)
        ]
        return spot, factors
