"""Phase-split timing of the bench config on the GPU (dev tool).

    python profile_phases.py
"""
import time
import jax

from storage_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp
from functools import partial

from __graft_entry__ import _build_case
from storage_tpu.engines import lsmc as lsmc_engine
from storage_tpu.models.spot_sim import simulate_ou_paths

NUM_SIMS = 262_144
NUM_STEPS = 365
NUM_GRID = 100

dtype = jnp.float32
inputs, arrays, sim_inputs, monomials = _build_case(
    num_steps=NUM_STEPS, num_grid=NUM_GRID, num_sims=NUM_SIMS, dtype=dtype
)
terminal_fn = inputs.compiled.terminal_value
inv0 = jnp.asarray(inputs.starting_inventory, dtype)
path_ids = jnp.arange(NUM_SIMS)


@jax.jit
def sim_only(key):
    return simulate_ou_paths(
        key, path_ids, sim_inputs["decay"], sim_inputs["chol"],
        sim_inputs["vols"], sim_inputs["half_var"], sim_inputs["fwd"],
        antithetic=False,
    )


USE_PALLAS = lsmc_engine.resolve_use_pallas(None, dtype)


@partial(jax.jit, static_argnames=())
def backward_only(spot, factors):
    v0, reg = lsmc_engine.lsmc_backward(
        arrays, spot, factors, monomials, 0, terminal_fn, False, None,
        use_pallas=USE_PALLAS,
    )
    return v0.sum(), jax.tree.map(lambda x: x, reg)


@jax.jit
def forward_only(spot, factors, regression):
    return lsmc_engine.lsmc_forward(
        arrays, spot, factors, regression, inv0, monomials, 0, False,
        terminal_fn, False, None, False,
    )["npv"]


def bench(fn, *args, n=3):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out


t_sim, reg_paths = bench(sim_only, jax.random.key(11))
print(f"simulate one path set: {t_sim*1e3:9.1f} ms")

t_bwd, (_, regression) = bench(backward_only, reg_paths.spot, reg_paths.factors)
print(f"backward induction:    {t_bwd*1e3:9.1f} ms")

_, val_paths = bench(sim_only, jax.random.key(13))
t_fwd, _ = bench(forward_only, val_paths.spot, val_paths.factors, regression)
print(f"forward pass:          {t_fwd*1e3:9.1f} ms")

print(f"sum (2x sim):          {(2*t_sim + t_bwd + t_fwd)*1e3:9.1f} ms")
