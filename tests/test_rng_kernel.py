"""Counter-addressed draws: every (path, step, factor) normal is a function of
the counter values alone.

The streamed engine regenerates any step's draws in isolation, and sharded
runs draw only their own path block; both rest on the bulk draw, the
single-step draw and the block-half layout emitting identical bits for the
same (path, step, factor).  The comparisons here are exact equality, not
closeness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import random as jex_random

from storage_tpu.models import spot_sim

CASES = [
    (0, 24, 3, 256),  # bench-like: 3 factors, aligned start
    (7, 11, 3, 256),  # odd word offset: straddled first block
    (0, 9, 1, 128),  # single factor
    (3, 5, 4, 384),  # even factor count (no straddling)
    (0, 6, 3, 640),  # S a non-power-of-two multiple of 128
]


def _halves_steps(key, start, t, path_ids, f, antithetic):
    """[T, F, S] assembled from the block-half bulk draw."""
    z1, z2, b0 = spot_sim.draw_normal_halves(
        key, start, t, path_ids, f, antithetic, jnp.float32
    )
    return jnp.stack([
        spot_sim.step_z_from_halves(z1, z2, b0, start + k, f) for k in range(t)
    ])


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("start,t,f,s", CASES)
def test_step_regenerated_alone_equals_bulk_draw(start, t, f, s, antithetic):
    key = jax.random.key(12345)
    path_ids = jnp.arange(s)
    bulk = spot_sim.multi_step_normals(
        key, start, t, path_ids, f, antithetic, jnp.float32
    )
    halves = _halves_steps(key, start, t, path_ids, f, antithetic)
    np.testing.assert_array_equal(np.asarray(halves), np.asarray(bulk))
    for k in (0, t // 2, t - 1):
        alone = spot_sim.step_normals(
            key, start + k, path_ids, f, antithetic, jnp.float32
        )
        np.testing.assert_array_equal(np.asarray(alone), np.asarray(bulk[k]))


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("start,t,f,s", CASES)
def test_draws_are_shard_invariant(start, t, f, s, antithetic):
    """A shard drawing the path-id window [s/2, s) reproduces those columns
    of the global draw, in both the bulk and the block-half layouts."""
    key = jax.random.key(99)
    full_ids, shard_ids = jnp.arange(s), jnp.arange(s // 2, s)
    full = spot_sim.multi_step_normals(key, start, t, full_ids, f, antithetic, jnp.float32)
    shard = spot_sim.multi_step_normals(key, start, t, shard_ids, f, antithetic, jnp.float32)
    np.testing.assert_array_equal(np.asarray(full)[..., s // 2:], np.asarray(shard))
    shard_halves = _halves_steps(key, start, t, shard_ids, f, antithetic)
    np.testing.assert_array_equal(np.asarray(shard_halves), np.asarray(shard))


def test_draws_traced_start():
    """The streamed engine calls with a traced segment start."""
    key = jax.random.key(7)
    path_ids = jnp.arange(256)

    @jax.jit
    def traced(s0):
        return spot_sim.draw_normal_halves(key, s0, 8, path_ids, 3, False, jnp.float32)[:2]

    for s0 in (0, 5, 32):
        want = spot_sim.draw_normal_halves(key, s0, 8, path_ids, 3, False, jnp.float32)
        got = traced(jnp.asarray(s0))
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_ragged_path_count():
    """Path counts need not tile onto any block width."""
    key = jax.random.key(3)
    full = spot_sim.multi_step_normals(key, 0, 4, jnp.arange(100), 3, False, jnp.float32)
    assert full.shape == (4, 3, 100)
    part = spot_sim.multi_step_normals(key, 0, 4, jnp.arange(37, 100), 3, False, jnp.float32)
    np.testing.assert_array_equal(np.asarray(full)[..., 37:], np.asarray(part))


def test_threefry_matches_jax_primitive():
    """The direct primitive binding is the same function as JAX's public
    threefry_2x32 on the concatenated counter halves."""
    key = jax.random.key(2024)
    hi = jnp.arange(64, dtype=jnp.uint32).reshape(4, 16)
    lo = (jnp.arange(64, dtype=jnp.uint32) * 7 + 3).reshape(4, 16)
    w1x, w2x = spot_sim._hash_counter_pairs(key, hi, lo)
    out = jex_random.threefry_2x32(
        jax.random.key_data(key), jnp.concatenate([hi.ravel(), lo.ravel()])
    )
    np.testing.assert_array_equal(np.asarray(w1x), np.asarray(out[:64]).reshape(4, 16))
    np.testing.assert_array_equal(np.asarray(w2x), np.asarray(out[64:]).reshape(4, 16))
