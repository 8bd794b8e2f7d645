"""Benchmark: 3-factor-seasonal LSMC of a 1-year ratcheted daily storage.

Prints ONE JSON line: paths x steps per second per device for the full LSMC
valuation (path simulation + backward induction with per-step regression
+ forward pass with deltas/profiles/trigger prices), measured after
compilation, each run ending on ``jax.block_until_ready``.  The device it ran
on (platform, kind, count, card name and power limit) goes to stderr.

Config (BASELINE.json headline): 365 daily decision steps, inventory-dependent
ratchets, 3-factor seasonal model, 9-term basis, dual simulation, 100
inventory grid points, 262,144 paths.

    python bench.py                # on a GPU; refuses to run elsewhere
    python bench.py --cpu          # CPU smoke run (CI), no device metric
    BENCH_NUM_SIMS=1048576 python bench.py
    python bench.py --scaling      # mesh-size sweep (bench_scaling.py)
"""
import json
import os
import sys
import time

import numpy as np


def main():
    if "--scaling" in sys.argv:
        from bench_scaling import main as scaling_main

        scaling_main()
        return

    num_sims = int(os.environ.get("BENCH_NUM_SIMS", 262_144))
    num_steps = int(os.environ.get("BENCH_NUM_STEPS", 365))
    num_grid = int(os.environ.get("BENCH_NUM_GRID", 100))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))

    import jax

    from storage_tpu.utils.compile_cache import enable_compile_cache
    from storage_tpu.utils.device_info import (
        gpu_name_and_power_limit, jax_device_summary,
    )

    enable_compile_cache()
    device = jax_device_summary()
    if device["platform"] != "gpu" and "--cpu" not in sys.argv:
        print(
            f"bench.py measures the GPU; JAX found {device['platform']!r}. "
            f"Pass --cpu for a smoke run.",
            file=sys.stderr,
        )
        sys.exit(2)
    card = gpu_name_and_power_limit() if device["platform"] == "gpu" else "none"
    print(
        f"# device: platform={device['platform']} kind={device['kind']} "
        f"count={device['count']} card={card!r} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        file=sys.stderr,
    )

    from __graft_entry__ import _build_case
    import jax.numpy as jnp
    from storage_tpu.parallel import mesh as pmesh

    n_chips = device["count"]
    dtype = jnp.float32
    num_sims = pmesh.pad_num_sims(num_sims, n_chips)
    inputs, arrays, sim_inputs, monomials = _build_case(
        num_steps=num_steps, num_grid=num_grid, num_sims=num_sims, dtype=dtype
    )
    mesh = pmesh.make_mesh()

    def run():
        result = pmesh.sharded_lsmc_core(
            mesh, arrays, sim_inputs, jax.random.key(11), jax.random.key(13),
            num_sims, inputs.starting_inventory, monomials,
            num_extra_decisions=0, discount_deltas=False,
            terminal_fn=inputs.compiled.terminal_value, ratchet_is_step=False,
            return_sim_data=False,
        )
        return jax.block_until_ready(result)

    result = run()  # compile + warmup
    npv = float(result["npv"])
    se = float(result["standard_error"])
    if not np.isfinite(npv):
        print(json.dumps({"metric": "error", "value": 0, "unit": ""}))
        sys.exit(1)

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    value = num_sims * num_steps / best / n_chips

    print(
        json.dumps(
            {
                "metric": "lsmc_3f_seasonal_paths_steps_per_s_per_chip",
                "value": round(value, 1),
                "unit": "paths*steps/s/chip",
                "device": device,
            }
        )
    )
    print(
        f"# config: sims={num_sims} steps={num_steps} grid={num_grid} "
        f"chips={n_chips} best={best:.4f}s times={times} npv={npv:.2f} "
        f"se={se:.2f}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
