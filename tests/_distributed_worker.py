"""Worker process for the multi-process CPU distribution test.

Launched by tests/test_distributed.py as
``python tests/_distributed_worker.py <proc_id> <num_procs> <port> <n_local_dev>``.
Each process holds a distinct block of the global sim panel and runs
``value_from_sims_host_local`` over the global (num_procs x n_local_dev)-device
mesh; reduced outputs must be identical on every process and equal to a
single-process run over the full panel.
"""
import sys


def build_case(num_sims_global: int):
    """Deterministic facility + market + full sim panels (numpy, seed-pinned).

    Importable by both the pytest parent (for the single-process expected
    values) and the worker processes (each slices its own block).
    """
    import numpy as np
    import pandas as pd

    from storage_tpu import CmdtyStorage

    storage = CmdtyStorage(
        "D", "2021-02-01", "2021-04-01", 0.7, 0.5,
        ratchets=[("2021-02-01", [(0.0, -250.0, 380.0), (3_000.0, -330.0, 260.0),
                                  (6_000.0, -400.0, 190.0)])],
        ratchet_interp=__import__("storage_tpu").RatchetInterp.LINEAR,
    )
    val_date = "2021-02-01"
    idx = pd.period_range(val_date, "2021-04-01", freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=28.0 + 6.0 * np.sin(2 * np.pi * i / 59.0))

    rng = np.random.default_rng(42)
    n = len(idx)
    z = rng.standard_normal((n, num_sims_global))
    x = 0.25 * np.cumsum(z, axis=0) / np.sqrt(np.arange(1, n + 1))[:, None]
    spot = fwd.to_numpy()[:, None] * np.exp(x - 0.5 * 0.25**2)

    def frames(cols):
        return (
            pd.DataFrame(spot[:, cols], index=idx),
            [pd.DataFrame(x[:, cols], index=idx)],
        )

    basis = "1 + s + s**2 + x0"
    return storage, val_date, fwd, frames, basis


def main():
    proc_id, nprocs, port, ndev = (int(a) for a in sys.argv[1:5])
    import os

    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from storage_tpu.parallel import distributed as dist

    dist.initialize(f"localhost:{port}", num_processes=nprocs, process_id=proc_id)
    assert dist.process_count() == nprocs

    import jax.numpy as jnp
    from storage_tpu import value_from_sims_host_local

    num_sims_global = 64
    storage, val_date, fwd, frames, basis = build_case(num_sims_global)
    s_local = num_sims_global // nprocs
    cols = range(proc_id * s_local, (proc_id + 1) * s_local)
    spot_local, factors_local = frames(list(cols))

    res = value_from_sims_host_local(
        storage, val_date, 500.0, fwd, 0.03, None, spot_local, spot_local,
        basis, False, sim_factors_regress=factors_local,
        sim_factors_valuation=factors_local, num_inventory_grid_points=30,
        dtype=jnp.float64,
    )
    print(
        f"RESULT proc={proc_id} npv={res.npv!r} se={res.val_sim_standard_error!r} "
        f"delta_sum={res.deltas.sum()!r} "
        f"trig0={res.trigger_prices['inject_trigger_price'].iloc[0]!r}",
        flush=True,
    )

    # Round 3: INTERNALLY-simulated multi-host valuation — sims drawn inside
    # the global-mesh shard_map (each process owns its global path block by
    # axis_index), inputs auto-replicated by sharded_lsmc_core.  Must agree
    # across processes and with a single-process run of the same call.
    import pandas as pd

    from storage_tpu import multi_factor_value

    res2 = multi_factor_value(
        storage, val_date, 500.0, fwd, 0.03, None,
        [(5.0, pd.Series(0.6, index=fwd.index))], None, 64, "1 + s + x0",
        False, seed=7, fwd_sim_seed=9, num_inventory_grid_points=30,
        dtype=jnp.float64,
    )
    print(
        f"RESULT2 proc={proc_id} npv={res2.npv!r} se={res2.val_sim_standard_error!r} "
        f"delta_sum={res2.deltas.sum()!r}",
        flush=True,
    )

    # Round 4: multi-process ADJOINT deltas — the
    # collective-free per-shard reverse sweep + explicit pmean on the global
    # mesh.  Same call as RESULT2 but deltas_method='adjoint'; NPV identical
    # (same sims, same policy), deltas must equal the pathwise series.
    res3 = multi_factor_value(
        storage, val_date, 500.0, fwd, 0.03, None,
        [(5.0, pd.Series(0.6, index=fwd.index))], None, 64, "1 + s + x0",
        False, seed=7, fwd_sim_seed=9, num_inventory_grid_points=30,
        dtype=jnp.float64, deltas_method="adjoint",
    )
    print(
        f"RESULT3 proc={proc_id} npv={res3.npv!r} "
        f"delta_sum={res3.deltas.sum()!r} "
        f"delta_vs_pathwise={(res3.deltas - res2.deltas).abs().max()!r}",
        flush=True,
    )

    # Round 5: multi-process USER-PANELS adjoint — same
    # host-local panel ingestion as RESULT, but deltas_method='adjoint'
    # (parallel.mesh.sharded_ad_deltas_from_sims on the global mesh).  NPV
    # identical to RESULT; deltas must equal RESULT's pathwise series.
    res4 = value_from_sims_host_local(
        storage, val_date, 500.0, fwd, 0.03, None, spot_local, spot_local,
        basis, False, sim_factors_regress=factors_local,
        sim_factors_valuation=factors_local, num_inventory_grid_points=30,
        dtype=jnp.float64, deltas_method="adjoint",
    )
    print(
        f"RESULT4 proc={proc_id} npv={res4.npv!r} "
        f"delta_sum={res4.deltas.sum()!r} "
        f"delta_vs_pathwise={(res4.deltas - res.deltas).abs().max()!r}",
        flush=True,
    )


if __name__ == "__main__":
    main()
