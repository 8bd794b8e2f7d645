"""Multi-process distribution tests.

Launches 2 real OS processes x 4 virtual CPU devices each, initialises
``jax.distributed`` against a local coordinator, ingests host-local path
blocks via ``value_from_sims_host_local`` and asserts:

* both processes report identical reduced outputs (NPV/SE/deltas/triggers);
* those outputs equal a single-process run over the full panel on an
  8-device mesh (the shard-count invariance test_sharding.py pins, extended
  across process boundaries).

Also unit-tests the cross-process shape validation and the multi-process
guard rails in-process.
"""
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

from tests._distributed_worker import build_case

F64 = jnp.float64
WORKER = Path(__file__).parent / "_distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _parse(line: str):
    vals = dict(re.findall(r"(\w+)=(?:np\.float64\()?([-0-9.e+]+)", line))
    return {k: float(v) for k, v in vals.items()}


def test_two_process_host_local_sims_match_single_process():
    # Single-process expected values over the full panel (8 virtual devices
    # from conftest shard it 8 ways already).
    from storage_tpu import value_from_sims

    storage, val_date, fwd, frames, basis = build_case(64)
    spot_all, factors_all = frames(list(range(64)))
    expected = value_from_sims(
        storage, val_date, 500.0, fwd, 0.03, None, spot_all, spot_all,
        basis, False, sim_factors_regress=factors_all,
        sim_factors_valuation=factors_all, num_inventory_grid_points=30,
        dtype=F64,
    )

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(i), "2", str(port), "4"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(WORKER.parent.parent),
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out)
        assert p.returncode == 0, f"worker failed:\n{out}"

    results = []
    results2 = []
    for out in outputs:
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line in worker output:\n{out}"
        results.append(_parse(lines[0]))
        lines2 = [l for l in out.splitlines() if l.startswith("RESULT2 ")]
        assert lines2, f"no RESULT2 line in worker output:\n{out}"
        results2.append(_parse(lines2[0]))

    # Identical across processes (replicated reductions).
    for key in ("npv", "se", "delta_sum", "trig0"):
        assert results[0][key] == results[1][key], key

    # Equal to the single-process full-panel run: same global path layout,
    # same 8-device reduction topology.
    assert results[0]["npv"] == pytest.approx(expected.npv, rel=1e-12)
    assert results[0]["se"] == pytest.approx(expected.val_sim_standard_error, rel=1e-12)
    assert results[0]["delta_sum"] == pytest.approx(expected.deltas.sum(), rel=1e-10)
    assert results[0]["trig0"] == pytest.approx(
        expected.trigger_prices["inject_trigger_price"].iloc[0], rel=1e-10
    )

    # Internally-simulated multi-host valuation (round 3): identical across
    # processes and equal to a single-process run of the same call (global
    # path ids -> identical draws; ~1e-8 covers scan-vs-eager ULP noise).
    import pandas as pd

    from storage_tpu import multi_factor_value

    expected2 = multi_factor_value(
        storage, val_date, 500.0, fwd, 0.03, None,
        [(5.0, pd.Series(0.6, index=fwd.index))], None, 64, "1 + s + x0",
        False, seed=7, fwd_sim_seed=9, num_inventory_grid_points=30,
        dtype=F64,
    )
    for key in ("npv", "se", "delta_sum"):
        assert results2[0][key] == results2[1][key], key
    assert results2[0]["npv"] == pytest.approx(expected2.npv, rel=1e-8)
    assert results2[0]["se"] == pytest.approx(
        expected2.val_sim_standard_error, rel=1e-8
    )
    assert results2[0]["delta_sum"] == pytest.approx(
        expected2.deltas.sum(), rel=1e-6
    )

    # Multi-process adjoint deltas (round 4): identical across processes,
    # NPV unchanged vs the pathwise run, and the AD delta series equals the
    # hand-derived pathwise series (the envelope-theorem identity
    # tests/test_ad_deltas_api.py pins single-process).
    results3 = []
    for out in outputs:
        lines3 = [l for l in out.splitlines() if l.startswith("RESULT3 ")]
        assert lines3, f"no RESULT3 line in worker output:\n{out}"
        results3.append(_parse(lines3[0]))
    for key in ("npv", "delta_sum"):
        assert results3[0][key] == results3[1][key], key
    assert results3[0]["npv"] == pytest.approx(results2[0]["npv"], rel=1e-10)
    scale = max(1.0, abs(results2[0]["delta_sum"]))
    assert results3[0]["delta_sum"] == pytest.approx(
        results2[0]["delta_sum"], rel=1e-6
    )
    assert results3[0]["delta_vs_pathwise"] < 1e-6 * scale

    # Multi-process USER-PANELS adjoint (round 5): identical across
    # processes, NPV unchanged vs the pathwise panel run, AD deltas equal
    # the pathwise series (sharded_ad_deltas_from_sims on the global mesh).
    results4 = []
    for out in outputs:
        lines4 = [l for l in out.splitlines() if l.startswith("RESULT4 ")]
        assert lines4, f"no RESULT4 line in worker output:\n{out}"
        results4.append(_parse(lines4[0]))
    for key in ("npv", "delta_sum"):
        assert results4[0][key] == results4[1][key], key
    assert results4[0]["npv"] == pytest.approx(results[0]["npv"], rel=1e-10)
    pscale = max(1.0, abs(results[0]["delta_sum"]))
    assert results4[0]["delta_vs_pathwise"] < 1e-6 * pscale


class TestDistributedHelpers:
    def test_single_process_passthrough(self):
        """In a single-process job the distributed helpers are no-ops usable
        without jax.distributed.initialize."""
        import numpy as np
        from storage_tpu.parallel import distributed as dist

        assert dist.process_count() == 1
        assert dist.process_index() == 0
        mesh = dist.global_mesh()
        assert mesh.devices.size == 8  # conftest virtual devices
        tree = {"a": np.ones(3), "b": 2.0}
        assert dist.replicate_to_global(tree) is tree  # no lifting needed

        spot = jnp.ones((5, 16), F64)
        factors = jnp.zeros((5, 1, 16), F64)
        g_spot, g_fac = dist.host_local_sims_to_global(spot, factors, mesh)
        assert g_spot.shape == (5, 16)
        assert g_fac.shape == (5, 1, 16)

    def test_local_sims_must_tile_local_devices(self):
        from storage_tpu.parallel import distributed as dist

        spot = jnp.ones((5, 12), F64)  # 12 % 8 != 0
        factors = jnp.zeros((5, 1, 12), F64)
        with pytest.raises(ValueError, match="multiple of the local"):
            dist.host_local_sims_to_global(spot, factors)
