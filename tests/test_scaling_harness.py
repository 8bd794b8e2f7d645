"""Smoke test for the path-scaling efficiency harness (bench_scaling.py) on
the virtual CPU mesh: the harness must sweep mesh sizes, produce well-formed
rows, and normalise efficiency to the 1-chip row.  (Real multi-chip numbers
come from running the same file unmodified on a pod slice.)"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def test_sweep_shape_and_efficiency():
    from bench_scaling import run_sweep

    result = run_sweep(
        num_sims_per_chip=64, num_steps=10, num_grid=8, repeats=1,
        mesh_sizes=[1, 2, 4],
    )
    rows = result["rows"]
    assert [r["chips"] for r in rows] == [1, 2, 4]
    assert [r["paths"] for r in rows] == [64, 128, 256]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["wall_s"] > 0
        assert r["paths_steps_per_s"] > 0
        assert abs(r["per_chip"] - r["paths_steps_per_s"] / r["chips"]) < 1.0
        assert 0 < r["efficiency"]
        import numpy as np

        assert np.isfinite(r["npv"])


def test_multiprocess_sweep_two_rows():
    """The cross-process sweep produces >=2
    rows through real jax.distributed jobs, and on an OVERSUBSCRIBED CPU
    harness (virtual devices > physical cores) reports them as
    correctness-only — efficiency is n/a, since a timing ratio there
    measures CPU oversubscription, not interconnect scaling."""
    import os

    from bench_scaling import run_multiprocess_sweep

    result = run_multiprocess_sweep(
        proc_counts=(1, 2), ndev=2, num_sims_per_chip=32, num_steps=8,
        num_grid=8, repeats=1,
    )
    rows = result["rows"]
    assert [r["processes"] for r in rows] == [1, 2]
    assert [r["devices"] for r in rows] == [2, 4]
    oversubscribed = 2 * 2 > (os.cpu_count() or 1)
    for r in rows:
        assert r["wall_s"] > 0 and r["paths_steps_per_s"] > 0
        if oversubscribed:
            assert r["efficiency"] is None
            assert "correctness-only" in result["config"]["efficiency_note"]
        else:
            assert 0 < r["efficiency"]
    if not oversubscribed:
        assert rows[0]["efficiency"] == 1.0
