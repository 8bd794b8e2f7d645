"""End-to-end check of the LSMC valuation on one GPU.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the path-sharded valuation on 4 cards

Drives the public API at the benchmark's full width (3-factor seasonal
model, 9-term basis, 365 daily steps, ratcheted facility with a terminal
value, 100 inventory grid points, 262,144 and 1,048,576 paths, f32) and
compares each result with the repo's plain references: the in-repo goldens,
the f64 XLA engine on the same paths, and the XLA body of the decision
kernel.  Any failed gate raises, so the script exits non-zero; the last line
of standard output is a JSON object naming the device, printed only when
every phase passed.  There is no CPU fallback.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import statistics
import sys
import time


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(3)


def _median_time(fn, repeats=3):
    """Median wall time of ``fn()`` after one warm-up call; every call ends
    on ``jax.block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    print(f"  ok: {msg}", flush=True)


# --------------------------------------------------------------- the case
NUM_STEPS = 365
NUM_GRID = 100
NUM_SIMS = 262_144
NUM_SIMS_1M = 1_048_576
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
MODEL = dict(spot_mean_reversion=14.5, spot_vol=1.1, long_term_vol=0.19,
             seasonal_vol=0.23)
SEED, FWD_SEED = 11, 13


@functools.cache
def _facility():
    """The benchmark's 1-year daily facility: inventory-dependent ratchets
    (linear interpolation) and a terminal value, on a seasonal curve.  Built
    once, so repeat valuations reuse one facility, as a desk revaluing its
    book does, and with it the compiled engine."""
    import numpy as np
    import pandas as pd

    from storage_tpu import CmdtyStorage, RatchetInterp

    start = pd.Period("2021-01-01", freq="D")
    storage = CmdtyStorage(
        "D", start, start + NUM_STEPS, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                           (5000.0, -300.0, 200.0)])],
        ratchet_interp=RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv,
    )
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0))
    return storage, start, 100.0, fwd, 0.02


def _value(num_sims: int, **kwargs):
    from storage_tpu import three_factor_seasonal_value

    storage, val_date, inventory, fwd, rate = _facility()
    return three_factor_seasonal_value(
        storage, val_date, inventory, fwd, rate, None, num_sims=num_sims,
        basis_funcs=BASIS, discount_deltas=False, seed=SEED,
        fwd_sim_seed=FWD_SEED, num_inventory_grid_points=NUM_GRID, **MODEL,
        **kwargs,
    )


def _engine_case(dtype, num_extra_decisions=0):
    """The API's own engine inputs for the facility (arrays, OU precompute,
    keys, basis), for phases that compare engine bodies on one set of paths."""
    import jax

    from storage_tpu.basis import parse_basis_functions
    from storage_tpu.engines import lsmc as lsmc_engine
    from storage_tpu.models import multi_factor as mf
    from storage_tpu.parallel import mesh as pmesh
    from storage_tpu.valuation_inputs import prepare_valuation

    storage, val_date, inventory, fwd, rate = _facility()
    inputs = prepare_valuation(storage, val_date, inventory, fwd, rate, None)
    factors, corrs = mf.create_3_factor_seasonal_params(
        "D", MODEL["spot_mean_reversion"], MODEL["spot_vol"],
        MODEL["long_term_vol"], MODEL["seasonal_vol"], inputs.periods[0],
        storage.end,
    )
    pre = mf.simulation_precompute(
        factors, corrs, inputs.val_day, list(inputs.periods), "D"
    )
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, NUM_GRID, dtype,
    )
    return {
        "inputs": inputs,
        "arrays": arrays,
        "sim_inputs": pmesh.sim_inputs_from_precompute(pre, inputs.fwd, dtype),
        "monomials": tuple(parse_basis_functions(BASIS)),
        "keys": (jax.random.key(SEED), jax.random.key(FWD_SEED)),
        "core": dict(
            num_extra_decisions=num_extra_decisions, discount_deltas=False,
            terminal_fn=inputs.compiled.terminal_value, ratchet_is_step=False,
        ),
    }


def _simulate_one(case, key, num_sims):
    import jax.numpy as jnp

    from storage_tpu.models.spot_sim import simulate_ou_paths

    si = case["sim_inputs"]
    return simulate_ou_paths(key, jnp.arange(num_sims), si["decay"], si["chol"],
                             si["vols"], si["half_var"], si["fwd"])


def _simulate(case, num_sims):
    """The regression and valuation path sets of the API's two seeds."""
    return [_simulate_one(case, key, num_sims) for key in case["keys"]]


def _lsmc_core(case, reg, val, use_pallas):
    import jax.numpy as jnp

    from storage_tpu.engines import lsmc as lsmc_engine

    dtype = case["arrays"]["grids"].dtype
    return lsmc_engine.lsmc_core(
        case["arrays"], reg.spot, reg.factors, val.spot, val.factors,
        jnp.asarray(case["inputs"].starting_inventory, dtype),
        case["monomials"], use_pallas=use_pallas, **case["core"],
    )


# ----------------------------------------------------------------- phases
def phase_device_report():
    print("phase 1: device report", flush=True)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        _fail(f"no GPU: JAX reports platform {devices[0].platform!r}; "
              f"this script measures the GPU and has no CPU fallback.")
    import jaxlib
    import pandas

    from storage_tpu.parallel import mesh as pmesh
    from storage_tpu.utils.compile_cache import enable_compile_cache
    from storage_tpu.utils.device_info import (
        gpu_name_and_power_limit, jax_device_summary,
    )

    cache_dir = enable_compile_cache()
    summary = jax_device_summary()
    print(f"  platform={summary['platform']} kind={summary['kind']} "
          f"count={summary['count']}")
    print(gpu_name_and_power_limit(), flush=True)
    print(f"  jax={jax.__version__} jaxlib={jaxlib.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {cache_dir}")
    print(f"  pandas={pandas.__version__}")
    limit = (devices[0].memory_stats() or {}).get("bytes_limit")
    print(f"  device bytes_limit={limit} stream threshold="
          f"{pmesh.stream_threshold_bytes()} bytes")
    return summary


def phase_intrinsic_and_tree():
    print("phase 2: intrinsic and tree", flush=True)
    import jax
    import jax.numpy as jnp
    import pandas as pd

    from storage_tpu import CmdtyStorage, intrinsic_value, trinomial_value

    # README facility (reference intrinsic sample, NPV 10,827.21 in f64).
    storage = CmdtyStorage(
        "D", "2019-09-01", "2019-10-01", 0.48, 0.74,
        min_inventory=0.0, max_inventory=1100.74,
        max_injection_rate=5.26, max_withdrawal_rate=14.74,
    )
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    fwd = pd.Series(index=idx, data=[
        56.6 if p < pd.Period("2019-09-23", freq="D") else 56.6 + 87.81
        for p in idx
    ])
    res = intrinsic_value(storage, "2019-09-15", 50.0, fwd, 0.0, None,
                          num_inventory_grid_points=101, dtype=jnp.float32)
    print(f"  README intrinsic f32 NPV {res.npv!r}")
    _check(abs(res.npv / 10827.21 - 1.0) <= 2e-3,
           "README intrinsic within 0.2% of 10,827.21")

    # Golden: the regression facility's intrinsic (tests/test_goldens.py, f64).
    reg_storage = CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    ridx = pd.period_range(val_date, "2020-04-01", freq="D")
    rfwd = pd.Series(index=ridx, data=[
        23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in ridx
    ])
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"),
                      data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    golden = intrinsic_value(reg_storage, val_date, 0.0, rfwd, rates, settle,
                             dtype=jnp.float32)
    print(f"  golden-facility intrinsic f32 NPV {golden.npv!r}")
    _check(abs(golden.npv / 1_705_564.2806059965 - 1.0) <= 1e-3,
           "intrinsic within 0.1% of the f64 golden 1,705,564.28")

    vols = pd.Series(index=pd.period_range("2019-09-15", "2019-10-31", freq="D"),
                     data=0.45)
    tree = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            tree[dtype] = trinomial_value(
                storage, "2019-09-15", 50.0, fwd, vols, 5.5, 1 / 365.0, 0.0,
                None, num_inventory_grid_points=101, dtype=dtype,
            )
    print(f"  README tree NPV f32 {tree[jnp.float32]!r} f64 {tree[jnp.float64]!r}")
    _check(abs(tree[jnp.float32] / tree[jnp.float64] - 1.0) <= 1e-3,
           "tree f32 within 0.1% of the f64 tree on the card")
    _check(tree[jnp.float32] >= res.npv * (1 - 1e-3),
           "tree value >= intrinsic value")


def phase_headline():
    print(f"phase 3: headline valuation, {NUM_SIMS} paths x {NUM_STEPS} steps "
          f"x {NUM_GRID} grid, f32", flush=True)
    import numpy as np

    t_first = time.perf_counter()
    res = _value(NUM_SIMS)
    t_first = time.perf_counter() - t_first
    med, times, res = _median_time(lambda: _value(NUM_SIMS))
    print(f"  NPV {res.npv!r} SE {res.val_sim_standard_error!r} "
          f"intrinsic {res.intrinsic_npv!r}")
    print(f"  first call {t_first:.3f} s (compile included); warm wall "
          f"median {med:.4f} s of {times}")
    print(f"  {NUM_SIMS * NUM_STEPS / med:.1f} paths*steps/s end to end")
    _check(np.isfinite(res.npv) and np.isfinite(res.val_sim_standard_error)
           and res.val_sim_standard_error > 0, "NPV and SE finite")
    _check(len(res.deltas) == NUM_STEPS + 1
           and bool(np.isfinite(res.deltas.to_numpy()).all()),
           "deltas finite, one per period")
    _check(len(res.trigger_prices) == NUM_STEPS and res.trigger_prices.shape[1] > 0,
           "trigger prices present, one row per decision period")
    return res


def phase_reference():
    print("phase 4: f32 engine vs the f64 XLA engine on the same paths", flush=True)
    import jax
    import jax.numpy as jnp

    from storage_tpu.engines import lsmc as lsmc_engine

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        case64 = _engine_case(jnp.float64)
        reg64, val64 = _simulate(case64, NUM_SIMS)
        r64 = _lsmc_core(case64, reg64, val64, use_pallas=False)
        npv64, se64 = float(r64["npv"]), float(r64["standard_error"])
        spot32 = [p.spot.astype(jnp.float32) for p in (reg64, val64)]
        fac32 = [p.factors.astype(jnp.float32) for p in (reg64, val64)]
        del r64, reg64, val64
    case32 = _engine_case(jnp.float32)
    use_pallas = lsmc_engine.resolve_use_pallas(None, jnp.float32)
    r32 = lsmc_engine.lsmc_core(
        case32["arrays"], spot32[0], fac32[0], spot32[1], fac32[1],
        jnp.asarray(case32["inputs"].starting_inventory, jnp.float32),
        case32["monomials"], use_pallas=use_pallas, **case32["core"],
    )
    npv32 = float(r32["npv"])
    rel = abs(npv32 / npv64 - 1.0)
    print(f"  f32 ({'kernel' if use_pallas else 'xla'}) NPV {npv32!r}; f64 NPV "
          f"{npv64!r} SE {se64!r}; rel diff {rel:.3e}; |dNPV|/SE "
          f"{abs(npv32 - npv64) / se64:.3f}")
    _check(rel <= 2e-3, "NPV relative difference <= 2e-3")
    _check(abs(npv32 - npv64) < 0.5 * se64, "|dNPV| < 0.5 SE")


def phase_kernel_vs_xla():
    print("phase 5: Pallas decision kernel vs the XLA body", flush=True)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from storage_tpu.engines import lsmc as lsmc_engine
    from storage_tpu.ops import decision_kernel

    f32 = jnp.float32
    case = _engine_case(f32)
    reg, val = _simulate(case, NUM_SIMS)
    arrays, monomials = case["arrays"], case["monomials"]
    terminal_fn = case["core"]["terminal_fn"]
    n = NUM_STEPS

    # Per-step inputs of the real backward pass, and its full-horizon
    # comparison: carry the XLA values and evaluate both updates on them.
    def step_inputs(extra):
        per_step = lsmc_engine._backward_per_step(arrays)
        per_step.update(lsmc_engine._backward_prep_all(per_step, extra, False))
        per_step["spot"] = reg.spot[:n]
        per_step["factors"] = reg.factors[:n]
        return per_step

    v_end = lsmc_engine._terminal_values(
        terminal_fn, reg.spot[n], arrays["grids"][n], NUM_GRID, NUM_SIMS, f32)

    @jax.jit
    def mismatch_by_step(per_step, v_end):
        def body(v, x):
            dm = lsmc_engine.design_matrix(monomials, x["spot"], x["factors"])
            mean, std = lsmc_engine.column_stats(dm, None)
            dm_std = (dm - mean) / std
            coeffs = lsmc_engine.fit_continuation(dm_std, v.T, None)
            ci = lsmc_engine._interp_coeffs(coeffs, x)
            args = (x["spot"], ci, x["idx_lo"], x["w_hi"], x["prep_a"], x["prep_b"])
            want = lsmc_engine.decision_update_xla(v, dm_std, *args)
            got = decision_kernel.decision_update_auto(v, dm_std.T, *args)
            rel = jnp.abs(got - want) / jnp.maximum(jnp.abs(want), 1e-30)
            return want, jnp.sum(rel > 1e-5)

        return jax.lax.scan(body, v_end, per_step, reverse=True)[1]

    for extra in (0, 1):
        d = 2 * extra + 3
        per_step = step_inputs(extra)
        counts = np.asarray(mismatch_by_step(per_step, v_end))
        share = counts.sum() / (n * NUM_GRID * NUM_SIMS)
        print(f"  D={d}: best_act entries beyond 1e-5 relative: {int(counts.sum())} "
              f"of {n * NUM_GRID * NUM_SIMS} (share {share:.3e}; worst step "
              f"{int(counts.max())})")
        _check(share <= 1e-4, f"D={d} mismatch share <= 1e-4")

        # Per-step time of the update alone, and of the whole backward pass.
        x = jax.tree.map(lambda a: a[n // 2], per_step)
        dm = lsmc_engine.design_matrix(monomials, x["spot"], x["factors"])
        mean, std = lsmc_engine.column_stats(dm, None)
        dm_std = (dm - mean) / std
        coeffs = jnp.asarray(np.random.default_rng(0).normal(
            0.0, 10.0, (len(monomials), NUM_GRID)), f32)
        ci = lsmc_engine._interp_coeffs(coeffs, x)
        v0 = jnp.broadcast_to(reg.spot[n][None, :] * arrays["grids"][n][:, None],
                              (NUM_GRID, NUM_SIMS)).astype(f32)
        args = (x["spot"], ci, x["idx_lo"], x["w_hi"], x["prep_a"], x["prep_b"])
        k_steps = 64

        def chain(update):
            @jax.jit
            def run(v, dm_std, args):
                return jax.lax.scan(lambda c, _: (update(c, dm_std, args), None),
                                    v, None, length=k_steps)[0]
            return lambda: run(v0, dm_std, args)

        t_k, _, _ = _median_time(chain(
            lambda v, dm, a: decision_kernel.decision_update_auto(v, dm.T, *a)))
        t_x, _, _ = _median_time(chain(
            lambda v, dm, a: lsmc_engine.decision_update_xla(v, dm, *a)))
        print(f"  D={d}: decision update per step: kernel {t_k / k_steps * 1e6:.1f} us, "
              f"XLA {t_x / k_steps * 1e6:.1f} us (median of 3, {k_steps}-step chains)")

        def backward(use_pallas):
            fn = jax.jit(lambda s, f: lsmc_engine.lsmc_backward(
                arrays, s, f, monomials, extra, terminal_fn, False, None,
                use_pallas=use_pallas)[0])
            return lambda: fn(reg.spot, reg.factors)

        tb_k, _, _ = _median_time(backward(True))
        tb_x, _, _ = _median_time(backward(False))
        print(f"  D={d}: backward pass: kernel {tb_k * 1e3:.2f} ms "
              f"({tb_k / n * 1e6:.1f} us/step), XLA {tb_x * 1e3:.2f} ms "
              f"({tb_x / n * 1e6:.1f} us/step)")

    # End to end on the same paths: NPV agreement and the whole valuation's
    # time with and without the kernel, plus the phase split of the XLA run.
    r_k = _lsmc_core(case, reg, val, use_pallas=True)
    r_x = _lsmc_core(case, reg, val, use_pallas=False)
    npv_k, npv_x = float(r_k["npv"]), float(r_x["npv"])
    se = float(r_x["standard_error"])
    print(f"  NPV kernel {npv_k!r} XLA {npv_x!r} SE {se!r}; |dNPV|/SE "
          f"{abs(npv_k - npv_x) / se:.4f}")
    _check(abs(npv_k - npv_x) <= 0.1 * se, "NPV with and without kernel within 0.1 SE")
    te_k, times_k, _ = _median_time(lambda: _lsmc_core(case, reg, val, True))
    te_x, times_x, _ = _median_time(lambda: _lsmc_core(case, reg, val, False))
    print(f"  lsmc_core (backward + forward) on materialised paths: kernel "
          f"{te_k * 1e3:.2f} ms {times_k}, XLA {te_x * 1e3:.2f} ms {times_x}; "
          f"kernel {'faster' if te_k < te_x else 'NOT faster'} end to end "
          f"({te_x / te_k:.3f}x)")

    sim = jax.jit(lambda key: _simulate_one(case, key, NUM_SIMS))
    t_sim, _, _ = _median_time(lambda: sim(case["keys"][0]))
    payload = jax.jit(lambda s, f: lsmc_engine.lsmc_backward(
        arrays, s, f, monomials, 0, terminal_fn, False, None,
        use_pallas=lsmc_engine.resolve_use_pallas(None, f32))[1])(
            reg.spot, reg.factors)
    fwd = jax.jit(lambda s, f, p: lsmc_engine.lsmc_forward(
        arrays, s, f, p, jnp.asarray(case["inputs"].starting_inventory, f32),
        monomials, 0, False, terminal_fn, False, None, False)["npv"])
    t_fwd, _, _ = _median_time(lambda: fwd(val.spot, val.factors, payload))
    print(f"  phase split: simulate one path set {t_sim * 1e3:.2f} ms, forward "
          f"pass {t_fwd * 1e3:.2f} ms = {t_fwd / te_k:.1%} of lsmc_core with "
          f"the default body")


class _ModeLog(logging.Handler):
    """Collects the engine's execution-path log lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_1m(headline):
    print(f"phase 6: {NUM_SIMS_1M} paths, auto-selected and forced streaming",
          flush=True)
    import math

    from storage_tpu.parallel import mesh as pmesh

    log = logging.getLogger("storage_tpu.parallel")
    handler = _ModeLog()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        runs = {}
        for label in ("auto", "streamed"):
            saved = pmesh.STREAM_THRESHOLD_BYTES
            if label == "streamed":
                pmesh.STREAM_THRESHOLD_BYTES = 1024
            try:
                handler.lines.clear()
                t0 = time.perf_counter()
                res = _value(NUM_SIMS_1M)
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                res = _value(NUM_SIMS_1M)
                warm = time.perf_counter() - t0
            finally:
                pmesh.STREAM_THRESHOLD_BYTES = saved
            mode = next((l for l in handler.lines if "LSMC execution" in l), "?")
            runs[label] = res
            print(f"  {label}: {mode}")
            print(f"  {label}: NPV {res.npv!r} SE {res.val_sim_standard_error!r}; "
                  f"first call {first:.3f} s, second {warm:.3f} s")
    finally:
        log.removeHandler(handler)
    a, s = runs["auto"], runs["streamed"]
    _check(abs(a.npv / s.npv - 1.0) <= 1e-3,
           "auto and streamed 1M NPVs agree within 1e-3 relative")
    for label, r in runs.items():
        comb = math.hypot(r.val_sim_standard_error, headline.val_sim_standard_error)
        _check(abs(r.npv - headline.npv) <= 3 * comb,
               f"{label} 1M NPV within 3 combined SE of the 262k NPV")


def phase_four_cards():
    print(f"four cards: {NUM_SIMS_1M} paths path-sharded over all devices", flush=True)
    import jax
    import jax.numpy as jnp

    from storage_tpu.parallel import mesh as pmesh

    n_dev = len(jax.devices())
    _check(n_dev == 4, f"4 devices visible (have {n_dev})")
    t0 = time.perf_counter()
    res = _value(NUM_SIMS_1M)
    first = time.perf_counter() - t0
    t_api, times_api, res = _median_time(lambda: _value(NUM_SIMS_1M))
    print(f"  API on 4 cards: NPV {res.npv!r} SE {res.val_sim_standard_error!r}; "
          f"first {first:.3f} s, warm median {t_api:.4f} s of {times_api}")

    def memory(stat):
        return [(d.memory_stats() or {}).get(stat) for d in jax.devices()]

    print(f"  peak_bytes_in_use per card after the 4-card runs: "
          f"{memory('peak_bytes_in_use')}")

    case = _engine_case(jnp.float32)

    def engine(n_dev):
        return lambda: pmesh.sharded_lsmc_core(
            pmesh.make_mesh(n_dev), case["arrays"], case["sim_inputs"],
            *case["keys"], NUM_SIMS_1M, case["inputs"].starting_inventory,
            case["monomials"], **case["core"])

    t_4, times_4, _ = _median_time(engine(4))
    t_1, times_1, ref = _median_time(engine(1))
    npv1, se1 = float(ref["npv"]), float(ref["standard_error"])
    print(f"  sharded_lsmc_core on make_mesh(4): warm median {t_4:.4f} s of {times_4}")
    print(f"  sharded_lsmc_core on make_mesh(1): NPV {npv1!r} SE {se1!r}; warm "
          f"median {t_1:.4f} s of {times_1}")
    print(f"  peak_bytes_in_use per card after the 1-card run: "
          f"{memory('peak_bytes_in_use')}")
    print(f"  |dNPV|/SE {abs(res.npv - npv1) / se1:.4f}; engine time 1 card / "
          f"4 cards {t_1 / t_4:.3f}")
    _check(abs(res.npv - npv1) <= 0.25 * se1, "4-card NPV within 0.25 SE of 1 card")


def main(argv):
    summary = phase_device_report()
    if "--four-cards" in argv:
        phase_four_cards()
    else:
        phase_intrinsic_and_tree()
        headline = phase_headline()
        phase_reference()
        phase_kernel_vs_xla()
        phase_1m(headline)
    print(json.dumps({"ok": True, "device": summary}))


if __name__ == "__main__":
    main(sys.argv[1:])
