"""Run-time configuration: compile cache, streaming threshold, device report
and the refusal of the GPU-only scripts to run elsewhere."""
import os
import subprocess
import sys

import jax
import pytest

from storage_tpu.parallel import mesh as pmesh
from storage_tpu.utils import compile_cache, device_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_set_wins(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_compile_cache_defaults_inside_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_threshold_is_fraction_of_device_limit(monkeypatch):
    monkeypatch.delenv(pmesh.STREAM_THRESHOLD_ENV, raising=False)
    limit = 60 * 2**30
    got = pmesh.default_stream_threshold(_FakeDevice({"bytes_limit": limit}))
    assert got == int(limit * pmesh.STREAM_THRESHOLD_FRACTION)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_threshold_fallback_without_limit(monkeypatch, stats):
    monkeypatch.delenv(pmesh.STREAM_THRESHOLD_ENV, raising=False)
    got = pmesh.default_stream_threshold(_FakeDevice(stats))
    assert got == pmesh.STREAM_THRESHOLD_FALLBACK_BYTES


def test_threshold_env_override(monkeypatch):
    monkeypatch.setenv(pmesh.STREAM_THRESHOLD_ENV, "12345")
    assert pmesh.default_stream_threshold(_FakeDevice({"bytes_limit": 10**12})) == 12345


def test_threshold_resolved_once(monkeypatch):
    monkeypatch.delenv(pmesh.STREAM_THRESHOLD_ENV, raising=False)
    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", None)
    first = pmesh.stream_threshold_bytes()
    assert first == pmesh.STREAM_THRESHOLD_FALLBACK_BYTES  # the CPU has no limit
    monkeypatch.setattr(pmesh, "STREAM_THRESHOLD_BYTES", 1024)
    assert pmesh.stream_threshold_bytes() == 1024


def test_gpu_report_without_nvidia_smi(monkeypatch):
    def missing(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert device_info.gpu_name_and_power_limit().startswith("nvidia-smi unavailable")


def test_device_summary_names_the_backend():
    summary = device_info.jax_device_summary()
    assert summary == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())}


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_device_report()
    assert exc.value.code != 0
    assert "no GPU" in capsys.readouterr().err


def test_bench_refuses_cpu_without_flag(monkeypatch, capsys):
    sys.path.insert(0, REPO)
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 2
    assert "--cpu" in capsys.readouterr().err
