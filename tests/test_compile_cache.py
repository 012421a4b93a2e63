"""The persistent compilation cache helper (utils/device.enable_compile_cache)
and the contract of chip_smoke.py off the GPU."""

import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.utils import device

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.append((name, value))
    )
    return calls


def test_env_var_wins(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert device.enable_compile_cache() == "/somewhere/cache"
    assert config_updates == []


def test_default_is_fixed_checkout_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.enable_compile_cache()
    second = device.enable_compile_cache()
    assert first == second == str(REPO_ROOT / ".jax_cache")
    assert not first.startswith(tempfile.gettempdir())
    assert config_updates == [("jax_compilation_cache_dir", first)] * 2


def test_cache_dir_is_gitignored():
    ignored = (REPO_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize(
    "path",
    ["cli.py", "bench.py", "chip_smoke.py",
     "real_time_path_tracing_with_spatiotemporal_filtering/viewer.py"],
)
def test_entry_points_enable_the_cache(path):
    assert "enable_compile_cache()" in (REPO_ROOT / path).read_text()


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO_ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "bench.py")],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO_ROOT,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
