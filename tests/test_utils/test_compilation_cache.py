"""Persistent compilation cache: placement and cross-process reuse."""

import os
import subprocess
import sys

import jax
import pytest

import dynode_tpu.utils.compilation_cache as cc
from dynode_tpu.utils import compilation_cache_dir, enable_compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = r"""
import sys, time
import jax
jax.config.update("jax_platforms", "cpu")
from dynode_tpu.utils import enable_compilation_cache
d = enable_compilation_cache(sys.argv[1], min_compile_time_secs=0.0)
assert d == sys.argv[1], (d, sys.argv[1])
import jax.numpy as jnp

@jax.jit
def f(x):
    return jnp.sin(x) @ jnp.cos(x.T) + jnp.tanh(x).sum()

x = jnp.ones((257, 129), jnp.float32)
t0 = time.perf_counter()
f(x).block_until_ready()
print("ELAPSED", time.perf_counter() - t0)
"""


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process."""
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.__setitem__(name, value)
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("DYNODE_COMPILATION_CACHE", raising=False)
    return calls


def _run_child(cache_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(cache_dir)],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    for line in out.stdout.splitlines():
        if line.startswith("ELAPSED"):
            return float(line.split()[1])
    raise AssertionError(out.stdout + out.stderr)


def test_cache_populates_and_second_process_hits(tmp_path):
    cache = tmp_path / "xla_cache"
    cold = _run_child(cache)
    entries = [
        f for _, _, fs in os.walk(cache) for f in fs
    ]
    assert entries, "cache directory empty after first process"
    warm = _run_child(cache)
    # a disk hit skips compilation entirely; require a decisive win so the
    # test stays meaningful on loaded hosts
    assert warm < cold * 0.6, (cold, warm)


def test_env_killswitch(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("DYNODE_COMPILATION_CACHE", "off")
    assert enable_compilation_cache(str(tmp_path / "never")) == ""
    assert not (tmp_path / "never").exists()
    assert config_updates == {}


def test_default_dir_respects_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "d"))
    assert compilation_cache_dir() == str(tmp_path / "d")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compilation_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_default_dir_is_fixed_and_gitignored(config_updates):
    """No temporary, process-id or time-based component: two calls (and
    two processes) agree, and the checkout's .gitignore lists the dir."""
    d = compilation_cache_dir()
    assert d == compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in d
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_dir_wins_and_is_not_overridden(monkeypatch, tmp_path,
                                            config_updates):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert enable_compilation_cache(str(tmp_path / "explicit")) == env_dir
    # JAX reads the variable itself; no other directory is configured
    assert "jax_compilation_cache_dir" not in config_updates
    assert not (tmp_path / "explicit").exists()
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_explicit_path_without_env(tmp_path, config_updates):
    d = str(tmp_path / "explicit")
    assert enable_compilation_cache(d, min_compile_time_secs=0.0) == d
    assert os.path.isdir(d)
    assert config_updates["jax_compilation_cache_dir"] == d
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


@pytest.mark.parametrize("platform,enabled", [("cpu", False), ("gpu", True)])
def test_fits_enable_cache_off_cpu(monkeypatch, platform, enabled):
    import dynode_tpu.infer.inference as inference

    calls = []
    monkeypatch.setattr(inference.jax, "default_backend", lambda: platform)
    monkeypatch.setattr(cc, "enable_compilation_cache",
                        lambda: calls.append(1) or "")
    inference._enable_compile_cache()
    assert bool(calls) is enabled
