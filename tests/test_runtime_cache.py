"""Persistent compilation cache placement (runtime/cache.py): JAX's own
JAX_COMPILATION_CACHE_DIR when set, else the fixed <checkout>/.cache/xla;
off for forced-CPU runs."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from cusdr_tpu.runtime import cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_default_is_fixed_checkout_path(monkeypatch, tmp_path,
                                        restore_cache_config):
    assert cache.CHECKOUT_CACHE == REPO / ".cache" / "xla"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "")
    monkeypatch.setattr(cache, "CHECKOUT_CACHE", tmp_path / "xla")
    got = cache.enable_persistent_cache()
    assert got == str(tmp_path / "xla")
    assert jax.config.jax_compilation_cache_dir == got
    assert (tmp_path / "xla").is_dir()


def test_env_dir_sets_no_directory(monkeypatch, tmp_path,
                                   restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PLATFORMS", "")
    monkeypatch.setattr(cache, "CHECKOUT_CACHE", tmp_path / "unused")
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / "unused").exists()


def test_forced_cpu_disables_cache(monkeypatch, restore_cache_config):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compiled_programs_land_in_env_dir(tmp_path):
    """End to end in a fresh process: with JAX_COMPILATION_CACHE_DIR set,
    a compiled program is written there and nowhere in the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = (
        "import jax, jax.numpy as jnp\n"
        "from cusdr_tpu.runtime.cache import enable_persistent_cache\n"
        "print(enable_persistent_cache())\n"
        "jax.config.update("
        "'jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes',"
        " 0)\n"
        "f = jax.jit(lambda x: jnp.sin(x) @ x.T)\n"
        "print(float(f(jnp.ones((64, 64))).sum()))\n")
    before = sorted(cache.CHECKOUT_CACHE.glob("*")) \
        if cache.CHECKOUT_CACHE.exists() else []
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0] == str(tmp_path / "cc")
    assert any((tmp_path / "cc").iterdir())
    after = sorted(cache.CHECKOUT_CACHE.glob("*")) \
        if cache.CHECKOUT_CACHE.exists() else []
    assert after == before
