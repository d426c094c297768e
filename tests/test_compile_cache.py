"""The persistent compilation cache has one fixed location per checkout,
or the one JAX_COMPILATION_CACHE_DIR names (fdoct_tpu.utils.compile_cache)."""

from pathlib import Path

import jax
import pytest

from fdoct_tpu.utils.compile_cache import enable_compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield old
    jax.config.update("jax_compilation_cache_dir", old)


def test_checkout_dir_when_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first, second = enable_compile_cache(), enable_compile_cache()
    assert first == second == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    first, second = enable_compile_cache(), enable_compile_cache()
    assert first == second == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir
