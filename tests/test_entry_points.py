"""Entry-point plumbing: the compile-cache location and chip_smoke's refusal
to run anywhere but on a GPU."""

from pathlib import Path

import jax
import pytest

from audio_modem_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env itself


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
