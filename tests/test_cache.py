"""The compile-cache helper (utils/cache.py)."""
import jax
import pytest

from path_tracer_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_is_left_alone(monkeypatch, tmp_path, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = cache.enable_compilation_cache()
    assert d == str(cache.CACHE_ROOT / "xla")
    assert jax.config.jax_compilation_cache_dir == d
    assert cache.CACHE_ROOT.parent == cache.Path(__file__).resolve().parents[1]


def test_cache_root_is_gitignored():
    ignored = (cache.CACHE_ROOT.parent / ".gitignore").read_text().split()
    assert f"{cache.CACHE_ROOT.name}/" in ignored
