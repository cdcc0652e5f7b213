"""Where the persistent compilation cache lives (utils/jaxcache.py)."""

from pathlib import Path

import jax
import pytest

from uvaia_tpu.utils import jaxcache

REPO = Path(__file__).resolve().parents[1]


def _enable(monkeypatch, backend: str) -> dict:
    """Run jaxcache.enable() as on `backend`; returns the config
    updates it made."""
    updates = {}
    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    jaxcache.enable()
    return updates


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it
    stands: no other directory is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _enable(monkeypatch, "gpu")
    assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_cache_fallback_is_fixed_and_in_checkout(monkeypatch, backend):
    """Without the variable a GPU run caches in .jax_cache/ at the
    checkout root — the same path every run, listed in .gitignore; a
    CPU run caches nothing."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _enable(monkeypatch, backend)
    if backend == "cpu":
        assert updates == {}
        return
    assert jaxcache.CACHE_DIR == REPO / ".jax_cache"
    assert updates["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    assert _enable(monkeypatch, backend) == updates      # fixed path


@pytest.mark.parametrize("layout", ["unwritable", "installed"])
def test_cache_fallback_off_without_writable_checkout(monkeypatch, tmp_path,
                                                      layout):
    """Where .jax_cache/ cannot be made (its parent is not a writable
    directory), or the package was installed away from its checkout,
    enable() runs uncached instead of raising."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if layout == "unwritable":
        # a file where the checkout root should be: mkdir fails even
        # for a user that ignores permission bits
        root = tmp_path / "root"
        root.write_text("")
        cache = root / ".jax_cache"
    else:
        site = tmp_path / "site-packages"
        site.mkdir()
        cache = jaxcache._checkout_cache(site)
        assert cache is None
        (site / "pyproject.toml").write_text("")
        assert jaxcache._checkout_cache(site) == site / ".jax_cache"
    monkeypatch.setattr(jaxcache, "CACHE_DIR", cache)
    assert _enable(monkeypatch, "gpu") == {}
