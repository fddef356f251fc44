"""Compile-cache location: JAX_COMPILATION_CACHE_DIR when set (and no
other directory), else the fixed in-checkout default."""

import jax
import pytest

from faid.utils import cache


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_rule(tmp_path, monkeypatch, env_set):
    default = tmp_path / "default"
    env_dir = tmp_path / "from_env"
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = env_dir if env_set else default
    assert cache.cache_dir(default) == want

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    cache.enable_compilation_cache(default)
    assert updates["jax_compilation_cache_dir"] == str(want)
    assert want.is_dir()
    assert not (env_dir if not env_set else default).exists()
