"""utils.compile_cache: one fixed cache directory for every entry point."""

import jax
import pytest

from pyspectrogram_tpu.utils import compile_cache


@pytest.fixture
def updates(monkeypatch):
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.append((name, value)))
    return seen


def test_env_var_wins_and_nothing_is_set(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() is None
    assert updates == []


def test_default_is_fixed_checkout_dir(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    again = compile_cache.enable_compile_cache()
    assert first == again == compile_cache.CHECKOUT / ".jax_cache"
    assert (compile_cache.CHECKOUT / "pyspectrogram_tpu").is_dir()
    assert updates == [("jax_compilation_cache_dir", str(first))] * 2


def test_cli_main_configures_the_cache(monkeypatch, capsys):
    from pyspectrogram_tpu.clients import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1))
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert calls == [1]
