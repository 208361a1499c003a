"""The persistent compilation cache sits at one fixed directory."""

import os
import subprocess
import sys

import pytest

from h263_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_child(code, **env):
    """Run `code` in a fresh interpreter (jax config is process-global)."""
    e = {k: v for k, v in os.environ.items()
         if k != compile_cache.ENV_VAR}
    e.update(env)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_default_dir_is_checkout_jax_cache():
    assert compile_cache.default_cache_dir() == os.path.join(
        ROOT, ".jax_cache")


def test_default_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_honours_env(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere/cache")
    assert compile_cache.cache_dir() == "/elsewhere/cache"
    monkeypatch.delenv(compile_cache.ENV_VAR)
    assert compile_cache.cache_dir() == compile_cache.default_cache_dir()


def test_env_set_means_nothing_set_in_code():
    code = ("import jax; from h263_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d, jax.config.jax_compilation_cache_dir)")
    got = _in_child(code, JAX_COMPILATION_CACHE_DIR="/x/y")
    assert got == "/x/y /x/y"  # JAX read the variable itself


def test_env_unset_uses_fixed_checkout_path():
    code = ("import jax; from h263_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d == jax.config.jax_compilation_cache_dir, d)")
    got = _in_child(code)
    assert got == f"True {os.path.join(ROOT, '.jax_cache')}"


@pytest.mark.parametrize("tmpdir_env", ["/tmp", "/var/tmp/other"])
def test_path_depends_on_no_temp_dir_pid_or_time(tmpdir_env):
    code = ("from h263_tpu.utils.compile_cache import default_cache_dir; "
            "print(default_cache_dir())")
    assert _in_child(code, TMPDIR=tmpdir_env) == os.path.join(
        ROOT, ".jax_cache")
