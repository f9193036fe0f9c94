"""One rule for the persistent compilation cache
(ida_tpu/utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR wins and
nothing is set in code; otherwise one fixed, git-ignored directory inside
the checkout. Never a path made from a temporary name, a pid or a time."""

import os
import subprocess
import sys

import jax

from ida_tpu.utils.compile_cache import DEFAULT_CACHE_DIR, REPO_ROOT, enable_compile_cache


def test_env_variable_is_honoured_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_directory_in_the_checkout():
    """Two processes without the variable land on the same directory,
    <checkout>/.jax_cache, which git ignores."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import jax; from ida_tpu.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "assert jax.config.jax_compilation_cache_dir == d; print(d)")
    seen = {
        subprocess.run(
            [sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout.strip()
        for _ in range(2)
    }
    assert seen == {str(REPO_ROOT / ".jax_cache")} == {str(DEFAULT_CACHE_DIR)}
    ignored = (REPO_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
