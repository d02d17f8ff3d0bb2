"""Process-level setup: where the compile cache lands, and the GPU smoke
script's refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

_CACHE_PROBE = r"""
import sypha, jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("case", ["env_var", "default"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured as set (the package sets no
    other); without it the cache is <checkout>/.jax_cache."""
    if case == "env_var":
        want = tmp_path / "cache"
        env = _env(JAX_COMPILATION_CACHE_DIR=str(want))
    else:
        want = REPO / ".jax_cache"
        env = _env()
    # run from elsewhere, with the checkout on the path as an installed
    # package would be: the default must not depend on the working directory
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=tmp_path,
        env=dict(env, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert pathlib.Path(out.stdout.strip().splitlines()[-1]) == want
    assert want.is_dir() and any(want.iterdir())


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
