"""pctpu.runtime.platform: the per-platform choices and the compile cache."""

import os
import subprocess
import sys

import pytest

from pctpu.runtime import platform
from pctpu.runtime.platform import platform_choice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name, nn, batch, fold", [
    ("gpu", "pruned", 16, "kernel"),
    ("cpu", "xla", 1, "scatter"),
])
def test_platform_choice(name, nn, batch, fold):
    c = platform_choice(name)
    assert (c.nn_impl, c.pair_batch, c.ordered_sum) == (nn, batch, fold)


def test_platform_choice_reads_first_device():
    """Without an argument the choice follows jax.devices()[0] (the CPU
    here), so no code path picks a GPU kernel on the CPU."""
    assert platform_choice() == platform_choice("cpu")


def test_platform_choice_rejects_unknown_platform():
    with pytest.raises(ValueError, match="unsupported platform 'rocm'"):
        platform_choice("rocm")


def test_icp_auto_resolves_through_platform_choice(monkeypatch):
    """ops.icp's nn_impl="auto" asks the platform module (the one place that
    chooses): a recording stub sees the call."""
    import numpy as np

    from pctpu.config import IcpConfig
    from pctpu.ops import icp

    calls = []

    def choice():
        calls.append(1)
        return platform_choice("cpu")

    monkeypatch.setattr(icp, "platform_choice", choice)
    import jax.numpy as jnp

    pts = jnp.asarray(np.random.default_rng(0).uniform(-5, 5, (64, 3)),
                      jnp.float32)
    ok = jnp.ones(64, bool)
    icp._icp_impl(pts, ok, pts, ok, jnp.eye(4, dtype=jnp.float32),
                  IcpConfig(max_correspondence_distance=1.0, max_iterations=1),
                  None, None, nn_tile=64)
    assert calls


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from pctpu.runtime.platform import "
            "enable_compile_cache as e; d = e(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split("\n")[:2]


def test_compile_cache_defaults_to_checkout(tmp_path):
    """Unset variable: the fixed in-checkout path, set in JAX's config."""
    returned, configured = _cache_dir_in_child(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    """Set variable: that directory, and nothing set in code."""
    returned, configured = _cache_dir_in_child(str(tmp_path))
    assert returned == configured == str(tmp_path)


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
