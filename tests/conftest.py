"""Test configuration: CPU JAX with 8 virtual devices so sharding tests run
anywhere (SURVEY.md §4)."""

import os

import pytest

# the suite runs on the CPU whatever accelerator the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402  (must configure before backend init)

try:
    # both updates are required: setting jax_platforms via config (not just
    # the env var) is what makes jax_num_cpu_devices take effect
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    pass  # backend already initialized

# persistent compilation cache (JAX_COMPILATION_CACHE_DIR when set, else
# <checkout>/.jax_cache): cache entries are keyed by the program, so
# correctness is unaffected
from pctpu.runtime.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

@pytest.fixture
def gpu():
    """The first GPU device.  Skips where JAX has none: the suite runs on
    the CPU, and chip_smoke.py runs the GPU checks on a card."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (chip_smoke.py runs this check on one)")


# opt-in line coverage (no coverage.py in this environment): PCTPU_COV=<out.json>
_cov_out = os.environ.get("PCTPU_COV")
if _cov_out:
    from tests import covtrace

    covtrace.start()

    def pytest_sessionfinish(session, exitstatus):
        covtrace.dump(_cov_out)
