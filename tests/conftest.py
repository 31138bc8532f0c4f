import jax
import pytest

# Smoke tests and kernels must see the single real CPU device; ONLY the
# dry-run (repro.launch.dryrun) sets xla_force_host_platform_device_count.
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running property/replay tests (deselect with "
        "-m 'not slow' for the fast CI job)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "without one (-m cuda runs only these)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
