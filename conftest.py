"""Root conftest: run the suite on the CPU with a virtual 8-device mesh.

Tests run on the local CPU (fast compiles, x64 for tight numerical
oracles) unless ``JAX_PLATFORMS`` names other platforms: the tests marked
``gpu`` need a card and run there with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Whether a card is present is decided inside the ``gpu_device`` fixture, at
test time, so every worker collects the same tests. Multi-device sharding
tests use the 8 virtual host devices.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# ---------------------------------------------------------------------------
# smoke tier: `pytest -m smoke` = a <5-min-on-1-core contract subset
# (config cascade, ODE engine contracts, handler/sample site contract, one
# conjugate MCMC end-to-end, the minimal example). The full suite is ~6 min
# on a multi-core host but >60 min on 1 core; constrained environments (CI
# snapshot drivers) run the smoke tier first so a timeout can never report
# nothing. Modules are marked here by path so test files stay marker-free.
# ---------------------------------------------------------------------------

_SMOKE_PREFIXES = (
    "tests/test_config/",
    "tests/test_ode/test_engine.py",
    "tests/test_simulation/test_odes.py",
    "tests/test_infer/test_handlers_and_sample.py",
    "tests/test_infer/test_checkpointing.py",
    "tests/test_infer/test_inference.py",
    "tests/test_parity/",
)
_SMOKE_NODEIDS = (
    "tests/test_examples/test_examples_run.py::test_example_runs_headless[sir.py]",
)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at import."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
            "-m gpu tests/"
        )


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.replace("\\", "/")
        if nodeid.startswith(_SMOKE_PREFIXES) or nodeid in _SMOKE_NODEIDS:
            item.add_marker(pytest.mark.smoke)
