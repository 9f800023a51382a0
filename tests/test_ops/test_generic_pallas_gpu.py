"""The compiled Triton kernel on a GPU (skips without one).

Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

The CPU suite covers the same kernel in interpret mode; these tests check
what only the GPU compiler decides: that the kernel lowers, compiles and
matches the ``lax`` reference, with padding and several blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.ops.generic_pallas as gp

pytestmark = pytest.mark.gpu


def sir_rhs(y, p, t):
    s, i, r = y
    beta, gamma = p
    inf = beta * s * i
    rec = gamma * i
    return [-inf, inf - rec, rec]


def _rows(batch):
    y0 = jnp.stack([
        jnp.full((batch,), 0.99), jnp.full((batch,), 0.01), jnp.zeros(batch)
    ])
    p = jnp.stack([jnp.linspace(0.2, 0.5, batch), jnp.full((batch,), 0.1)])
    return y0.astype(jnp.float32), p.astype(jnp.float32)


@pytest.mark.parametrize("method", ["rk4", "tsit5", "bosh3"])
def test_compiled_constant_step_matches_reference(gpu_device, method):
    assert gp.kernel_route() == "triton"
    with jax.default_device(gpu_device):
        y0, p = _rows(1000)  # not a multiple of the block: padded
        out = gp.ensemble_solve_kernel(
            sir_rhs, y0, p, duration=20.0, dt=0.5, method=method,
            save_rows=(1, 2),
        )
        ref = gp.ensemble_solve_kernel_reference(
            sir_rhs, y0, p, duration=20.0, dt=0.5, method=method,
        )[:, [1, 2]]
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-7
    )


def test_compiled_adaptive_matches_one_block_reference(gpu_device):
    """With one block of all members the kernel's controller decisions are
    the reference's."""
    with jax.default_device(gpu_device):
        y0, p = _rows(128)
        out, stats = gp.ensemble_solve_kernel_adaptive(
            sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8, block_b=128,
        )
        ref, rstats = gp.ensemble_solve_kernel_adaptive_reference(
            sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
        )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-7
    )
    for key in ("exhausted_intervals", "n_accepted", "n_rejected"):
        assert int(stats[key][0]) == int(rstats[key][0]), key
