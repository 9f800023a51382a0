"""Generic whole-solve kernel correctness (interpret mode on CPU).

The rows-RHS contract is validated three ways: against the generic ODE
engine (`simulate`) on SIR, against the closed form on a time-dependent
forcing (stage times), and against the multistrain model solved by the
generic engine. The Triton kernel itself runs here with ``interpret=True``
and is compared with the ``lax`` reference; on a GPU ``chip_smoke.py``
compares the compiled kernel with the same reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dynode_tpu.ops.generic_pallas as gp
from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.models import multistrain as ms
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)


def sir_rhs(y, p, t):
    """SIR in the rows idiom: y = [s, i, r], p = [beta, gamma]."""
    s, i, r = y
    beta, gamma = p
    inf = beta * s * i
    rec = gamma * i
    return [-inf, inf - rec, rec]


def _sir_rows(batch, seed=0):
    key = jax.random.PRNGKey(seed)
    beta = jax.random.uniform(key, (batch,), minval=0.2, maxval=0.5)
    gamma = jnp.full((batch,), 0.1)
    y0 = jnp.stack(
        [jnp.full((batch,), 0.99), jnp.full((batch,), 0.01),
         jnp.zeros(batch)], axis=0,
    )
    p = jnp.stack([beta, gamma], axis=0)
    return y0, p


def test_pack_unpack_roundtrip():
    B = 16
    leaves = [
        jnp.arange(2 * 3 * B, dtype=jnp.float32).reshape(2, 3, B),
        jnp.arange(B, dtype=jnp.float32),  # (B,) plain row
        jnp.float32(7.0),  # scalar -> broadcast
    ]
    packed, spec = gp.pack_rows(leaves, B)
    assert packed.shape == (2 * 3 + 1 + 1, B)
    out = gp.unpack_rows(packed, spec)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(leaves[0]))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(leaves[1]))
    assert np.all(np.asarray(out[2]) == 7.0)
    # leading time axis
    stacked = jnp.stack([packed, packed + 1.0], axis=0)
    out_t = gp.unpack_rows(stacked, spec)
    assert out_t[0].shape == (2, 2, 3, B)


def test_reference_matches_engine_sir():
    from dynode_tpu.simulation import AbstractODEParams
    from dynode_tpu.struct import pytree_dataclass

    @pytree_dataclass()
    class P(AbstractODEParams):
        beta: jnp.ndarray
        gamma: jnp.ndarray

    B = 8
    y0, p = _sir_rows(B)
    saves = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=50.0, dt=0.25,
    )
    assert saves.shape == (51, 3, B)
    sp = SolverParams(constant_step_size=0.25)

    def ode(t, y, params):
        s, i, r = y
        inf = params.beta * s * i
        rec = params.gamma * i
        return (-inf, inf - rec, rec)

    for member in (0, 3, 7):
        sol = simulate(
            ode, 50.0,
            (y0[0, member], y0[1, member], y0[2, member]),
            P(beta=p[0, member], gamma=p[1, member]), sp,
        )
        for row, comp in enumerate(sol.ys):
            np.testing.assert_allclose(
                np.asarray(saves[:, row, member]), np.asarray(comp),
                rtol=1e-5, atol=1e-7,
            )


def test_time_dependent_stage_times():
    """y' = cos(t) -> y = sin(t): wrong stage times would show instantly."""
    B = 8

    def rhs(y, p, t):
        return [jnp.cos(t) * jnp.ones_like(y[0])]

    y0 = jnp.zeros((1, B))
    saves = gp.ensemble_solve_kernel_reference(
        rhs, y0, None, duration=6.0, dt=0.5,
    )
    ts = np.arange(7, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(saves[:, 0, 0]), np.sin(ts), rtol=0, atol=5e-6
    )
    # t0 offset honored
    saves_off = gp.ensemble_solve_kernel_reference(
        rhs, y0, None, duration=4.0, dt=0.5, t0=1.5,
    )
    np.testing.assert_allclose(
        np.asarray(saves_off[:, 0, 0]),
        np.sin(1.5 + np.arange(5)) - np.sin(1.5),
        rtol=0, atol=5e-6,
    )


@pytest.mark.parametrize("method", ["tsit5", "bosh3", "rk4"])
def test_methods_agree_on_smooth_problem(method):
    B = 8
    y0, p = _sir_rows(B, seed=1)
    saves = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=30.0, dt=0.1, method=method,
    )
    gold = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=30.0, dt=0.01, method="tsit5",
    )
    np.testing.assert_allclose(
        np.asarray(saves[-1]), np.asarray(gold[-1]), rtol=5e-4, atol=1e-5
    )


def test_generic_reproduces_multistrain_kernel():
    """The multistrain model in rows form, solved by the generic engine,
    is the same trajectory as ``simulate(multistrain_ode)``."""
    cfg = multistrain_config(
        solver_params=SolverParams(constant_step_size=0.5)
    )
    par = multistrain_odeparams(cfg)
    y0 = multistrain_initial_state(cfg)
    B = 8
    scales = jnp.linspace(0.8, 1.2, B)
    beta = par.beta[None, :] * scales[:, None]
    got = gp.ensemble_solve_kernel_reference(
        ms.MultistrainRowsRHS.from_params(par),
        ms.pack_state(y0, B),
        ms.pack_params(beta, par.sigma, par.gamma, par.omega, B),
        duration=50.0, dt=0.5,
    )
    c = ms.unpack_saves(got)[4]  # (T, B, A, K)
    for member in (0, 5):
        p = par.replace(beta=par.beta * scales[member])
        sol = simulate(
            multistrain_ode, 50, y0, p, cfg.parameters.solver_params
        )
        np.testing.assert_allclose(
            np.asarray(c[:, member]), np.asarray(sol.ys[4]),
            rtol=1e-5, atol=1e-4,
        )


def test_kernel_interpret_matches_reference():
    B = 256
    y0, p = _sir_rows(B, seed=2)
    ref = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=20.0, dt=0.5,
    )
    out = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=20.0, dt=0.5, block_b=128, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-6, atol=1e-7
    )


def test_kernel_interpret_time_dependent_and_params_none():
    B = 128

    def rhs(y, p, t):
        return [jnp.cos(t) * jnp.ones_like(y[0])]

    y0 = jnp.zeros((1, B))
    ref = gp.ensemble_solve_kernel_reference(
        rhs, y0, None, duration=4.0, dt=0.25, t0=0.5,
    )
    out = gp.ensemble_solve_kernel(
        rhs, y0, None, duration=4.0, dt=0.25, t0=0.5, block_b=128,
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-6, atol=1e-7
    )


def test_validation_errors():
    y0 = jnp.zeros((3, 8))
    with pytest.raises(ValueError, match="unknown method"):
        gp.ensemble_solve_kernel(sir_rhs, y0, duration=1.0, dt=0.5,
                                 method="dopri9")
    with pytest.raises(ValueError, match="whole number"):
        gp.ensemble_solve_kernel(sir_rhs, y0, duration=1.3, dt=0.5)
    with pytest.raises(ValueError, match="must be \\(R, B\\)"):
        gp.ensemble_solve_kernel(sir_rhs, jnp.zeros(8), duration=1.0, dt=0.5)
    with pytest.raises(ValueError, match="unknown method"):
        gp.ensemble_solve_kernel_adaptive(sir_rhs, y0, duration=2.0,
                                          method="rk4")
    with pytest.raises(ValueError, match="at least one save"):
        gp.ensemble_solve_kernel_adaptive(sir_rhs, y0, duration=0.0)


# ---------------------------------------------------------------------------
# adaptive (lockstep-dt) variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_adaptive_reference_matches_tight_constant(method):
    """rtol=1e-5 adaptive lands on a dt=0.01 Tsit5 grid solve."""
    B = 32
    y0, p = _sir_rows(B, seed=4)
    saves, stats = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=60.0, rtol=1e-5, atol=1e-8, method=method,
    )
    assert saves.shape == (61, 3, B)
    assert int(stats["exhausted_intervals"][0]) == 0
    assert int(stats["n_accepted"][0]) >= 60  # at least one step/interval
    gold = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=60.0, dt=0.01,
    )
    np.testing.assert_allclose(
        np.asarray(saves), np.asarray(gold), rtol=0, atol=5e-5
    )
    # adaptive should take far fewer steps than the dt=0.01 grid (6000)
    assert int(stats["n_accepted"][0]) < 1000


def test_adaptive_kernel_interpret_matches_reference():
    """block_b == batch -> identical controller decisions, near-bit saves."""
    B = 128
    y0, p = _sir_rows(B, seed=5)
    ref, rstats = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
    )
    out, stats = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
        block_b=128, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-6, atol=1e-7
    )
    for key in ("exhausted_intervals", "n_accepted", "n_rejected"):
        assert int(stats[key][0]) == int(rstats[key][0]), key


def test_adaptive_budget_exhaustion_emits_nans_and_flags():
    B = 16
    y0, p = _sir_rows(B, seed=6)
    saves, stats = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=20.0, rtol=1e-10, atol=1e-14,
        steps_per_save=2,
    )
    n_bad = int(stats["exhausted_intervals"][0])
    assert n_bad > 0
    nan_slots = np.isnan(np.asarray(saves)).any(axis=(1, 2))
    assert int(nan_slots.sum()) == n_bad
    assert not nan_slots[0]  # the initial state is always emitted


def test_adaptive_bf16_saves_and_t0():
    B = 128
    y0, p = _sir_rows(B, seed=7)
    ref, _ = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=10.0, rtol=1e-5, atol=1e-8, t0=3.0,
    )
    out, _ = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=10.0, rtol=1e-5, atol=1e-8,
        block_b=128, save_dtype=jnp.bfloat16, t0=3.0, interpret=True,
    )
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref), rtol=0, atol=5e-3
    )
    # the CPU (lax) route honors save_dtype too
    fb, _ = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=10.0, save_dtype=jnp.bfloat16, t0=3.0,
    )
    assert fb.dtype == jnp.bfloat16


def test_constant_kernel_bf16_pipelined_saves():
    """save_dtype plumbs through the constant-step kernel's stores."""
    B = 128
    y0, p = _sir_rows(B, seed=8)
    ref = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=20.0, dt=0.5,
    )
    out32 = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=20.0, dt=0.5, block_b=128, interpret=True,
    )
    out16 = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=20.0, dt=0.5, block_b=128,
        save_dtype=jnp.bfloat16, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out32), np.asarray(ref), rtol=2e-6, atol=1e-7
    )
    assert out16.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out16, np.float32), np.asarray(ref), rtol=0, atol=5e-3
    )


def test_adaptive_multiblock_interpret_lockstep_per_block():
    """Two member blocks carry independent dt chains; members still accurate."""
    B = 256
    y0, p = _sir_rows(B, seed=9)
    out, stats = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
        block_b=128, interpret=True,
    )
    assert stats["n_accepted"].shape == (2,)
    gold = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=20.0, dt=0.01,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(gold), rtol=0, atol=5e-5
    )


def test_save_rows_constant_step_interpret():
    """save_rows saves exactly the selected rows, in the given order."""
    B = 128
    y0, p = _sir_rows(B, seed=10)
    full = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=10.0, dt=0.5,
    )
    out = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=10.0, dt=0.5, block_b=128, interpret=True,
        save_rows=(2, 0),
    )
    assert out.shape == (11, 2, B)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(full[:, [2, 0], :]), rtol=2e-6, atol=1e-7
    )


def test_save_rows_cpu_fallback_slices():
    B = 64
    y0, p = _sir_rows(B, seed=11)
    full = gp.ensemble_solve_kernel(sir_rhs, y0, p, duration=10.0, dt=0.5)
    sel = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=10.0, dt=0.5, save_rows=(1,),
    )
    assert sel.shape == (11, 1, B)
    np.testing.assert_array_equal(np.asarray(sel[:, 0]), np.asarray(full[:, 1]))


def test_save_rows_adaptive_interpret():
    B = 128
    y0, p = _sir_rows(B, seed=12)
    ref, rstats = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
    )
    out, stats = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=20.0, rtol=1e-5, atol=1e-8,
        block_b=128, save_rows=(1,), interpret=True,
    )
    assert out.shape == (21, 1, B)
    np.testing.assert_allclose(
        np.asarray(out[:, 0]), np.asarray(ref[:, 1]), rtol=2e-6, atol=1e-7
    )
    # same controller decisions as the unrestricted solve
    for key in ("exhausted_intervals", "n_accepted", "n_rejected"):
        assert int(stats[key][0]) == int(rstats[key][0]), key


def test_save_rows_validation():
    y0 = jnp.zeros((3, 8))
    with pytest.raises(ValueError, match="out of range"):
        gp.ensemble_solve_kernel(
            sir_rhs, y0, duration=1.0, dt=0.5, save_rows=(3,),
        )
    with pytest.raises(ValueError, match="at least one row"):
        gp.ensemble_solve_kernel(
            sir_rhs, y0, duration=1.0, dt=0.5, save_rows=(),
        )


@pytest.mark.parametrize("block_b", [128, 256])
@pytest.mark.parametrize("method", ["rk4", "tsit5", "bosh3"])
def test_triton_interpret_methods_and_blocks(method, block_b):
    """Every constant-step tableau, one and several member blocks, and a
    batch that is not a multiple of the block (padded by the wrapper)."""
    B = 300
    y0, p = _sir_rows(B, seed=15)
    ref = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=8.0, dt=0.5, method=method,
    )
    out = gp.ensemble_solve_kernel(
        sir_rhs, y0, p, duration=8.0, dt=0.5, method=method,
        block_b=block_b, interpret=True,
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-6, atol=1e-7
    )


def test_adaptive_interpret_padding_keeps_block_decisions():
    """Padding repeats the last member, so the padded last block makes the
    same controller decisions as that block solved alone."""
    B = 96
    y0, p = _sir_rows(B, seed=16)
    kw = dict(duration=10.0, rtol=1e-5, atol=1e-8, interpret=True)
    out, stats = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, block_b=64, **kw
    )
    assert out.shape == (11, 3, B) and stats["n_accepted"].shape == (2,)
    tail, tail_stats = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0[:, 64:], p[:, 64:], block_b=32, **kw
    )
    np.testing.assert_array_equal(np.asarray(out[..., 64:]), np.asarray(tail))
    for key in ("n_accepted", "n_rejected"):
        assert int(stats[key][1]) == int(tail_stats[key][0]), key


def test_kernel_route_selection():
    """One selection point: GPU -> Triton kernel, CPU -> lax, else error."""
    assert gp.kernel_route("gpu") == "triton"
    assert gp.kernel_route("cpu") == "lax"
    assert gp.kernel_route() == "lax"  # the tests run on the CPU
    for other in ("rocm", "metal", "neuron"):
        with pytest.raises(ValueError, match="no whole-solve route"):
            gp.kernel_route(other)


def test_cpu_route_is_the_lax_reference():
    B = 64
    y0, p = _sir_rows(B, seed=17)
    out = gp.ensemble_solve_kernel(sir_rhs, y0, p, duration=6.0, dt=0.5)
    ref = gp.ensemble_solve_kernel_reference(
        sir_rhs, y0, p, duration=6.0, dt=0.5
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    out_a, st = gp.ensemble_solve_kernel_adaptive(
        sir_rhs, y0, p, duration=6.0
    )
    ref_a, st_r = gp.ensemble_solve_kernel_adaptive_reference(
        sir_rhs, y0, p, duration=6.0
    )
    np.testing.assert_array_equal(np.asarray(out_a), np.asarray(ref_a))
    assert st["n_accepted"].shape == (1,)


def test_launch_config_rule():
    """One member per thread: block_b // 32 warps, at most 8; the default
    block shrinks to the next power of two for a small ensemble."""
    assert gp.launch_config(655360) == (gp.DEFAULT_BLOCK_B, 4)
    assert gp.launch_config(655360, 64) == (64, 2)
    assert gp.launch_config(655360, 256) == (256, 8)
    assert gp.launch_config(655360, 512) == (512, 8)
    assert gp.launch_config(10) == (32, 1)
    assert gp.launch_config(100) == (128, 4)
    assert gp.launch_config(50) == (64, 2)
    with pytest.raises(ValueError, match="power of two"):
        gp.launch_config(1000, 100)


@pytest.mark.parametrize("adaptive", [False, True])
def test_gpu_route_lowers_to_triton_for_cuda(monkeypatch, adaptive):
    """The GPU route of the public entry points lowers for CUDA from here:
    the multistrain rows RHS traces into Triton IR (an operation the
    Triton route cannot lower fails at this step, before any card)."""
    monkeypatch.setattr(gp, "kernel_route", lambda platform=None: "triton")
    cfg = multistrain_config()
    base = multistrain_odeparams(cfg)
    rhs = ms.MultistrainRowsRHS.from_params(base)
    B = 1000
    y_rows = ms.pack_state(multistrain_initial_state(cfg), B)
    p_rows = ms.pack_params(base.beta, base.sigma, base.gamma, base.omega, B)
    obs = tuple(range(ms.n_state_rows() - 6, ms.n_state_rows()))
    if adaptive:
        def solve(y, p):
            return gp.ensemble_solve_kernel_adaptive(
                rhs, y, p, duration=20.0, save_rows=obs
            )
    else:
        def solve(y, p):
            return gp.ensemble_solve_kernel(
                rhs, y, p, duration=20.0, dt=0.5, save_rows=obs
            )
    with jax.enable_x64(False):
        text = jax.jit(solve).trace(y_rows, p_rows).lower(
            lowering_platforms=("cuda",)
        ).as_text()
    assert text.count("@__gpu$xla.gpu.triton(") == 1
    assert "dynode_whole_solve" in text
