"""The row-major round-1 solve of the port against the JAX package on the
CPU.

``rowmajor.make_fused_solve`` (its plain version, on CPU tensors) against
``pallas_rollout.make_fused_solve(rng_in_kernel=False)`` in Pallas interpret
mode, fed the same (K_pad, D) int32 random bits: the cases of
``tests/test_utils.py:420-448`` (K = 300; K = 130, padded to 256; the null
row with the absolute action cost, ``u_scale`` 2 and a full sigma), the
pendulum, and a 20-step closed loop.  Also ``fused_solve_block_and_pad``
against JAX's, the flags the solve ignores, the seed mode's Philox
convention against the transposed solve's, the factory's checks, and the
bound's count of work.

Tolerances (``tests/test_utils.py:422-448``): costs rtol 1e-5 / atol 1e-4,
the update delta/s rtol 1e-4 / atol 1e-5; both sides sum the action cost,
the rollout and the update in other orders, in float32 (``tests/
conftest.py`` turns on x64, so both sides set it).  The closed loop's U and
state after 20 steps rtol 1e-4 / atol 1e-4.  The CUDA kernels are held
against the plain version on the card by ``chip_smoke.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import rowmajor as RM
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
LQ = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _problem(name):
    """(JAX dynamics, JAX cost, port kernel model, nu)."""
    if name == "pendulum":
        return jpend.pendulum_dynamics, jpend.pendulum_running_cost, PENDULUM_MODEL, 1
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    return (lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(axis=-1), LQ, 2)


def _solvers(problem, K, T, **flags):
    jdyn, jcost, model, nu = _problem(problem)
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, **flags)
    jsolve = PR.make_fused_solve(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                                 rng_in_kernel=False)
    return jsolve, RM.make_fused_solve(MPPIConfig(nx=2, nu=nu, K=K, T=T, **flags), model), nu


def _operands(rs, T, nu, sigma, lam):
    U = (rs.randn(T, nu) * 0.1).astype(np.float32)
    chol = np.linalg.cholesky(sigma).astype(np.float32)
    mu = np.array([0.05, -0.02][:nu], np.float32)
    lo, hi = np.full(nu, -1.0, np.float32), np.full(nu, 1.0, np.float32)
    a_flat = (lam * (U @ np.linalg.inv(sigma).T)).reshape(-1).astype(np.float32)
    return [U, chol, mu, lo, hi, a_flat]


def _compare(out_p, out_j, K, T, nu):
    delta_p, m_p, s_p, cost_p = out_p
    delta_j, m_j, s_j, cost_j = (np.asarray(v) for v in out_j)
    assert delta_p.shape == (T, nu) and cost_p.shape == (K,) and cost_p.dtype == torch.float32
    assert np.isfinite(cost_p.numpy()).all()
    np.testing.assert_allclose(cost_p.numpy(), cost_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose((delta_p / s_p).numpy(), delta_j / s_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(m_p), float(m_j), rtol=1e-5, atol=1e-4)


FULL_SIGMA = np.array([[1.0, 0.3], [0.3, 0.5]])
# name, problem, K, T, config flags, sigma
CASES = [
    ("K300_T8", "linear", 300, 8, {}, np.eye(2)),
    ("K130_padded", "linear", 130, 5, {}, np.eye(2)),
    ("null_abs_uscale2_full_sigma", "linear", 256, 6,
     {"sample_null_action": True, "noise_abs_cost": True, "u_scale": 2.0}, FULL_SIGMA),
    ("pendulum_uscale1.5", "pendulum", 300, 15, {"u_scale": 1.5}, np.array([[2.0]])),
]


@pytest.mark.parametrize("problem,K,T,flags,sigma", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_solve_plain_matches_jax_kernel(problem, K, T, flags, sigma):
    rs = np.random.RandomState(5)
    jsolve, solve, nu = _solvers(problem, K, T, **flags)
    lam = np.float32(0.7)
    bits = _rand_bits(rs, (solve.K_pad, T * nu))
    x0 = np.array([-1.0, 0.5], np.float32) if problem == "linear" else np.array(
        [np.pi, 1.0], np.float32)
    U, chol, mu, lo, hi, a_flat = _operands(rs, T, nu, sigma, lam)
    args = [bits, x0, U, chol, mu, lo, hi, a_flat, lam]
    out_j = jsolve(*(jnp.asarray(v) for v in args))
    out_p = solve(*(torch.from_numpy(np.asarray(v)) for v in args))
    _compare(out_p, out_j, K, T, nu)


@pytest.mark.parametrize("K", [1, 127, 128, 130, 511, 512, 513, 1000, 4096, 10_000])
def test_block_and_pad_match_jax(K):
    assert RM.fused_solve_block_and_pad(K) == PR.fused_solve_block_and_pad(K)
    solve = RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=K, T=3), LQ)
    assert (solve.block_k, solve.K_pad) == PR.fused_solve_block_and_pad(K)


def test_solve_ignores_antithetic_and_the_noise_mode():
    """As the JAX kernel, the solve reads neither ``antithetic`` nor
    ``diag_sigma`` nor ``noise_rho``: the same bits give the same result."""
    rs = np.random.RandomState(8)
    K, T = 200, 4
    lam = np.float32(1.0)
    bits = torch.from_numpy(_rand_bits(rs, (256, 2 * T)))
    ops = [torch.from_numpy(v) for v in _operands(rs, T, 2, FULL_SIGMA, lam)]
    x0 = torch.tensor([-1.0, 0.5])
    ref = RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=K, T=T), LQ)(bits, x0, *ops, lam)
    for flags in ({"antithetic": True}, {"diag_sigma": True}, {"noise_rho": 0.5}):
        out = RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=K, T=T, **flags), LQ)(
            bits, x0, *ops, lam)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_seed_mode_draws_the_transposed_solves_normals():
    """For one key, chol = I, mu = 0 and no antithetic sampling, the round-1
    solve's costs and update are the transposed solve's (the same normals,
    element d of sample k from Philox counter (k, d // 4))."""
    rs = np.random.RandomState(9)
    K, T, nu = 300, 6, 2
    D = T * nu
    key = FS.key_to_seed(0xFEDCBA9876543210)
    U = torch.from_numpy((rs.randn(T, nu) * 0.2).astype(np.float32))
    a_flat = U.reshape(-1) * 0.7
    x0 = torch.tensor([-3.0, -2.0])
    lam = torch.tensor(1.0)
    solve = RM.make_fused_solve(MPPIConfig(nx=2, nu=nu, K=K, T=T), LQ)
    delta, m, s, cost = solve(key, x0, U, torch.eye(nu), torch.zeros(nu), -1.0, 1.0, a_flat, lam)
    ones = torch.ones(D)
    delta_t, m_t, s_t, cost_t = FS.fused_solve_plain(
        key, x0[:, None].expand(2, K), U.reshape(D), ones, 0 * ones, -ones, ones, a_flat, lam,
        model=LQ, K=K, T=T, nu=nu)
    torch.testing.assert_close(cost, cost_t, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(delta.reshape(D) / s, delta_t / s_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [np.eye(2) * 0.5, FULL_SIGMA], ids=["diag", "full"])
def test_closed_loop_matches_jax(sigma):
    """20 commands of the round-1 solve from [-3, -2] towards [2, 2], the
    same fresh bits each command on both sides: ``U += delta / s``, act with
    ``U[0]``, shift; each side computes its own ``a_flat = λ·(U @ Σ⁻¹ᵀ)``.
    λ = 5: at λ = 1 the weights of K = 256 samples are nearly one-hot, and
    the loop multiplies a float32 rounding difference about threefold a
    command (to 0.08 in U after 20 commands with the full sigma)."""
    rs = np.random.RandomState(3)
    K, T, steps = 256, 10, 20
    jsolve, solve, nu = _solvers("linear", K, T)
    jsolve = jax.jit(jsolve)
    lam = np.float32(5.0)
    chol = np.linalg.cholesky(sigma).astype(np.float32)
    sinv = np.linalg.inv(sigma).astype(np.float32)
    mu, lo, hi = np.zeros(nu, np.float32), np.float32(-1.5), np.float32(1.5)
    x_j = x_p = np.array([-3.0, -2.0], np.float32)
    U_j = jnp.zeros((T, nu), F32)
    U_p = torch.zeros(T, nu)
    for _ in range(steps):
        bits = _rand_bits(rs, (solve.K_pad, T * nu))
        a_j = (lam * (U_j @ jnp.asarray(sinv).T)).reshape(-1)
        d_j, _, s_j, _ = jsolve(jnp.asarray(bits), jnp.asarray(x_j), U_j, jnp.asarray(chol),
                                jnp.asarray(mu), lo, hi, a_j, lam)
        U_j = U_j + d_j / s_j
        x_j = np.asarray(x_j + U_j[0] @ jnp.asarray(B_NP).T, np.float32)
        U_j = jnp.roll(U_j, -1, axis=0).at[-1].set(0.0)

        a_p = (float(lam) * (U_p @ torch.from_numpy(sinv).T)).reshape(-1)
        d_p, _, s_p, _ = solve(torch.from_numpy(bits), torch.from_numpy(x_p), U_p,
                               torch.from_numpy(chol), torch.from_numpy(mu), float(lo), float(hi),
                               a_p, float(lam))
        U_p = U_p + d_p / s_p
        x_p = (torch.from_numpy(x_p) + U_p[0] @ torch.from_numpy(B_NP).T).numpy()
        U_p = torch.roll(U_p, -1, dims=0)
        U_p[-1] = 0.0
    np.testing.assert_allclose(U_p.numpy(), np.asarray(U_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x_p, x_j, rtol=1e-4, atol=1e-4)
    assert np.linalg.norm(x_p - GOAL_NP) < 1.0  # the loop reached the goal


def test_factory_and_wrapper_checks():
    with pytest.raises(FS.FusedSolveUnavailable, match="timestep"):
        RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=8, T=3, step_dependent_dynamics=True), LQ)
    # nx = 33, beyond the named model's register arrays: the trace of its
    # callables, its state in shared memory (ROADMAP.md Queue 2a step 3b)
    wide = RM.make_fused_solve(MPPIConfig(nx=33, nu=2, K=8, T=3),
                               linear_quadratic(torch.zeros(33, 2), torch.zeros(33)))
    assert wide.spec.nx == 33 and wide.spec.act_ld > 0
    assert wide((1, 2), torch.ones(33), torch.zeros(3, 2), torch.eye(2), torch.zeros(2), -1.0,
                1.0, torch.zeros(6), 1.0)[3].shape == (8,)
    with pytest.raises(ValueError, match="float32"):
        RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=8, T=3, dtype=torch.float64), LQ)
    solve = RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=8, T=3), LQ)
    ops = [torch.zeros(3, 2), torch.eye(2), torch.zeros(2), -1.0, 1.0, torch.zeros(6), 1.0]
    with pytest.raises(ValueError, match="bits"):
        solve(torch.zeros((8, 6), dtype=torch.int32), torch.zeros(2), *ops)  # (128, 6)
    with pytest.raises(ValueError, match="cuda or cpu"):
        solve((1, 2), torch.empty(2, device="meta"), *ops)
    assert solve((1, 2), torch.zeros(2), *ops)[3].shape == (8,)
    # the D = 300 tiles of 128 samples do not fit in shared memory: the
    # kernel takes the global scratch
    assert RM.make_fused_solve(MPPIConfig(nx=2, nu=3, K=8, T=100),
                               linear_quadratic(torch.zeros(2, 3), torch.zeros(2)),
                               tile_k=128).tiles == "global"
    assert solve.tiles == "shared"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_rowmajor_work_counts_inputs_once():
    """``chip_smoke.fused_work`` for the round-1 solve: x0 (nx), U and
    a_flat (D), chol (nu²), mu, lo and hi (nu), lambda, the constants and
    the bits as given read once; the cost, delta, m and s written once; per
    drawn element nu multiply-adds and mu, no antithetic sign."""
    smoke = _chip_smoke()
    K, T, nu = 300, 4, 2
    D = T * nu
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T)
    bits = torch.zeros((512, D), dtype=torch.int32)
    chol = torch.eye(nu)
    ops, nbytes = smoke.fused_work(cfg, LQ, bits, torch.zeros(2), chol, variant="rowmajor")
    assert nbytes == 4 * (2 + 2 * D + nu * nu + 3 * nu + 1 + LQ.consts.numel() + bits.numel()
                          + K + D + 2)
    mppi_ops, _ = smoke.fused_work(cfg, LQ, torch.zeros((D, K), dtype=torch.int32),
                                   torch.zeros(2, 1).expand(2, K), torch.ones(D))
    # the drawn row's transform: 2 nu + 1 in place of the diagonal's 2, and
    # no antithetic sign
    assert ops - mppi_ops == K * D * (2 * nu + 1 - 2 - 1)
    seed_ops, seed_bytes = smoke.fused_work(cfg, LQ, (1, 2), torch.zeros(2), chol,
                                            variant="rowmajor")
    assert seed_bytes == nbytes - 4 * bits.numel()
    assert seed_ops == ops + K * -(-D // 4) * 98
