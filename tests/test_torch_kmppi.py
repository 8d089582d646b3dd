"""The port's KMPPI against the JAX package's.

* ``interpolation_operators`` for ``RBFKernel`` and ``BSplineKernel``;
* ``kmppi_solve_plain`` (what the CUDA kernel computes, on the CPU) against
  ``pallas_rollout.make_transposed_kmppi_solve(rng_in_kernel=False)`` in
  Pallas interpret mode, fed the same int32 random bits at the Dp = nsp·nu
  support rows;
* three chained plain ``make_kmppi_step`` commands against the JAX ones, fed
  the same N(0, 1) draws;
* the fused step (``use_pallas=True``, on the CPU the kernel's plain version)
  against JAX's operands + kernel + theta update, fed the same bits.

Every parity case sets float32 (or float64) on both sides, because
``tests/conftest.py`` turns on x64.  Tolerances, as
``tests/test_pallas_transposed.py:102-107`` allows for float32 summation
order: costs rtol 2e-5 / atol 1e-5, updates rtol 2e-4 / atol 2e-6; float64
1e-10.  The interpolated actions are one float32 product each: rtol 1e-5 /
atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import KMPPIParams as JKParams
from pytorch_mppi_tpu.config import KMPPIState as JKState
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.ops import kernels as JK
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import KMPPIState, MPPIConfig
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import kernels as PK
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import kmppi_params_from_numpy, params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


def _linear_pair(B_np, dtype=F32):
    B = jnp.asarray(B_np, dtype)
    goal = jnp.asarray(GOAL_NP, dtype)
    return (lambda s, a: s + a @ B.T,
            lambda s, a: ((goal - s) ** 2).sum(axis=-1),
            linear_quadratic(torch.from_numpy(np.asarray(B_np)), torch.from_numpy(GOAL_NP)))


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _interp(T, nsp, nu, jdt=F32, kernel=None):
    """JAX's interpolation operators and kron(interp_full, I_nu), as numpy."""
    full, shift = JK.interpolation_operators(kernel or JK.RBFKernel(2.0), T, nsp, jdt)
    Wt = jnp.kron(full, jnp.eye(nu, dtype=jdt))
    return np.asarray(full), np.asarray(shift), np.asarray(Wt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("kernel,T,nsp", [
    ("rbf", 8, 4), ("rbf", 15, 5), ("bspline", 8, 4), ("bspline", 12, 12),
], ids=["rbf_8_4", "rbf_15_5", "bspline_8_4", "bspline_12_12"])
def test_interpolation_operators_match_jax(dt, kernel, T, nsp):
    jdt, tdt, _ = DTYPES[dt]
    jk, pk = ((JK.RBFKernel(2.0), PK.RBFKernel(2.0)) if kernel == "rbf"
              else (JK.BSplineKernel(3.0), PK.BSplineKernel(3.0)))
    full_j, shift_j = JK.interpolation_operators(jk, T, nsp, jdt)
    full_p, shift_p = PK.interpolation_operators(pk, T, nsp, tdt)
    assert full_p.dtype == tdt and full_p.shape == (T, nsp) and shift_p.shape == (nsp, nsp)
    assert full_p.is_contiguous() and shift_p.is_contiguous()
    # float32 Gram matrices may differ by an ulp of the time grid, which the
    # float64 solve of an ill-conditioned Gram matrix can amplify
    tol = dict(rtol=2e-4, atol=2e-6) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(full_p.numpy(), np.asarray(full_j), **tol)
    np.testing.assert_allclose(shift_p.numpy(), np.asarray(shift_j), **tol)


# name, problem, K, T, nu, nsp, config flags, full op (noise_rho), emit
CASES = [
    ("linear", "linear", 256, 8, 2, 4, {}, 0.0, False),
    ("null_abs", "linear", 256, 8, 2, 4,
     {"sample_null_action": True, "noise_abs_cost": True}, 0.0, False),
    ("antithetic", "linear", 256, 8, 2, 4, {"antithetic": True}, 0.0, False),
    ("u_scale", "linear", 256, 8, 2, 3, {"u_scale": 1.5}, 0.0, False),
    ("pendulum", "pendulum", 256, 8, 1, 4, {"sample_null_action": True}, 0.0, False),
    ("odd_padded", "linear3", 200, 6, 3, 3, {"u_scale": 1.3}, 0.0, False),
    ("full_op_rho", "linear", 256, 8, 2, 4, {}, 0.5, False),
    ("emit_perturbed", "linear", 256, 8, 2, 4, {"antithetic": True}, 0.0, True),
]


@pytest.mark.parametrize(
    "problem,K,T,nu,nsp,flags,rho,emit",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel(problem, K, T, nu, nsp, flags, rho, emit):
    rs = np.random.RandomState(7)
    D, Dp = T * nu, nsp * nu
    nx = 2
    if problem == "pendulum":
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        x0 = np.array([np.pi, 1.0], np.float32)
    else:
        B_np = B_NP if nu == 2 else (rs.randn(2, nu) * 0.5).astype(np.float32)
        jdyn, jcost, model = _linear_pair(B_np)
        x0 = np.array([-2.0, -1.0], np.float32)
    lop, hip = np.full(Dp, -1.5, np.float32), np.full(Dp, 1.5, np.float32)
    lo, hi = np.full(D, -1.0, np.float32), np.full(D, 1.0, np.float32)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=not rho,
                   noise_rho=rho, num_support_pts=nsp, **flags)
    solve_j = PR.make_transposed_kmppi_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=False, emit_perturbed=emit)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (Dp, cols))
    U2 = (rs.randn(D) * 0.1).astype(np.float32)
    th2 = (rs.randn(Dp) * 0.2).astype(np.float32)
    if rho:
        sigma = np.array([[1.0, 0.3], [0.3, 0.8]], np.float32)
        op = np.asarray(JS._transposed_operands(
            jnp.asarray(sigma), jnp.zeros(nu, F32), jnp.asarray(lop[:nu]),
            jnp.asarray(hip[:nu]), jcfg, nsp, nu, F32)[1])
    else:
        op = np.full(Dp, 0.9, np.float32)
    mu = np.full(Dp, 0.05, np.float32)
    a_flat = U2 * 0.7
    Wt = _interp(T, nsp, nu)[2]
    lam = np.float32(0.9)
    x0T = np.broadcast_to(x0[:, None], (nx, K))
    operands = (U2, th2, op, mu, lop, hip, lo, hi, a_flat, Wt, lam)

    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in operands))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=not rho, noise_rho=rho,
                     num_support_pts=nsp, **flags)
    solve_p = FS.make_transposed_kmppi_solve(cfg, model, pair_block=solve_j.block_k,
                                             emit_perturbed=emit)
    t = torch.from_numpy
    out_p = solve_p(t(bits), t(x0)[:, None].expand(nx, K),
                    *(t(np.array(v)) for v in operands))

    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    assert delta_p.shape == (Dp,)
    np.testing.assert_allclose(ct_p, ct_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(m_p, m_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, rtol=2e-4, atol=2e-6)
    if emit:
        np.testing.assert_allclose(out_p[4].numpy(), np.asarray(out_j[4]),
                                   rtol=1e-5, atol=1e-6)


def _patch_normals(monkeypatch, jdt):
    jbank, pbank = np.random.RandomState(0), np.random.RandomState(0)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(jbank.randn(*shape), jdt))
    monkeypatch.setattr(PS, "standard_normal",
                        lambda gen, shape, dtype, device: torch.tensor(
                            pbank.randn(*shape), dtype=dtype, device=device))


# name, config flags, sigma, bound
STEP_CASES = [
    ("diag_sigma", {}, np.diag([0.8, 1.2]), None),
    ("full_sigma_bounds", {}, np.array([[1.0, 0.3], [0.3, 0.8]]), 0.8),
    ("noise_rho", {"noise_rho": 0.5}, np.diag([0.8, 1.2]), None),
    ("null_abs_scale", {"sample_null_action": True, "noise_abs_cost": True,
                        "u_scale": 1.5}, np.diag([0.8, 1.2]), 1.0),
    ("antithetic", {"antithetic": True}, np.diag([0.5, 1.0]), 1.0),
]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("flags,sigma,bound", [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_three_chained_steps(monkeypatch, dt, flags, sigma, bound):
    jdt, tdt, ndt = DTYPES[dt]
    K, T, nx, nu, nsp = 64, 8, 2, 2, 4
    diag = bool(np.all(sigma == np.diag(np.diagonal(sigma))))
    fields = dict(
        noise_mu=np.full(nu, 0.05), noise_sigma=sigma, lambda_=np.array(0.8),
        u_min=np.full(nu, -bound if bound else -np.inf),
        u_max=np.full(nu, bound if bound else np.inf), u_init=np.zeros(nu))
    full, shift, _ = _interp(T, nsp, nu, jdt)
    rs = np.random.RandomState(1)
    U0, th0 = rs.randn(T, nu) * 0.3, rs.randn(nsp, nu) * 0.2
    x0 = np.array([-2.0, -1.0])

    jdyn, jcost, model = _linear_pair(B_NP.astype(ndt), jdt)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=jdt, diag_sigma=diag,
                   num_support_pts=nsp, **flags)
    jfns = JS.make_kmppi_step(jcfg, jdyn, jcost, jit=False)
    jparams = JKParams(base=JParams(**{k: jnp.asarray(v, jdt) for k, v in fields.items()}),
                       interp_full=jnp.asarray(full), interp_shift=jnp.asarray(shift))
    jstate = JKState(U=jnp.asarray(U0, jdt), theta=jnp.asarray(th0, jdt),
                     key=jax.random.PRNGKey(0))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, dtype=tdt, diag_sigma=diag,
                     num_support_pts=nsp, **flags)
    fns = PS.make_kmppi_step(cfg, model.dynamics, model.running_cost)
    params = kmppi_params_from_numpy(params_from_numpy(**fields, dtype=tdt), full, shift)
    state = KMPPIState(U=torch.tensor(U0, dtype=tdt), theta=torch.tensor(th0, dtype=tdt), seed=0)

    _patch_normals(monkeypatch, jdt)
    tol_c = dict(rtol=2e-5, atol=1e-5) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    tol_u = dict(rtol=2e-4, atol=2e-6) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0, jdt))
        state, action, art = fns.step(params, state, torch.tensor(x0, dtype=tdt))
        assert art.cost_total.dtype == tdt
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **tol_c)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega), **tol_u)
        np.testing.assert_allclose(state.theta.numpy(), np.asarray(jstate.theta), **tol_u)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **tol_u)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **tol_u)
        np.testing.assert_allclose(art.noise.numpy(), np.asarray(jart.noise), **tol_u)
    assert state.counter == 3


CASES_ITER = [
    ("linear_anti_null", "linear", {"antithetic": True, "sample_null_action": True}, 0.0),
    ("pendulum_full_rho", "pendulum", {"noise_abs_cost": True}, 0.5),
]


@pytest.mark.parametrize("problem,flags,rho", [c[1:] for c in CASES_ITER],
                         ids=[c[0] for c in CASES_ITER])
def test_fused_iteration_matches_jax(monkeypatch, problem, flags, rho):
    """The port's fused KMPPI step (``make_kmppi_step(use_pallas=True)``)
    against JAX's operands + kernel + ``weighting_from_stats`` + theta
    update, given the same bits."""
    rs = np.random.RandomState(11)
    K = 256
    if problem == "pendulum":
        nx, nu, T, nsp = 2, 1, 10, 5
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        sigma = np.array([[2.0]], np.float32)
        x0 = np.array([np.pi, 1.0], np.float32)
    else:
        nx, nu, T, nsp = 2, 2, 8, 4
        jdyn, jcost, model = _linear_pair(B_NP)
        sigma = np.diag([0.8, 1.2]).astype(np.float32)
        x0 = np.array([-2.0, -1.0], np.float32)
    D, Dp = T * nu, nsp * nu
    fields = dict(
        noise_mu=np.full(nu, 0.05, np.float32), noise_sigma=sigma,
        lambda_=np.float32(0.8), u_min=np.full(nu, -1.0, np.float32),
        u_max=np.full(nu, 1.0, np.float32), u_init=np.zeros(nu, np.float32))
    full, shift, Wt = _interp(T, nsp, nu)
    U = (rs.randn(T, nu) * 0.3).astype(np.float32)
    theta = (rs.randn(nsp, nu) * 0.2).astype(np.float32)
    diag = not rho

    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=diag, noise_rho=rho,
                   num_support_pts=nsp, **flags)
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in fields.items()})
    solve_j = PR.make_transposed_kmppi_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (Dp, cols))
    Uj = JS._shift_U(jnp.asarray(U), jp.u_init)
    thj = jnp.asarray(shift) @ jnp.asarray(theta)
    sigma_inv, op, mu_p, lop, hip = JS._transposed_operands(
        jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, nsp, nu, F32)
    lo2, hi2 = jnp.tile(jp.u_min, T), jnp.tile(jp.u_max, T)
    a_flat = (jp.lambda_ * (Uj @ sigma_inv.T)).reshape(D)
    delta, m, s, cost_j = solve_j(
        jnp.asarray(bits), JS._x0_to_lanes(jnp.asarray(x0), K), Uj.reshape(D),
        thj.reshape(Dp), op, mu_p, lop, hip, lo2, hi2, a_flat, jnp.asarray(Wt), jp.lambda_)
    ctnz_j, omega_j = PR.weighting_from_stats(cost_j, jp.lambda_, m, s)
    th_j = thj + (delta / s).reshape(nsp, nu)
    U_j = jnp.asarray(full) @ th_j

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=diag, noise_rho=rho,
                     num_support_pts=nsp, **flags)
    fns = PS.make_kmppi_step(cfg, model.dynamics, model.running_cost, use_pallas=True)
    assert fns.fused
    assert solve_j.block_k == K  # the port's default pairing block is K
    monkeypatch.setattr(FS, "key_to_seed", lambda s_: torch.from_numpy(bits))
    params = kmppi_params_from_numpy(params_from_numpy(**fields), full, shift)
    state, action, art = fns.step(
        params, KMPPIState(U=torch.from_numpy(U), theta=torch.from_numpy(theta), seed=0),
        torch.from_numpy(x0))
    np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(cost_j), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(art.omega.numpy(), np.asarray(omega_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(art.cost_total_non_zero.numpy(), np.asarray(ctnz_j),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(state.theta.numpy(), np.asarray(th_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(state.U.numpy(), np.asarray(U_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(action.numpy(), np.asarray(U_j[0]), rtol=2e-4, atol=2e-6)
    assert state.counter == 1 and art.noise is None


def test_fused_artifacts_are_full_horizon():
    """With ``fused_artifacts`` the perturbed actions are the clamped
    full-horizon trajectories and the noise artifact is ``perturbed - U``."""
    model = linear_quadratic(torch.eye(2), torch.tensor([2.0, 2.0]))
    T, nsp = 6, 3
    cfg = MPPIConfig(nx=2, nu=2, K=32, T=T, diag_sigma=True, num_support_pts=nsp,
                     fused_artifacts=True)
    fns = PS.make_kmppi_step(cfg, model.dynamics, model.running_cost, use_pallas=True)
    fields = dict(noise_mu=np.zeros(2), noise_sigma=np.eye(2), lambda_=1.0,
                  u_min=np.full(2, -0.4), u_max=np.full(2, 0.4), u_init=np.zeros(2))
    full, shift = PK.interpolation_operators(PK.RBFKernel(2.0), T, nsp, torch.float32)
    params = kmppi_params_from_numpy(params_from_numpy(**fields), full, shift)
    state = KMPPIState(U=torch.full((T, 2), 0.1), theta=torch.zeros(nsp, 2), seed=3)
    new, _, art = fns.step_no_shift(params, state, torch.zeros(2))
    assert art.perturbed_action.shape == (32, T, 2)
    assert bool((art.perturbed_action.abs() <= torch.tensor(0.4)).all())
    torch.testing.assert_close(art.noise, art.perturbed_action - state.U, rtol=0, atol=0)
    torch.testing.assert_close(new.U, full @ new.theta, rtol=0, atol=0)
