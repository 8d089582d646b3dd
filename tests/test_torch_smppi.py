"""The port's SMPPI against the JAX package's.

* ``smppi_solve_plain`` (what the CUDA kernel computes, on the CPU) against
  ``pallas_rollout.make_transposed_smppi_solve(rng_in_kernel=False)`` in
  Pallas interpret mode, fed the same int32 random bits;
* three chained plain ``make_smppi_step`` commands against the JAX ones, fed
  the same N(0, 1) draws (``jax.random.normal`` and ``solve.standard_normal``
  patched, as in ``tests/test_torch_solve.py``);
* the fused step (``use_pallas=True``, on the CPU the kernel's plain version)
  against JAX's operands + kernel + update, fed the same bits.

Every parity case sets float32 (or float64) on both sides, because
``tests/conftest.py`` turns on x64.  Tolerances, as
``tests/test_pallas_transposed.py:102-107`` allows for float32 summation
order: costs rtol 2e-5 / atol 1e-5, updates rtol 2e-4 / atol 2e-6; float64
1e-10.  The perturbed actions are elementwise: rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import SMPPIParams as JSParams
from pytorch_mppi_tpu.config import SMPPIState as JSState
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import MPPIConfig, SMPPIState
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy, smppi_params_from_numpy

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


# name, problem, K, T, nu, config flags, full op (noise_rho), emit
CASES = [
    ("linear", "linear", 256, 6, 2, {}, 0.0, False),
    ("null_abs", "linear", 256, 6, 2,
     {"sample_null_action": True, "noise_abs_cost": True}, 0.0, False),
    ("antithetic", "linear", 256, 6, 2, {"antithetic": True}, 0.0, False),
    ("u_scale", "linear", 256, 6, 2, {"u_scale": 1.5}, 0.0, False),
    ("pendulum", "pendulum", 256, 8, 1, {"sample_null_action": True}, 0.0, False),
    ("odd_padded", "linear3", 200, 5, 3, {"u_scale": 1.3}, 0.0, False),
    ("full_op_rho", "linear", 256, 6, 2, {}, 0.5, False),
    ("emit_perturbed", "linear", 256, 6, 2, {"antithetic": True}, 0.0, True),
]


@pytest.mark.parametrize(
    "problem,K,T,nu,flags,rho,emit",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel(problem, K, T, nu, flags, rho, emit):
    rs = np.random.RandomState(7)
    D = T * nu
    nx = 2
    if problem == "pendulum":
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        x0 = np.array([np.pi, 1.0], np.float32)
    else:
        B_np = B_NP if nu == 2 else (rs.randn(2, nu) * 0.5).astype(np.float32)
        jdyn, jcost, model = _linear_pair(B_np)
        x0 = np.array([-1.0, -1.0], np.float32)
    lo, hi = np.full(D, -2.0, np.float32), np.full(D, 2.0, np.float32)  # rates
    alo, ahi = np.full(D, -1.0, np.float32), np.full(D, 1.0, np.float32)  # actions
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=not rho,
                   noise_rho=rho, smppi=True, **flags)
    solve_j = PR.make_transposed_smppi_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=False, emit_perturbed=emit)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    U2 = (rs.randn(D) * 0.1).astype(np.float32)
    as2 = (rs.randn(D) * 0.2).astype(np.float32)
    if rho:
        sigma = np.array([[1.0, 0.3], [0.3, 0.8]], np.float32)
        op = np.asarray(JS._transposed_operands(
            jnp.asarray(sigma), jnp.zeros(nu, F32), jnp.asarray(lo[:nu]),
            jnp.asarray(hi[:nu]), jcfg, T, nu, F32)[1])
    else:
        op = np.full(D, 0.8, np.float32)
    mu = np.full(D, 0.05, np.float32)
    a_flat = U2 * 0.7
    lam, w_seq, dt = np.float32(0.8), np.float32(5.0), np.float32(0.5)
    x0T = np.broadcast_to(x0[:, None], (nx, K))
    operands = (U2, as2, op, mu, lo, hi, alo, ahi, a_flat, lam, w_seq, dt)

    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in operands))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=not rho, noise_rho=rho,
                     smppi=True, **flags)
    solve_p = FS.make_transposed_smppi_solve(cfg, model, pair_block=solve_j.block_k,
                                             emit_perturbed=emit)
    t = torch.from_numpy
    out_p = solve_p(t(bits), t(x0)[:, None].expand(nx, K),
                    *(t(np.array(v)) for v in operands))

    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
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


# name, config flags, sigma, rate bound, action bound
STEP_CASES = [
    ("diag_sigma", {}, np.diag([0.8, 1.2]), None, None),
    ("full_sigma_bounds", {}, np.array([[1.0, 0.3], [0.3, 0.8]]), 1.0, 0.6),
    ("noise_rho", {"noise_rho": 0.5}, np.diag([0.8, 1.2]), None, 1.0),
    ("null_abs_scale", {"sample_null_action": True, "noise_abs_cost": True,
                        "u_scale": 1.5}, np.diag([0.8, 1.2]), 2.0, None),
    ("antithetic", {"antithetic": True}, np.diag([0.5, 1.0]), None, 1.0),
]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("flags,sigma,rate_bound,action_bound",
                         [c[1:] for c in STEP_CASES], ids=[c[0] for c in STEP_CASES])
def test_three_chained_steps(monkeypatch, dt, flags, sigma, rate_bound, action_bound):
    jdt, tdt, ndt = DTYPES[dt]
    K, T, nx, nu = 64, 6, 2, 2
    diag = bool(np.all(sigma == np.diag(np.diagonal(sigma))))
    inf = np.inf
    fields = dict(
        noise_mu=np.full(nu, 0.05), noise_sigma=sigma, lambda_=np.array(0.8),
        u_min=np.full(nu, -(rate_bound or inf)), u_max=np.full(nu, rate_bound or inf),
        u_init=np.zeros(nu))
    extra = dict(action_min=np.full(nu, -(action_bound or inf)),
                 action_max=np.full(nu, action_bound or inf),
                 w_action_seq_cost=np.array(3.0), delta_t=np.array(0.5))
    rs = np.random.RandomState(1)
    U0, as0 = rs.randn(T, nu) * 0.3, rs.randn(T, nu) * 0.2
    x0 = np.array([-1.0, -1.0])

    jdyn, jcost, model = _linear_pair(B_NP.astype(ndt), jdt)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=jdt, diag_sigma=diag, smppi=True, **flags)
    jfns = JS.make_smppi_step(jcfg, jdyn, jcost, jit=False)
    jparams = JSParams(base=JParams(**{k: jnp.asarray(v, jdt) for k, v in fields.items()}),
                       **{k: jnp.asarray(v, jdt) for k, v in extra.items()})
    jstate = JSState(U=jnp.asarray(U0, jdt), action_sequence=jnp.asarray(as0, jdt),
                     key=jax.random.PRNGKey(0))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, dtype=tdt, diag_sigma=diag, smppi=True, **flags)
    fns = PS.make_smppi_step(cfg, model.dynamics, model.running_cost)
    params = smppi_params_from_numpy(params_from_numpy(**fields, dtype=tdt), **extra)
    state = SMPPIState(U=torch.tensor(U0, dtype=tdt), action_sequence=torch.tensor(as0, dtype=tdt),
                       seed=0)

    _patch_normals(monkeypatch, jdt)
    tol_c = dict(rtol=2e-5, atol=1e-5) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    tol_u = dict(rtol=2e-4, atol=2e-6) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0, jdt))
        state, action, art = fns.step(params, state, torch.tensor(x0, dtype=tdt))
        assert art.cost_total.dtype == tdt
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **tol_c)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega), **tol_u)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **tol_u)
        np.testing.assert_allclose(state.action_sequence.numpy(),
                                   np.asarray(jstate.action_sequence), **tol_u)
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
    """The port's fused SMPPI step (``make_smppi_step(use_pallas=True)``)
    against JAX's operands + kernel + ``weighting_from_stats`` + update +
    integration, given the same bits."""
    rs = np.random.RandomState(11)
    K = 256
    if problem == "pendulum":
        nx, nu, T = 2, 1, 8
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        sigma = np.array([[2.0]], np.float32)
        x0 = np.array([np.pi, 1.0], np.float32)
        delta_t = np.float32(1.0)
    else:
        nx, nu, T = 2, 2, 6
        jdyn, jcost, model = _linear_pair(B_NP)
        sigma = np.diag([0.8, 1.2]).astype(np.float32)
        x0 = np.array([-1.0, -1.0], np.float32)
        delta_t = np.float32(0.5)
    D = T * nu
    fields = dict(
        noise_mu=np.full(nu, 0.05, np.float32), noise_sigma=sigma,
        lambda_=np.float32(0.8), u_min=np.full(nu, -2.0, np.float32),
        u_max=np.full(nu, 2.0, np.float32), u_init=np.zeros(nu, np.float32))
    extra = dict(action_min=np.full(nu, -1.0, np.float32),
                 action_max=np.full(nu, 1.0, np.float32),
                 w_action_seq_cost=np.float32(4.0), delta_t=delta_t)
    U = (rs.randn(T, nu) * 0.3).astype(np.float32)
    aseq = (rs.randn(T, nu) * 0.2).astype(np.float32)
    diag = not rho

    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=diag, noise_rho=rho,
                   smppi=True, **flags)
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in fields.items()})
    solve_j = PR.make_transposed_smppi_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    Uj = JS._shift_U(jnp.asarray(U), jp.u_init)
    asj = jnp.roll(jnp.asarray(aseq), -1, axis=0)
    asj = asj.at[-1].set(asj[-2])
    sigma_inv, op, mu_t, lo2, hi2 = JS._transposed_operands(
        jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, T, nu, F32)
    alo2 = jnp.tile(jnp.asarray(extra["action_min"]), T)
    ahi2 = jnp.tile(jnp.asarray(extra["action_max"]), T)
    a_flat = (jp.lambda_ * (Uj @ sigma_inv.T)).reshape(D)
    w, dt = jnp.asarray(extra["w_action_seq_cost"]), jnp.asarray(extra["delta_t"])
    delta, m, s, cost_j = solve_j(
        jnp.asarray(bits), JS._x0_to_lanes(jnp.asarray(x0), K), Uj.reshape(D),
        asj.reshape(D), op, mu_t, lo2, hi2, alo2, ahi2, a_flat, jp.lambda_, w, dt)
    ctnz_j, omega_j = PR.weighting_from_stats(cost_j, jp.lambda_, m, s)
    U_j = Uj + (delta / s).reshape(T, nu)
    as_j = asj + U_j * dt

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=diag, noise_rho=rho,
                     smppi=True, **flags)
    fns = PS.make_smppi_step(cfg, model.dynamics, model.running_cost, use_pallas=True)
    assert fns.fused
    assert solve_j.block_k == K  # the port's default pairing block is K
    monkeypatch.setattr(FS, "key_to_seed", lambda s_: torch.from_numpy(bits))
    params = smppi_params_from_numpy(params_from_numpy(**fields), **extra)
    state, action, art = fns.step(
        params, SMPPIState(U=torch.from_numpy(U), action_sequence=torch.from_numpy(aseq),
                           seed=0), torch.from_numpy(x0))
    np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(cost_j), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(art.omega.numpy(), np.asarray(omega_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(art.cost_total_non_zero.numpy(), np.asarray(ctnz_j),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(state.U.numpy(), np.asarray(U_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(state.action_sequence.numpy(), np.asarray(as_j),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(action.numpy(), np.asarray(as_j[0]), rtol=2e-4, atol=2e-6)
    assert state.counter == 1 and art.noise is None


def test_fused_artifacts_match_back_computation():
    """With ``fused_artifacts`` the noise artifact is the kernel's own
    back-computation through both clamps, and the perturbed actions respect
    the action bounds."""
    model = linear_quadratic(torch.eye(2), torch.tensor([2.0, 2.0]))
    cfg = MPPIConfig(nx=2, nu=2, K=32, T=5, diag_sigma=True, smppi=True, fused_artifacts=True)
    fns = PS.make_smppi_step(cfg, model.dynamics, model.running_cost, use_pallas=True)
    fields = dict(noise_mu=np.zeros(2), noise_sigma=np.eye(2), lambda_=1.0,
                  u_min=np.full(2, -1.0), u_max=np.full(2, 1.0), u_init=np.zeros(2))
    params = smppi_params_from_numpy(params_from_numpy(**fields), np.full(2, -0.3),
                                     np.full(2, 0.3), 2.0, 0.5)
    aseq = torch.full((5, 2), 0.1)
    state = SMPPIState(U=torch.zeros(5, 2), action_sequence=aseq, seed=3)
    _, _, art = fns.step_no_shift(params, state, torch.zeros(2))
    assert bool((art.perturbed_action.abs() <= torch.tensor(0.3)).all())
    noise = (art.perturbed_action - aseq) / 0.5 - state.U
    torch.testing.assert_close(art.noise, noise, rtol=0, atol=0)
