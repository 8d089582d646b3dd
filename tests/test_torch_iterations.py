"""The iteration loop (``num_iterations``, ``adaptive_covariance``) in the
port against the JAX package on the CPU.

* the plain MPPI, SMPPI, KMPPI and batched controllers with
  ``num_iterations = 3`` against the JAX controllers over chained commands:
  ``sample_noise_flat`` patched on both sides, so the i-th draw of either
  side is the same (JAX's iteration loop is a Python ``for``, and its side
  runs under ``jax.disable_jit``, so every iteration draws);
* adaptive covariance on MPPI (diagonal and full sigma, with the null row),
  SMPPI (rate space) and KMPPI (theta space) against JAX, with
  ``jax.random.normal`` and the port's ``solve.standard_normal`` patched so
  that each side applies its own (adapted) sigma; ``adapt_covariance`` alone;
* the fused MPPI, SMPPI and KMPPI steps with ``num_iterations = 3`` (the
  kernels' plain versions on the CPU) against three chained JAX kernel calls
  in Pallas interpret mode on the same bits (``key_to_seed`` patched on the
  port's side), the legacy route against JAX's legacy kernels, and the
  batched kernel's plain version against JAX's batched kernel;
* ``num_iterations = 1`` bit for bit against the default on every route, the
  gates and their texts, and the behaviour checks of JAX's
  ``tests/test_extensions.py:237-310`` and ``:431-595`` run on the port.

Float32 parity: costs rtol 2e-5 / atol 1e-5, commands and updates rtol 2e-4
/ atol 2e-6 (``tests/test_pallas_transposed.py:102-107``); float64 1e-10.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import MPPIState as JState
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import (
    KMPPIParams,
    KMPPIState,
    MPPIConfig,
    MPPIState,
    SMPPIParams,
    SMPPIState,
)
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import kernels as PK
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import batched_state_from_numpy, params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
LQ = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
K, T, NSP, N = 32, 5, 3, 3
_JB, _JG = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)


def jdyn(s, a):
    return s + a @ _JB.T


def jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


def _variant(name):
    """(JAX class, port class, JAX keywords, port keywords, noise rows)."""
    common = dict(num_samples=K, horizon=T, lambda_=1.0, u_scale=0.7)
    jb = dict(u_min=-jnp.ones(2, F32), u_max=jnp.ones(2, F32))
    pb = dict(u_min=-torch.ones(2), u_max=torch.ones(2), device="cpu")
    if name == "smppi":
        extra = dict(w_action_seq_cost=2.0, delta_t=0.5)
        return (J.SMPPI, P.SMPPI,
                dict(common, action_min=-jnp.ones(2, F32), action_max=jnp.ones(2, F32),
                     **extra, **jb),
                dict(common, action_min=-torch.ones(2), action_max=torch.ones(2), **extra, **pb),
                T * 2)
    if name == "kmppi":
        return (J.KMPPI, P.KMPPI,
                dict(common, num_support_pts=NSP, kernel=J.RBFKernel(2.0), **jb),
                dict(common, num_support_pts=NSP, kernel=P.RBFKernel(2.0), **pb), NSP * 2)
    if name == "batched":
        return (J.MPPI_Batched, P.MPPI_Batched, dict(common, num_envs=N, **jb),
                dict(common, num_envs=N, **pb), T * 2)
    return J.MPPI, P.MPPI, dict(common, **jb), dict(common, **pb), T * 2


VARIANTS = ("mppi", "smppi", "kmppi", "batched")


def _pair(name, sigma=None, **kw):
    """JAX and port controllers of one variant with the same nominal
    sequence."""
    jcls, pcls, jkw, pkw, _ = _variant(name)
    sigma = np.eye(2, dtype=np.float32) * 0.5 if sigma is None else sigma
    jc = jcls(jdyn, jcost, 2, jnp.asarray(sigma), **jkw, **kw)
    pc = pcls(LQ.dynamics, LQ.running_cost, 2, torch.from_numpy(sigma), **pkw, **kw)
    if name != "smppi":
        shape = (N, T, 2) if name == "batched" else (T, 2)
        U0 = (np.random.RandomState(1).randn(*shape) * 0.3).astype(np.float32)
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    return jc, pc


def _start(name):
    x = np.array([[-1.0, 0.5], [0.5, -1.0], [0.0, 0.0]], np.float32)
    return x if name == "batched" else x[0]


def _noise_bank(monkeypatch, rows):
    """The same (K, rows) noise for the i-th ``sample_noise_flat`` call on
    either side."""
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, rows).astype(np.float32) * 0.6))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, rows).astype(np.float32) * 0.6))


def _normal_bank(monkeypatch):
    """The same N(0, 1) draws for the i-th request on either side, before
    each side's own noise transform (``tests/test_torch_solve.py``)."""
    jbank, pbank = np.random.RandomState(4), np.random.RandomState(4)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(
        jbank.randn(*shape), dtype or F32))
    monkeypatch.setattr(PS, "standard_normal", lambda gen, shape, dtype, device: torch.tensor(
        pbank.randn(*shape), dtype=dtype, device=device))


def _chain(jc, pc, name, commands=3):
    x = _start(name)
    with jax.disable_jit():
        for _ in range(commands):
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total), **TOL_C)
            np.testing.assert_allclose(pc.omega.numpy(), np.asarray(jc.omega), **TOL_U)
            np.testing.assert_allclose(ap, aj, **TOL_U)
            np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **TOL_U)
            x = (x + 0.2 * ap[..., :2]).astype(np.float32)
    assert pc._state.counter == commands * pc.config.num_iterations


@pytest.mark.parametrize("name", VARIANTS)
def test_plain_iterations_match_jax(monkeypatch, name):
    """Three chained commands of three iterations each."""
    jc, pc = _pair(name, num_iterations=3)
    assert not pc._fns.fused and pc.config.num_iterations == 3
    _noise_bank(monkeypatch, _variant(name)[4])
    _chain(jc, pc, name)


# name, variant, sigma, keywords
ADAPT_CASES = [
    ("mppi_diag", "mppi", np.diag([0.5, 0.8]), {}),
    ("mppi_full", "mppi", np.array([[0.6, 0.2], [0.2, 0.5]]), {}),
    ("mppi_null_row", "mppi", np.diag([0.5, 0.8]), dict(sample_null_action=True)),
    ("smppi_rate_space", "smppi", np.diag([0.5, 0.8]), {}),
    ("kmppi_theta_space", "kmppi", np.array([[0.6, 0.2], [0.2, 0.5]]), {}),
]


@pytest.mark.parametrize("name,sigma,kw", [c[1:] for c in ADAPT_CASES],
                         ids=[c[0] for c in ADAPT_CASES])
def test_adaptive_covariance_matches_jax(monkeypatch, name, sigma, kw):
    """The adapted sigma drives the next iteration's draws and action cost
    on both sides; the next command starts from the base sigma."""
    jc, pc = _pair(name, sigma=sigma.astype(np.float32), num_iterations=3,
                   adaptive_covariance=True, adaptive_cov_lr=0.6, **kw)
    _normal_bank(monkeypatch)
    _chain(jc, pc, name)
    torch.testing.assert_close(pc.noise_sigma, torch.from_numpy(sigma.astype(np.float32)))


def _adapt_inputs(dt=np.float64):
    rs = np.random.RandomState(0)
    noise = rs.randn(8, 3, 2).astype(dt)
    noise[0] = 100.0  # the injected null row's "noise" (-U), a large value
    return noise, np.full(8, 1 / 8, dt)


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("n_injected", [0, 1])
def test_adapt_covariance_alone_matches_jax(diag, n_injected):
    """The estimate, the floor and the blend, with the null row masked and
    omega renormalised over the other rows."""
    noise, omega = _adapt_inputs()
    fields = dict(nx=2, nu=2, K=8, T=3, adaptive_covariance=True, adaptive_cov_lr=0.5,
                  sample_null_action=True, diag_sigma=diag)
    sigma = np.array([[4.0, 0.0], [0.0, 3.0]]) if diag else np.array([[4.0, 1.0], [1.0, 3.0]])
    got = PS.adapt_covariance(MPPIConfig(dtype=torch.float64, **fields), torch.tensor(sigma),
                              torch.tensor(omega), torch.tensor(noise), n_injected)
    want = JS.adapt_covariance(JConfig(dtype=jnp.float64, **fields), jnp.asarray(sigma),
                               jnp.asarray(omega), jnp.asarray(noise), n_injected)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    if n_injected:
        # the masked row did not drag sigma toward 100^2
        assert float(got.max()) < 50.0
        omega_pure = np.concatenate([[0.0], np.full(7, 1 / 7)])
        unmasked = PS.adapt_covariance(MPPIConfig(dtype=torch.float64, **fields),
                                       torch.tensor(sigma), torch.tensor(omega_pure),
                                       torch.tensor(noise), 0)
        torch.testing.assert_close(got, unmasked, rtol=1e-12, atol=1e-12)


def test_adapt_covariance_keeps_sigma_when_omega_is_on_the_injected_row():
    noise, _ = _adapt_inputs()
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=3, dtype=torch.float64, adaptive_covariance=True,
                     sample_null_action=True)
    sigma = torch.eye(2, dtype=torch.float64) * 4.0
    omega = torch.zeros(8, dtype=torch.float64)
    omega[0] = 1.0
    kept = PS.adapt_covariance(cfg, sigma, omega, torch.tensor(noise), 1)
    assert torch.equal(kept, sigma)


# -- the kernels' routes inside the loop -------------------------------------

def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


KF, TF, NSPF = 256, 5, 3
FIELDS = dict(noise_mu=np.full(2, 0.05, np.float32), noise_sigma=np.diag([0.8, 1.2]).astype(
    np.float32), lambda_=np.float32(0.8), u_min=np.full(2, -1.0, np.float32),
    u_max=np.full(2, 1.0, np.float32), u_init=np.zeros(2, np.float32))


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_fused_iterations_match_chained_jax_kernels(monkeypatch, variant):
    """One step of three iterations, each a call of the kernel's plain
    version on its own bits, against three JAX interpret-mode kernel calls
    chained through the same operands and updates
    (``tests/test_torch_fused_solve.py:211-274`` for one)."""
    nu, D = 2, TF * 2
    nsp = NSPF if variant == "kmppi" else 0
    R = nsp * nu if variant == "kmppi" else D
    flags = dict(sample_null_action=True, num_support_pts=nsp, smppi=variant == "smppi")
    jcfg = JConfig(nx=2, nu=nu, K=KF, T=TF, dtype=F32, diag_sigma=True, num_iterations=3,
                   **flags)
    cfg = MPPIConfig(nx=2, nu=nu, K=KF, T=TF, diag_sigma=True, num_iterations=3, **flags)
    jmake = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
             "kmppi": PR.make_transposed_kmppi_solve}[variant]
    solve_j = jmake(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                    rng_in_kernel=False)
    pmake = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
             "kmppi": FS.make_transposed_kmppi_solve}[variant]
    assert pmake(cfg, LQ).bits_cols == solve_j.K_pad
    rs = np.random.RandomState(8)
    bits = [_rand_bits(rs, (R, solve_j.K_pad)) for _ in range(3)]
    fed = iter(bits)
    monkeypatch.setattr(FS, "key_to_seed", lambda s: torch.from_numpy(next(fed)))
    make = {"mppi": PS.make_mppi_step, "smppi": PS.make_smppi_step,
            "kmppi": PS.make_kmppi_step}[variant]
    fns = make(cfg, LQ.dynamics, LQ.running_cost, use_pallas=True)
    assert fns.fused

    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    base = params_from_numpy(**FIELDS)
    U0 = (rs.randn(TF, nu) * 0.3).astype(np.float32)
    x0 = np.array([-3.0, -2.0], np.float32)
    x0T = JS._x0_to_lanes(jnp.asarray(x0), KF)
    U = JS._shift_U(jnp.asarray(U0), jp.u_init)
    lam = jp.lambda_
    if variant == "smppi":
        w, dt = np.float32(2.0), np.float32(0.5)
        amax = np.full(2, 1.5, np.float32)
        as0 = (rs.randn(TF, nu) * 0.2).astype(np.float32)
        seq = jnp.roll(jnp.asarray(as0), -1, axis=0)
        seq = seq.at[-1].set(seq[-2])
        params = SMPPIParams(base, torch.from_numpy(-amax), torch.from_numpy(amax),
                             torch.tensor(w), torch.tensor(dt))
        state = SMPPIState(U=torch.from_numpy(U0), action_sequence=torch.from_numpy(as0), seed=0)
    elif variant == "kmppi":
        full, shift = PK.interpolation_operators(PK.RBFKernel(2.0), TF, nsp, torch.float32)
        th0 = (rs.randn(nsp, nu) * 0.3).astype(np.float32)
        theta = jnp.asarray(shift.numpy()) @ jnp.asarray(th0)
        jfull = jnp.asarray(full.numpy())
        Wt = jnp.kron(jfull, jnp.eye(nu, dtype=F32))
        params = KMPPIParams(base, full, shift)
        state = KMPPIState(U=torch.from_numpy(U0), theta=torch.from_numpy(th0), seed=0)
    else:
        params, state = base, MPPIState(U=torch.from_numpy(U0), seed=0)

    lo_t, hi_t = (jnp.tile(b, TF) for b in (jp.u_min, jp.u_max))
    for b in bits:
        reps = nsp if variant == "kmppi" else TF
        sigma_inv, op, mu_t, lo2, hi2 = JS._transposed_operands(
            jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, reps, nu, F32)
        a_flat = (lam * (U @ sigma_inv.T)).reshape(D)
        if variant == "mppi":
            out = solve_j(jnp.asarray(b), x0T, U.reshape(D), op, mu_t, lo2, hi2, a_flat, lam)
        elif variant == "smppi":
            out = solve_j(jnp.asarray(b), x0T, U.reshape(D), seq.reshape(D), op, mu_t, lo2, hi2,
                          jnp.tile(jnp.asarray(-amax), TF), jnp.tile(jnp.asarray(amax), TF),
                          a_flat, lam, w, dt)
        else:
            out = solve_j(jnp.asarray(b), x0T, U.reshape(D), theta.reshape(R), op, mu_t, lo2,
                          hi2, lo_t, hi_t, a_flat, Wt, lam)
        delta, m, s, cost_j = out[:4]
        if variant == "kmppi":
            theta = theta + (delta / s).reshape(nsp, nu)
            U = jfull @ theta
        else:
            U = U + (delta / s).reshape(TF, nu)
    new, action, art = fns.step(params, state, torch.from_numpy(x0))
    np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(cost_j), **TOL_C)
    np.testing.assert_allclose(new.U.numpy(), np.asarray(U), **TOL_U)
    if variant == "smppi":
        np.testing.assert_allclose(new.action_sequence.numpy(), np.asarray(seq + U * dt), **TOL_U)
    if variant == "kmppi":
        np.testing.assert_allclose(new.theta.numpy(), np.asarray(theta), **TOL_U)
    assert new.counter == 3


def test_legacy_iterations_match_jax(monkeypatch):
    """The legacy route (the rollout and the weighted update, twice an
    iteration) with three iterations against JAX's legacy kernels in
    interpret mode, on the same normals."""
    Kl, Tl = 128, 5
    jcfg = JConfig(nx=2, nu=2, K=Kl, T=Tl, dtype=F32, diag_sigma=True, num_iterations=3)
    jfns = JS.make_mppi_step(jcfg, jdyn, jcost, jit=False, use_pallas="rollout")
    cfg = MPPIConfig(nx=2, nu=2, K=Kl, T=Tl, diag_sigma=True, num_iterations=3)
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas="rollout")
    assert fns.fused
    U0 = (np.random.RandomState(1).randn(Tl, 2) * 0.3).astype(np.float32)
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    jstate = JState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0))
    params, state = params_from_numpy(**FIELDS), MPPIState(U=torch.from_numpy(U0), seed=0)
    _normal_bank(monkeypatch)
    x0 = np.array([-3.0, -2.0], np.float32)
    for _ in range(2):
        jstate, jaction, jart = jfns.step(jp, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **TOL_C)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **TOL_U)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **TOL_U)
        x0 = x0 + 0.2
    assert state.counter == 6


@pytest.mark.parametrize("mode", ["bits", "operand"])
def test_batched_kernel_iterations_match_jax(monkeypatch, mode):
    """The batched kernel's plain version, once an iteration, against JAX's
    batched kernel through ``transposed_solve_override``: three iterations
    a command on consecutive bits (or operand draws)."""
    Nb, Kb, Tb = 2, 256, 5
    D = Tb * 2
    jcfg = JConfig(nx=2, nu=2, K=Kb, T=Tb, dtype=F32, diag_sigma=True, num_iterations=3)
    cfg = MPPIConfig(nx=2, nu=2, K=Kb, T=Tb, diag_sigma=True, num_iterations=3)
    solve_j = PR.make_transposed_batched_solve(
        jcfg, Nb, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), block_k=128,
        rng_in_kernel=mode != "bits", noise_operand=mode == "operand")
    solve_p = FS.make_transposed_batched_solve(cfg, Nb, LQ, pair_block=solve_j.block_k,
                                               noise_operand=mode == "operand")
    jfns = JS.make_batched_step(jcfg, Nb, jdyn, jcost, jit=False,
                                transposed_solve_override=solve_j)
    fns = PS.make_batched_step(cfg, Nb, LQ.dynamics, LQ.running_cost,
                               transposed_solve_override=solve_p)
    if mode == "bits":
        rs = np.random.RandomState(4)
        bits = [_rand_bits(rs, (D, solve_p.bits_cols)) for _ in range(6)]
        jfed, pfed = iter(bits), iter(bits)
        monkeypatch.setattr(PR, "key_to_seed", lambda k: jnp.asarray(next(jfed)))
        monkeypatch.setattr(FS, "key_to_seed", lambda s: torch.from_numpy(next(pfed)))
    else:
        jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
        monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
            jbank.randn(Kb, D).astype(np.float32)))
        monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
            pbank.randn(Kb, D).astype(np.float32)))
    U0 = (np.random.RandomState(1).randn(Nb, Tb, 2) * 0.3).astype(np.float32)
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    jstate = JS.BatchedState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0))
    params, state = params_from_numpy(**FIELDS), batched_state_from_numpy(U0, seed=0)
    x0 = np.array([[-3.0, -2.0], [1.0, 1.0]], np.float32)
    for _ in range(2):
        jstate, jaction, jart = jfns.step(jp, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **TOL_C)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **TOL_U)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **TOL_U)
    assert state.counter == 6


# -- num_iterations = 1, and the gates ---------------------------------------

ROUTES = [("mppi", False), ("mppi", True), ("mppi", "rollout"), ("smppi", False), ("smppi", True),
          ("kmppi", False), ("kmppi", True), ("batched", False), ("batched", "force"),
          ("batched", "kernel_rng")]


@pytest.mark.parametrize("name,use_pallas", ROUTES,
                         ids=[f"{n}_{u}" for n, u in ROUTES])
def test_one_iteration_is_the_default_bit_for_bit(name, use_pallas):
    """``num_iterations = 1`` is the default command on every route: the
    same actions, costs and nominal sequences bit for bit."""
    _, pcls, _, pkw, _ = _variant(name)
    pkw = dict(pkw, num_samples=256)
    c0 = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, seed=3, use_pallas=use_pallas,
              **pkw)
    c1 = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, seed=3, use_pallas=use_pallas,
              num_iterations=1, **pkw)
    assert c0._fns.fused == c1._fns.fused == bool(use_pallas)
    x = torch.from_numpy(_start(name))
    for _ in range(3):
        a0, a1 = c0.command(x), c1.command(x)
        assert torch.equal(a0, a1) and torch.equal(c0.cost_total, c1.cost_total)
        assert torch.equal(c0.U, c1.U)
        x = x + 0.2 * a0
    assert c1._state.counter == 3


@pytest.mark.parametrize("name", VARIANTS)
def test_zero_iterations_raise(name):
    """The controller's ValueError, and the factory's with JAX's text."""
    _, pcls, _, pkw, _ = _variant(name)
    with pytest.raises(ValueError, match="num_iterations must be >= 1"):
        pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_iterations=0, **pkw)
    fields = dict(nx=2, nu=2, K=16, T=5, num_iterations=0,
                  num_support_pts=NSP if name == "kmppi" else 0)
    with pytest.raises(ValueError) as err:
        if name == "batched":
            PS.make_batched_step(MPPIConfig(**fields), 2, LQ.dynamics, LQ.running_cost)
        else:
            getattr(PS, f"make_{name}_step")(MPPIConfig(**fields), LQ.dynamics, LQ.running_cost)
    with pytest.raises(ValueError) as jerr:
        if name == "batched":
            JS.make_batched_step(JConfig(**fields), 2, jdyn, jcost)
        else:
            getattr(JS, f"make_{name}_step")(JConfig(**fields), jdyn, jcost)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("bad", [0.0, -0.1, 1.5])
def test_adaptive_cov_lr_validated(bad):
    with pytest.raises(ValueError, match=r"adaptive_cov_lr must be in \(0, 1\]"):
        P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=16, horizon=4,
               device="cpu", num_iterations=2, adaptive_covariance=True, adaptive_cov_lr=bad)


@pytest.mark.parametrize("name", ["mppi", "smppi", "kmppi"])
def test_adaptive_covariance_with_one_iteration_warns_and_changes_nothing(caplog, name):
    _, pcls, _, pkw, _ = _variant(name)
    x = torch.tensor([0.5, -0.5])
    base = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), seed=4, **pkw).command(x)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        on = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), seed=4,
                  adaptive_covariance=True, **pkw).command(x)
    assert torch.equal(base, on)
    assert "adaptive_covariance with num_iterations=1 has no effect" in caplog.text


@pytest.mark.parametrize("name,use_pallas", [("mppi", True), ("mppi", "rollout"),
                                             ("smppi", True), ("kmppi", True)])
def test_adaptive_covariance_takes_the_plain_path(caplog, name, use_pallas):
    """It reads each iteration's noise and omega, which the kernels keep
    out of memory: ``use_pallas`` takes the plain path with JAX's warning,
    and the plain path's artifacts are there."""
    _, pcls, _, pkw, _ = _variant(name)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_iterations=2,
                 adaptive_covariance=True, use_pallas=use_pallas, **pkw)
    assert not c._fns.fused
    assert "needs the per-iteration noise/omega artifacts" in caplog.text
    c.command(torch.tensor([0.5, -0.5]))
    assert c.noise is not None


def test_batched_rejects_adaptive_covariance():
    fields = dict(nx=2, nu=2, K=16, T=5, adaptive_covariance=True)
    with pytest.raises(ValueError) as err:
        PS.make_batched_step(MPPIConfig(**fields), 2, LQ.dynamics, LQ.running_cost)
    with pytest.raises(ValueError) as jerr:
        JS.make_batched_step(JConfig(**fields), 2, jdyn, jcost)
    assert str(err.value) == str(jerr.value)


# -- JAX's behaviour checks (tests/test_extensions.py), run on the port ------

F64 = torch.float64
B64 = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)
GOAL64 = torch.tensor([2.0, 2.0], dtype=F64)
SEED = 42


def linear_dynamics(state, action):
    return state + action @ B64.T


def quadratic_cost(state, action):
    return ((GOAL64 - state) ** 2).sum(-1)


def _run_iterations(num_iterations, steps=5):
    ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, torch.eye(2, dtype=F64), num_samples=128,
                  horizon=10, lambda_=1.0, seed=SEED, device="cpu",
                  num_iterations=num_iterations)
    s = torch.tensor([-3.0, -2.0], dtype=F64)
    total = 0.0
    for _ in range(steps):
        a = ctrl.command(s)
        total += float(quadratic_cost(s[None], a[None])[0])
        s = linear_dynamics(s, a)
    return total, s


def test_more_iterations_refine_faster():
    """``TestNumIterations.test_more_iterations_refine_faster``."""
    c1, s1 = _run_iterations(1, steps=8)
    c4, s4 = _run_iterations(4, steps=8)
    assert c4 <= c1 * 1.05
    assert float(torch.linalg.norm(s4 - GOAL64)) < 2.0
    assert float(torch.linalg.norm(s1 - GOAL64)) < 2.0


@pytest.mark.parametrize("cls", [P.SMPPI, P.KMPPI], ids=["smppi", "kmppi"])
def test_smppi_kmppi_multi_iteration(cls):
    """``TestNumIterations.test_smppi_kmppi_multi_iteration``."""
    ctrl = cls(linear_dynamics, quadratic_cost, 2, torch.eye(2, dtype=F64), num_samples=64,
               horizon=8, lambda_=1.0, seed=SEED, device="cpu", num_iterations=3)
    s = torch.tensor([-3.0, -2.0], dtype=F64)
    for _ in range(10):
        s = linear_dynamics(s, ctrl.command(s))
    assert torch.isfinite(s).all()
    assert float(torch.linalg.norm(GOAL64 - s)) < (4.0 if cls is P.SMPPI else 2.0)


U_MAX = torch.tensor([0.6, 0.6], dtype=F64)
BIG_SIGMA = 25.0  # a deliberately mis-scaled exploration covariance


def _run_adaptive(seed, cls=P.MPPI, steps=15, sigma=None, **extra):
    sigma = BIG_SIGMA * torch.eye(2, dtype=F64) if sigma is None else sigma
    kw = dict(dict(num_samples=256, horizon=10, num_iterations=5), **extra)
    ctrl = cls(linear_dynamics, quadratic_cost, 2, sigma, lambda_=1.0, seed=seed, device="cpu",
               u_max=U_MAX, **kw)
    s = torch.tensor([-3.0, -2.0], dtype=F64)
    for _ in range(steps):
        s = linear_dynamics(s, ctrl.command(s))
    return float(torch.min(ctrl.cost_total)), s, ctrl


def test_plan_quality_improves_with_misscaled_sigma():
    """``TestAdaptiveCovariance.test_plan_quality_improves_with_misscaled_sigma``:
    the best sampled plan's cost at least halves."""
    fixed = np.mean([_run_adaptive(s)[0] for s in range(3)])
    adapt = np.mean([_run_adaptive(s, adaptive_covariance=True, adaptive_cov_lr=0.8)[0]
                     for s in range(3)])
    assert np.isfinite(adapt)
    assert adapt < 0.5 * fixed, (adapt, fixed)


def test_adaptive_covariance_is_deterministic():
    m1, s1, _ = _run_adaptive(SEED, adaptive_covariance=True, steps=6)
    m2, s2, _ = _run_adaptive(SEED, adaptive_covariance=True, steps=6)
    assert m1 == m2 and torch.equal(s1, s2)


def test_adaptive_full_sigma_path():
    """A full sigma takes the full estimate and stays positive definite."""
    _, s, ctrl = _run_adaptive(SEED, steps=8, num_samples=128, horizon=8, num_iterations=4,
                               sigma=torch.tensor([[25.0, 5.0], [5.0, 25.0]], dtype=F64),
                               adaptive_covariance=True)
    assert torch.isfinite(s).all() and torch.isfinite(ctrl.cost_total).all()


@pytest.mark.parametrize("cls,kw", [(P.SMPPI, dict(w_action_seq_cost=0.1, delta_t=1.0)),
                                    (P.KMPPI, dict(num_support_pts=5))], ids=["smppi", "kmppi"])
def test_smppi_kmppi_adapt(cls, kw):
    _, s, _ = _run_adaptive(SEED, cls=cls, steps=12, adaptive_covariance=True, **kw)
    assert torch.isfinite(s).all()
    assert float(torch.linalg.norm(GOAL64 - s)) < 4.0


def test_null_action_closed_loop_with_adaptation():
    """Near the goal omega falls on the null row; the masked estimate keeps
    sigma finite and the loop converges."""
    _, s, _ = _run_adaptive(SEED, adaptive_covariance=True, steps=12, sample_null_action=True)
    assert torch.isfinite(s).all()
    assert float(torch.linalg.norm(GOAL64 - s)) < 2.0


def test_stochastic_iterations_repeat_on_one_seed():
    """With stochastic dynamics every iteration takes its own rollout
    stream: one seed repeats bit for bit, and three iterations move the
    counter by three."""
    def noisy(s, a, rng):
        return linear_dynamics(s, a) + 0.05 * torch.randn(s.shape, generator=rng, dtype=s.dtype)

    ctrls = [P.MPPI(noisy, quadratic_cost, 2, torch.eye(2, dtype=F64), num_samples=64,
                    horizon=6, seed=9, device="cpu", stochastic_dynamics=True, rollout_samples=2,
                    num_iterations=3) for _ in range(2)]
    x = torch.tensor([-1.0, 1.0], dtype=F64)
    for _ in range(3):
        a0, a1 = (c.command(x) for c in ctrls)
        assert torch.equal(a0, a1)
        x = linear_dynamics(x, a0)
    assert ctrls[0]._state.counter == 9

