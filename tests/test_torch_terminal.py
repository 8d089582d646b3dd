"""Terminal costs in the port against the JAX package on the CPU.

* the four controllers on the plain path with ``terminal_state_cost`` and
  with ``terminal_final_cost`` against the JAX controllers, fed the same
  noise (``sample_noise_flat`` patched on both sides; the JAX side under
  ``jax.disable_jit`` so that every command draws): commands, ``cost_total``
  and the stored ``states``;
* ``terminal_final_cost`` bit for bit against the same cost given as
  ``terminal_state_cost`` (JAX's ``test_bit_identical_to_full_terminal``),
  with the rollout states kept only for the latter;
* the plain versions of the four fused kernels with ``quadratic_terminal``
  against JAX's ``make_transposed_{fused,smppi,kmppi,batched}_solve(
  terminal_final=...)`` in Pallas interpret mode, fed the same int32 bits
  (``tests/test_pallas_transposed.py:1085-1115``);
* the hooks' ValueError, and the warnings that route to the plain path.

Float32 on both sides.  Costs and states rtol 2e-5 / atol 1e-5, updates
and commands rtol 2e-4 / atol 2e-6 (``tests/test_pallas_transposed.py:
102-107``: float32 summation order).  The CUDA kernels are held against
the plain versions on the card by ``chip_smoke.py``.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import kernels as PK
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import (
    find_kernel_terminal,
    linear_quadratic,
    quadratic_terminal,
)

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
TERM_GOAL = np.array([1.5, -0.5], np.float32)
W_STATE, W_ACTION = 10.0, 0.1
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
LQ = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
K, T, NSP, N = 32, 5, 3, 3

_JB, _JG, _JTG = (jnp.asarray(v, F32) for v in (B_NP, GOAL_NP, TERM_GOAL))


def jdyn(s, a):
    return s + a @ _JB.T


def jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


def jfterm(s, a):
    return W_STATE * ((s - _JTG) ** 2).sum(axis=-1) + W_ACTION * (a ** 2).sum(axis=-1)


def jfull(states, actions):
    return jfterm(states[..., -1, :], actions[..., -1, :])


P_FTERM = quadratic_terminal(TERM_GOAL, W_STATE, W_ACTION)


def pfull(states, actions):
    return P_FTERM(states[..., -1, :], actions[..., -1, :])


# the four controllers: (JAX class, port class, keywords of each, noise rows)
def _variant(name):
    common = dict(num_samples=K, horizon=T, lambda_=1.0, u_scale=0.7)
    jb = dict(u_min=-jnp.ones(2, F32), u_max=jnp.ones(2, F32))
    pb = dict(u_min=-torch.ones(2), u_max=torch.ones(2), device="cpu")
    if name == "mppi":
        return J.MPPI, P.MPPI, dict(common, **jb), dict(common, **pb), T * 2
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
    return J.MPPI_Batched, P.MPPI_Batched, dict(common, num_envs=N, **jb), \
        dict(common, num_envs=N, **pb), T * 2


VARIANTS = ("mppi", "smppi", "kmppi", "batched")


def _noise_bank(monkeypatch, rows):
    """The same (K, rows) noise for the i-th ``sample_noise_flat`` call on
    either side."""
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, rows).astype(np.float32) * 0.6))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, rows).astype(np.float32) * 0.6))


def _pair(name, hook):
    """JAX and port controllers of one variant with the same nominal
    sequence, with the terminal cost as ``hook``."""
    jcls, pcls, jkw, pkw, _ = _variant(name)
    if hook == "state":
        jkw, pkw = dict(jkw, terminal_state_cost=jfull), dict(pkw, terminal_state_cost=pfull)
    else:
        jkw, pkw = dict(jkw, terminal_final_cost=jfterm), dict(pkw, terminal_final_cost=P_FTERM)
    jc = jcls(jdyn, jcost, 2, jnp.eye(2, dtype=F32) * 0.5, **jkw)
    pc = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, **pkw)
    if name in ("mppi", "kmppi", "batched"):
        shape = (N, T, 2) if name == "batched" else (T, 2)
        U0 = (np.random.RandomState(1).randn(*shape) * 0.3).astype(np.float32)
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    return jc, pc


def _start(name):
    x = np.array([[-1.0, 0.5], [0.5, -1.0], [0.0, 0.0]], np.float32)
    return x if name == "batched" else x[0]


@pytest.mark.parametrize("hook", ["state", "final"])
@pytest.mark.parametrize("name", VARIANTS)
def test_controllers_match_jax(monkeypatch, name, hook):
    """Three commands of each controller on the plain path with each hook,
    on the same noise as JAX's: commands, costs and the stored states."""
    jc, pc = _pair(name, hook)
    assert not pc._fns.fused
    _noise_bank(monkeypatch, _variant(name)[4])
    x = _start(name)
    with jax.disable_jit():
        for _ in range(3):
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total), **TOL_C)
            np.testing.assert_allclose(ap, aj, **TOL_U)
            if hook == "state":
                assert pc.states.shape == np.asarray(jc.states).shape
                np.testing.assert_allclose(pc.states.numpy(), np.asarray(jc.states), **TOL_C)
            else:
                assert pc.states is None and jc.states is None
            x = (x + 0.2 * ap[..., :2]).astype(np.float32)


@pytest.mark.parametrize("name", VARIANTS)
def test_final_cost_bit_identical_to_full_terminal(name):
    """The same cost through either hook gives the same commands and costs
    bit for bit (both add the same float32 value to each sample's running
    cost), and only the full-trajectory hook keeps the rollout states."""
    _, pcls, _, pkw, _ = _variant(name)
    full = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, seed=11,
                terminal_state_cost=pfull, **pkw)
    fin = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, seed=11,
               terminal_final_cost=P_FTERM, **pkw)
    x = torch.from_numpy(_start(name))
    for _ in range(3):
        a1, a2 = full.command(x), fin.command(x)
        assert torch.equal(a1, a2) and torch.equal(full.cost_total, fin.cost_total)
        x = x + 0.2 * a1
    assert full.states is not None and fin.states is None


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _kernel_pair(variant, jcfg, cfg, jdyn_, jcost_, model, **kw):
    """JAX's transposed factory (injected bits) and the port's, each with
    the terminal cost."""
    jmake = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
             "kmppi": PR.make_transposed_kmppi_solve}
    pmake = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
             "kmppi": FS.make_transposed_kmppi_solve}
    wd, wc = JS.wrap_dynamics(jcfg, jdyn_), JS.wrap_cost(jcfg, jcost_)
    wt = JS.wrap_final_cost(jfterm)
    if variant == "batched":
        solve_j = PR.make_transposed_batched_solve(jcfg, N, wd, wc, rng_in_kernel=False,
                                                   terminal_final=wt)
        solve_p = FS.make_transposed_batched_solve(cfg, N, model, pair_block=solve_j.block_k,
                                                   terminal_final=P_FTERM)
    else:
        solve_j = jmake[variant](jcfg, wd, wc, rng_in_kernel=False, terminal_final=wt, **kw)
        solve_p = pmake[variant](cfg, model, pair_block=solve_j.block_k,
                                 terminal_final=P_FTERM, **kw)
    return solve_j, solve_p


@pytest.mark.parametrize("variant,problem", [("mppi", "linear"), ("mppi", "pendulum"),
                                             ("smppi", "linear"), ("kmppi", "linear"),
                                             ("batched", "linear")])
def test_kernel_plain_matches_jax_kernel(variant, problem):
    """Bits mode, K = 200 (the JAX kernel pads), u_scale 1.5 (the terminal
    cost takes the last scaled action), antithetic pairs on the MPPI case."""
    rs = np.random.RandomState(7)
    Kk, Tk = 200, 6
    if problem == "pendulum":
        jd, jc_, model, nu = jpend.pendulum_dynamics, jpend.pendulum_running_cost, \
            PENDULUM_MODEL, 1
    else:
        jd, jc_, model, nu = jdyn, jcost, LQ, 2
    D = Tk * nu
    nsp = NSP if variant == "kmppi" else 0
    R = nsp * nu if variant == "kmppi" else D
    flags = dict(u_scale=1.5, antithetic=variant == "mppi" and problem == "linear",
                 num_support_pts=nsp, smppi=variant == "smppi")
    jcfg = JConfig(nx=2, nu=nu, K=Kk, T=Tk, dtype=F32, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=2, nu=nu, K=Kk, T=Tk, diag_sigma=True, **flags)
    solve_j, solve_p = _kernel_pair(variant, jcfg, cfg, jd, jc_, model)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (R, cols))
    x0 = np.array([np.pi, 1.0] if problem == "pendulum" else [-1.0, -1.0], np.float32)
    full = lambda v, n=D: np.full(n, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.1).astype(np.float32)
    a_flat, lam = U2 * 0.7, np.float32(0.8)
    if variant == "batched":
        x0T = (rs.randn(2, N) * 1.5).astype(np.float32)
        U2T = (rs.randn(D, N) * 0.3).astype(np.float32)
        operands = (x0T, U2T, full(0.8), full(0.05), full(-1.0), full(1.0),
                    (rs.randn(D, N) * 0.5).astype(np.float32), lam)
    else:
        x0T = np.broadcast_to(x0[:, None], (2, Kk))
        if variant == "mppi":
            rest = (U2, full(0.8), full(0.05), full(-1.0), full(1.0), a_flat, lam)
        elif variant == "smppi":
            rest = (U2, (rs.randn(D) * 0.2).astype(np.float32), full(0.8), full(0.05),
                    full(-2.0), full(2.0), full(-1.0), full(1.0), a_flat, lam,
                    np.float32(5.0), np.float32(0.5))
        else:
            full_k, _ = PK.interpolation_operators(PK.RBFKernel(2.0), Tk, nsp, torch.float32)
            Wt = np.kron(full_k.numpy(), np.eye(nu, dtype=np.float32))
            rest = (U2, (rs.randn(R) * 0.2).astype(np.float32), full(0.9, R), full(0.05, R),
                    full(-1.5, R), full(1.5, R), full(-1.0), full(1.0), a_flat, Wt, lam)
        operands = (x0T,) + rest
    out_j = solve_j(jnp.asarray(bits), *(jnp.asarray(v) for v in operands))
    out_p = solve_p(torch.from_numpy(bits), *(torch.from_numpy(np.array(v)) for v in operands))
    if variant == "batched":
        (delta_j, ms_j, ct_j), (delta_p, ms_p, ct_p) = out_j, out_p
        m_j, s_j, m_p, s_p = ms_j[0], ms_j[1], ms_p[0], ms_p[1]
    else:
        delta_j, m_j, s_j, ct_j = out_j[:4]
        delta_p, m_p, s_p, ct_p = out_p[:4]
    np.testing.assert_allclose(ct_p.numpy(), np.asarray(ct_j), **TOL_C)
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), **TOL_C)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=2e-5)
    np.testing.assert_allclose((delta_p / s_p).numpy(), np.asarray(delta_j / s_j), **TOL_U)
    # the terminal cost is in the costs: without it every cost is lower
    if variant == "batched":
        bare = FS.make_transposed_batched_solve(cfg, N, model, pair_block=solve_j.block_k)
    else:
        bare = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                "kmppi": FS.make_transposed_kmppi_solve}[variant](
                    cfg, model, pair_block=solve_j.block_k)
    ct_bare = bare(torch.from_numpy(bits), *(torch.from_numpy(np.array(v)) for v in operands))
    ct_bare = ct_bare[2] if variant == "batched" else ct_bare[3]
    assert bool((ct_p > ct_bare).all())


def test_quadratic_terminal_is_a_kernel_terminal_cost():
    """The plain callable is JAX's final-state cost on the same inputs, and
    it carries its constants (goal, w_state, w_action) for the kernel."""
    rs = np.random.RandomState(2)
    s, a = rs.randn(7, 2).astype(np.float32), rs.randn(7, 2).astype(np.float32)
    np.testing.assert_allclose(P_FTERM(torch.from_numpy(s), torch.from_numpy(a)).numpy(),
                               np.asarray(jfterm(jnp.asarray(s), jnp.asarray(a))), **TOL_C)
    term = find_kernel_terminal(P_FTERM)
    assert term.nx == 2 and term.cost is P_FTERM
    assert term.consts.tolist() == [1.5, -0.5, W_STATE, pytest.approx(W_ACTION)]
    assert find_kernel_terminal(pfull) is None
    with pytest.raises(ValueError, match="goal"):
        quadratic_terminal(np.zeros((2, 2)), 1.0, 1.0)
    with pytest.raises(ValueError, match="nx=3"):
        FS.make_transposed_fused_solve(MPPIConfig(nx=3, nu=2, K=8, T=3),
                                       linear_quadratic(torch.zeros(3, 2), torch.zeros(3)),
                                       terminal_final=P_FTERM)


@pytest.mark.parametrize("name", VARIANTS)
def test_hooks_are_mutually_exclusive(name):
    """Both hooks at once raise at construction, with the JAX text."""
    _, pcls, _, pkw, _ = _variant(name)
    with pytest.raises(ValueError, match="mutually exclusive") as err:
        pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_state_cost=pfull,
             terminal_final_cost=P_FTERM, **pkw)
    with pytest.raises(ValueError) as jerr:
        JS._gate_terminal(jfull, jfterm)
    assert str(err.value) == str(jerr.value)


def test_step_factory_needs_the_storage_flag():
    """A ``terminal_state_cost`` needs ``config.has_terminal_cost`` (its
    rollout states), and the flag needs the hook: a mismatch raises rather
    than dropping the cost."""
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=3)
    assert not cfg.store_rollouts and MPPIConfig(nx=2, nu=2, K=8, T=3,
                                                 has_terminal_cost=True).store_rollouts
    with pytest.raises(ValueError, match="has_terminal_cost"):
        PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, terminal_state_cost=pfull)
    with pytest.raises(ValueError, match="has_terminal_cost"):
        PS.make_batched_step(MPPIConfig(nx=2, nu=2, K=8, T=3, has_terminal_cost=True), 2,
                             LQ.dynamics, LQ.running_cost)


def _use_pallas(name):
    return "force" if name == "batched" else True


@pytest.mark.parametrize("name", VARIANTS)
def test_state_cost_takes_the_plain_path_with_a_warning(caplog, name):
    _, pcls, _, pkw, _ = _variant(name)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_state_cost=pfull,
                 use_pallas=_use_pallas(name), **pkw)
    assert not c._fns.fused
    assert "terminal_state_cost reads the (K, T, nx) rollout storage" in caplog.text


@pytest.mark.parametrize("hook", ["terminal_state_cost", "terminal_final_cost"])
def test_legacy_route_takes_no_terminal_cost(caplog, hook):
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=K, horizon=T,
                   device="cpu", use_pallas="rollout",
                   **{hook: pfull if hook == "terminal_state_cost" else P_FTERM})
    assert not c._fns.fused
    assert "a terminal cost is set, which the legacy rollout kernel does not take" in caplog.text


@pytest.mark.parametrize("name", VARIANTS)
def test_traced_final_cost_keeps_the_kernel(name):
    """A terminal callable that is not a kernel terminal cost but traces
    (``ops/batch_last.py``) keeps the kernel; its plain version's costs
    equal the same cost given as ``terminal_state_cost`` on the plain
    path's rollout of the kernel's actions."""
    _, pcls, _, pkw, _ = _variant(name)
    goal = torch.from_numpy(TERM_GOAL)

    def my_terminal(s, a):
        return W_STATE * ((s - goal) ** 2).sum(-1) + W_ACTION * (a ** 2).sum(-1)

    c = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_final_cost=my_terminal,
             use_pallas=_use_pallas(name), **pkw)
    named = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_final_cost=P_FTERM,
                 use_pallas=_use_pallas(name), **pkw)
    assert c._fns.fused and named._fns.fused
    x = torch.from_numpy(_start(name))
    a, b = c.command(x), named.command(x)
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-6)
    torch.testing.assert_close(c.cost_total, named.cost_total, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", VARIANTS)
def test_other_final_cost_takes_the_plain_path_naming_it(caplog, name):
    """A terminal callable that is not a kernel terminal cost and that the
    tracer refuses: the plain path, with a warning that names it and the
    op; a kernel terminal cost keeps the kernel (on the CPU its plain
    version), with no states stored."""
    _, pcls, _, pkw, _ = _variant(name)

    def my_terminal(s, a):  # a sort: outside the tracer's vocabulary
        return torch.sort(s, dim=-1).values[:, 0]

    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_final_cost=my_terminal,
                 use_pallas=_use_pallas(name), **pkw)
    assert not c._fns.fused
    assert "'my_terminal' cannot be traced" in caplog.text and "sort" in caplog.text
    fused = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), terminal_final_cost=P_FTERM,
                 use_pallas=_use_pallas(name), **pkw)
    assert fused._fns.fused
    action = fused.command(torch.from_numpy(_start(name)))
    assert torch.isfinite(action).all() and fused.states is None
