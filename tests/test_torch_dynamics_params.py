"""``dynamics_params`` in the port against the JAX package on the CPU.

* the four controllers with a parameterised linear model,
  ``dynamics(params, state, action)``, over three chained commands against
  the JAX controllers under ``jax.disable_jit`` in float64 at 1e-10, with
  ``sample_noise_flat`` patched on both sides so that the i-th draw is the
  same; ``get_rollouts`` with the parameters;
* the parameters as a tensor, a tuple, a list and a dict, and with step
  dependence and stochastic dynamics (``dynamics(params, state, action, t)``,
  ``dynamics(params, state, action, rng)``), reassigned between commands;
* ``use_pallas`` with ``dynamics_params`` takes the plain path with the
  routing warning on every kernel route, as JAX's eligibility checks
  (``pallas_rollout.py:70, 280``).
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import legacy as LG
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

torch.set_num_threads(1)

F64 = torch.float64
TOL_64 = dict(rtol=1e-10, atol=1e-10)
K, T, NSP, N = 32, 5, 3, 3
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
P_NP = np.array([[0.8, 0.1], [-0.2, 1.1]])  # the model's parameters: x' = x + u Pᵀ
_JG, _G = jnp.asarray(GOAL_NP), torch.tensor(GOAL_NP)


def jdyn(p, s, a):
    return s + a @ p.T


def pdyn(p, s, a):
    return s + a @ p.T


def jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


def pcost(s, a):
    return ((_G - s) ** 2).sum(dim=-1)


def _variant(name):
    """(JAX class, port class, JAX keywords, port keywords, noise rows)."""
    common = dict(num_samples=K, horizon=T, lambda_=1.0, seed=3)
    jb = dict(u_min=-jnp.ones(2), u_max=jnp.ones(2))
    pb = dict(u_min=-torch.ones(2, dtype=F64), u_max=torch.ones(2, dtype=F64), device="cpu")
    if name == "smppi":
        extra = dict(w_action_seq_cost=2.0, delta_t=0.5)
        return (J.SMPPI, P.SMPPI,
                dict(common, action_min=-jnp.ones(2), action_max=jnp.ones(2), **extra, **jb),
                dict(common, action_min=-torch.ones(2, dtype=F64),
                     action_max=torch.ones(2, dtype=F64), **extra, **pb), T * 2)
    if name == "kmppi":
        return (J.KMPPI, P.KMPPI, dict(common, num_support_pts=NSP, kernel=J.RBFKernel(2.0), **jb),
                dict(common, num_support_pts=NSP, kernel=P.RBFKernel(2.0), **pb), NSP * 2)
    if name == "batched":
        return (J.MPPI_Batched, P.MPPI_Batched, dict(common, num_envs=N, **jb),
                dict(common, num_envs=N, **pb), T * 2)
    return J.MPPI, P.MPPI, dict(common, **jb), dict(common, **pb), T * 2


def _noise_bank(monkeypatch, rows):
    jbank, pbank = np.random.RandomState(7), np.random.RandomState(7)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, rows) * 0.6))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, rows) * 0.6))


@pytest.mark.parametrize("name", ["mppi", "smppi", "kmppi", "batched"])
def test_controllers_match_jax(monkeypatch, name):
    """Three chained commands with the model's parameters, reassigned
    before the third, against JAX: costs, actions and U at 1e-10."""
    jcls, pcls, jkw, pkw, rows = _variant(name)
    sigma = np.eye(2) * 0.5
    jc = jcls(jdyn, jcost, 2, jnp.asarray(sigma), dynamics_params=jnp.asarray(P_NP), **jkw)
    pc = pcls(pdyn, pcost, 2, torch.from_numpy(sigma), dynamics_params=torch.from_numpy(P_NP),
              **pkw)
    assert pc.config.parameterized_dynamics and not pc._fns.fused
    if name != "smppi":
        shape = (N, T, 2) if name == "batched" else (T, 2)
        U0 = np.random.RandomState(1).randn(*shape) * 0.3
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    x = np.array([[-1.0, 0.5], [0.5, -1.0], [0.0, 0.0]])
    x = x if name == "batched" else x[0]
    _noise_bank(monkeypatch, rows)
    with jax.disable_jit():
        for i in range(3):
            if i == 2:  # a retrained model
                jc.dynamics_params = jnp.asarray(P_NP * 0.5)
                pc.dynamics_params = torch.from_numpy(P_NP * 0.5)
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total),
                                       **TOL_64)
            np.testing.assert_allclose(ap, aj, **TOL_64)
            np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **TOL_64)
            x = x + 0.2 * ap
        if name != "batched":
            rj = jc.get_rollouts(jnp.asarray(x), num_rollouts=2)
            rp = pc.get_rollouts(torch.from_numpy(x), num_rollouts=2)
            np.testing.assert_allclose(rp.numpy(), np.asarray(rj), **TOL_64)


@pytest.mark.parametrize("kind", ["tensor", "tuple", "list", "dict"])
def test_parameter_containers(kind):
    """The parameters reach the dynamics as given, unchanged, at every
    rollout step of every command."""
    p = torch.from_numpy(P_NP)
    params = {"tensor": p, "tuple": (p, torch.zeros(2, dtype=F64)),
              "list": [p, torch.zeros(2, dtype=F64)], "dict": {"P": p}}[kind]
    seen = []

    def dyn(prm, s, a):
        seen.append(prm)
        m = prm if kind == "tensor" else prm["P"] if kind == "dict" else prm[0]
        return s + a @ m.T

    ctrl = P.MPPI(dyn, pcost, 2, torch.eye(2, dtype=F64), num_samples=8, horizon=4,
                  device="cpu", dynamics_params=params)
    ctrl.command(torch.zeros(2, dtype=F64))
    ctrl.get_rollouts(torch.zeros(2, dtype=F64))
    assert len(seen) == 8 and all(s is params for s in seen)


def test_step_dependent_and_stochastic_signatures():
    """``dynamics(params, state, action, t)`` with step dependence and
    ``dynamics(params, state, action, rng)`` with stochastic dynamics."""
    p = torch.from_numpy(P_NP)
    calls = []

    def dyn_t(prm, s, a, t):
        calls.append(("t", t))
        return s + a @ prm.T

    def dyn_rng(prm, s, a, rng):
        calls.append(("rng", type(rng).__name__))
        return s + a @ prm.T + 0.01 * torch.randn(s.shape, generator=rng, dtype=s.dtype)

    def cost_t(s, a, t):
        return pcost(s, a)

    P.MPPI(dyn_t, cost_t, 2, torch.eye(2, dtype=F64), num_samples=8, horizon=3, device="cpu",
           step_dependent_dynamics=True, dynamics_params=p).command(torch.zeros(2, dtype=F64))
    P.MPPI(dyn_rng, pcost, 2, torch.eye(2, dtype=F64), num_samples=8, horizon=3, device="cpu",
           stochastic_dynamics=True, dynamics_params=p).command(torch.zeros(2, dtype=F64))
    assert calls == [("t", 0), ("t", 1), ("t", 2)] + [("rng", "Generator")] * 3


LQ = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor([2.0, 2.0]))


@pytest.mark.parametrize("cls,use_pallas", [(P.MPPI, True), (P.MPPI, "rollout"),
                                            (P.SMPPI, True), (P.KMPPI, True),
                                            (P.MPPI_Batched, "force")])
def test_kernel_routes_take_the_plain_path(caplog, cls, use_pallas):
    """A kernel model with ``dynamics_params`` is ineligible, as in JAX: the
    plain path runs, after the routing warning."""
    kw = dict(num_envs=3) if cls is P.MPPI_Batched else {}
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=300, horizon=4,
                   device="cpu", use_pallas=use_pallas, dynamics_params=torch.zeros(()), **kw)
    assert not ctrl._fns.fused
    assert "parameterized dynamics" in caplog.text
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=4, parameterized_dynamics=True)
    assert not FS.transposed_eligible(cfg) and not LG.pallas_eligible(cfg)
