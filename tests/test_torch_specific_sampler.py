"""The specific-action sampler in the port against the JAX package on the CPU.

* ``SpecificActionSampler`` rows and its ``specific_dynamics`` hook in the
  MPPI, SMPPI and KMPPI controllers against the JAX controllers over three
  chained commands, with the null row on and off and at M = 1 and M = 3,
  on the same noise (``sample_noise_flat`` patched on both sides, the JAX
  side under ``jax.disable_jit``): the hook's ``state`` argument is the new
  state at M = 1 and the initial state at M > 1 (the reference's quirks),
  its action the ``u_scale``-scaled one, and the sampler reads ``info``;
* ``rollout_costs`` with the hook against JAX's in float64;
* ``info`` reaching the sampler, ``register_sample_start_end``, the row
  order [null, sampler rows, elites] (JAX's
  ``TestEliteReuse.test_injection_rows_and_refresh``) and the warnings that
  route a sampler to the plain path.

Float32 parity: costs and states rtol 2e-5 / atol 1e-5, commands rtol 2e-4
/ atol 2e-6, the injected rows rtol 1e-5 / atol 1e-6
(``tests/test_pallas_transposed.py:102-107``); float64 1e-10.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
TOL_P = dict(rtol=1e-5, atol=1e-6)
LQ = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
K, T, NSP, N_SPECIFIC = 32, 5, 3, 2
_JB, _JG = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
RAMP = np.linspace(-1.2, 1.2, N_SPECIFIC * T * 2).reshape(N_SPECIFIC, T, 2).astype(np.float32)


def jdyn(s, a):
    return s + a @ _JB.T


def jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


class JRamps(J.SpecificActionSampler):
    """Two ramps scaled by ``info["scale"]`` and moved by the state, with a
    hook that reads every argument."""

    num_trajectories = N_SPECIFIC

    def sample_trajectories(self, state, info):
        return info["scale"] * jnp.asarray(RAMP) + 0.1 * state.sum()

    def specific_dynamics(self, next_state, state, action, t):
        return next_state - 0.1 * (next_state - state) + 0.01 * action[..., :1] + 0.005 * t


class PRamps(P.SpecificActionSampler):
    num_trajectories = N_SPECIFIC

    def sample_trajectories(self, state, info):
        return info["scale"] * torch.from_numpy(RAMP) + 0.1 * state.sum()

    def specific_dynamics(self, next_state, state, action, t):
        return next_state - 0.1 * (next_state - state) + 0.01 * action[..., :1] + 0.005 * t


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
    return J.MPPI, P.MPPI, dict(common, **jb), dict(common, **pb), T * 2


def _noise_bank(monkeypatch, rows):
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, rows).astype(np.float32) * 0.6))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, rows).astype(np.float32) * 0.6))


@pytest.mark.parametrize("M", [1, 3], ids=["M1", "M3"])
@pytest.mark.parametrize("null", [False, True], ids=["null_off", "null_on"])
@pytest.mark.parametrize("name", ["mppi", "smppi", "kmppi"])
def test_sampler_matches_jax_controller(monkeypatch, name, null, M):
    """Three chained commands with a sampler of two rows and its hook:
    costs, commands, the stored states (M = 3) and the injected rows."""
    jcls, pcls, jkw, pkw, rows = _variant(name)
    kw = dict(sample_null_action=null, rollout_samples=M)
    jc = jcls(jdyn, jcost, 2, jnp.eye(2, dtype=F32) * 0.5, specific_action_sampler=JRamps(),
              **jkw, **kw)
    pc = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5,
              specific_action_sampler=PRamps(), **pkw, **kw)
    assert pc.config.num_specific_trajectories == N_SPECIFIC and not pc._fns.fused
    if name != "smppi":
        U0 = (np.random.RandomState(1).randn(T, 2) * 0.3).astype(np.float32)
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    _noise_bank(monkeypatch, rows)
    x = np.array([-1.0, 0.5], np.float32)
    i0 = int(null)
    with jax.disable_jit():
        for scale in (0.5, 1.0, 2.0):
            aj = np.asarray(jc.command(jnp.asarray(x), info={"scale": jnp.float32(scale)}))
            ap = pc.command(torch.from_numpy(x), info={"scale": torch.tensor(scale)}).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total), **TOL_C)
            np.testing.assert_allclose(ap, aj, **TOL_U)
            np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **TOL_U)
            rows_p = pc.perturbed_action[i0:i0 + N_SPECIFIC].numpy()
            np.testing.assert_allclose(rows_p, np.asarray(jc.perturbed_action[i0:i0 + N_SPECIFIC]),
                                       **TOL_P)
            if name != "smppi":  # SMPPI's rows are the integrated actions, clamped
                want = np.clip(scale * RAMP + 0.1 * x.sum(), -1.0, 1.0)
                np.testing.assert_allclose(rows_p, want, **TOL_P)
            if null:
                assert not pc.perturbed_action[0].any()
            if M > 1:
                assert pc.states.shape == (M, K, T, 2)
                np.testing.assert_allclose(pc.states.numpy(), np.asarray(jc.states), **TOL_C)
            x = (x + 0.2 * ap).astype(np.float32)


@pytest.mark.parametrize("M", [1, 3], ids=["M1", "M3"])
def test_rollout_hook_matches_jax(M):
    """``rollout_costs`` with the hook in float64: the hook sees the new
    state again at M = 1 and x0 at every step at M > 1, (M, K, ·) shapes and
    the scaled action; a recording hook shows each."""
    rs = np.random.RandomState(5)
    Kr, Tr = 6, 4
    fields = dict(nx=2, nu=2, K=Kr, T=Tr, M=M, u_scale=0.7)
    jcfg = JConfig(dtype=jnp.float64, **fields)
    cfg = MPPIConfig(dtype=torch.float64, **fields)
    x0 = rs.randn(2)
    pert = rs.randn(Kr, Tr, 2)
    B64 = torch.tensor(B_NP, dtype=torch.float64)
    seen = []

    def jhook(n, s, a, t):
        return n - 0.1 * (n - s) + 0.01 * a[..., :1] + 0.005 * t

    def phook(n, s, a, t):
        seen.append((n.clone(), s.clone(), a.clone(), t))
        return n - 0.1 * (n - s) + 0.01 * a[..., :1] + 0.005 * t

    jB = jnp.asarray(B_NP, jnp.float64)
    jG = jnp.asarray(GOAL_NP, jnp.float64)
    want, _, _ = JS.rollout_costs(
        jcfg, JS.wrap_dynamics(jcfg, lambda s, a: s + a @ jB.T),
        JS.wrap_cost(jcfg, lambda s, a: ((jG - s) ** 2).sum(-1)), None, jhook, None,
        jnp.asarray(x0), jnp.asarray(pert), jax.random.PRNGKey(0))
    pG = torch.tensor(GOAL_NP, dtype=torch.float64)
    got, _, _ = PS.rollout_costs(
        cfg, PS.wrap_dynamics(cfg, lambda s, a: s + a @ B64.T),
        PS.wrap_cost(cfg, lambda s, a: ((pG - s) ** 2).sum(-1)), torch.tensor(x0),
        torch.tensor(pert), specific_dynamics=phook)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    assert [t for *_, t in seen] == list(range(Tr))
    for n, s, a, t in seen:
        assert n.shape == s.shape == (M, Kr, 2) and a.shape == (M, Kr, 2)
        torch.testing.assert_close(a[0], torch.tensor(pert[:, t]) * 0.7)
        if M == 1:
            assert torch.equal(s, n)
        else:
            assert torch.equal(s, torch.tensor(x0).expand(M, Kr, 2))


def test_info_reaches_the_sampler():
    """JAX's ``test_info_passed_to_sampler``."""
    captured = {}

    class InfoSampler(P.SpecificActionSampler):
        num_trajectories = 1

        def sample_trajectories(self, state, info):
            captured["info"] = info
            return info["bias"].expand(1, 5, 2)

    ctrl = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=32, horizon=5,
                  lambda_=1.0, seed=42, specific_action_sampler=InfoSampler(), device="cpu")
    info = {"bias": torch.full((2,), 0.25)}
    ctrl.command(torch.zeros(2), info=info)
    assert captured["info"] is info and ctrl.info is info
    assert torch.allclose(ctrl.perturbed_action[0], torch.tensor(0.25))


@pytest.mark.parametrize("null", [False, True], ids=["null_off", "null_on"])
def test_register_sample_start_end(null):
    """The constructor registers the sampler's rows, after the null row."""
    s = PRamps()
    assert (s.start_idx, s.end_idx, s.slice) == (0, 0, slice(0, 0))
    P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=16, horizon=T,
           sample_null_action=null, specific_action_sampler=s, device="cpu")
    i0 = int(null)
    assert (s.start_idx, s.end_idx, s.slice) == (i0, i0 + N_SPECIFIC,
                                                 slice(i0, i0 + N_SPECIFIC))


def test_default_hook_is_the_identity():
    s = P.SpecificActionSampler()
    x = torch.randn(1, 3, 2)
    assert s.specific_dynamics(x, None, None, 0) is x
    with pytest.raises(NotImplementedError):
        s.sample_trajectories(None, None)
    assert P.SpecificActionSampler.num_trajectories == 1


class _Ramp(P.SpecificActionSampler):
    num_trajectories = 1

    def sample_trajectories(self, state, info):
        return 0.25 * torch.ones((1, 8, 2), dtype=torch.float64)


def test_row_order_null_sampler_elites():
    """JAX's ``test_injection_rows_and_refresh``: with the null row, a sampler
    and elites the leading rows are [null, sampler, elites]; the elite rows
    are the last command's top-k shifted and clamped, and the stored elites
    this command's top-k."""
    B64 = torch.tensor(B_NP, dtype=torch.float64)
    G64 = torch.tensor(GOAL_NP, dtype=torch.float64)

    def dyn(s, a):
        return s + a @ B64.T

    def cost(s, a):
        return ((G64 - s) ** 2).sum(-1)

    E = 3
    ctrl = P.MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), num_samples=24, horizon=8,
                  lambda_=1.0, seed=3, u_min=-torch.ones(2, dtype=torch.float64),
                  u_max=torch.ones(2, dtype=torch.float64), sample_null_action=True,
                  specific_action_sampler=_Ramp(), num_elites=E, device="cpu")
    x = torch.tensor([-2.0, 1.0], dtype=torch.float64)
    ctrl.command(x)
    prev = ctrl._state.elites
    idx = torch.sort(ctrl.cost_total, stable=True).indices[:E]
    assert torch.equal(ctrl.perturbed_action[idx], prev)
    ctrl.command(dyn(x, ctrl.U[0]))
    assert not ctrl.perturbed_action[0].any()
    assert torch.allclose(ctrl.perturbed_action[1], torch.tensor(0.25, dtype=torch.float64))
    want = torch.clamp(PS._shift_elites(prev, ctrl.u_init), -1.0, 1.0)
    assert torch.equal(ctrl.perturbed_action[2:2 + E], want)


def test_injected_rows_are_masked_from_adaptive_covariance(monkeypatch):
    """The null row, the sampler's rows and the elites are left out of the
    estimate: JAX's count (``solve.py:1114-1118``) on both sides."""
    calls = []
    real = PS.adapt_covariance

    def spy(config, sigma, omega, noise, n_injected=0):
        calls.append(n_injected)
        return real(config, sigma, omega, noise, n_injected)

    monkeypatch.setattr(PS, "adapt_covariance", spy)
    for kw, n in ((dict(sample_null_action=True, specific_action_sampler=PRamps()), 3),
                  (dict(specific_action_sampler=PRamps(), num_elites=2), 4),
                  (dict(num_elites=2), 2)):
        calls.clear()
        c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=16, horizon=T,
                   num_iterations=2, adaptive_covariance=True, device="cpu", **kw)
        c.command(torch.zeros(2), info={"scale": torch.tensor(1.0)})
        assert calls == [n]


@pytest.mark.parametrize("name,use_pallas", [("mppi", True), ("mppi", "rollout"),
                                             ("smppi", True), ("kmppi", True)])
def test_sampler_takes_the_plain_path_with_a_warning(caplog, name, use_pallas):
    """A sampler's rows and hook are not the kernels': the plain path, with
    the routes' warnings (JAX's controller always passes the hook)."""
    _, pcls, _, pkw, _ = _variant(name)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = pcls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), use_pallas=use_pallas,
                 specific_action_sampler=PRamps(), **pkw)
    assert not c._fns.fused
    said = "specific_dynamics" if use_pallas == "rollout" else "specific sampler"
    assert said in caplog.text
    c.command(torch.zeros(2), info={"scale": torch.tensor(1.0)})
    assert c.noise is not None


def test_legacy_route_keeps_its_kernels_for_rows_without_a_hook():
    """At the ops layer, sampler rows without a hook are a row write before
    the legacy kernels, as JAX's ``pallas_eligible(has_specific)``."""
    cfg = MPPIConfig(nx=2, nu=2, K=64, T=T, num_specific_trajectories=N_SPECIFIC)
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas="rollout",
                            sample_trajectories=lambda s, i: torch.from_numpy(RAMP))
    assert fns.fused
