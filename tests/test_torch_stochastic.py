"""Stochastic rollouts in the port against the JAX package on the CPU.

* ``rollout_costs`` at M > 1 (the M-outer fold, the variance at ddof=1 and
  its discount, CVaR) against JAX's ``rollout_costs``, and with the terminal
  costs at M = 3;
* the MPPI, SMPPI and KMPPI controllers with M = 3 against the JAX
  controllers over three chained commands, on the same noise
  (``sample_noise_flat`` patched on both sides; the JAX side under
  ``jax.disable_jit`` so that every command draws);
* the port's stochastic stream: a ``torch.Generator`` a step, made from the
  iteration's rollout seed;
* ``get_rollouts`` with stochastic dynamics, the gates and ValueErrors, and
  the warnings that route M > 1 and stochastic dynamics to the plain path;
* draws with tensor arguments (``torch.bernoulli(p)``, ``torch.normal(0,
  std)``) against ``jax.random.bernoulli`` and ``jax.random.normal`` in
  distribution: the mean and variance of the rollout costs over five keys
  or seeds, within four standard errors.

The parity cases use step-dependent stochastic dynamics that add a
(T, M·K, nx) numpy table indexed by ``t`` on both sides and ignore the key
or generator: a JAX key cannot be mapped to torch draws, and a patched
``jax.random.normal`` inside the dynamics would run once at trace time under
``lax.scan``.  Tolerances: float64 1e-10; float32 costs and states rtol 2e-5
/ atol 1e-5, commands rtol 2e-4 / atol 2e-6 (``tests/test_pallas_transposed.py:
102-107``: float32 summation order).
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

B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
TOL = {"f32": dict(rtol=2e-5, atol=1e-5), "f64": dict(rtol=1e-10, atol=1e-10)}
TOL_U = dict(rtol=2e-4, atol=2e-6)
LQ = linear_quadratic(torch.tensor(B_NP, dtype=torch.float32),
                      torch.tensor(GOAL_NP, dtype=torch.float32))


def _table_models(table, jdt, tdt):
    """Step-dependent stochastic dynamics adding ``table[t]`` ((T, M·K, nx))
    and a running cost with an action term, on each side; the key and the
    generator are ignored."""
    jB, jG, jt = (jnp.asarray(v, jdt) for v in (B_NP, GOAL_NP, table))
    pB, pG, pt = (torch.tensor(v, dtype=tdt) for v in (B_NP, GOAL_NP, table))

    def jdyn(s, a, t, key):
        return s + a @ jB.T + jt[t]

    def jcost(s, a, t):
        return ((jG - s) ** 2).sum(axis=-1) + 0.1 * (a ** 2).sum(axis=-1)

    def pdyn(s, a, t, rng):
        return s + a @ pB.T + pt[t]

    def pcost(s, a, t):
        return ((pG - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)

    return jdyn, jcost, pdyn, pcost


def _rollout_pair(dt, M, K, T, flags, x0, acts, table, jterm=None, pterm=None,
                  jfinal=None, pfinal=None):
    """JAX's and the port's ``rollout_costs`` on the same inputs."""
    jdt, tdt = DTYPES[dt]
    fields = dict(nx=2, nu=2, K=K, T=T, M=M, stochastic_dynamics=True,
                  step_dependent_dynamics=True, has_terminal_cost=jterm is not None, **flags)
    jcfg, cfg = JConfig(dtype=jdt, **fields), MPPIConfig(dtype=tdt, **fields)
    jdyn, jcost, pdyn, pcost = _table_models(table, jdt, tdt)
    out_j = JS.rollout_costs(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), jterm, None, None,
        jnp.asarray(x0, jdt), jnp.asarray(acts, jdt), jax.random.PRNGKey(0),
        terminal_final_cost=None if jfinal is None else JS.wrap_final_cost(jfinal))
    out_p = PS.rollout_costs(
        cfg, PS.wrap_dynamics(cfg, pdyn), PS.wrap_cost(cfg, pcost),
        torch.tensor(x0, dtype=tdt), torch.tensor(acts, dtype=tdt), pterm,
        None if pfinal is None else PS.wrap_final_cost(pfinal), seed=123)
    return out_j, out_p


def _inputs(M, K, T, shared_x0=True, seed=0):
    rs = np.random.RandomState(seed)
    x0 = np.array([-1.0, 0.5]) if shared_x0 else rs.randn(K, 2)
    return x0, rs.randn(K, T, 2) * 0.7, rs.randn(T, M * K, 2) * 0.4


# id, dtype, M, rollout_var_discount, risk_alpha, shared x0
ROLLOUT_CASES = [
    ("M2_discount095", "f64", 2, 0.95, 0.0, True),
    ("M4_discount1", "f64", 4, 1.0, 0.0, False),
    ("M10_cvar03", "f64", 10, 0.95, 0.3, True),
    ("M4_cvar05", "f64", 4, 0.95, 0.5, False),
    ("M4_cvar1_discount1", "f64", 4, 1.0, 1.0, True),
    ("M2_cvar05", "f64", 2, 0.95, 0.5, True),
    ("M4_cvar05_f32", "f32", 4, 0.95, 0.5, True),
]


@pytest.mark.parametrize("dt,M,discount,alpha,shared", [c[1:] for c in ROLLOUT_CASES],
                         ids=[c[0] for c in ROLLOUT_CASES])
def test_rollout_costs_match_jax(dt, M, discount, alpha, shared):
    """Costs, the (M, K, T, nx) states and the (M, K, T, nu) scaled
    actions; with ``u_scale`` and a variance cost."""
    K, T = 6, 5
    x0, acts, table = _inputs(M, K, T, shared)
    flags = dict(rollout_var_cost=0.7, rollout_var_discount=discount, risk_alpha=alpha,
                 u_scale=1.3)
    (cj, sj, aj), (cp, sp, ap) = _rollout_pair(dt, M, K, T, flags, x0, acts, table)
    assert cp.shape == (K,) and sp.shape == (M, K, T, 2) and ap.shape == (M, K, T, 2)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **TOL[dt])
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL[dt])
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL[dt])


@pytest.mark.parametrize("alpha,worst", [(0.3, 3), (0.25, 3), (0.31, 4), (1.0, 10)])
def test_cvar_is_the_mean_of_the_worst(alpha, worst):
    """CVaR takes the worst ``max(1, min(M, ceil(alpha·M)))`` rollouts, the
    JAX expression: at M = 10, 0.3·10 is exactly 3.0 in float64 (3
    rollouts), 0.25·10 rounds up to 3 and 0.31·10 to 4; alpha = 1 is the
    mean.  Recomputed from the stored rollouts."""
    M, K, T = 10, 6, 5
    x0, acts, table = _inputs(M, K, T)
    _, (cp, states, actions) = _rollout_pair("f64", M, K, T, dict(risk_alpha=alpha), x0, acts,
                                             table)
    per_m = (((torch.tensor(GOAL_NP) - states) ** 2).sum(-1)
             + 0.1 * (actions ** 2).sum(-1)).sum(-1)  # (M, K)
    expected = torch.sort(per_m, dim=0, descending=True).values[:worst].mean(0)
    torch.testing.assert_close(cp, expected, rtol=1e-12, atol=1e-12)


TERMINAL_CASES = ["state_K", "state_MK", "final"]


@pytest.mark.parametrize("hook", TERMINAL_CASES)
def test_terminal_costs_at_M3_match_jax(hook):
    """A ``terminal_state_cost`` of (K,) or (M, K) broadcast onto the
    rollouts, and ``terminal_final_cost`` reshaped to (M, K)."""
    M, K, T = 3, 6, 4
    x0, acts, table = _inputs(M, K, T, seed=1)
    g = np.array([1.0, -0.5])
    jg, pg = jnp.asarray(g), torch.tensor(g)
    kw = {}
    if hook == "final":
        kw = dict(jfinal=lambda s, a: ((s - jg) ** 2).sum(-1) + 0.2 * (a ** 2).sum(-1),
                  pfinal=lambda s, a: ((s - pg) ** 2).sum(-1) + 0.2 * (a ** 2).sum(-1))
    else:
        def red(v, mean):
            return v.mean(0) if mean else v
        kw = dict(jterm=lambda s, a: red(((s[..., -1, :] - jg) ** 2).sum(-1), hook == "state_K"),
                  pterm=lambda s, a: red(((s[..., -1, :] - pg) ** 2).sum(-1), hook == "state_K"))
    flags = dict(rollout_var_cost=0.5, u_scale=0.8)
    (cj, _, _), (cp, sp, _) = _rollout_pair("f64", M, K, T, flags, x0, acts, table, **kw)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **TOL["f64"])
    # the terminal cost is in the costs
    _, (bare, _, _) = _rollout_pair("f64", M, K, T, flags, x0, acts, table)
    assert bool((cp > bare).all())


def _full_and_final(name, **kw):
    g = torch.tensor([1.5, -0.5])

    def fterm(s, a):
        return 10.0 * ((s - g) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)

    def full(states, actions):
        return fterm(states[..., -1, :], actions[..., -1, :])

    cls, extra = CONTROLLERS[name]
    common = dict(num_samples=32, horizon=5, device="cpu", seed=11, rollout_samples=3,
                  rollout_var_cost=0.5, u_scale=0.7, **extra, **kw)
    return (cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5,
                terminal_state_cost=full, **common),
            cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5,
                terminal_final_cost=fterm, **common))


CONTROLLERS = {"mppi": (P.MPPI, {}),
               "smppi": (P.SMPPI, dict(w_action_seq_cost=2.0, delta_t=0.5)),
               "kmppi": (P.KMPPI, dict(num_support_pts=3, kernel=P.RBFKernel(2.0)))}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_final_cost_bit_identical_to_full_terminal_at_M3(name):
    """M = 3: the final-state hook sees the (M·K,) final states, and its
    (M, K) cost lands on the rollouts exactly as the full hook's
    (``tests/test_extensions.py:1404-1410``): the same commands and costs
    bit for bit."""
    full, fin = _full_and_final(name)
    x = torch.tensor([-2.0, 1.0])
    for _ in range(3):
        a1, a2 = full.command(x), fin.command(x)
        assert torch.equal(a1, a2) and torch.equal(full.cost_total, fin.cost_total)
        x = LQ.dynamics(x[None], a1[None])[0]
    assert full.states.shape == fin.states.shape == (3, 32, 5, 2)


# -- the controllers with M = 3 against JAX's ----------------------------------

K_C, T_C, NSP, M_C = 16, 5, 3, 3


def _jax_port_controllers(name, table):
    jdyn, jcost, pdyn, pcost = _table_models(table, jnp.float32, torch.float32)
    common = dict(num_samples=K_C, horizon=T_C, lambda_=1.0, rollout_samples=M_C,
                  rollout_var_cost=0.4, risk_alpha=0.5 if name == "mppi" else 0.0,
                  stochastic_dynamics=True, step_dependent_dynamics=True)
    jb = dict(u_min=-jnp.ones(2, jnp.float32), u_max=jnp.ones(2, jnp.float32))
    pb = dict(u_min=-torch.ones(2), u_max=torch.ones(2), device="cpu")
    if name == "smppi":
        extra_j = dict(w_action_seq_cost=2.0, delta_t=0.5, action_min=-jnp.ones(2, jnp.float32),
                       action_max=jnp.ones(2, jnp.float32))
        extra_p = dict(w_action_seq_cost=2.0, delta_t=0.5, action_min=-torch.ones(2),
                       action_max=torch.ones(2))
        jcls, pcls = J.SMPPI, P.SMPPI
    elif name == "kmppi":
        extra_j = dict(num_support_pts=NSP, kernel=J.RBFKernel(2.0))
        extra_p = dict(num_support_pts=NSP, kernel=P.RBFKernel(2.0))
        jcls, pcls = J.KMPPI, P.KMPPI
    else:
        extra_j = extra_p = {}
        jcls, pcls = J.MPPI, P.MPPI
    jc = jcls(jdyn, jcost, 2, jnp.eye(2, dtype=jnp.float32) * 0.5, **common, **jb, **extra_j)
    pc = pcls(pdyn, pcost, 2, torch.eye(2) * 0.5, **common, **pb, **extra_p)
    if name != "smppi":
        U0 = (np.random.RandomState(1).randn(T_C, 2) * 0.3).astype(np.float32)
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    return jc, pc


def _noise_bank(monkeypatch, rows, scale=0.6):
    """The same (K, rows) noise for the i-th ``sample_noise_flat`` call on
    either side."""
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K_C, rows).astype(np.float32) * scale))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K_C, rows).astype(np.float32) * scale))


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_controllers_with_M3_match_jax(monkeypatch, name):
    """Three chained commands with M = 3, the variance cost (and CVaR on
    MPPI): commands, costs and the (M, K, T, nx) states."""
    table = (np.random.RandomState(5).randn(T_C, M_C * K_C, 2) * 0.3).astype(np.float32)
    jc, pc = _jax_port_controllers(name, table)
    assert not pc._fns.fused and pc.M == M_C and f"M={M_C}" in pc.get_params()
    _noise_bank(monkeypatch, (NSP if name == "kmppi" else T_C) * 2)
    x = np.array([-1.0, 0.5], np.float32)
    with jax.disable_jit():
        for _ in range(3):
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total),
                                       **TOL["f32"])
            np.testing.assert_allclose(ap, aj, **TOL_U)
            assert pc.states.shape == (M_C, K_C, T_C, 2)
            np.testing.assert_allclose(pc.states.numpy(), np.asarray(jc.states), **TOL["f32"])
            x = (x + 0.2 * ap).astype(np.float32)


# -- the stochastic stream -----------------------------------------------------

def _noisy(s, a, rng):
    return LQ.dynamics(s, a) + 0.05 * torch.randn(s.shape, generator=rng, dtype=s.dtype)


def _noisy_ctrl(seed=42, **kw):
    kw = dict(dict(num_samples=64, horizon=8), **kw)
    return P.MPPI(_noisy, LQ.running_cost, 2, torch.eye(2), device="cpu", seed=seed,
                  stochastic_dynamics=True, **kw)


def test_m_slices_differ_and_seeds_repeat():
    """The M rollouts see different draws; two controllers with one seed
    give the same ten commands bit for bit; another seed does not."""
    c1, c2, c3 = (_noisy_ctrl(rollout_samples=4, rollout_var_cost=0.1, seed=s)
                  for s in (42, 42, 7))
    x1 = x2 = x3 = torch.tensor([-1.0, -1.0])
    for i in range(10):
        a1, a2, a3 = c1.command(x1), c2.command(x2), c3.command(x3)
        assert torch.equal(a1, a2)
        if i == 0:
            assert c1.states.shape == (4, 64, 8, 2)
            assert not torch.allclose(c1.states[0], c1.states[1])
            assert not torch.equal(a1, a3)
        x1, x2, x3 = (LQ.dynamics(x[None], a[None])[0] for x, a in ((x1, a1), (x2, a2), (x3, a3)))
    assert torch.isfinite(a1).all()


def test_rollout_stream_per_command_and_step():
    """Each iteration's rollout seed is its own (not the noise seed, not the
    last command's), and a step's draws do not depend on how many numbers
    earlier steps drew: the generator is made afresh a step."""
    seeds = {PS.rollout_seed(9, c) for c in range(4)} | {PS.iteration_seed(9, c) for c in range(4)}
    assert len(seeds) == 8
    draws = {}

    def recorder(extra):
        def dyn(s, a, t, rng):
            first = torch.randn(3, generator=rng)
            if t % 2 == 0:
                torch.randn(extra, generator=rng)  # more numbers at even steps
            draws.setdefault(extra, []).append(first)
            return s + 0.01 * first[:2]
        return dyn

    cfg = MPPIConfig(nx=2, nu=2, K=4, T=5, stochastic_dynamics=True,
                     step_dependent_dynamics=True)
    cost = PS.wrap_cost(cfg, lambda s, a, t: (s ** 2).sum(-1))
    acts = torch.zeros(4, 5, 2)
    for extra in (1, 1000):
        PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, recorder(extra)), cost, torch.zeros(2),
                         acts, seed=PS.rollout_seed(9, 0))
    for a, b in zip(draws[1], draws[1000]):
        assert torch.equal(a, b)
    assert not torch.equal(draws[1][0], draws[1][1])
    # another command's rollout draws differ
    s0 = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, recorder(1)), cost, torch.zeros(2), acts,
                          seed=PS.rollout_seed(9, 0))[0]
    s1 = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, recorder(1)), cost, torch.zeros(2), acts,
                          seed=PS.rollout_seed(9, 1))[0]
    assert not torch.equal(s0, s1)


def test_each_iteration_rolls_out_on_its_own_stream():
    """Iteration i of a command rolls out on ``rollout_seed(seed,
    counter + i)``: over two commands of two iterations the first step's
    draws are those of stream positions 0, 1, 2 and 3, all different."""
    first = []

    def dyn(s, a, t, rng):
        if t == 0:
            first.append(torch.randn(2, generator=rng))
        return s + a

    c = P.MPPI(dyn, lambda s, a, t: (s ** 2).sum(-1), 2, torch.eye(2), num_samples=8, horizon=3,
               device="cpu", stochastic_dynamics=True, step_dependent_dynamics=True,
               num_iterations=2)
    seed = c._state.seed
    for _ in range(2):
        c.command(torch.zeros(2))
    expected = [torch.randn(2, generator=PS.step_generator(PS.rollout_seed(seed, pos), 0, "cpu"))
                for pos in range(4)]
    assert len(first) == 4
    for got, want in zip(first, expected):
        assert torch.equal(got, want)
    assert len({tuple(v.tolist()) for v in first}) == 4


def test_generator_is_on_the_rollout_device():
    """The generator lives on the tensors' device (a CUDA rollout never gets
    a CPU generator): here the CPU's."""
    seen = []

    def dyn(s, a, rng):
        seen.append(rng.device)
        return s + a

    cfg = MPPIConfig(nx=2, nu=2, K=3, T=2, stochastic_dynamics=True)
    PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, dyn), PS.wrap_cost(cfg, LQ.running_cost),
                     torch.zeros(2), torch.zeros(3, 2, 2), seed=1)
    assert seen == [torch.device("cpu")] * 2


def test_get_rollouts_stochastic():
    """``get_rollouts`` draws from a fresh seed each call (JAX's
    ``_next_key()``); on a given seed the step-dependent table dynamics
    agree with JAX's ``get_rollouts``."""
    c = _noisy_ctrl(num_samples=32, horizon=5)
    c.command(torch.zeros(2))
    r1 = c.get_rollouts(torch.zeros(2), num_rollouts=3)
    r2 = c.get_rollouts(torch.zeros(2), num_rollouts=3)
    assert r1.shape == (3, 5, 2) and not torch.equal(r1, r2)
    U = c.get_action_sequence()
    assert torch.equal(c._fns.get_rollouts(None, torch.zeros(2), U, 3, seed=5),
                       c._fns.get_rollouts(None, torch.zeros(2), U, 3, seed=5))
    T = 6
    table = np.random.RandomState(2).randn(T, 3, 2).astype(np.float32) * 0.3
    jdyn, _, pdyn, _ = _table_models(table, jnp.float32, torch.float32)
    fields = dict(nx=2, nu=2, K=4, T=T, u_scale=1.5, stochastic_dynamics=True,
                  step_dependent_dynamics=True)
    jcfg, cfg = JConfig(dtype=jnp.float32, **fields), MPPIConfig(**fields)
    jfns = JS.make_mppi_step(jcfg, jdyn, lambda s, a, t: (s ** 2).sum(-1), jit=False)
    fns = PS.make_mppi_step(cfg, pdyn, lambda s, a, t: (s ** 2).sum(-1))
    Un = np.random.RandomState(3).randn(T, 2).astype(np.float32)
    x0 = np.array([[0.5, -1.0]], np.float32)
    r_j = jfns.get_rollouts(None, jnp.asarray(x0), jnp.asarray(Un), key=jax.random.PRNGKey(1),
                            num_rollouts=3)
    r_p = fns.get_rollouts(None, torch.from_numpy(x0), torch.from_numpy(Un), num_rollouts=3,
                           seed=1)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)


# -- gates and routing ---------------------------------------------------------

@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_risk_alpha_errors_match_jax(name):
    """The controller's and the factories' ValueErrors, with the JAX text."""
    cls, extra = CONTROLLERS[name]
    kw = dict(num_samples=16, horizon=4, device="cpu", **extra)
    with pytest.raises(ValueError, match=r"risk_alpha must be in \[0, 1\], got 1.5"):
        cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), risk_alpha=1.5,
            rollout_samples=4, **kw)
    with pytest.raises(ValueError, match="risk_alpha needs rollout_samples"):
        cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), risk_alpha=0.5, **kw)
    make = {"mppi": PS.make_mppi_step, "smppi": PS.make_smppi_step,
            "kmppi": PS.make_kmppi_step}[name]
    nsp = 3 if name == "kmppi" else 0
    for fields in (dict(risk_alpha=0.5), dict(M=4, risk_alpha=1.5)):
        with pytest.raises(ValueError) as err:
            make(MPPIConfig(nx=2, nu=2, K=16, T=5, num_support_pts=nsp, **fields),
                 LQ.dynamics, LQ.running_cost)
        with pytest.raises(ValueError) as jerr:
            JS._gate_risk_alpha(JConfig(nx=2, nu=2, K=16, T=5, **fields))
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("fields", [dict(M=2), dict(M=4, risk_alpha=0.5), dict(risk_alpha=0.5),
                                    dict(risk_alpha=-0.1)],
                         ids=["M2", "M4_risk", "risk_M1", "risk_negative"])
def test_batched_rejects_M_and_risk_alpha(fields):
    """The batched rollout has no M axis: JAX's ValueError, word for word."""
    with pytest.raises(ValueError) as err:
        PS.make_batched_step(MPPIConfig(nx=2, nu=2, K=16, T=5, **fields), 2, LQ.dynamics,
                             LQ.running_cost)
    with pytest.raises(ValueError) as jerr:
        JS.make_batched_step(JConfig(nx=2, nu=2, K=16, T=5, **fields), 2, lambda s, a: s,
                             lambda s, a: s.sum(-1))
    assert str(err.value) == str(jerr.value)


ROUTES = [("fused_M3", True, dict(M=3)), ("fused_stochastic", True, dict(stochastic_dynamics=True)),
          ("legacy_M3", "rollout", dict(M=3)),
          ("legacy_stochastic", "rollout", dict(stochastic_dynamics=True))]


@pytest.mark.parametrize("use_pallas,fields", [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_kernel_routes_take_the_plain_path(caplog, use_pallas, fields):
    """M > 1 and stochastic dynamics make the fused kernel and the legacy
    pair ineligible (``pallas_rollout.py:61-72, 259-283``): the plain path,
    with a warning naming why."""
    cfg = MPPIConfig(nx=2, nu=2, K=16, T=5, **fields)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas=use_pallas)
    assert not fns.fused
    assert "M>1 / stochastic" in caplog.text
    for variant, make in (("smppi", PS.make_smppi_step), ("kmppi", PS.make_kmppi_step)):
        if use_pallas is True:
            c = MPPIConfig(nx=2, nu=2, K=16, T=5, num_support_pts=3 if variant == "kmppi" else 0,
                           **fields)
            assert not make(c, LQ.dynamics, LQ.running_cost, use_pallas=True).fused


def test_batched_stochastic_plain_path(caplog):
    """``stochastic_dynamics`` on MPPI_Batched: the plain path over the N·K
    flat batch (a kernel mode asked for warns), and the commands repeat on
    one seed."""
    def noisy(s, a, rng):
        return LQ.dynamics(s, a) + 0.05 * torch.randn(s.shape, generator=rng)

    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c1 = P.MPPI_Batched(noisy, LQ.running_cost, 2, torch.eye(2), num_envs=3, num_samples=256,
                            horizon=5, device="cpu", stochastic_dynamics=True,
                            use_pallas="force")
    assert not c1._fns.fused and "M>1 / stochastic" in caplog.text
    c2 = P.MPPI_Batched(noisy, LQ.running_cost, 2, torch.eye(2), num_envs=3, num_samples=256,
                        horizon=5, device="cpu", stochastic_dynamics=True)
    x = torch.tensor([[-3.0, -2.0], [0.0, 0.0], [1.0, 1.0]])
    for _ in range(3):
        a1, a2 = c1.command(x), c2.command(x)
        assert torch.equal(a1, a2) and torch.isfinite(a1).all()
        x = LQ.dynamics(x, a1)


def _gated_pair(flip=False):
    """A plant whose dynamics add a Bernoulli-gated impulse, its probability
    by state, and a normal of state-scaled deviation: JAX's with
    ``jax.random.bernoulli`` and ``jax.random.normal`` on the step's key,
    the port's with ``torch.bernoulli(p)`` and ``torch.normal(0, std)`` on
    the step's generator (``flip``: the port's gate at 1 - p, a wrong
    definition the test must see)."""
    jB, pB = jnp.asarray(B_NP), torch.tensor(B_NP)
    jG, pG = jnp.asarray(GOAL_NP), torch.tensor(GOAL_NP)

    def jdyn(s, a, key):
        k1, k2 = jax.random.split(key)
        gate = jax.random.bernoulli(k1, jnp.clip(jax.nn.sigmoid(2.0 * s), 0.1, 0.9))
        std = 0.2 * (1.0 + jnp.abs(s))
        return (s + 0.1 * a @ jB.T + 0.5 * gate.astype(s.dtype)
                + std * jax.random.normal(k2, s.shape, s.dtype))

    def pdyn(s, a, rng):
        p = torch.clamp(torch.sigmoid(2.0 * s), 0.1, 0.9)
        gate = torch.bernoulli(1.0 - p if flip else p, generator=rng)
        return (s + 0.1 * a @ pB.T + 0.5 * gate
                + torch.normal(0.0, 0.2 * (1.0 + s.abs()), generator=rng))

    return (jdyn, lambda s, a: ((jG - s) ** 2).sum(axis=-1), pdyn,
            lambda s, a: ((pG - s) ** 2).sum(-1))


def _gated_costs(flip=False, K=2000, T=8, seeds=5):
    """Each package's rollout costs of the same (K, T, 2) actions from the
    same state over ``seeds`` keys or seeds, pooled: (JAX's, the port's)."""
    rs = np.random.RandomState(3)
    x0, acts = np.array([0.5, -0.5]), rs.randn(K, T, 2) * 0.5
    fields = dict(nx=2, nu=2, K=K, T=T, stochastic_dynamics=True)
    jcfg, cfg = JConfig(dtype=jnp.float64, **fields), MPPIConfig(dtype=torch.float64, **fields)
    jdyn, jcost, pdyn, pcost = _gated_pair(flip)
    jc = [np.asarray(JS.rollout_costs(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), None, None, None,
        jnp.asarray(x0), jnp.asarray(acts), jax.random.PRNGKey(s))[0]) for s in range(seeds)]
    pc = [PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, pdyn), PS.wrap_cost(cfg, pcost),
                           torch.tensor(x0), torch.tensor(acts), seed=100 + s)[0].numpy()
          for s in range(seeds)]
    return np.concatenate(jc), np.concatenate(pc)


def _same_distribution(a, b):
    """The means, and the variances, within four standard errors of their
    difference (a variance's from the fourth central moment: the costs'
    tails are heavy)."""
    def var_se2(x):
        return (((x - x.mean()) ** 4).mean() - x.var() ** 2) / x.size

    se_mean = np.sqrt(a.var() / a.size + b.var() / b.size)
    se_var = np.sqrt(var_se2(a) + var_se2(b))
    return (abs(a.mean() - b.mean()) <= 4 * se_mean
            and abs(a.var() - b.var()) <= 4 * se_var)


def test_bernoulli_and_state_scaled_normal_match_jax_in_distribution():
    """Torch's streams cannot reproduce JAX's keys, so the draws with tensor
    arguments are held against ``jax.random.bernoulli`` and
    ``jax.random.normal`` in distribution (``tests/test_torch_deploy_
    stochastic.py`` holds the served commands to the live ones bit for
    bit): the rollout costs of 2,000 samples over 5 keys or seeds agree in
    mean and variance within four standard errors, and a gate drawn at
    1 - p does not."""
    j, p = _gated_costs()
    assert np.isfinite(p).all() and _same_distribution(j, p), (j.mean(), p.mean(), j.var(),
                                                               p.var())
    j, p = _gated_costs(flip=True)
    assert not _same_distribution(j, p)
