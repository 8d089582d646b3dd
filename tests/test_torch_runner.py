"""``run_mppi_jit`` and the command's split into a host prologue and a
device body, on the CPU.

* the contracts of JAX's runner tests (``tests/test_extensions.py:999-1140``
  and ``:1323``) on the port: indivisible steps raise, the loop is cached,
  ``u_per_command`` blocks and the N = 3 batched loop equal the eager
  ``command()`` loop bit for bit, a ``dynamics_params`` swap equals a fresh
  controller, the step-dependent default cost, elites threaded through;
* the port's loop against JAX's ``run_mppi_jit`` for MPPI, SMPPI, KMPPI and
  MPPI_Batched in float64 at 1e-10, ``sample_noise_flat`` patched on both
  sides so that the i-th draw is the same (JAX's side under
  ``jax.disable_jit``, whose scan then runs a Python loop);
* the split: ``streams.prologue`` then ``body`` is ``step`` on every route,
  the prologue's generators draw what a generator made afresh from the
  iteration seed draws and its key buffer holds ``key_to_seed`` of the
  iteration seed, and the kernels' plain versions give the same with the key
  buffer as with the key by value;
* the graph loop's bookkeeping (``runner._GraphLoop``) with a stand-in for
  the CUDA graph that replays the captured step by calling it: equal to the
  eager loop, the controller's state and ``dynamics_params`` read at every
  run, the outputs clones, and the launch counters advanced by the captured
  launches at each replay only.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch import runner as PR
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

torch.set_num_threads(1)

F64 = torch.float64
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
B, GOAL = torch.tensor(B_NP), torch.tensor(GOAL_NP)
TOL_64 = dict(rtol=1e-10, atol=1e-10)
SEED = 42


def linear_dynamics(state, action):
    return state + action @ B.T


def quadratic_cost(state, action):
    return ((GOAL - state) ** 2).sum(dim=-1)


def _mppi(**kw):
    kw = dict(dict(num_samples=32, horizon=8, lambda_=1.0, seed=SEED, device="cpu"), **kw)
    return P.MPPI(linear_dynamics, quadratic_cost, 2, torch.eye(2, dtype=F64), **kw)


def _eager(ctrl, plant, x, steps, cost=quadratic_cost):
    """The eager loop: each command's block applied in order, the cost
    taken after each plant step, as JAX's tests write it."""
    batched = isinstance(ctrl, P.MPPI_Batched)
    acc = torch.zeros(ctrl.N if batched else (), dtype=ctrl.dtype)
    xs, acts = [], []
    for _ in range(steps // ctrl.u_per_command):
        a = ctrl.command(x)
        block = (a.reshape(ctrl.N, -1, 2).transpose(0, 1) if batched else a.reshape(-1, 2))
        for a_j in block:
            x = plant(x, a_j)
            acc = acc + (cost(x, a_j) if batched else cost(x[None], a_j[None])[0])
            xs.append(x)
            acts.append(a_j)
    return torch.stack(xs), torch.stack(acts), acc


# -- JAX's runner contracts ------------------------------------------------------


def test_indivisible_steps_raise():
    ctrl = _mppi(num_samples=16, horizon=4, seed=0, u_per_command=3)
    with pytest.raises(ValueError, match="multiple of u_per_command"):
        P.run_mppi_jit(ctrl, linear_dynamics, torch.zeros(2, dtype=F64), steps=2)


def test_start_state_shape_is_checked():
    with pytest.raises(ValueError, match=r"x0 must have shape \(2,\)"):
        P.run_mppi_jit(_mppi(), linear_dynamics, torch.zeros(3, 2, dtype=F64), steps=2)


def test_loop_is_cached():
    ctrl = _mppi(num_samples=16, horizon=4, seed=0)
    x0 = torch.zeros(2, dtype=F64)
    P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
    cached = dict(ctrl._runner_cache)
    assert len(cached) == 1
    P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
    assert ctrl._runner_cache == cached
    P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=4)
    assert len(ctrl._runner_cache) == 2


def test_u_per_command_blocks_match_eager():
    """Each command's block of two actions goes to the plant in order, bit
    for bit the eager ``command()`` loop."""
    ctrl, twin = _mppi(u_per_command=2), _mppi(u_per_command=2)
    x0 = torch.tensor([-2.0, 1.0], dtype=F64)
    states, actions, total = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=6)
    assert states.shape == (7, 2) and actions.shape == (6, 2) and total.shape == ()
    xs, acts, acc = _eager(twin, linear_dynamics, x0, 6)
    assert torch.equal(states[0], x0) and torch.equal(states[1:], xs)
    assert torch.equal(actions, acts) and torch.equal(total, acc)
    assert torch.equal(ctrl.U, twin.U) and ctrl._state.counter == twin._state.counter == 3


def test_batched_whole_loop():
    """N = 3 plants with blocks of two actions, a cost per plant."""
    def build():
        return P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, torch.eye(2, dtype=F64),
                              num_envs=3, num_samples=32, horizon=8, lambda_=1.0, seed=SEED,
                              u_per_command=2, device="cpu")

    ctrl, twin = build(), build()
    x0 = torch.tensor([[-2.0, 1.0], [0.5, -0.5], [1.0, 1.0]], dtype=F64)
    states, actions, total = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=4)
    assert states.shape == (5, 3, 2) and actions.shape == (4, 3, 2) and total.shape == (3,)
    xs, acts, acc = _eager(twin, linear_dynamics, x0, 4)
    assert torch.equal(states[1:], xs) and torch.equal(actions, acts)
    assert torch.equal(total, acc) and torch.equal(ctrl.U, twin.U)


def _pdyn(p, state, action):
    return state + action @ (p * B).T


def _param_ctrl(p0):
    return P.MPPI(_pdyn, quadratic_cost, 2, torch.eye(2, dtype=F64), num_samples=32,
                  horizon=6, lambda_=1.0, seed=SEED, device="cpu",
                  dynamics_params=torch.tensor(p0, dtype=F64))


def test_dynamics_params_swap_equals_fresh_controller():
    """A new ``mppi.dynamics_params`` takes effect in the cached loop."""
    ctrl = _param_ctrl(1.0)
    x0 = torch.tensor([-1.0, 0.5], dtype=F64)
    _, acts_first, _ = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
    ctrl.dynamics_params = torch.tensor(0.5, dtype=F64)  # a retrained model
    ctrl._state = _param_ctrl(1.0)._state  # back to a known state
    _, acts_swapped, _ = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
    assert len(ctrl._runner_cache) == 1
    _, acts_fresh, _ = P.run_mppi_jit(_param_ctrl(0.5), linear_dynamics, x0, steps=3)
    assert torch.equal(acts_swapped, acts_fresh)
    assert not torch.equal(acts_swapped, acts_first)


def test_step_dependent_default_cost():
    """The default running cost takes ``(state, u, t)`` controllers' costs,
    with the action's index in its block as t."""
    seen = []

    def dyn_t(state, action, t):
        return linear_dynamics(state, action)

    def cost_t(state, action, t):
        seen.append(t)
        return quadratic_cost(state, action) + 0.0 * t

    ctrl = P.MPPI(dyn_t, cost_t, 2, torch.eye(2, dtype=F64), num_samples=16, horizon=4,
                  seed=0, step_dependent_dynamics=True, u_per_command=2, device="cpu")
    seen.clear()
    states, actions, total = P.run_mppi_jit(ctrl, linear_dynamics, torch.zeros(2, dtype=F64),
                                            steps=4)
    assert torch.isfinite(total)
    # each command's rollout takes t = 0..3; the loop's two plant steps t = 0, 1
    assert seen == ([0, 1, 2, 3] + [0, 1]) * 2


def test_threads_elites():
    ctrl, twin = _mppi(num_samples=16, horizon=6, seed=0, num_elites=2), \
        _mppi(num_samples=16, horizon=6, seed=0, num_elites=2)
    x0 = torch.tensor([-1.0, 1.0], dtype=F64)
    states, actions, total = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=4)
    assert torch.isfinite(total)
    assert ctrl._state.elites.shape == (2, 6, 2) and torch.isfinite(ctrl._state.elites).all()
    _eager(twin, linear_dynamics, x0, 4)
    assert torch.equal(ctrl._state.elites, twin._state.elites)


# -- against JAX's run_mppi_jit -------------------------------------------------------

K, T, NSP, N = 32, 5, 3, 3
_JB, _JG = jnp.asarray(B_NP), jnp.asarray(GOAL_NP)


def _jdyn(s, a):
    return s + a @ _JB.T


def _jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


def _variant(name):
    """(JAX class, port class, JAX keywords, port keywords, noise rows)."""
    common = dict(num_samples=K, horizon=T, lambda_=1.0, u_scale=0.7, seed=3)
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
    """The same float64 (K, rows) noise for the i-th ``sample_noise_flat``
    call on either side."""
    jbank, pbank = np.random.RandomState(5), np.random.RandomState(5)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, rows) * 0.6))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, rows) * 0.6))


@pytest.mark.parametrize("name", ["mppi", "smppi", "kmppi", "batched"])
def test_matches_jax_run_mppi_jit(monkeypatch, name):
    """Six plant steps in blocks of two against JAX's loop on the same
    normals: states, actions and the total cost at 1e-10 in float64."""
    jcls, pcls, jkw, pkw, rows = _variant(name)
    sigma = np.eye(2) * 0.5
    jc = jcls(_jdyn, _jcost, 2, jnp.asarray(sigma), u_per_command=2, **jkw)
    pc = pcls(linear_dynamics, quadratic_cost, 2, torch.from_numpy(sigma), u_per_command=2,
              **pkw)
    if name != "smppi":
        shape = (N, T, 2) if name == "batched" else (T, 2)
        U0 = np.random.RandomState(1).randn(*shape) * 0.3
        jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    x0 = np.array([[-1.0, 0.5], [0.5, -1.0], [0.0, 0.0]])
    x0 = x0 if name == "batched" else x0[0]
    plant_j = lambda s, a: s + 0.9 * (a @ _JB.T)
    plant_p = lambda s, a: s + 0.9 * (a @ B.T)
    _noise_bank(monkeypatch, rows)
    with jax.disable_jit():
        sj, aj, tj = J.run_mppi_jit(jc, plant_j, jnp.asarray(x0), 6)
    sp, ap, tp = P.run_mppi_jit(pc, plant_p, torch.from_numpy(x0), 6)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL_64)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), **TOL_64)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), **TOL_64)
    np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **TOL_64)


# -- the split: host prologue, device body -----------------------------------------------

LQ = linear_quadratic(torch.from_numpy(B_NP.astype(np.float32)),
                      torch.from_numpy(GOAL_NP.astype(np.float32)))


def _noisy_lq(s, a, rng):
    return LQ.dynamics(s, a) + 0.05 * torch.randn(s.shape, generator=rng, dtype=s.dtype)


# route -> (controller class, keywords): every route's CPU path
ROUTES = {
    "mppi_plain": (P.MPPI, {}),
    "mppi_fused": (P.MPPI, dict(use_pallas=True)),
    "mppi_rollout": (P.MPPI, dict(use_pallas="rollout")),
    "mppi_fused_elites_iter3": (P.MPPI, dict(use_pallas=True, num_elites=3, fused_artifacts=True,
                                            num_iterations=3)),
    "mppi_plain_stochastic": (P.MPPI, dict(dynamics=_noisy_lq, stochastic_dynamics=True,
                                           rollout_samples=2, num_iterations=2)),
    "mppi_refine_stochastic": (P.MPPI, dict(dynamics=_noisy_lq, stochastic_dynamics=True,
                                            gradient_refinement_steps=2)),
    "mppi_adaptive": (P.MPPI, dict(num_iterations=2, adaptive_covariance=True)),
    "smppi_fused": (P.SMPPI, dict(use_pallas=True)),
    "smppi_plain": (P.SMPPI, {}),
    "kmppi_fused": (P.KMPPI, dict(use_pallas=True, num_support_pts=3)),
    "kmppi_plain": (P.KMPPI, dict(num_support_pts=3)),
    "batched_seed": (P.MPPI_Batched, dict(use_pallas="kernel_rng", num_envs=3)),
    "batched_operand": (P.MPPI_Batched, dict(use_pallas="force", num_envs=3)),
    "batched_plain": (P.MPPI_Batched, dict(num_envs=3)),
}


def _route_ctrl(route, seed=9):
    cls, kw = ROUTES[route]
    kw = dict(kw)
    dynamics = kw.pop("dynamics", LQ.dynamics)
    return cls(dynamics, LQ.running_cost, 2, torch.eye(2) * 0.5, num_samples=24, horizon=6,
               lambda_=1.0, seed=seed, device="cpu", **kw)


def _x0(ctrl):
    if isinstance(ctrl, P.MPPI_Batched):
        return torch.tensor([[-1.0, 0.5], [0.5, -1.0], [0.0, 0.0]])
    return torch.tensor([-1.0, 0.5])


def _run_body(ctrl, state, x0):
    fns = ctrl._fns
    params = ctrl._full_params() if hasattr(ctrl, "_full_params") else ctrl._params
    fns.streams.prologue(state.seed, state.counter, x0.device)
    if isinstance(ctrl, P.MPPI_Batched):
        return fns.body(params, state, x0, None, True)
    return fns.body(params, state, x0, None, None, True)


@pytest.mark.parametrize("route", list(ROUTES))
def test_prologue_then_body_is_the_step(route):
    """Three commands of ``step`` against the prologue then the body from
    the same states: bit for bit, artifacts included."""
    ctrl = _route_ctrl(route)
    assert ctrl._fns.fused == any(w in route for w in ("fused", "rollout", "seed", "operand"))
    x0 = _x0(ctrl)
    for _ in range(3):
        state = ctrl._state
        s_body, a_body, art_body = _run_body(ctrl, state, x0)
        a_step = ctrl.command(x0)
        assert torch.equal(a_body, a_step)
        assert torch.equal(s_body.U, ctrl._state.U) and s_body.counter == ctrl._state.counter
        assert torch.equal(art_body.cost_total, ctrl.cost_total)
        x0 = x0 + 0.1


@pytest.mark.parametrize("route", ["mppi_plain_stochastic", "mppi_refine_stochastic",
                                   "mppi_fused_elites_iter3", "batched_seed", "batched_operand"])
def test_prologue_positions_every_stream(route):
    """After the prologue at (seed, counter), iteration i's noise generator
    draws what ``torch.Generator().manual_seed(iteration_seed(seed, counter
    + i))`` draws, its rollout step t's what ``step_generator(rollout_seed(
    seed, counter + i), t)`` draws, each refinement descent step's what
    ``step_generator(refine_seed(seed, counter), t)`` draws, and the key
    buffer's row i holds ``key_to_seed(iteration_seed(seed, counter + i))``
    as int32 words."""
    ctrl = _route_ctrl(route)
    streams, seed, counter = ctrl._fns.streams, ctrl._state.seed, 17
    slots = streams.prologue(seed, counter, "cpu")
    cfg = ctrl.config

    def same(gen, ref):
        return torch.equal(torch.randn(5, generator=gen), torch.randn(5, generator=ref))

    for it in range(cfg.num_iterations):
        s = PS.iteration_seed(seed, counter + it)
        if streams.noise:
            assert same(slots.noise[it], PS._generator(s, "cpu"))
        if streams.kernel_keys:
            words = [w & 0xFFFFFFFF for w in slots.keys[it].tolist()]
            assert tuple(words) == FS.key_to_seed(s)
            assert slots.leads[it].data_ptr() == slots.keys[it].data_ptr()
        if streams.rollout:
            rs = PS.rollout_seed(seed, counter + it)
            assert all(same(g, PS.step_generator(rs, t, "cpu"))
                       for t, g in enumerate(slots.rollout[it]))
    assert len(slots.refine) == (cfg.gradient_refinement_steps if cfg.stochastic_dynamics else 0)
    for group in slots.refine:
        rs = PS.refine_seed(seed, counter)
        assert all(same(g, PS.step_generator(rs, t, "cpu")) for t, g in enumerate(group))
    assert len(streams.on("cpu").generators()) == (
        (cfg.num_iterations if streams.noise else 0)
        + (cfg.num_iterations * cfg.T if streams.rollout else 0) + len(slots.refine) * cfg.T)


def _key_words(s):
    return torch.tensor(FS.key_to_seed(s), dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi", "batched"])
def test_plain_kernel_versions_take_the_key_buffer(variant):
    """Each kernel's plain version with the (2,) int32 key tensor gives the
    same as with the key by value (the kernels read the key from memory in
    a CUDA graph)."""
    cfg = _route_ctrl(f"{variant}_seed" if variant == "batched" else f"{variant}_fused").config
    s = PS.iteration_seed(123, 4)
    key_tensor = _key_words(s)
    assert FS.is_device_key(key_tensor) and not FS.is_device_key(key_tensor[None])
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}
    D = cfg.T * cfg.nu
    g = torch.Generator().manual_seed(0)
    x0T = torch.randn(2, cfg.K, generator=g)
    U2 = torch.randn(D, generator=g) * 0.3
    lo, hi = torch.full((D,), -1.0), torch.full((D,), 1.0)
    lam = torch.tensor(1.0)
    if variant == "batched":
        solve = FS.make_transposed_batched_solve(cfg, 3, LQ)
        rest = (torch.randn(2, 3, generator=g), torch.randn(D, 3, generator=g),
                torch.full((D,), 0.7), torch.zeros(D), lo, hi, torch.randn(D, 3, generator=g),
                lam)
    else:
        solve = factories[variant](cfg, LQ)
        R = cfg.num_support_pts * cfg.nu if variant == "kmppi" else D
        common = (torch.full((R,), 0.7), torch.zeros(R), torch.full((R,), -1.0),
                  torch.full((R,), 1.0))
        a = torch.randn(D, generator=g)
        if variant == "mppi":
            rest = (x0T, U2) + common + (a, lam)
        elif variant == "smppi":
            rest = (x0T, U2, U2 * 0.5) + common + (lo, hi, a, lam, torch.tensor(0.5),
                                                   torch.tensor(1.0))
        else:
            Wt = torch.randn(D, R, generator=g)
            rest = (x0T, U2, torch.randn(R, generator=g)) + common[:2] + common[2:] + (
                lo, hi, a, Wt, lam)
    by_value = solve(FS.key_to_seed(s), *rest)
    by_buffer = solve(key_tensor, *rest)
    for v, b in zip(by_value, by_buffer):
        assert torch.equal(v, b)


# -- the graph loop's bookkeeping, with a stand-in graph ----------------------------------


class _StandInGraph:
    """Replays the captured step by calling it; the launch counters its host
    code advances are set back, as a replay runs no host code."""

    def register_generator_state(self, generator):
        self.generators = getattr(self, "generators", []) + [generator]

    def replay(self):
        counts = dict(FS.launches)
        self.step()
        FS.launches.update(counts)


class _StandInStream:
    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_graph(monkeypatch):
    """``runner._GraphLoop`` on the CPU: the CUDA stream and graph calls it
    makes replaced by stand-ins, and the capture recording the step (whose
    host code a capture runs: it runs once here too)."""
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)

    def capture(graph, step):
        step()
        graph.step = step

    monkeypatch.setattr(PR, "_capture_into", capture)
    monkeypatch.setattr(PR, "_EagerLoop", PR._GraphLoop)


@pytest.mark.parametrize("route", ["mppi_plain", "mppi_fused_elites_iter3",
                                   "mppi_plain_stochastic", "smppi_fused", "kmppi_plain",
                                   "batched_seed", "batched_operand"])
def test_graph_loop_bookkeeping(stand_in_graph, route):
    """Two runs of the graph loop against two runs of the eager loop: bit
    for bit, the second run starting from the controller's state after the
    first; the first run's outputs untouched by the second."""
    ctrl, twin = _route_ctrl(route), _route_ctrl(route)
    x0 = _x0(ctrl)
    plant = LQ.dynamics if isinstance(ctrl, P.MPPI_Batched) else (
        lambda x, a: LQ.dynamics(x[None], a[None])[0])
    s1, a1, t1 = P.run_mppi_jit(ctrl, plant, x0, 3)
    loop = next(iter(ctrl._runner_cache.values()))
    assert isinstance(loop, PR._GraphLoop) and loop.graph is not None
    keep = (s1.clone(), a1.clone(), t1.clone())
    xs, acts, acc = _eager(twin, plant, x0, 3, LQ.running_cost)
    assert torch.equal(s1[1:], xs.to(s1.dtype)) and torch.equal(a1, acts.to(a1.dtype))
    assert torch.equal(t1, acc.to(t1.dtype))
    assert torch.equal(ctrl.U, twin.U) and ctrl._state.counter == twin._state.counter
    graph = loop.graph
    x1 = s1[-1] + 0.2
    s2, a2, _ = P.run_mppi_jit(ctrl, plant, x1, 3)
    assert loop.graph is graph  # replayed, not captured again
    xs, acts, _ = _eager(twin, plant, x1, 3, LQ.running_cost)
    assert torch.equal(s2[1:], xs.to(s2.dtype)) and torch.equal(a2, acts.to(a2.dtype))
    assert all(torch.equal(k, o) for k, o in zip(keep, (s1, a1, t1)))
    assert ctrl._state.U is not loop.state.U  # the controller holds a clone
    if getattr(ctrl._state, "elites", None) is not None:
        assert torch.equal(ctrl._state.elites, twin._state.elites)
    n_gen = len(ctrl._fns.streams.on("cpu").generators())
    assert len(getattr(graph, "generators", [])) == n_gen


def test_graph_loop_counts_the_captured_launches(stand_in_graph, monkeypatch):
    """Warming up and capturing count nothing; each replay adds what the
    captured step launched (a body counted as one ``mppi`` launch here)."""
    ctrl = _route_ctrl("mppi_plain")
    body = ctrl._fns.body

    def counted(*args):
        FS.launches["mppi"] += 1
        return body(*args)

    ctrl._fns = ctrl._fns._replace(body=counted)
    monkeypatch.setattr(FS, "launches", dict.fromkeys(FS.KERNELS, 0))
    P.run_mppi_jit(ctrl, lambda x, a: x + a, _x0(ctrl), 5)
    assert FS.launches["mppi"] == 5
    P.run_mppi_jit(ctrl, lambda x, a: x + a, _x0(ctrl), 5)
    assert FS.launches["mppi"] == 10


def test_graph_loop_reads_dynamics_params(stand_in_graph):
    """A swap of the same structure is copied into the captured buffers; a
    new structure is captured again; both equal a fresh controller."""
    def build(p):
        return P.MPPI(lambda p_, s, a: s + a @ (p_["w"] * B).T, quadratic_cost, 2,
                      torch.eye(2, dtype=F64), num_samples=16, horizon=5, seed=1,
                      device="cpu", dynamics_params=p)

    x0 = torch.tensor([-1.0, 0.5], dtype=F64)
    ctrl = build({"w": torch.tensor(1.0, dtype=F64)})
    P.run_mppi_jit(ctrl, linear_dynamics, x0, 2)
    loop = next(iter(ctrl._runner_cache.values()))
    graph = loop.graph
    for p, recaptured in (({"w": torch.tensor(0.5, dtype=F64)}, False),
                          ({"w": torch.full((2, 2), 0.5, dtype=F64)}, True)):
        ctrl.dynamics_params = p
        ctrl._state = build(p)._state
        _, acts, _ = P.run_mppi_jit(ctrl, linear_dynamics, x0, 2)
        _, fresh, _ = P.run_mppi_jit(build(p), linear_dynamics, x0, 2)
        assert torch.equal(acts, fresh)
        assert (loop.graph is not graph) == recaptured
        graph = loop.graph


def test_graph_loop_raises_naming_the_roadmap_item(stand_in_graph, monkeypatch):
    """A command that cannot be captured raises; it never runs eagerly."""
    def refuse(graph, step):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(PR, "_capture_into", refuse)
    ctrl = _route_ctrl("mppi_plain")
    with pytest.raises(RuntimeError, match="ROADMAP.md Queue 1 item 9a"):
        P.run_mppi_jit(ctrl, lambda x, a: x + a, _x0(ctrl), 2)


def test_config_flag_default():
    assert MPPIConfig(nx=2, nu=2, K=4, T=3).parameterized_dynamics is False
