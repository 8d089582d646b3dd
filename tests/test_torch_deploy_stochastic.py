"""Stochastic dynamics in the port's deployment artifact, and the fed form of
their draws (``pytorch_mppi_tpu_torch/ops/solve.py``: ``record_draws``,
``replay_draws``, ``fed_draws`` and ``CommandStreams.record``, ``feeds`` and
``fed``), on the CPU.

* the plan: each op of the vocabulary recorded with its shape, dtype and
  scalar arguments, and replayed bit for bit from a generator in the same
  state (the in-place draws ``exponential_``, ``bernoulli_``, ``random_``,
  ``cauchy_``, ``log_normal_``, ``geometric_`` and ``torch.randperm`` too);
  ``torch.bernoulli(p)`` and ``torch.normal`` with tensor arguments in
  the dynamics' step recorded and fed as their base draws (``torch.rand``,
  ``torch.randn``), their values those the port defines, which torch's own
  ops draw on the CPU too; ``torch.multinomial``, ``out=``, a shape from a
  tensor's value, a draw with tensor arguments outside the step and
  another op raise ``NotImplementedError`` naming ROADMAP.md Queue 1 item
  10; a draw that is not the plan's next, a draw beyond the plan and
  a fed tensor left undrawn raise;
* ``export_solver`` on MPPI, SMPPI and KMPPI whose dynamics really draw
  from their step's generator (``torch.randn``, ``Tensor.normal_``; a
  Bernoulli-gated impulse and a state-scaled normal with tensor arguments;
  ``Tensor.exponential_``, ``torch.randperm`` and ``Tensor.cauchy_``), at
  M = 1 and M = 3, step-dependent, with iterations, with gradient
  refinement on the stochastic dynamics (its ``refine_seed`` streams), and
  on ``MPPI_Batched``'s plain path: the served actions and costs equal the
  live controller's bit for bit (rtol = atol = 0) over three commands, in
  memory, after ``load_solver`` and in a fresh process that has none of the
  user's code;
* a version-5 artifact (no plan, no stochastic streams) still loads and
  replays.

The live stochastic commands are held against JAX's by
``tests/test_torch_stochastic.py::test_controllers_with_M3_match_jax``;
here the artifact is held to the live commands.  Float64 throughout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.utils import checkpoint as ckpt
from pytorch_mppi_tpu_torch.utils import deploy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
ITEM = "ROADMAP.md Queue 1 item 10"
B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)
GOAL = torch.tensor([2.0, 2.0], dtype=F64)


# -- the plan ------------------------------------------------------------------

def _every_op(rng):
    """One draw of each op of the vocabulary, in each of its call forms."""
    x = torch.empty(3, 2, dtype=F64)
    return [torch.randn(4, 2, generator=rng, dtype=F64),
            torch.randn((5,), generator=rng),
            torch.rand(size=(2, 3), generator=rng, dtype=torch.float32),
            torch.randint(7, (6,), generator=rng),
            torch.randint(-3, 3, (2, 2), generator=rng, dtype=torch.int32),
            torch.normal(1.5, 0.5, (3,), generator=rng, dtype=F64),
            x.normal_(0.5, 2.0, generator=rng),
            torch.empty(4, dtype=F64).uniform_(-1.0, 1.0, generator=rng),
            torch.empty(2).normal_(generator=rng)]


def test_each_op_recorded_and_replayed_bit_for_bit():
    g = torch.Generator().manual_seed(11)
    live = []
    plan = PS.record_draws([g], lambda: live.extend(_every_op(g)))
    assert [d.op for d in plan[0]] == [
        "torch.randn", "torch.randn", "torch.rand", "torch.randint", "torch.randint",
        "torch.normal", "Tensor.normal_", "Tensor.uniform_", "Tensor.normal_"]
    assert plan[0][0] == PS.Draw("torch.randn", (4, 2), "float64", ())
    assert plan[0][1].dtype == "float32" and plan[0][3] == PS.Draw(
        "torch.randint", (6,), "int64", (0, 7))
    assert plan[0][4].scalars == (-3, 3) and plan[0][4].dtype == "int32"
    assert plan[0][5].scalars == (1.5, 0.5) and plan[0][6].scalars == (0.5, 2.0)
    assert plan[0][8].scalars == (0.0, 1.0)
    assert PS.plan_from_json(json.loads(json.dumps(plan))) == plan
    replayed = PS.replay_draws(plan, [torch.Generator().manual_seed(11)])
    assert len(replayed) == len(live)
    for a, b in zip(live, replayed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # fed: each draw answered with its tensor, in place for the methods
    got = []
    with PS.fed_draws([g], plan, replayed):
        got.extend(_every_op(g))
    for a, b in zip(got, replayed):
        assert torch.equal(a, b)


P6 = torch.linspace(0.1, 0.9, 6, dtype=F64)
# the draws fed since the vocabulary grew: (draw, the plan's entry, its values
# made from a generator as the port defines them: a draw of the vocabulary as
# itself, a draw with tensor arguments from its base draw)
NEW_DRAWS = {
    "bernoulli": (lambda g: torch.bernoulli(P6, generator=g),
                  ("torch.rand", (6,), "float64", ()),
                  lambda g: (torch.rand(6, dtype=F64, generator=g) < P6).to(F64)),
    "bernoulli_method": (lambda g: P6.bernoulli(generator=g),
                         ("torch.rand", (6,), "float64", ()),
                         lambda g: (torch.rand(6, dtype=F64, generator=g) < P6).to(F64)),
    "bernoulli_scalar_p": (lambda g: torch.bernoulli(torch.empty(2, 3), 0.4, generator=g),
                           ("torch.bernoulli", (2, 3), "float32", (0.4,)),
                           lambda g: torch.bernoulli(torch.zeros(2, 3), 0.4, generator=g)),
    "tensor_std": (lambda g: torch.normal(0.0, P6, generator=g),
                   ("torch.randn", (6,), "float64", ()),
                   lambda g: 0.0 + P6 * torch.randn(6, dtype=F64, generator=g)),
    "tensor_mean": (lambda g: torch.normal(P6, 0.5, generator=g),
                    ("torch.randn", (6,), "float64", ()),
                    lambda g: P6 + 0.5 * torch.randn(6, dtype=F64, generator=g)),
    "tensor_mean_std": (lambda g: torch.normal(P6[:, None], P6, generator=g),
                        ("torch.randn", (6, 6), "float64", ()),
                        lambda g: P6[:, None] + P6 * torch.randn(6, 6, dtype=F64, generator=g)),
    "randperm": (lambda g: torch.randperm(5, generator=g),
                 ("torch.randperm", (5,), "int64", (5,)),
                 lambda g: torch.randperm(5, generator=g)),
    "exponential_": (lambda g: torch.empty(3).exponential_(generator=g),
                     ("Tensor.exponential_", (3,), "float32", (1.0,)),
                     lambda g: torch.empty(3).exponential_(1.0, generator=g)),
    "bernoulli_": (lambda g: torch.empty(4, dtype=F64).bernoulli_(0.3, generator=g),
                   ("Tensor.bernoulli_", (4,), "float64", (0.3,)),
                   lambda g: torch.empty(4, dtype=F64).bernoulli_(0.3, generator=g)),
    "random_": (lambda g: torch.empty(5, dtype=torch.int64).random_(generator=g),
                ("Tensor.random_", (5,), "int64", ()),
                lambda g: torch.empty(5, dtype=torch.int64).random_(generator=g)),
    "random_to": (lambda g: torch.empty(5).random_(7, generator=g),
                  ("Tensor.random_", (5,), "float32", (0, 7)),
                  lambda g: torch.empty(5).random_(0, 7, generator=g)),
    "random_from_to": (lambda g: torch.empty(5, dtype=F64).random_(-3, to=9, generator=g),
                       ("Tensor.random_", (5,), "float64", (-3, 9)),
                       lambda g: torch.empty(5, dtype=F64).random_(-3, 9, generator=g)),
    "cauchy_": (lambda g: torch.empty(3).cauchy_(sigma=0.5, generator=g),
                ("Tensor.cauchy_", (3,), "float32", (0.0, 0.5)),
                lambda g: torch.empty(3).cauchy_(0.0, 0.5, generator=g)),
    "log_normal_": (lambda g: torch.empty(3, dtype=F64).log_normal_(0.5, 0.25, generator=g),
                    ("Tensor.log_normal_", (3,), "float64", (0.5, 0.25)),
                    lambda g: torch.empty(3, dtype=F64).log_normal_(0.5, 0.25, generator=g)),
    "geometric_": (lambda g: torch.empty(4).geometric_(0.2, generator=g),
                   ("Tensor.geometric_", (4,), "float32", (0.2,)),
                   lambda g: torch.empty(4).geometric_(0.2, generator=g)),
}


def _in_step(draw, g):
    """``draw(g)`` as the dynamics' step makes it: ``wrap_dynamics`` calls
    the dynamics within ``solve._BasedDraws`` on their generator."""
    with PS._BasedDraws(g):
        return draw(g)


@pytest.mark.parametrize("what", sorted(NEW_DRAWS))
def test_new_draws_recorded_and_replayed_bit_for_bit(what):
    """Each draw fed since the vocabulary grew, made in the dynamics' step:
    recorded as the plan's entry (a draw with tensor arguments as its base
    draw), replayed and fed bit for bit, its values those the port defines
    from a generator in the same state; and on the CPU torch's own op
    draws the same values outside the step."""
    draw, entry, defined = NEW_DRAWS[what]
    g = torch.Generator().manual_seed(11)
    live = []
    plan = PS.record_draws([g], lambda: live.append(_in_step(draw, g)))
    assert plan == ((PS.Draw(*entry),),)
    assert PS.plan_from_json(json.loads(json.dumps(plan))) == plan
    (replayed,) = PS.replay_draws(plan, [torch.Generator().manual_seed(11)])
    want = defined(torch.Generator().manual_seed(11))
    assert live[0].dtype == want.dtype and torch.equal(live[0], want)
    with PS.fed_draws([g], plan, [replayed]):
        assert torch.equal(_in_step(draw, g), want)
    own = draw(torch.Generator().manual_seed(11))
    assert torch.equal(own, want)


def test_base_draws_only_at_the_steps_that_make_them(monkeypatch):
    """``wrap_dynamics`` learns at each step's first call whether the
    dynamics draw with tensor arguments: a step that does runs within
    ``solve._BasedDraws`` at every call (its values the base draws'),
    and a step that does not runs without it after that first call."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig

    entered = []
    enter = PS._BasedDraws.__enter__
    monkeypatch.setattr(PS._BasedDraws, "__enter__",
                        lambda self: entered.append(self) or enter(self))
    p = torch.linspace(0.1, 0.9, 8, dtype=F64).reshape(4, 2)

    def dyn(s, a, t, rng):
        if t >= 2:
            return s + a + torch.bernoulli(p, generator=rng)
        return s + a + torch.randn(s.shape, generator=rng, dtype=s.dtype)

    cfg = MPPIConfig(nx=2, nu=2, K=4, T=4, dtype=F64, step_dependent_dynamics=True,
                     stochastic_dynamics=True)
    wrapped = PS.wrap_dynamics(cfg, dyn)
    s, a = torch.zeros(4, 2, dtype=F64), torch.zeros(4, 2, dtype=F64)
    for rep in range(3):
        for t in range(4):
            got = wrapped(s, a, t, PS.step_generator(5, t, "cpu"))
            if t >= 2:
                u = torch.rand(4, 2, dtype=F64, generator=PS.step_generator(5, t, "cpu"))
                assert torch.equal(got, (u < p).to(F64))
    assert len(entered) == 4 + 2 * 2  # every step at first, then the two that draw so
    assert [m.made for m in entered] == [False, False, True, True, True, True, True, True]


UNFED = {
    "out": lambda g: torch.randn(3, generator=g, out=torch.empty(3)),
    "multinomial": lambda g: torch.multinomial(torch.ones(4), 2, generator=g),
    "bernoulli_out": lambda g: torch.bernoulli(torch.full((3,), 0.5), generator=g,
                                               out=torch.empty(3)),
    "tensor_std_out": lambda g: torch.normal(0.0, torch.ones(3), generator=g,
                                             out=torch.empty(3)),
    "shape_from_data": lambda g: torch.randn(torch.tensor(3), generator=g),
    "randperm_from_data": lambda g: torch.randperm(torch.tensor(4), generator=g),
    "bernoulli_tensor_p_": lambda g: torch.empty(3).bernoulli_(torch.full((3,), 0.5),
                                                               generator=g),
    "poisson": lambda g: torch.poisson(torch.ones(3), generator=g),
    # a draw with tensor arguments has its fed form only in the dynamics' step
    "bernoulli_outside_the_step": lambda g: torch.bernoulli(torch.full((3,), 0.5), generator=g),
    "tensor_std_outside_the_step": lambda g: torch.normal(0.0, torch.ones(3), generator=g),
}


@pytest.mark.parametrize("what", sorted(UNFED))
def test_a_draw_outside_the_vocabulary_raises(what):
    g = torch.Generator().manual_seed(1)
    with pytest.raises(NotImplementedError, match=ITEM):
        PS.record_draws([g], lambda: UNFED[what](g))
    plan = ((),)
    with pytest.raises(NotImplementedError, match=ITEM):
        with PS.fed_draws([g], plan, []):
            UNFED[what](g)


def test_other_generators_and_calls_pass_through():
    """Only the listed generators are recorded or fed: a draw from another
    generator, and every other call, runs as it is."""
    g, other = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    plan = PS.record_draws([g], lambda: (torch.randn(2, generator=other),
                                         torch.bernoulli(torch.ones(2), generator=other)))
    assert plan == ((),)
    want = torch.randn(2, generator=torch.Generator().manual_seed(2))
    with PS.fed_draws([g], plan, []):
        assert torch.equal(torch.randn(2, generator=torch.Generator().manual_seed(2)), want)


def test_mismatches_raise():
    g = torch.Generator().manual_seed(1)
    plan = PS.record_draws([g], lambda: torch.randn(3, generator=g))
    fed = PS.replay_draws(plan, [torch.Generator().manual_seed(1)])
    with pytest.raises(ValueError, match="where its plan has"):
        with PS.fed_draws([g], plan, fed):
            torch.randn(4, generator=g)
    with pytest.raises(ValueError, match="beyond its plan"):
        with PS.fed_draws([g], plan, fed):
            torch.randn(3, generator=g)
            torch.randn(3, generator=g)
    with pytest.raises(ValueError, match="not drawn"):
        with PS.fed_draws([g], plan, fed):
            pass
    with pytest.raises(ValueError, match="draws fed"):
        PS.fed_draws([g], plan, fed + fed).__enter__()


# -- the artifact --------------------------------------------------------------

def _stochastic(style, step_dependent):
    """Dynamics that draw from their step's generator: additive noise from
    ``torch.randn`` or ``Tensor.normal_``; a Bernoulli-gated impulse with
    a state-dependent probability and a normal of state-scaled deviation
    (``based``: ``torch.bernoulli(p)``, ``torch.normal(0, std)``); or
    exponential noise on a drawn permutation of the state and a clipped
    Cauchy draw (``in_place``: ``Tensor.exponential_``, ``torch.randperm``,
    ``Tensor.cauchy_``); its scale by step where step-dependent."""
    def noise(s, rng):
        if style == "randn":
            return torch.randn(s.shape, generator=rng, dtype=s.dtype)
        if style == "based":
            gate = torch.bernoulli(torch.sigmoid(s).clamp(0.1, 0.9), generator=rng)
            return 2.0 * gate + torch.normal(0.0, 1.0 + 0.1 * s.abs(), generator=rng)
        if style == "in_place":
            e = torch.empty_like(s).exponential_(4.0, generator=rng)
            perm = torch.randperm(s.shape[-1], generator=rng)
            c = torch.empty_like(s).cauchy_(0.0, 0.2, generator=rng)
            return torch.index_select(e, -1, perm) + c.clamp(-1.0, 1.0)
        return torch.empty_like(s).normal_(0.0, 1.0, generator=rng)

    if step_dependent:
        return lambda s, a, t, rng: s + a @ B.T + 0.05 * (1.0 + 0.1 * t) * noise(s, rng)
    return lambda s, a, rng: s + a @ B.T + 0.05 * noise(s, rng)


def _cost(step_dependent):
    if step_dependent:
        return lambda s, a, t: ((GOAL - s) ** 2).sum(-1) + 0.01 * t
    return lambda s, a: ((GOAL - s) ** 2).sum(-1)


VARIANTS = {"mppi": (P.MPPI, {}),
            "smppi": (P.SMPPI, dict(w_action_seq_cost=0.5, delta_t=0.5)),
            "kmppi": (P.KMPPI, dict(num_support_pts=3, kernel=P.RBFKernel(2.0)))}


def _ctrl(variant, style="randn", step_dependent=False, **kw):
    cls, extra = VARIANTS[variant]
    return cls(_stochastic(style, step_dependent), _cost(step_dependent), 2,
               torch.eye(2, dtype=F64), num_samples=32, horizon=5, lambda_=1.0, seed=5,
               u_max=torch.tensor([1.5, 1.5], dtype=F64), stochastic_dynamics=True,
               step_dependent_dynamics=step_dependent, device="cpu", **extra, **kw)


def _states(n=4):
    g = torch.Generator().manual_seed(3)
    return [torch.randn(2, generator=g, dtype=F64) for _ in range(n)]


def _export_and_replay(ctrl, tmp_path, x0=None):
    """Export after one command, then three commands of the live controller,
    the in-memory solver and the loaded one from the same states, bit for
    bit; returns the loaded solver."""
    xs = _states() if x0 is None else x0
    ctrl.command(xs[0])
    path = str(tmp_path / "stochastic.npz")
    solver = deploy.export_solver(ctrl, path)
    loaded = deploy.load_solver(path)
    for x in xs[1:]:
        live = ctrl.command(x)
        for served in (solver, loaded):
            torch.testing.assert_close(served.command(x), live, rtol=0, atol=0)
            torch.testing.assert_close(served.cost_total, ctrl.cost_total, rtol=0, atol=0)
    return loaded


# a step's plan for each style of _stochastic: (op, scalars) of each draw, of
# the state's shape unless a shape is given
STEP_PLANS = {"randn": [("torch.randn", [])], "normal_": [("Tensor.normal_", [0.0, 1.0])],
              "based": [("torch.rand", []), ("torch.randn", [])],
              "in_place": [("Tensor.exponential_", [4.0]), ("torch.randperm", [2], [2], "int64"),
                           ("Tensor.cauchy_", [0.0, 0.2])]}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("style,step_dependent", [("randn", False), ("normal_", True),
                                                  ("based", False), ("in_place", True)],
                         ids=["randn", "normal_step", "based", "in_place_step"])
def test_served_equals_live(tmp_path, variant, M, style, step_dependent):
    kw = dict(rollout_samples=M, rollout_var_cost=0.2) if M > 1 else {}
    ctrl = _ctrl(variant, style, step_dependent, **kw)
    solver = _export_and_replay(ctrl, tmp_path)
    meta = solver.meta
    assert meta["version"] == 7 and meta["route"] == "plain"
    assert meta["streams"]["stochastic_dynamics"]
    assert meta["streams"]["gradient_refinement_steps"] == 0
    want = [[op, *(rest[:1] or [[M * 32, 2]]), *(rest[1:] or ["float64"]), scalars]
            for op, scalars, *rest in STEP_PLANS[style]]
    plan = meta["draws"]
    assert len(plan) == ctrl.config.num_iterations * ctrl.T
    assert all(slot == want for slot in plan)


@pytest.mark.parametrize("flags", [
    dict(gradient_refinement_steps=2),
    dict(gradient_refinement_steps=2, rollout_samples=3, risk_alpha=0.5, num_iterations=2)],
    ids=["refine2", "refine2_M3_cvar_iter2"])
def test_refinement_on_stochastic_dynamics(tmp_path, flags):
    """Gradient refinement on stochastic dynamics draws from its own
    streams (``refine_seed``): the plan has a slot per descent step and
    rollout step after the iterations' slots, and the artifact replays."""
    ctrl = _ctrl("mppi", "normal_", True, **flags)
    solver = _export_and_replay(ctrl, tmp_path)
    n_iter, T = ctrl.config.num_iterations, ctrl.T
    assert solver.meta["streams"]["gradient_refinement_steps"] == 2
    assert len(solver.meta["draws"]) == (n_iter + 2) * T
    M = flags.get("rollout_samples", 1)
    assert solver.meta["draws"][-1][0][1] == [M, 2]  # refinement: one nominal, M rollouts


def test_batched_plain_path(tmp_path):
    """MPPI_Batched with stochastic dynamics takes the plain path (a
    kernel mode asked for warns), and its artifact replays."""
    ctrl = P.MPPI_Batched(_stochastic("randn", False), _cost(False), 2,
                          torch.eye(2, dtype=F64), num_envs=3, num_samples=32, horizon=5,
                          seed=2, stochastic_dynamics=True, use_pallas="force", device="cpu")
    assert not ctrl._fns.fused
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(3, 2, generator=g, dtype=F64) for _ in range(4)]
    solver = _export_and_replay(ctrl, tmp_path, xs)
    assert solver.meta["draws"][0][0][1] == [3 * 32, 2]


def test_feeds_are_the_live_draws():
    """``CommandStreams.feeds`` after the noise are the draws the live body
    makes, drawn again from the seeded generators: bit for bit what the
    dynamics saw."""
    seen = []

    def dyn(s, a, t, rng):
        z = torch.randn(s.shape, generator=rng, dtype=s.dtype)
        seen.append(z)
        return s + a @ B.T + 0.05 * z

    ctrl = P.MPPI(dyn, _cost(True), 2, torch.eye(2, dtype=F64), num_samples=16, horizon=4,
                  seed=9, stochastic_dynamics=True, step_dependent_dynamics=True,
                  num_iterations=2, device="cpu")
    fns, state = ctrl._fns, ctrl._state
    x0 = torch.zeros(2, dtype=F64)
    plan = fns.streams.record(lambda: fns.body(ctrl._params, state, x0, None, None, True),
                              state.seed, state.counter, "cpu")
    feeds = fns.streams.feeds(state.seed, state.counter, "cpu", plan)
    assert len(feeds) == 2 + 2 * 4  # two iterations' noise, then 2 x T draws
    for live, fed in zip(seen, feeds[2:]):
        assert torch.equal(live, fed)
    with pytest.raises(ValueError, match="plan"):
        fns.streams.feeds(state.seed, state.counter, "cpu")


def test_version_5_artifact_loads(tmp_path):
    """A file of version 5, written before the plan and the stochastic
    streams were in the meta, loads and replays the live controller."""
    ctrl = P.MPPI(lambda s, a: s + a @ B.T, _cost(False), 2, torch.eye(2, dtype=F64),
                  num_samples=32, horizon=5, seed=5, device="cpu")
    path = str(tmp_path / "v5.npz")
    deploy.export_solver(ctrl, path)
    tree = ckpt.load(path)
    meta = json.loads(tree["meta"])
    meta["version"] = 5
    assert "draws" not in meta  # a plan only where the dynamics draw
    for key in ("stochastic_dynamics", "gradient_refinement_steps"):
        del meta["streams"][key]
    tree["meta"] = json.dumps(meta)
    ckpt.save(path, tree)
    solver = deploy.load_solver(path)
    assert solver.meta["version"] == 5
    for x in _states():
        torch.testing.assert_close(solver.command(x), ctrl.command(x), rtol=0, atol=0)


def test_serving_host_needs_no_user_code(tmp_path):
    """Two artifacts with drawing dynamics (MPPI at M = 3 with gradient
    refinement, and SMPPI) served in a fresh interpreter that imports only
    the port, torch and numpy: the live controllers' actions bit for bit."""
    xs = _states(5)
    jobs = []
    for name, ctrl in (("mppi", _ctrl("mppi", "normal_", True, rollout_samples=3,
                                      gradient_refinement_steps=2)),
                       ("smppi", _ctrl("smppi"))):
        ctrl.command(xs[0])
        path = str(tmp_path / f"{name}.npz")
        deploy.export_solver(ctrl, path)
        live = torch.stack([ctrl.command(x) for x in xs[1:]]).numpy()
        jobs.append((path, str(tmp_path / f"{name}.npy"), live))
    np.save(tmp_path / "states.npy", torch.stack(xs[1:]).numpy())
    child = (
        "import sys, numpy as np, torch\n"
        "from pytorch_mppi_tpu_torch.utils import deploy\n"
        f"xs = torch.from_numpy(np.load({str(tmp_path / 'states.npy')!r}))\n"
        f"for path, out in {[(p, o) for p, o, _ in jobs]!r}:\n"
        "    solver = deploy.load_solver(path)\n"
        "    np.save(out, torch.stack([solver.command(x) for x in xs]).numpy())\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pytorch_mppi_tpu', 'tests')]\n"
        "print('SERVED OK', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert done.returncode == 0 and "SERVED OK []" in done.stdout, (
        done.stdout[-2000:] + done.stderr[-2000:])
    for _, out, live in jobs:
        np.testing.assert_array_equal(np.load(out), live)
