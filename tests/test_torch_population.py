"""The port's population evaluator and ``GradientOpt`` (``pytorch_mppi_tpu_torch/
autotune.py``) on the CPU.

* ``PopulationEvaluator`` and ``evaluate_population`` against JAX's in
  float64 on one injected draw: JAX's ``jax.random.normal`` patched from the
  test side to return it, the port's ``CommandStreams.feeds`` to feed it, so
  every candidate, trajectory and refinement step of both sees the same
  numbers; costs and rollouts within rtol 1e-9 for MPPI, SMPPI (with
  ``w_action_seq_cost`` and ``delta_t``), KMPPI (with ``kernel_sigma``),
  horizon groups and a step-dependent cost;
* the vmapped evaluation against a per-candidate loop of ``step_no_shift``
  calls on the port's own streams, and the controller's route left as it
  was;
* ``GradientOpt``'s gradients against ``jax.value_and_grad`` within rtol
  1e-8, and its theta after 5 Adam steps against optax's within 1e-8,
  also through gradient refinement;
* stochastic dynamics (M = 3 rollouts) and gradient refinement against
  JAX's evaluator within ``TOL_EVAL``, on dynamics that add a seeded numpy
  table and ignore the key or generator (``tests/test_torch_stochastic.py``'s
  table dynamics) and the injected noise; with dynamics that really draw,
  the vmapped generation against the loop over candidates, streams and
  candidates drawing apart and a second generation drawing afresh;
* the refusal of a mesh, which names ROADMAP.md Queue 1 item 11b;
* JAX's ``TestPopulationEvaluator`` and ``TestGradientOpt``
  (``tests/test_autotune.py:603-1035``) on the port, with their thresholds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu import autotune as JA
from pytorch_mppi_tpu import autotune_global as JAG
from pytorch_mppi_tpu.models import Toy2DEnvironment as JToy2D

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch import autotune
from pytorch_mppi_tpu_torch import autotune_global
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment
from pytorch_mppi_tpu_torch.ops import solve as PS

torch.set_num_threads(1)

F64 = torch.float64
SEED = 1
TOL_EVAL = dict(rtol=1e-9, atol=1e-12)
TOL_GRAD = dict(rtol=1e-8, atol=1e-12)
ITEM = "ROADMAP.md Queue 1 item 11b"


def _draw(shape):
    """The one injected N(0, 1) draw of a shape, the same on both sides."""
    return np.random.RandomState(abs(hash(tuple(shape))) % 2**31).randn(*shape)


@pytest.fixture
def injected(monkeypatch):
    """Both packages draw ``_draw(shape)`` for every noise draw: JAX's
    ``jax.random.normal`` and the port's fed streams."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float64):
        if len(shape) == 2:
            return jnp.asarray(_draw(shape), dtype)
        return real(key, shape, dtype)

    def feeds(self, seed, counter, device, plan=None):
        # the dynamics of these tests draw nothing: a plan of no draws
        assert plan is None or not any(plan)
        return [torch.tensor(_draw(self.draw_shape), dtype=self.dtype, device=device)
                for _ in range(self.n_iter)]

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(PS.CommandStreams, "feeds", feeds)


def _pair(variant, horizon=8, K=64, port_kw=None, **kw):
    """A JAX controller and the port's twin on toy2d in float64, the port
    started from the JAX controller's nominal trajectory; ``port_kw`` goes
    to the port's alone."""
    jenv = JToy2D(terminal_scale=10.0, dtype=jnp.float64)
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    common = dict(num_samples=K, horizon=horizon, lambda_=1.0, seed=SEED)
    jcls, pcls = {"mppi": (J.MPPI, P.MPPI), "smppi": (J.SMPPI, P.SMPPI),
                  "kmppi": (J.KMPPI, P.KMPPI)}[variant]
    jkw, pkw = dict(kw), dict(kw)
    for name in ("u_max", "action_max"):
        if name in kw:
            jkw[name] = jnp.asarray(kw[name], jnp.float64)
            pkw[name] = torch.tensor(kw[name], dtype=F64)
    jdyn, jcost, pdyn, pcost = jenv.dynamics, jenv.running_cost, env.dynamics, env.running_cost
    if kw.pop("step_dependent", False):
        jkw.pop("step_dependent"), pkw.pop("step_dependent")
        jdyn = lambda s, a, t: jenv.dynamics(s, a)  # noqa: E731
        jcost = lambda s, a, t: jenv.running_cost(s, a) * (1.0 + 0.01 * t)  # noqa: E731
        pdyn = lambda s, a, t: env.dynamics(s, a)  # noqa: E731
        # t is an int at a rollout step and an int64 arange when scored
        pcost = lambda s, a, t: env.running_cost(s, a) * (  # noqa: E731
            1.0 + 0.01 * torch.as_tensor(t, dtype=F64))
        jkw["step_dependent_dynamics"] = pkw["step_dependent_dynamics"] = True
    jc = jcls(jdyn, jcost, 2, noise_sigma=jnp.diag(jnp.array([5.0, 5.0])), **common, **jkw)
    pc = pcls(pdyn, pcost, 2, noise_sigma=torch.diag(torch.tensor([5.0, 5.0], dtype=F64)),
              device="cpu", **common, **pkw, **(port_kw or {}))
    pc.U = torch.from_numpy(np.array(jc.U))
    return jenv, env, jc, pc


def _both(cands):
    """Candidate dicts for JAX (jnp values) and for the port (tensors)."""
    def conv(v, mod):
        return (jnp.asarray(v, jnp.float64) if mod == "jax"
                else torch.tensor(v, dtype=F64)) if isinstance(v, list) else v
    return ([{k: conv(v, "jax") for k, v in c.items()} for c in cands],
            [{k: conv(v, "torch") for k, v in c.items()} for c in cands])


BASE_CANDS = [{"sigma": [5.0, 5.0], "lambda": 1.0},
              {"sigma": [1.0, 2.0], "lambda": 0.5},
              {"mu": [0.1, -0.1]},
              {}]
PARITY = {
    "mppi": ("mppi", dict(u_max=[2.0, 2.0]), BASE_CANDS),
    "mppi_iter2_null": ("mppi", dict(u_max=[2.0, 2.0], num_iterations=2,
                                     sample_null_action=True), BASE_CANDS),
    "smppi": ("smppi", dict(w_action_seq_cost=3.0, delta_t=0.5, action_max=[2.0, 2.0]),
              BASE_CANDS + [{"w_action_seq_cost": 10.0, "delta_t": 0.3},
                            {"w_action_seq_cost": 0.0, "sigma": [2.0, 2.0]}]),
    "kmppi": ("kmppi", dict(num_support_pts=4),
              BASE_CANDS + [{"kernel_sigma": 3.0}, {"kernel_sigma": 0.5, "lambda": 2.0}]),
    "step_dependent": ("mppi", dict(u_max=[2.0, 2.0], step_dependent=True), BASE_CANDS),
}


class TestParityWithJax:
    @pytest.mark.parametrize("case", sorted(PARITY))
    def test_costs_and_rollouts(self, injected, case):
        variant, kw, cands = PARITY[case]
        jenv, env, jc, pc = _pair(variant, **kw)
        jd, pd = _both(cands)
        jev = JA.PopulationEvaluator(jc, jenv.start, num_refinement_steps=3, num_trajectories=2)
        pev = autotune.PopulationEvaluator(pc, env.start, num_refinement_steps=3,
                                           num_trajectories=2)
        jres, pres = jev(jd), pev(pd)
        np.testing.assert_allclose(pres.costs.numpy(), np.asarray(jres.costs), **TOL_EVAL)
        np.testing.assert_allclose(pres.rollouts.numpy(), np.asarray(jres.rollouts), **TOL_EVAL)
        assert pres.rollouts.shape == (len(cands), pc.T, 2)

    @pytest.mark.parametrize("variant", ["mppi", "kmppi"])
    def test_horizon_groups(self, injected, variant):
        """evaluate_population's groups by effective horizon (KMPPI clamps
        below its 5 support points), each one evaluation, then the
        controller restored: the same costs as JAX's."""
        kw = dict(u_max=[2.0, 2.0]) if variant == "mppi" else dict(num_support_pts=5)
        jenv, env, jc, pc = _pair(variant, horizon=10, **kw)
        cands = [{"sigma": [5.0, 5.0], "horizon": 4}, {"sigma": [2.0, 3.0], "horizon": 10},
                 {"sigma": [1.0, 1.0], "horizon": 7.4}, {"lambda": 0.5, "horizon": 3},
                 {"sigma": [3.0, 3.0], "horizon": 12}]
        jd, pd = _both(cands)
        out = []
        for mod, ctrl, env_, dicts in ((JA, jc, jenv, jd), (autotune, pc, env, pd)):
            glob = JAG if mod is JA else autotune_global
            ev = mod.PopulationEvaluator(ctrl, env_.start, num_refinement_steps=2,
                                         num_trajectories=2)
            tuner = glob.AutotuneGlobal(
                [glob.SigmaGlobalParameter(ctrl), glob.LambdaGlobalParameter(ctrl),
                 glob.HorizonGlobalParameter(ctrl)],
                evaluate_fn=lambda: None,
                optimizer=glob.GlobalSearchOpt(batch_size=2, seed=SEED),
                population_evaluate_fn=ev)
            full = [dict(d) for d in dicts]
            for d in full:
                d.setdefault("sigma", tuner.params[0].get_current_parameter_value())
                d.setdefault("lambda", ctrl.lambda_)
            out.append(mod.evaluate_population(tuner, ev, full))
            assert ctrl.T == 10
        np.testing.assert_allclose(out[1], out[0], **TOL_EVAL)
        np.testing.assert_array_equal(pc.U.numpy(), np.asarray(jc.U))


def _candidate_params(pc, cand):
    """The full params of a controller with one candidate's values."""
    full = pc._full_params()
    base = full.base if hasattr(full, "base") else full
    repl = {}
    if "sigma" in cand:
        repl["noise_sigma"] = torch.diag(torch.tensor(cand["sigma"], dtype=pc.dtype))
    if "mu" in cand:
        repl["noise_mu"] = torch.tensor(cand["mu"], dtype=pc.dtype)
    if "lambda" in cand:
        repl["lambda_"] = torch.tensor(cand["lambda"], dtype=pc.dtype)
    base = base._replace(**repl)
    if not hasattr(full, "base"):
        return base
    var = {k: torch.tensor(cand[k], dtype=pc.dtype)
           for k in ("w_action_seq_cost", "delta_t") if k in cand}
    if "kernel_sigma" in cand:
        from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

        var["interp_full"], var["interp_shift"] = interpolation_operators(
            type(pc.interpolation_kernel)(cand["kernel_sigma"]), pc.T, pc.num_support_pts,
            pc.dtype)
    return full._replace(base=base, **var)


def _drawing_ctrl(variant, in_place="result", **kw):
    """A float64 controller on the linear plant whose dynamics draw from
    their generator at each step: ``torch.randn`` and ``Tensor.normal_``,
    by step (step-dependent), as a user's would.  ``in_place`` says how the
    ``Tensor.normal_`` steps read their draw: "result" the method's result,
    "target" the tensor drawn into (``torch.empty_like`` of the state), and
    "unbatched" the tensor drawn into, made with ``torch.empty``; "based"
    draws instead a Bernoulli-gated impulse with a state-dependent
    probability, a normal of state-scaled deviation and exponential noise
    (``torch.bernoulli(p)``, ``torch.normal(0, std)``,
    ``Tensor.exponential_``) at every step."""
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)
    goal = torch.tensor([2.0, 2.0], dtype=F64)
    stochastic = kw.setdefault("stochastic_dynamics", True)

    def dyn(s, a, t, rng=None):
        nxt = s + a @ B.T
        if not stochastic:
            return nxt
        if in_place == "based":
            gate = torch.bernoulli(torch.sigmoid(s).clamp(0.1, 0.9), generator=rng)
            e = torch.empty_like(s).exponential_(4.0, generator=rng)
            std = 0.05 * (1.0 + 0.1 * s.abs())
            return nxt + 0.05 * gate + torch.normal(0.0, std, generator=rng) + 0.01 * e
        if t % 2:
            return nxt + 0.05 * torch.randn(s.shape, generator=rng, dtype=s.dtype)
        if in_place == "result":
            return nxt + 0.05 * torch.empty_like(s).normal_(0.0, 1.0, generator=rng)
        eps = torch.empty_like(s) if in_place == "target" else torch.empty(s.shape, dtype=F64)
        eps.normal_(0.0, 1.0, generator=rng)
        return nxt + 0.05 * eps

    cost = lambda s, a, t: ((goal - s) ** 2).sum(-1)  # noqa: E731
    extra = {"smppi": dict(w_action_seq_cost=1.0, delta_t=0.5),
             "kmppi": dict(num_support_pts=3)}.get(variant, {})
    cls = {"mppi": P.MPPI, "smppi": P.SMPPI, "kmppi": P.KMPPI}[variant]
    ctrl = cls(dyn, cost, 2, torch.eye(2, dtype=F64), num_samples=32, horizon=5, seed=3,
               u_max=torch.tensor([2.0, 2.0], dtype=F64), step_dependent_dynamics=True,
               device="cpu", **extra, **kw)
    return ctrl, torch.tensor([-3.0, -2.0], dtype=F64)


# case: (variant, controller flags) of the loop tests with drawing dynamics
DRAWING = {
    "mppi_M3": ("mppi", dict(rollout_samples=3, rollout_var_cost=0.1)),
    "mppi_refine2": ("mppi", dict(stochastic_dynamics=False, gradient_refinement_steps=2)),
    "mppi_M3_refine2_iter2": ("mppi", dict(rollout_samples=3, gradient_refinement_steps=2,
                                           num_iterations=2)),
    "smppi": ("smppi", {}),
    "kmppi_M3": ("kmppi", dict(rollout_samples=3)),
    # the draw read from the tensor drawn into, its result discarded
    "mppi_M3_target": ("mppi", dict(rollout_samples=3, in_place="target")),
    "mppi_M3_refine2_target": ("mppi", dict(rollout_samples=3, gradient_refinement_steps=2,
                                            in_place="target")),
    # draws with tensor arguments, fed as their base draws, and Tensor.exponential_
    "mppi_M3_based": ("mppi", dict(rollout_samples=3, in_place="based")),
    "smppi_based": ("smppi", dict(in_place="based")),
    "kmppi_M3_based": ("kmppi", dict(rollout_samples=3, in_place="based")),
    "mppi_M3_refine2_based": ("mppi", dict(rollout_samples=3, gradient_refinement_steps=2,
                                           in_place="based")),
}


class TestAgainstTheLoop:
    """Candidate p, trajectory m computes what R ``step_no_shift`` calls
    of a controller with p's parameters compute from state seed
    ``seed_pm``: the vmapped population against that loop on the port's own
    streams, and the controller's own route untouched."""

    @pytest.mark.parametrize("case,use_pallas", [
        ("mppi", False), ("mppi", True), ("mppi_iter2_null", False), ("smppi", False),
        ("smppi", True), ("kmppi", True), ("step_dependent", False)])
    def test_vmapped_equals_loop(self, case, use_pallas):
        variant, kw, cands = PARITY[case]
        _, env, _, pc = _pair(variant, port_kw=dict(use_pallas=use_pallas), **kw)
        own_fns, R, M = pc._fns, 3, 2
        ev = autotune.PopulationEvaluator(pc, env.start, num_refinement_steps=R,
                                          num_trajectories=M, seed=7)
        res = ev(_both(cands)[1])
        assert pc._fns is own_fns and pc.use_pallas == use_pallas
        twin = autotune.PopulationEvaluator(pc, env.start, seed=7)
        seeds = twin._stream_seeds(len(cands) * M)
        fns = ev._planning_fns()
        assert not fns.fused
        loop = []
        for p, cand in enumerate(cands):
            params = _candidate_params(pc, cand)
            base = params.base if hasattr(params, "base") else params
            costs = []
            for m in range(M):
                state = pc._state._replace(seed=seeds[p * M + m])
                for _ in range(R):
                    state, _, _ = fns.step_no_shift(params, state, env.start)
                seq = getattr(state, "action_sequence", state.U)
                rollout = fns.get_rollouts(base, env.start, seq)[0]
                cost_fn = ev._default_cost_fn()
                costs.append(cost_fn(rollout, seq))
            loop.append(torch.stack(costs).mean())
        torch.testing.assert_close(res.costs, torch.stack(loop), rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("case", sorted(DRAWING))
    def test_drawing_dynamics_equal_the_loop(self, case):
        """Dynamics that draw from their generator (``torch.randn`` and
        ``Tensor.normal_``), gradient refinement, or both: the vmapped
        generation, fed each stream's draws, computes what the loop of live
        ``step_no_shift`` calls computes on the same state seeds, the
        refinement's ``torch.func.grad`` against its ``torch.autograd.grad``
        (float64, rtol 1e-12)."""
        variant, kw = DRAWING[case]
        pc, start = _drawing_ctrl(variant, **kw)
        R, M = 2, 2
        cands = [{"sigma": [1.0, 2.0]}, {"lambda": 0.5}, {}]
        ev = autotune.PopulationEvaluator(pc, start, num_refinement_steps=R,
                                          num_trajectories=M, seed=7)
        res = ev(_both(cands)[1])
        seeds = autotune.PopulationEvaluator(pc, start, seed=7)._stream_seeds(len(cands) * M)
        fns = ev._planning_fns()
        score = ev._default_cost_fn()
        loop = []
        for p, cand in enumerate(cands):
            params = _candidate_params(pc, cand)
            base = params.base if hasattr(params, "base") else params
            costs = []
            for m in range(M):
                state = pc._state._replace(seed=seeds[p * M + m])
                for _ in range(R):
                    state, _, _ = fns.step_no_shift(params, state, start)
                seq = getattr(state, "action_sequence", state.U)
                costs.append(score(fns.get_rollouts(base, start, seq)[0], seq))
            loop.append(torch.stack(costs).mean())
        assert torch.isfinite(res.costs).all()
        torch.testing.assert_close(res.costs, torch.stack(loop), rtol=1e-12, atol=1e-12)

    def test_streams_candidates_and_generations_draw_apart(self):
        """The dynamics' fed draws differ between the streams of one
        generation (so between candidates, whose streams are their own, as
        JAX's split keys), and a second generation draws afresh: its costs
        on the same candidates differ too."""
        pc, start = _drawing_ctrl("mppi", rollout_samples=3)
        ev = autotune.PopulationEvaluator(pc, start, num_refinement_steps=2,
                                          num_trajectories=2, seed=7)
        fed = []
        real = ev._draws
        ev._draws = lambda *a: fed.append(real(*a)) or fed[-1]
        cands = [{"sigma": torch.tensor([1.0, 1.0], dtype=F64)}] * 2
        first, second = ev(cands).costs, ev(cands).costs
        n_noise = pc._fns.streams.n_iter
        for draws in fed:
            rollout = draws[n_noise:]  # the dynamics' draws, after the noise
            assert rollout and all(z.shape[:2] == (4, 2) for z in rollout)
            flat = torch.cat([z.reshape(4, -1) for z in rollout], 1)
            assert len({tuple(row.tolist()) for row in flat}) == 4
        assert not torch.equal(torch.cat([z.reshape(-1) for z in fed[0][n_noise:]]),
                               torch.cat([z.reshape(-1) for z in fed[1][n_noise:]]))
        assert first[0] != first[1] and not torch.equal(first, second)

    def test_unbatched_in_place_target_reads_nan(self):
        """An in-place draw into a tensor made with ``torch.empty`` cannot
        hold the draws a vmap feeds each stream: code that reads the tensor
        and discards the draw's result reads NaN, so its costs are NaN
        rather than numbers of another sum; the same dynamics run live."""
        pc, start = _drawing_ctrl("mppi", in_place="unbatched")
        ev = autotune.PopulationEvaluator(pc, start, num_refinement_steps=2,
                                          num_trajectories=2, seed=7)
        assert torch.isnan(ev([{}, {"lambda": 0.5}]).costs).all()
        assert torch.isfinite(pc.command(start)).all()

    def test_fresh_streams_each_generation(self):
        _, env, _, pc = _pair("mppi", u_max=[2.0, 2.0])
        ev = autotune.PopulationEvaluator(pc, env.start, num_refinement_steps=2,
                                          num_trajectories=1)
        cand = [{"sigma": torch.tensor([5.0, 5.0], dtype=F64)}] * 2
        a, b = ev(cand).costs, ev(cand).costs
        assert a[0] != a[1] and not torch.equal(a, b)


def _table_pair(variant, flags, K=64, T=8):
    """A JAX controller and the port's twin on toy2d in float64 with
    step-dependent stochastic dynamics that add ``table[t]`` (its first
    rows: the rollouts have M·K, refinement M and the scoring one) and
    ignore the key or generator, as ``tests/test_torch_stochastic.py``'s."""
    M = flags.get("rollout_samples", 1)
    table = np.random.RandomState(5).randn(T, M * K, 2) * 0.1
    jenv = JToy2D(terminal_scale=10.0, dtype=jnp.float64)
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    jt, pt = jnp.asarray(table), torch.tensor(table)
    common = dict(num_samples=K, horizon=T, lambda_=1.0, seed=SEED, stochastic_dynamics=True,
                  step_dependent_dynamics=True, **flags)
    extra_j, extra_p = {}, {}
    if variant == "smppi":
        extra_j = dict(w_action_seq_cost=3.0, delta_t=0.5,
                       action_max=jnp.asarray([2.0, 2.0], jnp.float64))
        extra_p = dict(w_action_seq_cost=3.0, delta_t=0.5,
                       action_max=torch.tensor([2.0, 2.0], dtype=F64))
    elif variant == "kmppi":
        extra_j = extra_p = dict(num_support_pts=4)
    else:
        extra_j = dict(u_max=jnp.asarray([2.0, 2.0], jnp.float64))
        extra_p = dict(u_max=torch.tensor([2.0, 2.0], dtype=F64))
    jcls, pcls = {"mppi": (J.MPPI, P.MPPI), "smppi": (J.SMPPI, P.SMPPI),
                  "kmppi": (J.KMPPI, P.KMPPI)}[variant]
    jc = jcls(lambda s, a, t, key: jenv.dynamics(s, a) + jt[t][:s.shape[0]],
              lambda s, a, t: jenv.running_cost(s, a), 2,
              noise_sigma=jnp.diag(jnp.array([5.0, 5.0])), **common, **extra_j)
    pc = pcls(lambda s, a, t, rng: env.dynamics(s, a) + pt[t][:s.shape[0]],
              lambda s, a, t: env.running_cost(s, a), 2,
              noise_sigma=torch.diag(torch.tensor([5.0, 5.0], dtype=F64)), device="cpu",
              **common, **extra_p)
    pc.U = torch.from_numpy(np.array(jc.U))
    return jenv, env, jc, pc


# case: (variant, controller flags) of the parity with JAX's evaluator
TABLE = {
    "mppi_M3": ("mppi", dict(rollout_samples=3, rollout_var_cost=0.2)),
    "mppi_M3_cvar": ("mppi", dict(rollout_samples=3, risk_alpha=0.5)),
    "smppi_M3": ("smppi", dict(rollout_samples=3)),
    "kmppi_M3": ("kmppi", dict(rollout_samples=3)),
    "mppi_refine2": ("mppi", dict(gradient_refinement_steps=2)),
    "mppi_M3_refine2": ("mppi", dict(rollout_samples=3, gradient_refinement_steps=2)),
}


class TestStochasticParityWithJax:
    @pytest.mark.parametrize("case", sorted(TABLE))
    def test_costs_and_rollouts(self, injected, case):
        """Stochastic dynamics at M = 3 (the variance cost, CVaR), gradient
        refinement on them: the port's evaluator against JAX's within
        ``TOL_EVAL``, every candidate, stream and refinement step on the
        injected noise."""
        variant, flags = TABLE[case]
        jenv, env, jc, pc = _table_pair(variant, flags)
        jd, pd = _both(BASE_CANDS)
        jev = JA.PopulationEvaluator(jc, jenv.start, num_refinement_steps=3, num_trajectories=2)
        pev = autotune.PopulationEvaluator(pc, env.start, num_refinement_steps=3,
                                           num_trajectories=2)
        jres, pres = jev(jd), pev(pd)
        np.testing.assert_allclose(pres.costs.numpy(), np.asarray(jres.costs), **TOL_EVAL)
        np.testing.assert_allclose(pres.rollouts.numpy(), np.asarray(jres.rollouts), **TOL_EVAL)


def _jax_linear(sigma0, lambda0, dtype=jnp.float64, variant="mppi", **flags):
    B = jnp.array([[1.0, 0.0], [0.0, -1.0]], dtype)
    goal = jnp.array([2.0, 2.0], dtype)
    dyn = lambda s, a, *key: s + a @ B.T  # noqa: E731 (a key ignored if stochastic)
    cost = lambda s, a: ((goal - s) ** 2).sum(axis=-1)  # noqa: E731
    kw = dict(w_action_seq_cost=2.0, delta_t=0.7) if variant == "smppi" else {}
    cls = J.SMPPI if variant == "smppi" else J.MPPI
    ctrl = cls(dyn, cost, nx=2, noise_sigma=jnp.eye(2, dtype=dtype) * sigma0,
               num_samples=64, horizon=8, lambda_=lambda0, seed=0, **kw, **flags)
    ev = JA.PopulationEvaluator(ctrl, start_state=jnp.array([-3.0, -2.0], dtype),
                                num_refinement_steps=3, num_trajectories=2, seed=1)
    return ctrl, ev


def _linear(sigma0, lambda0, dtype=torch.float32, variant="mppi", K=256, T=10, R=5, M=2,
            start=(-3.0, -2.0), **flags):
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=dtype)
    goal = torch.tensor([2.0, 2.0], dtype=dtype)
    dyn = lambda s, a, *rng: s + a @ B.T  # noqa: E731 (a generator ignored if stochastic)
    cost = lambda s, a: ((goal - s) ** 2).sum(dim=-1)  # noqa: E731
    kw = dict(w_action_seq_cost=2.0, delta_t=0.7) if variant == "smppi" else {}
    cls = P.SMPPI if variant == "smppi" else P.MPPI
    ctrl = cls(dyn, cost, nx=2, noise_sigma=torch.eye(2, dtype=dtype) * sigma0,
               num_samples=K, horizon=T, lambda_=lambda0, seed=0, device="cpu", **kw, **flags)
    ev = autotune.PopulationEvaluator(ctrl, start_state=torch.tensor(start, dtype=dtype),
                                      num_refinement_steps=R, num_trajectories=M, seed=1)
    return ctrl, ev


GRAD_PARAMS = {
    "mppi": lambda m, c: [m.SigmaParameter(c), m.LambdaParameter(c), m.MuParameter(c)],
    "smppi": lambda m, c: [m.SigmaParameter(c), m.WActionSeqCostParameter(c),
                           m.DeltaTParameter(c)],
}


REFINE = dict(gradient_refinement_steps=2)


class TestGradientParity:
    @pytest.mark.parametrize("variant,flags", [
        ("mppi", {}), ("smppi", {}), ("mppi", REFINE),
        ("mppi", dict(REFINE, stochastic_dynamics=True, rollout_samples=3))],
        ids=["mppi", "smppi", "mppi_refine2", "mppi_stochastic_M3_refine2"])
    def test_gradients_and_adam_against_jax(self, injected, variant, flags):
        """The cost and its gradient with respect to each log-space theta
        against ``jax.value_and_grad``; then theta after one optimize_step
        of 5 Adam updates against optax's, and the applied parameters.  With
        gradient refinement in every command (also on stochastic dynamics
        at M = 3 that ignore their key or generator) the gradient goes
        through the refinement's Adam descent: ``torch.autograd`` over
        ``torch.func.grad`` against JAX's grad of grad."""
        jc, jev = _jax_linear(0.8, 2.0, variant=variant, **flags)
        pc, pev = _linear(0.8, 2.0, F64, variant, K=64, T=8, R=3, M=2, **flags)
        pc.U = torch.from_numpy(np.array(jc.U))
        jt = JA.Autotune(GRAD_PARAMS[variant](JA, jc), evaluate_fn=lambda: None,
                         optimizer=JA.GradientOpt(lr=0.1, steps_per_iteration=5),
                         population_evaluate_fn=jev)
        pt = autotune.Autotune(GRAD_PARAMS[variant](autotune, pc), evaluate_fn=lambda: None,
                               optimizer=autotune.GradientOpt(lr=0.1, steps_per_iteration=5),
                               population_evaluate_fn=pev)
        jo, po = jt.optim, pt.optim
        vg = jo._loss_and_grad(jev._planning_fns())
        keys = jax.random.split(jax.random.PRNGKey(0), jev.M)
        jcost, jgrads = vg(jo._theta, jo._full_template(), keys, jc.U, jc._state,
                           jc.dynamics_params)
        pcost, pgrads = po.value_and_grad()
        np.testing.assert_allclose(float(pcost), float(jcost), **TOL_GRAD)
        for n in jgrads:
            np.testing.assert_allclose(pgrads[n].numpy(), np.asarray(jgrads[n]), **TOL_GRAD)
            assert np.abs(np.asarray(jgrads[n])).max() > 0
        jres, pres = jt.optimize_step(), pt.optimize_step()
        for n in jo._theta:
            np.testing.assert_allclose(po._theta[n].detach().numpy(), np.asarray(jo._theta[n]),
                                       rtol=0, atol=1e-8)
        np.testing.assert_allclose(pres.costs.numpy(), np.asarray(jres.costs), **TOL_EVAL)
        np.testing.assert_allclose(np.diag(pc.noise_sigma.numpy()),
                                   np.diag(np.asarray(jc.noise_sigma)), rtol=1e-8)


class TestStochasticAndRefinement:
    @pytest.mark.parametrize("flags", [dict(stochastic_dynamics=True),
                                       dict(gradient_refinement_steps=2)])
    def test_evaluator_and_gradient_opt_run(self, flags):
        """What the evaluator refused before (ROADMAP.md Queue 1 item 11b's
        first two bullets): stochastic dynamics that draw, and gradient
        refinement, evaluate in float32 to finite costs, and GradientOpt
        takes a finite, non-zero gradient and steps."""
        B = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
        if flags.get("stochastic_dynamics"):
            dyn = lambda s, a, rng: s + a @ B.T + 0.01 * torch.randn(  # noqa: E731
                s.shape, generator=rng)
        else:
            dyn = lambda s, a: s + a @ B.T  # noqa: E731
        ctrl = P.MPPI(dyn, lambda s, a: (s ** 2).sum(-1), 2, torch.eye(2), num_samples=16,
                      horizon=4, device="cpu", **flags)
        ev = autotune.PopulationEvaluator(ctrl, torch.ones(2), num_refinement_steps=1)
        assert torch.isfinite(ev([{}, {"lambda": 0.5}]).costs).all()
        tuner = autotune.Autotune([autotune.SigmaParameter(ctrl)], evaluate_fn=lambda: None,
                                  optimizer=autotune.GradientOpt(steps_per_iteration=2),
                                  population_evaluate_fn=ev)
        cost, grads = tuner.optim.value_and_grad()
        assert torch.isfinite(cost) and torch.isfinite(grads["sigma"]).all()
        assert bool((grads["sigma"] != 0).any())
        assert torch.isfinite(tuner.optimize_step().costs).all()


class TestRefusals:

    def test_mesh(self, tmp_path):
        import torch.distributed as dist

        from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

        initialize_multihost(f"file://{tmp_path / 'group'}", 1, 0, device="cpu")
        try:
            mesh = make_mesh((1,), ("k",), device="cpu")
            B = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
            ctrl = P.MPPI(lambda s, a: s + a @ B.T, lambda s, a: (s ** 2).sum(-1), 2,
                          torch.eye(2), num_samples=16, horizon=4, device="cpu", mesh=mesh)
            ev = autotune.PopulationEvaluator(ctrl, torch.zeros(2), num_refinement_steps=1)
            with pytest.raises(NotImplementedError, match=ITEM):
                ev([{}])
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX's tests/test_autotune.py:603-1035 on the port
# ---------------------------------------------------------------------------


def _toy_mppi(horizon=10, K=128, sigma=5.0, **kw):
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    mppi = P.MPPI(env.dynamics, env.running_cost, 2,
                  noise_sigma=torch.diag(torch.tensor([sigma, sigma], dtype=F64)),
                  num_samples=K, horizon=horizon, u_max=torch.tensor([2.0, 2.0], dtype=F64),
                  lambda_=1.0, seed=SEED, device="cpu", **kw)
    return env, mppi


def _t(*v):
    return torch.tensor(v, dtype=F64)


class TestPopulationEvaluator:
    """The whole CMA-ES ask() batch in one vmapped evaluation."""

    def test_shapes_and_finiteness(self):
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)
        res = ev([{"sigma": _t(5.0, 5.0), "lambda": 1.0},
                  {"sigma": _t(1.0, 1.0), "lambda": 0.5},
                  {"mu": _t(0.1, -0.1)}])
        assert res.costs.shape == (3,)
        assert res.rollouts.shape == (3, 10, 2)
        assert torch.isfinite(res.costs).all()

    def test_ordering_sane(self):
        """A reasonable sigma must beat a degenerate tiny sigma on this task."""
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=5,
                                          num_trajectories=3)
        costs = ev([{"sigma": _t(5.0, 5.0)}, {"sigma": _t(1e-3, 1e-3)}]).costs
        assert costs[0] < costs[1]

    def test_cmaes_population_path_improves_and_skips_evaluate_fn(self):
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)
        calls = {"n": 0}

        def must_not_run():
            calls["n"] += 1
            raise AssertionError("sequential evaluate_fn must not be called")

        tuner = autotune.Autotune(
            [autotune.SigmaParameter(mppi), autotune.LambdaParameter(mppi)],
            evaluate_fn=must_not_run,
            optimizer=autotune.CMAESOpt(population=6, sigma=0.5, seed=SEED),
            population_evaluate_fn=ev)
        first = None
        for _ in range(3):
            res = tuner.optimize_step()
            if first is None:
                first = autotune.mean_cost(res.costs)
        assert calls["n"] == 0
        best = tuner.get_best_result()
        assert autotune.mean_cost(best.costs) <= first + 1e-6
        assert set(best.params) == {"sigma", "lambda"}

    def test_unsupported_param_rejected(self):
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=2)
        with pytest.raises(ValueError, match="Horizon changes"):
            ev([{"horizon": 12}])

    def test_horizon_change_after_construction_honored(self):
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=2,
                                          num_trajectories=1)
        assert ev([{"sigma": _t(5.0, 5.0)}]).rollouts.shape == (1, 10, 2)
        mppi.change_horizon(6)
        res6 = ev([{"sigma": _t(5.0, 5.0)}])
        assert res6.rollouts.shape == (1, 6, 2)
        assert torch.isfinite(res6.costs).all()

    def test_u_reassignment_honored(self):
        """mppi.U = ... between calls changes the shared starting trajectory."""
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=0,
                                          num_trajectories=1)
        cand = [{"sigma": _t(5.0, 5.0)}]
        r1 = ev(cand)
        mppi.U = torch.ones_like(mppi.U)
        r2 = ev(cand)
        assert not torch.allclose(r1.rollouts, r2.rollouts)

    def test_smppi_controller_supported(self):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        mppi = P.SMPPI(env.dynamics, env.running_cost, 2,
                       noise_sigma=torch.diag(_t(5.0, 5.0)), num_samples=64, horizon=8,
                       w_action_seq_cost=10.0, u_max=_t(2.0, 2.0), action_max=_t(2.0, 2.0),
                       lambda_=1.0, seed=SEED, device="cpu")
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)
        res = ev([{"sigma": _t(5.0, 5.0)}, {"sigma": _t(0.5, 0.5), "lambda": 0.7}])
        assert res.costs.shape == (2,)
        assert res.rollouts.shape == (2, 8, 2)
        assert torch.isfinite(res.costs).all()

    def test_kmppi_controller_supported(self):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        mppi = P.KMPPI(env.dynamics, env.running_cost, 2,
                       noise_sigma=torch.diag(_t(5.0, 5.0)), num_samples=64, horizon=10,
                       num_support_pts=4, u_max=_t(2.0, 2.0), lambda_=1.0, seed=SEED,
                       device="cpu")
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)
        res = ev([{"sigma": _t(5.0, 5.0)}, {"mu": _t(0.1, -0.1)}])
        assert res.costs.shape == (2,)
        assert torch.isfinite(res.costs).all()

    def test_eval_cache_per_solver_bundle(self):
        """Horizon toggling reuses the evaluation built for a solver bundle."""
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=1,
                                          num_trajectories=1)
        cand = [{"sigma": _t(5.0, 5.0)}]
        ev(cand)
        mppi.change_horizon(6)
        ev(cand)
        mppi.change_horizon(10)  # back to the first solver (cached fns)
        ev(cand)
        assert len(ev._eval_cache) == 2

    def test_population_values_validated(self):
        """Candidates go through ensure_valid_value: a zero or negative sigma
        from an unclipped space must not reach the sampling factors."""
        env, mppi = _toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=1,
                                          num_trajectories=1)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(
                mppi, search_space=autotune_global.Uniform(0.0, 10.0))],
            evaluate_fn=lambda: None,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=3, seed=SEED),
            population_evaluate_fn=ev)
        costs = autotune.evaluate_population(
            tuner, ev, [{"sigma": _t(0.0, -1.0)}, {"sigma": _t(5.0, 5.0)}])
        assert np.isfinite(costs).all()
        for _ in range(2):
            res = tuner.optimize_step()
            assert torch.isfinite(res.costs).all()
        for r in tuner.results:
            assert torch.isfinite(r.costs).all()

    def test_horizon_groups_restore_controller_state(self):
        env, mppi = _toy_mppi()
        mppi.U = torch.linspace(0.1, 2.0, 20, dtype=F64).reshape(10, 2)
        U0 = mppi.U.clone()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=1,
                                          num_trajectories=1)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi),
             autotune_global.HorizonGlobalParameter(mppi)],
            evaluate_fn=lambda: None,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=2, seed=SEED),
            population_evaluate_fn=ev)
        costs = autotune.evaluate_population(
            tuner, ev, [{"sigma": _t(5.0, 5.0), "horizon": 4},
                        {"sigma": _t(5.0, 5.0), "horizon": 10}])
        assert np.isfinite(costs).all()
        assert mppi.T == 10
        assert torch.equal(mppi.U, U0)

    def test_effective_value_is_pure(self):
        env, mppi = _toy_mppi()
        p = autotune.HorizonParameter(mppi)
        T0, U0 = mppi.T, mppi.U.clone()
        assert p.effective_value(3.7) == 4
        assert mppi.T == T0
        assert torch.equal(mppi.U, U0)

    def test_kmppi_horizon_groups_by_effective_value(self):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        mppi = P.KMPPI(env.dynamics, env.running_cost, 2,
                       noise_sigma=torch.diag(_t(5.0, 5.0)), num_samples=32, horizon=12,
                       num_support_pts=5, u_max=_t(2.0, 2.0), lambda_=1.0, seed=SEED,
                       device="cpu")
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=1,
                                          num_trajectories=1)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi),
             autotune_global.HorizonGlobalParameter(mppi)],
            evaluate_fn=lambda: None,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=2, seed=SEED),
            population_evaluate_fn=ev)
        calls = []

        def counting(dicts):
            calls.append(len(dicts))
            return ev(dicts)

        # horizons 2, 3, 4 all clamp to nsp = 5: one group of 3
        costs = autotune.evaluate_population(
            tuner, counting, [{"sigma": _t(5.0, 5.0), "horizon": h} for h in (2, 3, 4)])
        assert calls == [3]
        assert np.isfinite(costs).all()
        assert mppi.T == 12

    def test_step_dependent_default_cost(self):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        mppi = P.MPPI(lambda s, a, t: env.dynamics(s, a),
                      lambda s, a, t: env.running_cost(s, a) + 0.0 * t, 2,
                      noise_sigma=torch.diag(_t(5.0, 5.0)), num_samples=64, horizon=8,
                      u_max=_t(2.0, 2.0), lambda_=1.0, seed=SEED,
                      step_dependent_dynamics=True, device="cpu")
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=2,
                                          num_trajectories=1)
        assert torch.isfinite(ev([{"sigma": _t(5.0, 5.0)}]).costs).all()


class TestGradientOpt:
    """Gradient-based tuning through the solve."""

    def test_improves_bad_hyperparameters(self):
        """From sigma too small to explore and lambda too soft, Adam on the
        log-space params cuts the refinement cost by a large factor."""
        ctrl, ev = _linear(sigma0=0.05, lambda0=20.0)
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(ctrl), autotune.LambdaParameter(ctrl)],
            evaluate_fn=lambda: ev([{}]),
            optimizer=autotune.GradientOpt(lr=0.2, steps_per_iteration=10),
            population_evaluate_fn=ev)
        c0 = autotune.mean_cost(ev([{}]).costs)
        for _ in range(6):
            tuner.optimize_step()
        c1 = autotune.mean_cost(tuner.get_best_result().costs)
        assert c1 < 0.3 * c0, f"{c1} vs initial {c0}"
        assert float(torch.diagonal(ctrl.noise_sigma).min()) > 0.05

    def test_requires_population_evaluator(self):
        ctrl, ev = _linear(1.0, 1.0)
        with pytest.raises(ValueError, match="PopulationEvaluator"):
            autotune.Autotune([autotune.SigmaParameter(ctrl)], evaluate_fn=lambda: ev([{}]),
                              optimizer=autotune.GradientOpt())

    @pytest.mark.parametrize("param", ["HorizonParameter", "KernelSigmaParameter"])
    def test_rejects_shape_changing_params(self, param):
        ctrl, ev = _linear(1.0, 1.0)
        with pytest.raises(ValueError, match="horizon" if param[0] == "H" else "kernel_sigma"):
            autotune.Autotune([getattr(autotune, param)(ctrl)], evaluate_fn=lambda: ev([{}]),
                              optimizer=autotune.GradientOpt(), population_evaluate_fn=ev)

    def test_resample_noise_path(self):
        """Stochastic gradients (fresh draws each update) also descend."""
        ctrl, ev = _linear(sigma0=0.1, lambda0=10.0)
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(ctrl), autotune.LambdaParameter(ctrl)],
            evaluate_fn=lambda: ev([{}]),
            optimizer=autotune.GradientOpt(lr=0.15, steps_per_iteration=5,
                                           resample_noise=True),
            population_evaluate_fn=ev)
        c0 = autotune.mean_cost(ev([{}]).costs)
        for _ in range(4):
            tuner.optimize_step()
        assert autotune.mean_cost(tuner.get_best_result().costs) < c0

    def test_smppi_variant_scalars(self):
        """The gradient reaches SMPPI's w_action_seq_cost and delta_t."""
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        ctrl = P.SMPPI(env.dynamics, env.running_cost, 2,
                       noise_sigma=torch.diag(_t(2.0, 2.0)), num_samples=128, horizon=10,
                       lambda_=5.0, seed=SEED, w_action_seq_cost=5.0, delta_t=0.8,
                       action_max=_t(2.0, 2.0), device="cpu")
        ev = autotune.PopulationEvaluator(ctrl, env.start, num_refinement_steps=3,
                                          num_trajectories=1, seed=2)
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(ctrl), autotune.WActionSeqCostParameter(ctrl),
             autotune.DeltaTParameter(ctrl)],
            evaluate_fn=lambda: ev([{}]),
            optimizer=autotune.GradientOpt(lr=0.1, steps_per_iteration=5),
            population_evaluate_fn=ev)
        # the start's cost on as many fresh draws as there are results: one
        # draw of M = 1 spreads 386-621 on the port's streams at this seed
        c0 = float(np.mean([autotune.mean_cost(ev([{}]).costs) for _ in range(4)]))
        for _ in range(4):
            res = tuner.optimize_step()
        assert torch.isfinite(res.costs).all()
        # no blow-up, the objective being stochastic (JAX's threshold)
        assert autotune.mean_cost(tuner.get_best_result().costs) <= 1.15 * c0
        assert not (ctrl.w_action_seq_cost == pytest.approx(5.0)
                    and ctrl.delta_t == pytest.approx(0.8))

    def test_kmppi_gradient_tuning(self):
        """The gradient flows through KMPPI's support-point sampling and
        kernel interpolation too."""
        B = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
        goal = torch.tensor([2.0, 2.0])
        ctrl = P.KMPPI(lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(dim=-1),
                       nx=2, noise_sigma=torch.eye(2) * 0.05, num_samples=128, horizon=10,
                       lambda_=10.0, seed=0, kernel=P.RBFKernel(2.0), num_support_pts=5,
                       device="cpu")
        ev = autotune.PopulationEvaluator(ctrl, start_state=torch.tensor([-3.0, -2.0]),
                                          num_refinement_steps=4, num_trajectories=1, seed=1)
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(ctrl), autotune.LambdaParameter(ctrl)],
            evaluate_fn=lambda: ev([{}]),
            optimizer=autotune.GradientOpt(lr=0.2, steps_per_iteration=8),
            population_evaluate_fn=ev)
        c0 = autotune.mean_cost(ev([{}]).costs)
        for _ in range(6):
            tuner.optimize_step()
        assert autotune.mean_cost(tuner.get_best_result().costs) < 0.5 * c0
