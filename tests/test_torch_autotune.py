"""The port's tuners (``pytorch_mppi_tpu_torch/autotune.py``,
``autotune_global.py``, ``autotune_qd.py``): the optimisers and the
parameter logic, on the CPU.

* ``CMAES`` against JAX's over 30 ask/tell generations on one seed: the
  same asks and a mean within 1e-12;
* flatten, unflatten and apply on MPPI, SMPPI and KMPPI against JAX's;
* ``CMAESOpt``, ``GlobalSearchOpt`` and ``CMAMEOpt`` against JAX's with the
  same analytic evaluation on both sides, on the sequential and the
  population path: the same asked points, bests, archive and applied
  parameters;
* ``RayOptimizer`` through a copy of JAX's ``ray_stub`` fixture; importing
  the tuners needs neither ``ray`` nor JAX;
* JAX's ``TestCMAES``, ``TestParameters``, ``TestCMAESOpt``, ``TestGlobal``,
  ``TestVariantParams``, ``TestRayOptimizer`` and ``TestQD``
  (``tests/test_autotune.py:52-600``) on the port, with their thresholds.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.models import Toy2DEnvironment as JToy2D
from pytorch_mppi_tpu import autotune as JA
from pytorch_mppi_tpu import autotune_global as JAG
from pytorch_mppi_tpu import autotune_qd as JAQ

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch import autotune, autotune_global, autotune_qd
from pytorch_mppi_tpu_torch.autotune import CMAES
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
SEED = 1


def _t(*v):
    return torch.tensor(v, dtype=F64)


# ---------------------------------------------------------------------------
# Against JAX's tuners
# ---------------------------------------------------------------------------


def test_cmaes_asks_jax_points():
    """30 generations on a rotated ellipsoid: every ask identical to JAX's,
    the mean, step size and best within 1e-12."""
    target = np.array([1.5, -2.0, 0.5, 3.0])
    rot = np.linalg.qr(np.random.RandomState(3).randn(4, 4))[0]

    def f(x):
        y = rot @ (x - target)
        return float(y @ (np.array([1.0, 10.0, 100.0, 1000.0]) * y))

    mine, ref = CMAES(np.zeros(4), 0.7, popsize=9, seed=11), JA.CMAES(np.zeros(4), 0.7,
                                                                       popsize=9, seed=11)
    for _ in range(30):
        xs, jxs = mine.ask(), ref.ask()
        np.testing.assert_array_equal(np.array(xs), np.array(jxs))
        mine.tell(xs, [f(x) for x in xs])
        ref.tell(jxs, [f(x) for x in jxs])
        np.testing.assert_allclose(mine.mean, ref.mean, rtol=0, atol=1e-12)
        assert abs(mine.sigma - ref.sigma) <= 1e-12 * ref.sigma
    assert mine.best.f == ref.best.f
    np.testing.assert_array_equal(mine.best.x, ref.best.x)


def _controllers(variant, horizon=10):
    """A JAX controller and the port's twin on toy2d in float64, with the
    JAX controller's nominal sequences."""
    jenv = JToy2D(terminal_scale=10.0, dtype=jnp.float64)
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    kw = dict(num_samples=32, horizon=horizon, lambda_=1.5, seed=SEED)
    extra = {"mppi": {}, "smppi": dict(w_action_seq_cost=2.0, delta_t=0.5),
             "kmppi": dict(num_support_pts=4)}[variant]
    jcls, pcls = {"mppi": (J.MPPI, P.MPPI), "smppi": (J.SMPPI, P.SMPPI),
                  "kmppi": (J.KMPPI, P.KMPPI)}[variant]
    jc = jcls(jenv.dynamics, jenv.running_cost, 2, noise_sigma=jnp.diag(jnp.array([5.0, 3.0])),
              noise_mu=jnp.array([0.1, -0.2]), **kw, **extra)
    pc = pcls(env.dynamics, env.running_cost, 2, noise_sigma=torch.diag(_t(5.0, 3.0)),
              noise_mu=_t(0.1, -0.2), device="cpu", **kw, **extra)
    pc.U = torch.from_numpy(np.array(jc.U))
    if variant == "smppi":
        pc.action_sequence = torch.from_numpy(np.array(jc.action_sequence))
    return jc, pc


def _params(mod, ctrl, variant):
    ps = [mod.SigmaParameter(ctrl), mod.MuParameter(ctrl), mod.LambdaParameter(ctrl),
          mod.HorizonParameter(ctrl)]
    if variant == "smppi":
        ps += [mod.WActionSeqCostParameter(ctrl), mod.DeltaTParameter(ctrl)]
    if variant == "kmppi":
        ps += [mod.KernelSigmaParameter(ctrl)]
    return ps


def _held(ctrl):
    """What a controller holds of the tunables, as numpy."""
    out = dict(sigma=np.asarray(ctrl.noise_sigma), mu=np.asarray(ctrl.noise_mu),
               lam=float(ctrl.lambda_), T=ctrl.T, U=np.asarray(ctrl.U))
    for name in ("w_action_seq_cost", "delta_t", "kernel_sigma"):
        if hasattr(ctrl, name):
            out[name] = float(getattr(ctrl, name))
    if hasattr(ctrl, "_interp_full"):
        out["interp"] = np.asarray(ctrl._interp_full)
    return out


def _assert_held_equal(pc, jc):
    mine, ref = _held(pc), _held(jc)
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_flatten_unflatten_apply_against_jax(variant):
    jc, pc = _controllers(variant)
    jt = JA.Autotune(_params(JA, jc, variant), evaluate_fn=lambda: None,
                     optimizer=JA.CMAESOpt(seed=SEED))
    pt = autotune.Autotune(_params(autotune, pc, variant), evaluate_fn=lambda: None,
                           optimizer=autotune.CMAESOpt(seed=SEED))
    np.testing.assert_array_equal(pt.flatten_params(), jt.flatten_params())
    x = jt.flatten_params() * 0.7 - 0.3  # negative mu; clipped sigma stays positive
    x[5] = 13.6  # the horizon, rounded
    mine, ref = pt.unflatten_params(x, apply=False), jt.unflatten_params(x, apply=False)
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(autotune._numpy(mine[k]), np.asarray(ref[k]), rtol=1e-15)
    _assert_held_equal(pc, jc)  # apply=False left both as they were
    pt.unflatten_params(x)
    jt.unflatten_params(x)
    _assert_held_equal(pc, jc)
    assert pc.T == 14
    np.testing.assert_array_equal(pt.flatten_params(), jt.flatten_params())


def _analytic_cost(sigma, lam, T):
    """A smooth cost of the tunables, the same numpy arithmetic on both
    sides; its optimum is sigma (2, 0.5), lambda 3, horizon 7."""
    s = np.log(np.asarray(sigma, dtype=np.float64)) - np.log([2.0, 0.5])
    return float(s @ s + (np.log(float(lam)) - np.log(3.0)) ** 2 + 0.01 * (T - 7) ** 2)


def _sequential(ctrl, mod):
    """An evaluate_fn that reads the live controller."""
    tensor = (lambda v: torch.tensor(v, dtype=F64)) if mod is autotune else jnp.asarray

    def evaluate():
        c = _analytic_cost(np.diag(np.asarray(ctrl.noise_sigma)), ctrl.lambda_, ctrl.T)
        return mod.EvaluationResult(tensor([c, c + 0.25]), tensor(np.zeros((2, ctrl.T, 2))))

    return evaluate


def _population(ctrl, mod):
    """A population evaluate_fn: one cost per candidate dict, at the
    horizon its group applied to the controller."""
    tensor = (lambda v: torch.tensor(v, dtype=F64)) if mod is autotune else jnp.asarray
    sigma0 = lambda: np.diag(np.asarray(ctrl.noise_sigma))  # noqa: E731

    def pop(dicts):
        costs = [_analytic_cost(autotune._numpy(d["sigma"]) if "sigma" in d else sigma0(),
                                d.get("lambda", ctrl.lambda_), ctrl.T) for d in dicts]
        return mod.EvaluationResult(tensor(costs), tensor(np.zeros((len(dicts), ctrl.T, 2))))

    return pop


OPTIMIZERS = {  # (autotune, autotune_global, autotune_qd) -> optimizer
    "cmaes": lambda m, mg, mq: m.CMAESOpt(population=7, sigma=0.4, seed=SEED),
    "global": lambda m, mg, mq: mg.GlobalSearchOpt(batch_size=6, seed=SEED),
    "cmame": lambda m, mg, mq: mq.CMAMEOpt(population=6, sigma=0.5, bins=6, seed=SEED),
}


@pytest.mark.parametrize("path", ["sequential", "population"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_against_jax(name, path):
    """Five steps of each optimiser on both packages: the same asked
    points, results, bests, archive and applied parameters."""
    jc, pc = _controllers("mppi")
    sides = []
    for mod, glob, qd, ctrl in ((JA, JAG, JAQ, jc), (autotune, autotune_global, autotune_qd, pc)):
        params = [glob.SigmaGlobalParameter(ctrl), glob.LambdaGlobalParameter(ctrl),
                  glob.HorizonGlobalParameter(ctrl, search_space=glob.RandInt(4, 12))]
        opt = OPTIMIZERS[name](mod, glob, qd)
        tuner = glob.AutotuneGlobal(
            params, evaluate_fn=_sequential(ctrl, mod), optimizer=opt,
            population_evaluate_fn=_population(ctrl, mod) if path == "population" else None)
        sides.append((tuner, ctrl))
    (jt, jc), (pt, pc) = sides
    for _ in range(5):
        jres, pres = jt.optimize_step(), pt.optimize_step()
        np.testing.assert_array_equal(autotune._numpy(pres.costs), np.asarray(jres.costs))
        if name != "global":
            np.testing.assert_array_equal(pt.optim.optim._asked[0], jt.optim.optim._asked[0])
            np.testing.assert_array_equal(pt.optim.optim.mean, jt.optim.optim.mean)
            np.testing.assert_array_equal(pt.optim.optim.best.x, jt.optim.optim.best.x)
        else:
            assert pt.optim.best_cost == jt.optim.best_cost
            assert pt.optim.best_config == jt.optim.best_config
        _assert_held_equal(pc, jc)
    assert autotune.mean_cost(pt.get_best_result().costs) == float(
        jnp.mean(jt.get_best_result().costs))
    if name == "cmame":
        mine, ref = pt.optim.archive, jt.optim.archive
        assert mine._cells.keys() == ref._cells.keys()
        for k in ref._cells:
            assert mine._cells[k][0] == ref._cells[k][0]
            np.testing.assert_array_equal(mine._cells[k][1], ref._cells[k][1])
        for a, b in zip(pt.optim.get_diverse_top_parameters(3),
                        jt.optim.get_diverse_top_parameters(3)):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(autotune._numpy(a[k]), np.asarray(b[k]))


def test_importing_the_tuners_needs_neither_ray_nor_jax():
    code = ("import sys; import pytorch_mppi_tpu_torch.autotune, "
            "pytorch_mppi_tpu_torch.autotune_global, pytorch_mppi_tpu_torch.autotune_qd, "
            "pytorch_mppi_tpu_torch.examples.auto_tune_parameters; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ray', 'jax', 'optax', 'pytorch_mppi_tpu')]; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# JAX's tests/test_autotune.py:52-600 on the port
# ---------------------------------------------------------------------------


def _make_problem(sigma0=(5.0, 5.0), horizon=10, num_samples=128):
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    mppi = P.MPPI(env.dynamics, env.running_cost, 2, noise_sigma=torch.diag(_t(*sigma0)),
                  num_samples=num_samples, horizon=horizon,
                  terminal_state_cost=env.terminal_cost, u_max=_t(2.0, 2.0), lambda_=1.0,
                  seed=SEED, device="cpu")
    nominal = mppi.U
    num_refinement_steps = 5
    num_trajectories = 2

    def evaluate():
        costs, rollouts = [], []
        for _ in range(num_trajectories):
            mppi.U = nominal[: mppi.T] if nominal.shape[0] >= mppi.T else nominal
            mppi.change_horizon(mppi.T)
            for _ in range(num_refinement_steps):
                mppi.command(env.start, shift_nominal_trajectory=False)
            rollout = mppi.get_rollouts(env.start)[0]
            c = 0.0
            for t in range(len(rollout) - 1):
                c = c + env.running_cost(rollout[t][None], mppi.U[t][None])[0]
            c = c + env.terminal_cost(rollout, mppi.U)
            rollouts.append(rollout)
            costs.append(c)
        return autotune.EvaluationResult(torch.stack(costs), torch.stack(rollouts))

    return env, mppi, evaluate


class TestCMAES:
    def test_minimizes_sphere(self):
        """Native CMA-ES sanity: converge on a shifted sphere function."""
        target = np.array([1.5, -2.0, 0.5])
        es = CMAES(x0=np.zeros(3), sigma0=0.5, popsize=12, seed=0)
        for _ in range(60):
            xs = es.ask()
            es.tell(xs, [float(((x - target) ** 2).sum()) for x in xs])
        assert es.best.f < 1e-4
        np.testing.assert_allclose(es.best.x, target, atol=0.05)


class TestParameters:
    def test_sigma_apply_changes_solve(self):
        _, mppi, _ = _make_problem()
        p = autotune.SigmaParameter(mppi)
        state = _t(-3.0, -2.0)
        a1 = mppi.command(state, shift_nominal_trajectory=False)
        p.apply_parameter_value(_t(0.01, 0.01))
        np.testing.assert_allclose(torch.diagonal(mppi.noise_sigma).numpy(), [0.01, 0.01])
        a2 = mppi.command(state, shift_nominal_trajectory=False)
        assert not torch.allclose(a1, a2)

    def test_sigma_eps_clamp(self):
        _, mppi, _ = _make_problem()
        p = autotune.SigmaParameter(mppi)
        v = p.ensure_valid_value(_t(-1.0, 0.5))
        assert float(v[0]) == pytest.approx(p.eps)
        assert float(v[1]) == pytest.approx(0.5)

    def test_lambda_apply(self):
        _, mppi, _ = _make_problem()
        p = autotune.LambdaParameter(mppi)
        p.apply_parameter_value(np.array([3.0]))
        assert mppi.lambda_ == pytest.approx(3.0)
        assert p.ensure_valid_value(-5.0) == pytest.approx(p.eps)

    def test_horizon_apply_respecializes(self):
        _, mppi, _ = _make_problem(horizon=10)
        p = autotune.HorizonParameter(mppi)
        p.apply_parameter_value(np.array([7.3]))
        assert mppi.T == 7
        assert mppi.U.shape[0] == 7
        assert mppi.command(_t(-3.0, -2.0)).shape == (2,)

    def test_flatten_unflatten_roundtrip(self):
        _, mppi, evaluate = _make_problem()
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(mppi), autotune.LambdaParameter(mppi)],
            evaluate_fn=evaluate, optimizer=autotune.CMAESOpt(seed=SEED))
        x = tuner.flatten_params()
        assert x.shape == (3,)  # sigma(2) + lambda(1)
        np.testing.assert_allclose(x, [5.0, 5.0, 1.0])
        vals = tuner.unflatten_params(np.array([2.0, 3.0, 0.5]))
        np.testing.assert_allclose(vals["sigma"].numpy(), [2.0, 3.0])
        assert vals["lambda"] == pytest.approx(0.5)
        np.testing.assert_allclose(tuner.flatten_params(), [2.0, 3.0, 0.5])


class TestCMAESOpt:
    def test_tuning_improves_cost(self):
        """CMA-ES tuning from a deliberately bad sigma improves the cost
        (reference auto_tune_parameters.py main() flow)."""
        _, mppi, evaluate = _make_problem(sigma0=(10.0, 10.0))
        initial = autotune.mean_cost(evaluate().costs)
        tuner = autotune.Autotune(
            [autotune.SigmaParameter(mppi)], evaluate_fn=evaluate,
            optimizer=autotune.CMAESOpt(sigma=1.0, population=5, seed=SEED))
        for _ in range(4):
            tuner.optimize_step()
        best = tuner.get_best_result()
        assert autotune.mean_cost(best.costs) <= initial * 1.05
        assert best.params["sigma"].shape == (2,)
        assert len(tuner.results) == 4

    def test_get_best_result_is_min(self):
        _, mppi, evaluate = _make_problem()
        tuner = autotune.Autotune(
            [autotune.LambdaParameter(mppi)], evaluate_fn=evaluate,
            optimizer=autotune.CMAESOpt(sigma=0.5, population=4, seed=SEED))
        tuner.optimize_all(3)
        best = tuner.get_best_result()
        assert autotune.mean_cost(best.costs) == min(
            autotune.mean_cost(r.costs) for r in tuner.results)


def _toy_mppi(sigma, K=128, horizon=10):
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
    mppi = P.MPPI(env.dynamics, env.running_cost, 2, noise_sigma=torch.diag(_t(sigma, sigma)),
                  num_samples=K, horizon=horizon, u_max=_t(2.0, 2.0), lambda_=1.0, seed=SEED,
                  device="cpu")
    return env, mppi


class TestGlobal:
    def test_search_space_and_linearization(self):
        _, mppi, evaluate = _make_problem()
        params = [autotune_global.SigmaGlobalParameter(mppi),
                  autotune_global.LambdaGlobalParameter(mppi),
                  autotune_global.HorizonGlobalParameter(mppi)]
        tuner = autotune_global.AutotuneGlobal(
            params, evaluate_fn=evaluate,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=2, seed=SEED))
        assert set(tuner.search_space()) == {"sigma0", "sigma1", "lambda", "horizon"}
        lo, hi = tuner.linearized_search_space()["sigma0"]
        assert lo == pytest.approx(np.log10(1e-4))
        assert hi == pytest.approx(np.log10(1e2))
        assert tuner.initial_value()["sigma0"] == pytest.approx(5.0)
        v = tuner.linearize_params(tuner.get_parameter_values(params))
        assert v.shape == (4,)
        assert v[0] == pytest.approx(np.log10(5.0))

    def test_global_search_improves_or_matches(self):
        _, mppi, evaluate = _make_problem(sigma0=(20.0, 20.0))
        initial = autotune.mean_cost(evaluate().costs)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=evaluate,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=6, seed=SEED))
        tuner.optimize_all(2)
        assert autotune.mean_cost(tuner.get_best_result().costs) <= initial * 1.05

    def test_global_search_population_path(self):
        """GlobalSearchOpt evaluates each Sobol batch in one vmapped
        evaluation when a population evaluator is attached."""
        env, mppi = _toy_mppi(20.0)
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)
        calls = {"n": 0}

        def must_not_run():
            calls["n"] += 1
            raise AssertionError("sequential evaluate_fn must not be called")

        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi),
             autotune_global.LambdaGlobalParameter(mppi)],
            evaluate_fn=must_not_run,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=6, seed=SEED),
            population_evaluate_fn=ev)
        first = autotune.mean_cost(tuner.optimize_step().costs)
        tuner.optimize_step()
        assert calls["n"] == 0
        assert autotune.mean_cost(tuner.get_best_result().costs) <= first + 1e-6

    def test_global_search_population_with_horizon(self):
        """Horizon joins the population path by grouping per shape."""
        env, mppi = _toy_mppi(5.0, K=64)
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=2,
                                          num_trajectories=1)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi),
             autotune_global.HorizonGlobalParameter(
                 mppi, search_space=autotune_global.RandInt(3, 12))],
            evaluate_fn=lambda: None,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=4, seed=SEED),
            population_evaluate_fn=ev)
        res = tuner.optimize_step()
        assert torch.isfinite(res.costs).all()
        assert 3 <= mppi.T <= 12 or mppi.T == 10

    def test_global_search_all_nonfinite_raises_clearly(self):
        _, mppi, _ = _make_problem()

        def diverging():
            return autotune.EvaluationResult(torch.full((2,), torch.nan),
                                             torch.zeros((2, 10, 2)))

        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=diverging,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=3, seed=SEED))
        with pytest.raises(RuntimeError, match="non-finite"):
            tuner.optimize_step()

    def test_global_search_skips_nan_candidates(self):
        """A NaN candidate in an otherwise finite batch is never the best."""
        _, mppi, evaluate = _make_problem()
        calls = {"n": 0}

        def sometimes_nan():
            calls["n"] += 1
            res = evaluate()
            if calls["n"] % 2 == 0:  # poison every other candidate
                return autotune.EvaluationResult(torch.full_like(res.costs, torch.nan),
                                                 res.rollouts)
            return res

        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=sometimes_nan,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=4, seed=SEED))
        tuner.optimize_step()
        assert np.isfinite(tuner.optim.best_cost)
        assert tuner.optim.best_config is not None

    def test_ray_optimizer_raises_without_ray(self):
        _, mppi, evaluate = _make_problem()
        with pytest.raises((ImportError, RuntimeError)):
            autotune_global.AutotuneGlobal(
                [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=evaluate,
                optimizer=autotune_global.RayOptimizer())


class TestVariantParams:
    """SMPPI's w_action_seq_cost and delta_t and KMPPI's kernel_sigma."""

    def _smppi(self, w=0.0, horizon=10):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        ctrl = P.SMPPI(env.dynamics, env.running_cost, 2, noise_sigma=torch.diag(_t(5.0, 5.0)),
                       num_samples=128, horizon=horizon, lambda_=1.0, seed=SEED,
                       w_action_seq_cost=w, delta_t=0.5, action_max=_t(2.0, 2.0),
                       device="cpu")
        return env, ctrl

    def test_scalar_setters_apply(self):
        env, ctrl = self._smppi(w=1.0)
        p_w = autotune.WActionSeqCostParameter(ctrl)
        p_dt = autotune.DeltaTParameter(ctrl)
        assert p_w.get_current_parameter_value() == pytest.approx(1.0)
        p_w.apply_parameter_value(3.5)
        p_dt.apply_parameter_value(0.25)
        assert ctrl.w_action_seq_cost == pytest.approx(3.5)
        assert ctrl.delta_t == pytest.approx(0.25)
        assert ctrl.command(env.start).shape == (2,)
        p_dt.apply_parameter_value(-1.0)  # clamps to the eps floor
        assert ctrl.delta_t == pytest.approx(1e-4)

    def test_smppi_w_population_tuning_improves_smoothness(self):
        """CMA-ES over w_action_seq_cost through the population path reduces
        a smoothness-weighted objective against the untuned w = 0."""
        env, ctrl = self._smppi(w=0.0)

        def smooth_cost(states, U):
            run = env.running_cost(states, U).sum()
            jerk = ((U[1:] - U[:-1]) ** 2).sum()
            return run + 200.0 * jerk

        ev = autotune.PopulationEvaluator(ctrl, env.start, num_refinement_steps=4,
                                          num_trajectories=2, rollout_cost_fn=smooth_cost)
        initial = autotune.mean_cost(ev([{}]).costs)
        tuner = autotune.Autotune(
            [autotune.WActionSeqCostParameter(ctrl)], evaluate_fn=lambda: ev([{}]),
            optimizer=autotune.CMAESOpt(sigma=2.0, population=6, seed=SEED),
            population_evaluate_fn=ev)
        for _ in range(4):
            tuner.optimize_step()
        best = tuner.get_best_result()
        assert autotune.mean_cost(best.costs) <= initial * 1.01
        assert "w_action_seq_cost" in best.params

    def test_smppi_population_batches_w_and_delta_t(self):
        env, ctrl = self._smppi(w=1.0)
        ev = autotune.PopulationEvaluator(ctrl, env.start, num_refinement_steps=3,
                                          num_trajectories=1)
        costs = ev([{"w_action_seq_cost": torch.tensor(0.0)},
                    {"w_action_seq_cost": torch.tensor(50.0)},
                    {"delta_t": torch.tensor(0.1)}]).costs
        assert torch.isfinite(costs).all()
        assert len({round(float(c), 6) for c in costs}) == 3

    def test_kmppi_kernel_sigma_population(self):
        env = Toy2DEnvironment(terminal_scale=10.0, dtype=F64, device="cpu")
        ctrl = P.KMPPI(env.dynamics, env.running_cost, 2, noise_sigma=torch.diag(_t(5.0, 5.0)),
                       num_samples=128, horizon=10, lambda_=1.0, seed=SEED, num_support_pts=5,
                       device="cpu")
        ev = autotune.PopulationEvaluator(ctrl, env.start, num_refinement_steps=3,
                                          num_trajectories=1)
        costs = ev([{"kernel_sigma": 0.5}, {"kernel_sigma": 2.0}, {"kernel_sigma": 8.0}]).costs
        assert torch.isfinite(costs).all()
        assert len({round(float(c), 6) for c in costs}) == 3
        # the sequential apply path: the setter rebuilds the operators
        p = autotune.KernelSigmaParameter(ctrl)
        before = ctrl._interp_full.clone()
        p.apply_parameter_value(4.0)
        assert ctrl.kernel_sigma == pytest.approx(4.0)
        assert not torch.allclose(before, ctrl._interp_full)
        assert ctrl.command(env.start).shape == (2,)

    def test_global_spaces_for_variant_params(self):
        env, ctrl = self._smppi(w=1.0)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.WActionSeqCostGlobalParameter(ctrl),
             autotune_global.DeltaTGlobalParameter(ctrl)],
            evaluate_fn=lambda: None,
            optimizer=autotune_global.GlobalSearchOpt(batch_size=2, seed=SEED))
        assert set(tuner.search_space()) == {"w_action_seq_cost", "delta_t"}
        assert tuner.initial_value()["w_action_seq_cost"] == pytest.approx(1.0)

    def test_unsupported_variant_param_on_plain_mppi(self):
        _, mppi, _ = _make_problem()
        ev = autotune.PopulationEvaluator(mppi, torch.zeros(2, dtype=F64),
                                          num_refinement_steps=1)
        with pytest.raises(ValueError, match="supports"):
            ev([{"w_action_seq_cost": 1.0}])


@pytest.fixture
def ray_stub(monkeypatch):
    """A minimal in-process stand-in for the ray[tune] API surface
    RayOptimizer.optimize_all uses (a copy of JAX's fixture,
    tests/test_autotune.py:420-508): tune.{loguniform,uniform,randint,
    TuneConfig,Tuner}, train.report, HyperOptSearch.  Trials run in turn
    in-process; points_to_evaluate seed the first trials, the rest sample
    the space."""
    import types

    rng = np.random.RandomState(0)
    reported = {}

    class _Space:
        def __init__(self, kind, lo, hi):
            self.kind, self.lo, self.hi = kind, lo, hi

        def sample(self):
            if self.kind == "log":
                return float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
            if self.kind == "int":
                return int(rng.randint(self.lo, self.hi))
            return float(rng.uniform(self.lo, self.hi))

    class HyperOptSearch:
        def __init__(self, points_to_evaluate=None, metric=None, mode=None):
            self.points = list(points_to_evaluate or [])
            assert metric == "cost" and mode == "min"

    class TuneConfig:
        def __init__(self, num_samples, search_alg, metric, mode):
            self.num_samples = num_samples
            self.search_alg = search_alg
            assert metric == "cost" and mode == "min"

    class _Result:
        def __init__(self, config):
            self.config = config

    class _Results:
        def __init__(self, best):
            self._best = best

        def get_best_result(self):
            return _Result(self._best)

    class Tuner:
        def __init__(self, trainable, tune_config=None, param_space=None):
            self.trainable = trainable
            self.cfg = tune_config
            self.space = param_space

        def fit(self):
            best_cost, best_config = np.inf, None
            pending = list(self.cfg.search_alg.points)
            for _ in range(self.cfg.num_samples):
                config = (pending.pop(0) if pending else
                          {k: v.sample() for k, v in self.space.items()})
                reported.clear()
                self.trainable(dict(config))
                c = reported["cost"]
                if c < best_cost:
                    best_cost, best_config = c, config
            assert best_config is not None
            return _Results(best_config)

    ray = types.ModuleType("ray")
    tune = types.ModuleType("ray.tune")
    train = types.ModuleType("ray.train")
    search = types.ModuleType("ray.tune.search")
    hyperopt = types.ModuleType("ray.tune.search.hyperopt")
    tune.loguniform = lambda lo, hi: _Space("log", lo, hi)
    tune.uniform = lambda lo, hi: _Space("lin", lo, hi)
    tune.randint = lambda lo, hi: _Space("int", lo, hi)
    tune.TuneConfig = TuneConfig
    tune.Tuner = Tuner
    train.report = lambda d: reported.update(d)
    hyperopt.HyperOptSearch = HyperOptSearch
    ray.tune = tune
    ray.train = train
    tune.search = search
    search.hyperopt = hyperopt
    for name, mod in [("ray", ray), ("ray.tune", tune), ("ray.train", train),
                      ("ray.tune.search", search), ("ray.tune.search.hyperopt", hyperopt)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return reported


class TestRayOptimizer:
    def test_optimize_all_end_to_end(self, ray_stub):
        """RayOptimizer.optimize_all through the stub: space translation, the
        seeded first trial, per-trial attach/apply, cost reporting, and the
        best config applied."""
        _, mppi, evaluate = _make_problem(sigma0=(20.0, 20.0))
        initial_sigma = torch.diagonal(mppi.noise_sigma).clone()
        opt = autotune_global.RayOptimizer(default_iterations=6)
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi),
             autotune_global.LambdaGlobalParameter(mppi)],
            evaluate_fn=evaluate, optimizer=opt)
        res = tuner.optimize_all(6)
        assert res.costs is not None and torch.isfinite(res.costs).all()
        assert opt.all_res is not None
        best = opt.all_res.get_best_result().config
        np.testing.assert_allclose(torch.diagonal(mppi.noise_sigma).numpy(),
                                   [best["sigma0"], best["sigma1"]], rtol=1e-6)
        assert float(mppi.lambda_) == pytest.approx(best["lambda"], rel=1e-6)
        assert float(initial_sigma[0]) == pytest.approx(20.0)

    def test_optimize_step_disallowed(self, ray_stub):
        _, mppi, evaluate = _make_problem()
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=evaluate,
            optimizer=autotune_global.RayOptimizer())
        with pytest.raises(RuntimeError, match="all iterations"):
            tuner.optimize_step()


class TestQD:
    def test_archive_basics(self):
        arch = autotune_qd.GridArchive(dims=[4, 4], ranges=[(0, 1), (0, 1)])
        assert np.isfinite(arch.add(np.array([1.0]), objective=-5.0, measures=[0.1, 0.1]))
        assert len(arch) == 1
        assert arch.add(np.array([2.0]), -9.0, [0.1, 0.1]) == -np.inf  # worse: rejected
        assert arch.add(np.array([3.0]), -1.0, [0.1, 0.1]) == pytest.approx(4.0)
        assert arch.best_elite.objective == pytest.approx(-1.0)

    def test_cmame_population_path(self):
        """CMAMEOpt evaluates each emitter population in one vmapped
        evaluation when a population evaluator is attached."""
        env, mppi = _toy_mppi(5.0)
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=3,
                                          num_trajectories=2)

        def must_not_run():
            raise AssertionError("sequential evaluate_fn must not be called")

        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=must_not_run,
            optimizer=autotune_qd.CMAMEOpt(population=4, sigma=1.0, bins=8, seed=SEED),
            population_evaluate_fn=ev)
        tuner.optimize_all(3)
        assert len(tuner.optim.archive) >= 2
        assert 1 <= len(tuner.optim.get_diverse_top_parameters(3)) <= 3

    def test_cmame_finds_diverse_params(self):
        _, mppi, evaluate = _make_problem()
        tuner = autotune_global.AutotuneGlobal(
            [autotune_global.SigmaGlobalParameter(mppi)], evaluate_fn=evaluate,
            optimizer=autotune_qd.CMAMEOpt(population=4, sigma=1.0, bins=8, seed=SEED))
        tuner.optimize_all(3)
        assert len(tuner.optim.archive) >= 2
        diverse = tuner.optim.get_diverse_top_parameters(3)
        assert 1 <= len(diverse) <= 3
        for p in diverse:
            assert "sigma" in p


class TestAutoTuneExample:
    def test_fast_run_all_five_sections(self, capsys):
        """The example's five tuning sections (CMA-ES, Sobol, QD, the
        population path, the gradient) run end to end at reduced shapes, as
        JAX's tests/test_examples.py:66-79."""
        from pytorch_mppi_tpu_torch.examples import auto_tune_parameters

        results = auto_tune_parameters.main(fast=True, device="cpu")
        out = capsys.readouterr().out
        assert "CMA-ES best cost" in out
        assert "Global search best cost" in out
        assert "QD archive size" in out
        assert "Population-parallel global search best cost" in out
        assert "Gradient (through-the-solve) best cost" in out
        assert all(np.isfinite(v) for v in results.values())
