"""Hyperparameter autotuning for MPPI controllers.

The counterpart of ``pytorch_mppi_tpu/autotune.py``: an :class:`Autotune`
core that flattens and unflattens :class:`TunableParameter` vectors, applies
them to a live controller and drives a pluggable :class:`Optimizer`
(:class:`CMAESOpt`, a native CMA-ES; :class:`GradientOpt`, Adam on gradients
taken through the solve).

Values follow the controller's device, ``mppi.d``: a parameter's value is a
tensor there (a Python number for the scalars), and numpy only at the CMA-ES
boundary, as JAX's are ``jnp`` arrays and numpy there.  The tuners take no
device of their own, so a tuner of a default controller runs on the card.

:class:`PopulationEvaluator` evaluates a whole population of candidates in
one ``torch.func.vmap`` of the controller's plain command body
(``ops/solve.StepFns.body``) over the candidates and then the trajectories,
with each trajectory's draws fed to the body (``CommandStreams.fed``) in
place of its generators: the noise's and, with stochastic dynamics, the
draws the dynamics make; gradient refinement takes ``torch.func.grad``
there (inside a ``torch.func`` transform).  It launches no kernel: a
``use_pallas`` controller's command keeps its kernel, and the evaluator
takes the plain bundle of the same configuration.
"""
from __future__ import annotations

import abc
import contextlib
import logging
import typing

import numpy as np
import torch

from .ops import solve as _solve
from .ops.kernels import interpolation_operators
from .utils import checkpoint as _ckpt
from .utils.batch import ensure_tensor

logger = logging.getLogger(__name__)

# what the population evaluator cannot run yet (a mesh); its refusal names
# this item
_NOT_YET = "ROADMAP.md Queue 1 item 11b"


def _numpy(value) -> np.ndarray:
    """A tensor (on any device), array or number as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _first(value):
    """The first element of an array-valued scalar parameter value."""
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return np.ravel(_numpy(value))[0]
    return value


def _draw_seeds(generator: torch.Generator, n: int) -> list:
    """``n`` 63-bit stream seeds from a generator on the controller's device."""
    return torch.randint(0, 2**63 - 1, (n,), generator=generator,
                         device=generator.device).tolist()


def mean_cost(costs) -> float:
    """The mean of an evaluation's costs, as the tuners rank it."""
    return float(torch.as_tensor(_numpy(costs)).mean())


class EvaluationResult(typing.NamedTuple):
    """Result of one evaluation of the controller (reference autotune.py:18-26)."""

    # (N) cost for each trajectory evaluated
    costs: torch.Tensor
    # (N x H x nx) rollouts, H horizon, nx state dimension
    rollouts: torch.Tensor
    # parameter values populated by the tuner after evaluation returns
    params: dict = None
    # iteration number populated by the tuner after evaluation returns
    iteration: int = None


_VMAPPABLE_PARAMS = frozenset({
    "sigma", "mu", "lambda",
    # the variants' device scalars: SMPPI's smoothness weight and
    # integration step, KMPPI's kernel bandwidth
    "w_action_seq_cost", "delta_t", "kernel_sigma",
})


def vmappable_subset(param_values: dict) -> dict:
    """The part of a param-value dict that :class:`PopulationEvaluator`
    batches on its candidate axis."""
    return {k: v for k, v in param_values.items() if k in _VMAPPABLE_PARAMS}


# ---------------------------------------------------------------------------
# Native CMA-ES (JAX autotune.py:68-168, numpy only)
# ---------------------------------------------------------------------------


class CMAES:
    """(mu/mu_w, lambda)-CMA-ES with rank-1 + rank-mu covariance adaptation and
    CSA step-size control (Hansen, "The CMA Evolution Strategy: A Tutorial").

    The JAX package's arithmetic on the same ``np.random.RandomState``, so
    the same seed asks the same points.
    """

    def __init__(self, x0, sigma0: float, popsize: int = 10, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.mean = np.asarray(x0, dtype=np.float64).copy()
        self.sigma = float(sigma0)
        self.n = len(self.mean)
        n = self.n
        self.lam = max(int(popsize), 4 + int(3 * np.log(n)))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights**2)

        # strategy parameters (standard defaults)
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff) / ((n + 2) ** 2 + self.mueff),
        )
        self.damps = 1 + 2 * max(0, np.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs
        self.chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.B = np.eye(n)
        self.D = np.ones(n)
        self.invsqrtC = np.eye(n)
        self.generation = 0
        self._asked = None
        self.best_x = self.mean.copy()
        self.best_f = np.inf

    class _Best(typing.NamedTuple):
        x: np.ndarray
        f: float

    @property
    def best(self):
        return self._Best(self.best_x, self.best_f)

    def ask(self):
        z = self.rng.randn(self.lam, self.n)
        y = z @ (self.B * self.D).T
        xs = self.mean + self.sigma * y
        self._asked = (xs, y)
        return [x.copy() for x in xs]

    def tell(self, solutions, fitnesses):
        xs = np.asarray(solutions, dtype=np.float64)
        fs = np.asarray(fitnesses, dtype=np.float64)
        order = np.argsort(fs)
        if fs[order[0]] < self.best_f:
            self.best_f = float(fs[order[0]])
            self.best_x = xs[order[0]].copy()

        old_mean = self.mean.copy()
        sel = xs[order[: self.mu]]
        self.mean = self.weights @ sel

        y_mean = (self.mean - old_mean) / self.sigma
        self.ps = (1 - self.cs) * self.ps + np.sqrt(
            self.cs * (2 - self.cs) * self.mueff
        ) * (self.invsqrtC @ y_mean)
        hsig = float(
            np.linalg.norm(self.ps)
            / np.sqrt(1 - (1 - self.cs) ** (2 * (self.generation + 1)))
            / self.chiN
            < 1.4 + 2 / (self.n + 1)
        )
        self.pc = (1 - self.cc) * self.pc + hsig * np.sqrt(
            self.cc * (2 - self.cc) * self.mueff
        ) * y_mean

        ys = (sel - old_mean) / self.sigma
        rank_mu = sum(w * np.outer(y, y) for w, y in zip(self.weights, ys))
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (np.outer(self.pc, self.pc) + (1 - hsig) * self.cc * (2 - self.cc) * self.C)
            + self.cmu * rank_mu
        )
        self.sigma *= np.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chiN - 1)
        )
        self.generation += 1

        # eigendecomposition for sampling (n is tiny for hyperparameters)
        self.C = (self.C + self.C.T) / 2
        d2, self.B = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(d2, 1e-20))
        self.invsqrtC = self.B @ np.diag(1.0 / self.D) @ self.B.T


# ---------------------------------------------------------------------------
# Optimizer protocol (reference autotune.py:29-48)
# ---------------------------------------------------------------------------


class Optimizer:
    def __init__(self):
        self.tuner: typing.Optional[Autotune] = None
        self.optim = None

    @abc.abstractmethod
    def setup_optimization(self) -> None:
        """Create backend optim object from the tuner's parameters."""

    @abc.abstractmethod
    def optimize_step(self) -> EvaluationResult:
        """Optimize a single step, returning the latest evaluation result."""

    def optimize_all(self, iterations) -> EvaluationResult:
        res = None
        for _ in range(iterations):
            res = self.optimize_step()
        return res


def _evaluate_best(tuner, pop_fn, best_values) -> EvaluationResult:
    """The optimizers' re-evaluation of the best values, already applied to
    the controller: through the population evaluator where there is one."""
    if pop_fn is not None:
        res = pop_fn([vmappable_subset(best_values)])
        return res._replace(costs=res.costs.reshape(-1))
    return tuner.evaluate_fn()


class CMAESOpt(Optimizer):
    """Local search via CMA-ES around the current parameter values
    (reference autotune.py:51-84, backed by the native :class:`CMAES`)."""

    def __init__(self, population=10, sigma=0.1, seed=None):
        self.population = population
        self.sigma = sigma
        self.seed = seed
        super().__init__()

    def setup_optimization(self):
        x0 = self.tuner.flatten_params()
        seed = self.seed if self.seed is not None else np.random.randint(0, 10000)
        self.optim = CMAES(x0=x0, sigma0=self.sigma, popsize=self.population, seed=seed)

    def optimize_step(self):
        params = self.optim.ask()
        pop_fn = getattr(self.tuner, "population_evaluate_fn", None)
        if pop_fn is not None:
            # the whole population in one vmapped evaluation (horizon
            # candidates group into an outer loop, evaluate_population)
            dicts = [self.tuner.unflatten_params(p, apply=False) for p in params]
            cost_per_param = evaluate_population(self.tuner, pop_fn, dicts)
        else:
            cost_per_param = []
            for param in params:
                self.tuner.unflatten_params(param)
                cost_per_param.append(mean_cost(self.tuner.evaluate_fn().costs))
            cost_per_param = np.array(cost_per_param)
        self.optim.tell(params, cost_per_param)

        # re-evaluate the best (reference autotune.py:81-84)
        best_values = self.tuner.unflatten_params(self.optim.best.x)
        return _evaluate_best(self.tuner, pop_fn, best_values)


# ---------------------------------------------------------------------------
# Tunable parameters (reference autotune.py:87-241)
# ---------------------------------------------------------------------------


class TunableParameter(abc.ABC):
    """A parameter the autotuner can adjust; holds a reference to the object that
    owns the actual value (reference autotune.py:87-121)."""

    @staticmethod
    @abc.abstractmethod
    def name():
        """Name of the parameter."""

    @abc.abstractmethod
    def dim(self):
        """Dimension of the parameter."""

    @abc.abstractmethod
    def get_current_parameter_value(self):
        """Current underlying value."""

    @abc.abstractmethod
    def ensure_valid_value(self, value):
        """Return a validated value as close in intent to the input as possible."""

    @abc.abstractmethod
    def apply_parameter_value(self, value):
        """Apply the value to the underlying object."""

    @abc.abstractmethod
    def attach_to_state(self, state: dict):
        """Reattach the parameter to new internal state (multiprocessing reload)."""

    def effective_value(self, value):
        """The value the controller would actually end up with if this value
        were applied, without applying it.  Defaults to
        ``ensure_valid_value``; parameters whose controllers clamp further
        (KMPPI's horizons) override it, so that :func:`evaluate_population`
        groups candidates by the shape that runs."""
        return self.ensure_valid_value(value)

    def get_parameter_value_from_config(self, config):
        return config[self.name()]

    def get_config_from_parameter_value(self, value):
        return {self.name(): value}


class MPPIParameter(TunableParameter, abc.ABC):
    def __init__(self, mppi, dim=None):
        self.mppi = mppi
        self._dim = dim
        if self.mppi is not None:
            self.d = self.mppi.d
            self.dtype = self.mppi.dtype
            if dim is None:
                self._dim = self.mppi.nu

    def attach_to_state(self, state: dict):
        self.mppi = state["mppi"]
        self.d = self.mppi.d
        self.dtype = self.mppi.dtype


class _VectorParameter(MPPIParameter):
    """A (nu,) tunable whose config names are ``name0``, ``name1``, ..."""

    def dim(self):
        return self._dim

    def get_parameter_value_from_config(self, config):
        return torch.tensor([config[f"{self.name()}{i}"] for i in range(self.dim())],
                            dtype=self.dtype, device=self.d)

    def get_config_from_parameter_value(self, value):
        v = np.ravel(_numpy(value))
        return {f"{self.name()}{i}": float(v[i]) for i in range(self.dim())}


class SigmaParameter(_VectorParameter):
    """Diagonal of the noise covariance (reference autotune.py:140-168).  The
    solve derives its sampling factors from the params at every command, so
    applying rebuilds nothing."""

    eps = 0.0001

    @staticmethod
    def name():
        return "sigma"

    def get_current_parameter_value(self):
        return torch.diagonal(self.mppi.noise_sigma).clone()

    def ensure_valid_value(self, value):
        return torch.clamp(ensure_tensor(self.d, self.dtype, value), min=self.eps)

    def apply_parameter_value(self, value):
        self.mppi.noise_sigma = torch.diag(self.ensure_valid_value(value))


class MuParameter(_VectorParameter):
    """Noise mean (reference autotune.py:171-195)."""

    @staticmethod
    def name():
        return "mu"

    def get_current_parameter_value(self):
        return self.mppi.noise_mu.clone()

    def ensure_valid_value(self, value):
        return ensure_tensor(self.d, self.dtype, value)

    def apply_parameter_value(self, value):
        self.mppi.noise_mu = self.ensure_valid_value(value)


class _ScalarParameter(MPPIParameter):
    """Base for scalar tunables exposed as controller attributes."""

    attr: str = None
    eps = 0.0

    def dim(self):
        return 1

    def get_current_parameter_value(self):
        return getattr(self.mppi, self.attr)

    def ensure_valid_value(self, value):
        return max(float(_first(value)), self.eps)

    def apply_parameter_value(self, value):
        setattr(self.mppi, self.attr, self.ensure_valid_value(value))


class LambdaParameter(_ScalarParameter):
    """Temperature (reference autotune.py:198-219)."""

    attr = "lambda_"
    eps = 0.0001

    @staticmethod
    def name():
        return "lambda"


class HorizonParameter(MPPIParameter):
    """Planning horizon; changes shapes and rebuilds the solve
    (reference autotune.py:222-241)."""

    @staticmethod
    def name():
        return "horizon"

    def dim(self):
        return 1

    def get_current_parameter_value(self):
        return self.mppi.T

    def ensure_valid_value(self, value):
        return max(round(float(_first(value))), 1)

    def effective_value(self, value):
        # KMPPI clamps horizons below num_support_pts (controller.py), so
        # shape grouping matches what apply would do
        v = self.ensure_valid_value(value)
        floor = getattr(self.mppi, "num_support_pts", None)
        return max(v, int(floor)) if floor else v

    def apply_parameter_value(self, value):
        self.mppi.change_horizon(self.ensure_valid_value(value))


class WActionSeqCostParameter(_ScalarParameter):
    """SMPPI's smoothness weight ``w_action_seq_cost``: a device scalar of
    ``SMPPIParams``, so the population evaluator batches its candidates (the
    reference tuner cannot reach it, autotune.py:140-241)."""

    attr = "w_action_seq_cost"

    @staticmethod
    def name():
        return "w_action_seq_cost"


class DeltaTParameter(_ScalarParameter):
    """SMPPI's integration step ``delta_t``, a device scalar of
    ``SMPPIParams``."""

    attr = "delta_t"
    eps = 1e-4

    @staticmethod
    def name():
        return "delta_t"


class KernelSigmaParameter(_ScalarParameter):
    """KMPPI's interpolation-kernel bandwidth (RBF sigma, B-spline scale).
    Applying rebuilds the two small interpolation operators (their shapes
    stay)."""

    attr = "kernel_sigma"
    eps = 1e-3

    @staticmethod
    def name():
        return "kernel_sigma"


# ---------------------------------------------------------------------------
# Population evaluation: one vmapped evaluation a generation
# ---------------------------------------------------------------------------


class PopulationEvaluator:
    """Evaluate a population of candidates in one ``torch.func.vmap`` of the
    controller's plain command body (JAX ``autotune.py:480-738``).

    The candidates are the leading axis of the batched parameters: the
    ``MPPIParams`` leaves (sigma diagonal, mu, lambda), SMPPI's
    ``w_action_seq_cost`` and ``delta_t``, and KMPPI's interpolation
    operators for a ``kernel_sigma``.  Horizons change shapes and cannot be
    batched: :func:`evaluate_population` groups them into an outer loop.

    Protocol (``examples/auto_tune_parameters.py``, reference
    auto_tune_parameters.py:256-276): every candidate starts from the
    controller's current ``U`` (and its other state: SMPPI's commanded
    sequence, KMPPI's theta), re-read at every call, runs
    ``num_refinement_steps`` (R) no-shift commands from ``start_state`` in
    each of ``num_trajectories`` (M) streams, rolls the refined plan out
    (SMPPI's commanded ``action_sequence``, not its rates) and scores it
    with ``rollout_cost_fn(states (T, nx), U (T, nu)) -> scalar``; a
    candidate's cost is the mean over its M streams.  The default scorer is
    the controller's running cost summed over the rollout, with the step
    indices ``arange(T)`` for step-dependent costs.

    Streams: candidate p, trajectory m draws a state seed ``seed_pm`` from
    the evaluator's own ``torch.Generator`` on the controller's device
    (seeded with ``seed``), and its refinement step r is fed the draws that
    ``CommandStreams.feeds(seed_pm, counter + r·num_iterations)`` makes:
    the noise and, with stochastic dynamics, the draws the dynamics make at
    each rollout and descent step, whose plan (``CommandStreams.record``)
    a live command of the controller gives once per bundle.  The scoring
    rollout's dynamics draw what ``get_rollouts`` draws on the stream of 0,
    the same for every candidate, as JAX's take one key.  So it computes
    what R ``step_no_shift`` calls of a controller with p's parameters
    compute from a state seeded ``seed_pm``, gradient refinement with
    ``torch.func.grad`` in place of ``torch.autograd.grad``.

    The solver bundle (the plain one of the controller's configuration:
    ``use_pallas`` controllers keep their kernel in ``command()``), the
    nominal trajectory and ``dynamics_params`` are read at every call, so a
    ``change_horizon`` or ``mppi.U = ...`` between generations is honoured.
    A mesh has no vmapped body yet and raises ``NotImplementedError``.

    Pass it as ``Autotune(..., population_evaluate_fn=evaluator)``.
    """

    def __init__(self, mppi, start_state, num_refinement_steps: int = 10,
                 num_trajectories: int = 1, rollout_cost_fn=None, seed: int = 0):
        self.mppi = mppi
        self.dtype = mppi.dtype
        self.start = torch.as_tensor(start_state, dtype=mppi.dtype, device=mppi.d)
        self.R = int(num_refinement_steps)
        self.M = int(num_trajectories)
        self._gen = torch.Generator(device=mppi.d)
        self._gen.manual_seed(int(seed))
        self._rollout_cost_fn = rollout_cost_fn
        # one population evaluation per solver bundle: a horizon sweep
        # toggles between the controller's cached bundles
        self._eval_cache: dict = {}
        # the draw plans of stochastic dynamics per bundle (_plans)
        self._plan_cache: dict = {}

    def _default_cost_fn(self):
        rc = _solve.wrap_cost(self.mppi.config, self.mppi.running_cost)

        def rollout_cost_fn(states, U):
            t = torch.arange(states.shape[0], device=states.device)
            return rc(states, U, t).sum()

        return rollout_cost_fn

    def _planning_fns(self):
        """The plain solver bundle of the controller's configuration, from
        its cache; the controller's own ``_fns`` and ``use_pallas`` are left
        as they were, so its ``command()`` keeps its kernel.  Raises for a
        mesh, whose body calls collectives."""
        mppi = self.mppi
        if mppi.use_pallas is False:
            fns = mppi._fns
        else:
            saved, saved_fns = mppi.use_pallas, mppi._fns
            mppi.use_pallas = False
            try:
                mppi._build_step_fns()
                fns = mppi._fns
            finally:
                mppi.use_pallas, mppi._fns = saved, saved_fns
        if getattr(mppi, "mesh", None) is not None:
            raise NotImplementedError(
                f"PopulationEvaluator cannot vmap the command body of a controller with a "
                f"mesh yet ({_NOT_YET}); tune it through Autotune's sequential evaluate_fn")
        return fns

    def _stream_seeds(self, n: int) -> list:
        """``n`` state seeds, one per stream, from the evaluator's generator."""
        return _draw_seeds(self._gen, n)

    def _plans(self, fns):
        """With stochastic dynamics, the plan of one command's draws
        (``CommandStreams.record``, on a live no-shift command of the
        controller's parameters and state from ``start``), and the scoring
        rollout's plan and draws on ``get_rollouts``' stream of 0; else
        Nones.  Once per bundle."""
        if fns in self._plan_cache:
            return self._plan_cache[fns]
        mppi, d = self.mppi, self.mppi.d
        out = (None, None, None)
        if mppi.config.stochastic_dynamics:
            state, dyn_params = mppi._state, mppi.dynamics_params
            params = mppi._full_params()
            plan = fns.streams.record(
                lambda: fns.body(params, state, self.start, None, dyn_params, False),
                state.seed, state.counter, d)
            base = params.base if hasattr(params, "base") else params

            def gens():
                return [_solve.step_generator(0, t, d) for t in range(state.U.shape[0])]

            score_gens = gens()
            score_plan = _solve.record_draws(score_gens, lambda: fns.get_rollouts(
                base, self.start, state.U, dyn_params=dyn_params, rngs=score_gens))
            out = (plan, score_plan, _solve.replay_draws(score_plan, gens()))
        self._plan_cache[fns] = out
        return out

    def _draws(self, fns, seeds, counter: int) -> list:
        """The fed draws of each stream seed's R no-shift commands from
        ``counter``: for each tensor a command is fed
        (``CommandStreams.feeds``), a (len(seeds), R, ...) stack."""
        streams, d = fns.streams, self.mppi.d
        plan = self._plans(fns)[0]
        per = [[streams.feeds(s, counter + r * streams.n_iter, d, plan) for r in range(self.R)]
               for s in seeds]
        if not self.R:  # the shapes of one command's, R = 0 of them
            return [torch.empty((len(seeds), 0, *z.shape), dtype=z.dtype, device=d)
                    for z in streams.feeds(seeds[0], counter, d, plan)]
        return [torch.stack([torch.stack([cmd[j] for cmd in seed]) for seed in per])
                for j in range(len(per[0][0]))]

    def _candidate_evaluator(self, fns):
        """The evaluation of one candidate, ``(params, draws (for each fed
        tensor an (M, R, ...) stack), U_nom, state_template, dyn_params,
        start=None) -> (mean cost, first rollout)``: vmapped over the M
        streams, each from its own copy of ``start`` (the evaluator's start
        state; a (P, nx) stack over the population's vmap), so that a tensor
        the dynamics make like their state (``torch.empty_like(s)``) is
        batched like the fed draws and an in-place draw writes them into it.
        Shared by the population path and :class:`GradientOpt` (autograd
        through it)."""
        cost_fn = self._rollout_cost_fn or self._default_cost_fn()
        start, R = self.start, self.R
        plan, score_plan, score_draws = self._plans(fns)
        score_gens = ([torch.Generator(device=start.device) for _ in score_plan]
                      if score_plan is not None else None)

        def one_traj(params, draws, start, U_nom, state_template, dyn_params):
            state = state_template._replace(U=U_nom)
            for r in range(R):
                # the body takes its streams from the device its U is on
                # ("cuda:0", where the controller may say "cuda")
                with fns.streams.fed(U_nom.device, [z[r] for z in draws], plan):
                    state, _, _ = fns.body(params, state, start, None, dyn_params, False)
            base = params.base if hasattr(params, "base") else params
            # the executed plan: SMPPI commands its integrated action_sequence,
            # not the rate-space U (reference mppi.py:520-537)
            seq = getattr(state, "action_sequence", state.U)
            with (contextlib.nullcontext() if score_gens is None
                  else _solve.fed_draws(score_gens, score_plan, score_draws)):
                rollout = fns.get_rollouts(base, start, seq, dyn_params=dyn_params,
                                           rngs=score_gens)[0]
            return cost_fn(rollout, seq), rollout

        def eval_candidate(params, draws, U_nom, state_template, dyn_params, start=start):
            costs, rollouts = torch.func.vmap(
                lambda d, x: one_traj(params, d, x, U_nom, state_template, dyn_params))(
                    draws, start.expand(self.M, *start.shape))
            return torch.mean(costs), rollouts[0]

        return eval_candidate

    def _build(self, fns):
        eval_candidate = self._candidate_evaluator(fns)

        def eval_pop(base, variant, draws, full, U_nom, state_template, dyn_params):
            # candidates on axis 0 of the batched base leaves, of the batched
            # variant fields, of the draws and of the start states; the rest
            # of ``full`` unbatched
            def one(base_p, variant_p, draws_p, start_p):
                params = (full._replace(base=base_p, **variant_p) if hasattr(full, "base")
                          else base_p)
                return eval_candidate(params, draws_p, U_nom, state_template, dyn_params,
                                      start_p)

            starts = self.start.expand(base.lambda_.shape[0], *self.start.shape)
            return torch.func.vmap(one)(base, variant, draws, starts)

        self._eval_cache[fns] = eval_pop
        return eval_pop

    def _supported(self):
        """sigma/mu/lambda always; SMPPI's w_action_seq_cost/delta_t and
        KMPPI's kernel_sigma where the controller's full params carry them."""
        s = {"sigma", "mu", "lambda"}
        full = self.mppi._full_params()
        if hasattr(full, "w_action_seq_cost"):
            s |= {"w_action_seq_cost", "delta_t"}
        if hasattr(full, "interp_full"):
            s |= {"kernel_sigma"}
        return s

    def _batch_variant_fields(self, param_dicts):
        """The candidate-batched SMPPI/KMPPI fields: the scalars stacked; a
        kernel bandwidth builds each candidate's interpolation operators."""
        dt, d = self.dtype, self.mppi.d
        keys = {k for p in param_dicts for k in p}
        out = {}
        if "w_action_seq_cost" in keys or "delta_t" in keys:
            full = self.mppi._full_params()
            for field in ("w_action_seq_cost", "delta_t"):
                fallback = getattr(full, field)
                out[field] = torch.stack([
                    ensure_tensor(d, dt, p[field]).reshape(()) if field in p
                    else fallback
                    for p in param_dicts
                ])
        if "kernel_sigma" in keys:
            mppi = self.mppi
            cur = mppi.kernel_sigma
            fulls, shifts = [], []
            for p in param_dicts:
                sig = float(_first(p.get("kernel_sigma", cur)))
                f, sh = interpolation_operators(type(mppi.interpolation_kernel)(sig), mppi.T,
                                                mppi.num_support_pts, dt, device=d)
                fulls.append(f)
                shifts.append(sh)
            out["interp_full"] = torch.stack(fulls)
            out["interp_shift"] = torch.stack(shifts)
        return out

    def _batch_params(self, param_dicts):
        base = self.mppi._params
        P = len(param_dicts)
        dt, d = self.dtype, self.mppi.d
        supported = self._supported()
        unsupported = {k for p in param_dicts for k in p} - supported
        if unsupported:
            raise ValueError(
                f"PopulationEvaluator supports {sorted(supported)} on this "
                f"controller; got {sorted(unsupported)}. Horizon changes "
                f"shapes and cannot be vmapped — tune it with the sequential "
                f"evaluate_fn path or an outer per-horizon loop."
            )

        def value(p, field):
            return ensure_tensor(d, dt, p[field])

        sigma = torch.stack([torch.diag(value(p, "sigma")) if "sigma" in p
                             else base.noise_sigma for p in param_dicts])
        mu = torch.stack([value(p, "mu") if "mu" in p else base.noise_mu
                          for p in param_dicts])
        lam = torch.stack([value(p, "lambda").reshape(()) if "lambda" in p
                           else base.lambda_ for p in param_dicts])
        bcast = lambda leaf: leaf.expand(P, *leaf.shape)  # noqa: E731
        return base._replace(noise_sigma=sigma, noise_mu=mu, lambda_=lam,
                             u_min=bcast(base.u_min), u_max=bcast(base.u_max),
                             u_init=bcast(base.u_init))

    def __call__(self, param_dicts) -> EvaluationResult:
        fns = self._planning_fns()
        eval_pop = self._eval_cache.get(fns) or self._build(fns)
        mppi = self.mppi
        P = len(param_dicts)
        state = mppi._state
        draws = self._draws(fns, self._stream_seeds(P * self.M), state.counter)
        draws = [z.reshape(P, self.M, *z.shape[1:]) for z in draws]
        costs, rollouts = eval_pop(self._batch_params(param_dicts),
                                   self._batch_variant_fields(param_dicts), draws,
                                   mppi._full_params(), mppi.U, state, mppi.dynamics_params)
        return EvaluationResult(costs, rollouts)


def evaluate_population(tuner, pop_fn, param_values_list):
    """Evaluate a list of full param-value dicts with as few population
    evaluations as possible (JAX ``autotune.py:741-805``): the batched
    parameters ride one ``pop_fn`` call (:class:`PopulationEvaluator`); the
    shape-changing ones (horizon) group by their
    :meth:`TunableParameter.effective_value` into an outer loop, one call a
    distinct shape.

    Every value goes through its parameter's ``ensure_valid_value``, as the
    sequential apply path does.  The controller's state is snapshotted
    (``utils/checkpoint.snapshot``) before the group loop and restored
    between groups and at the end, so a ``change_horizon`` truncation or
    padding of one group never reaches another group's (or the caller's)
    nominal trajectory.

    :returns: (P,) numpy array of mean costs aligned with the input list.
    """
    by_name = {p.name(): p for p in tuner.params}
    shape_names = [n for n in by_name if n not in _VMAPPABLE_PARAMS]
    costs = np.full(len(param_values_list), np.nan)

    def effective_key(pv):
        # pure: no controller mutation during grouping
        return tuple(by_name[n].effective_value(pv[n]) for n in shape_names)

    groups: dict = {}
    for i, pv in enumerate(param_values_list):
        groups.setdefault(effective_key(pv), []).append(i)

    mppi = next((p.mppi for p in tuner.params if getattr(p, "mppi", None)
                 is not None), None)
    snap = _ckpt.snapshot(mppi) if (mppi is not None and shape_names) else None
    T0 = mppi.T if snap is not None else None

    def _restore():
        if snap is not None:
            # the horizon back first so the snapshot's shapes fit, then the
            # exact state from before the loop
            mppi.change_horizon(T0)
            _ckpt.restore(mppi, snap)

    try:
        for key, idxs in groups.items():
            _restore()
            for n, v in zip(shape_names, key):
                by_name[n].apply_parameter_value(v)
            dicts = [{k: by_name[k].ensure_valid_value(v)
                      for k, v in vmappable_subset(param_values_list[i]).items()}
                     for i in idxs]
            res = pop_fn(dicts)
            costs[np.asarray(idxs)] = np.asarray(_numpy(res.costs), dtype=np.float64).reshape(-1)
    finally:
        _restore()
    return costs


class GradientOpt(Optimizer):
    """First-order hyperparameter tuning by differentiating through the solve
    (JAX ``autotune.py:808-979``).

    The gradient of the population evaluator's candidate cost (R no-shift
    commands in each of M streams, the rollout, the score) with respect to
    sigma, mu, lambda and SMPPI's ``w_action_seq_cost`` and ``delta_t`` is
    ``torch.autograd``'s through the vmapped plain body: through the noise
    scaling (the fed draws are fixed, sigma only scales them), the bound
    clamp, the T-step rollout, the softmax weights and the R refinements.

    Positive parameters (sigma, lambda, w_action_seq_cost, delta_t) are
    optimised in log space, each above its parameter's floor; mu is
    unconstrained.  Each ``optimize_step`` runs ``steps_per_iteration``
    ``torch.optim.Adam`` updates (the update of optax's ``adam``), applies
    the result through the tuner's ``apply_parameters``, re-syncs theta with
    what the controller holds, and scores it with the evaluator.  The draws
    stay fixed between updates (common random numbers) unless
    ``resample_noise``.

    Needs ``Autotune(..., population_evaluate_fn=PopulationEvaluator(...))``.
    Horizon and ``kernel_sigma`` have no gradient path and are refused at
    setup.
    """

    LOG_SPACE = {"sigma", "lambda", "w_action_seq_cost", "delta_t"}
    SUPPORTED = {"sigma", "mu", "lambda", "w_action_seq_cost", "delta_t"}

    def __init__(self, lr: float = 0.05, steps_per_iteration: int = 5,
                 resample_noise: bool = False, seed: int = 0):
        self.lr = float(lr)
        self.steps = int(steps_per_iteration)
        self.resample_noise = bool(resample_noise)
        self.seed = int(seed)
        super().__init__()

    def setup_optimization(self):
        ev = getattr(self.tuner, "population_evaluate_fn", None)
        if not isinstance(ev, PopulationEvaluator):
            raise ValueError(
                "GradientOpt requires Autotune(..., population_evaluate_fn="
                "PopulationEvaluator(...)) — it differentiates through the "
                "evaluator's refinement solves"
            )
        names = [p.name() for p in self.tuner.params]
        bad = set(names) - self.SUPPORTED
        if bad:
            raise ValueError(
                f"GradientOpt supports {sorted(self.SUPPORTED)}; got "
                f"{sorted(bad)} (horizon changes shapes; kernel_sigma "
                f"rebuilds interpolation operators eagerly — neither has a "
                f"gradient path)"
            )
        self.ev = ev
        # the log transform's floor: the parameter's own eps when positive,
        # else a tiny one, so a legitimate 0 (w_action_seq_cost) stays
        # representable as a very negative log
        self._floor = {
            p.name(): max(float(getattr(p, "eps", Autotune.eps) or 0.0), 1e-8)
            for p in self.tuner.params
        }
        self._theta = {p.name(): self._to_theta(p.name(), p.get_current_parameter_value())
                       .requires_grad_(True) for p in self.tuner.params}
        self.optim = torch.optim.Adam(list(self._theta.values()), lr=self.lr)
        self._gen = torch.Generator(device=ev.mppi.d)
        self._gen.manual_seed(self.seed)
        self._fixed_draws = None

    def _to_theta(self, name, value) -> torch.Tensor:
        ev = self.ev
        v = torch.as_tensor(value, dtype=ev.dtype, device=ev.mppi.d).reshape(-1)
        return torch.log(torch.clamp(v, min=self._floor[name])) if name in self.LOG_SPACE else v

    def _param_dict(self, theta):
        return {n: torch.exp(v) if n in self.LOG_SPACE else v for n, v in theta.items()}

    def _loss(self, fns, theta, draws):
        """The candidate cost at ``theta`` on the controller's current
        params, nominal trajectory, state and ``dynamics_params``."""
        mppi = self.ev.mppi
        d = self._param_dict(theta)
        full = mppi._full_params()
        base = full.base if hasattr(full, "base") else full
        repl = {}
        if "sigma" in d:
            repl["noise_sigma"] = torch.diag(d["sigma"])
        if "mu" in d:
            repl["noise_mu"] = d["mu"]
        if "lambda" in d:
            repl["lambda_"] = d["lambda"].reshape(())
        base = base._replace(**repl)
        if hasattr(full, "base"):
            variant = {n: d[n].reshape(()) for n in d.keys() & {"w_action_seq_cost", "delta_t"}}
            params = full._replace(base=base, **variant)
        else:
            params = base
        cost, _ = self.ev._candidate_evaluator(fns)(params, draws, mppi.U, mppi._state,
                                                    mppi.dynamics_params)
        return cost

    def value_and_grad(self):
        """The candidate cost at the current theta on the current draws, and
        its gradient with respect to each theta (log space where it is)."""
        ev = self.ev
        fns = ev._planning_fns()
        if self.resample_noise or self._fixed_draws is None:
            self._fixed_draws = ev._draws(fns, _draw_seeds(self._gen, ev.M),
                                          ev.mppi._state.counter)
        with torch.enable_grad():
            cost = self._loss(fns, self._theta, self._fixed_draws)
            grads = torch.autograd.grad(cost, list(self._theta.values()))
        return cost.detach(), dict(zip(self._theta, grads))

    def optimize_step(self) -> EvaluationResult:
        for _ in range(self.steps):
            _, grads = self.value_and_grad()
            for n, g in grads.items():
                self._theta[n].grad = g
            self.optim.step()
        # apply through the tuner's normal validation/apply path, then score
        values = self._param_dict({n: v.detach() for n, v in self._theta.items()})
        applied = {p.name(): p.ensure_valid_value(values[p.name()]) for p in self.tuner.params}
        self.tuner.apply_parameters(applied)
        # re-sync theta with what the controller holds (projected descent):
        # a clamped parameter must not let Adam descend a theta the
        # controller can never hold
        with torch.no_grad():
            for n, v in applied.items():
                self._theta[n].copy_(self._to_theta(n, v))
        res = self.ev([vmappable_subset(applied)])
        return res._replace(costs=res.costs.reshape(-1))


# ---------------------------------------------------------------------------
# Autotune core (reference autotune.py:244-342)
# ---------------------------------------------------------------------------


class Autotune:
    """Tune selected hyperparameters by minimizing a user evaluation function.

    See ``examples/auto_tune_parameters.py`` for an example ``evaluate_fn``.
    """

    eps = 0.0001

    def __init__(
        self,
        params_to_tune: typing.Sequence[TunableParameter],
        evaluate_fn: typing.Callable[[], EvaluationResult],
        reload_state_fn: typing.Callable[[], dict] = None,
        optimizer=None,
        population_evaluate_fn=None,
    ):
        self.evaluate_fn = evaluate_fn
        # optional: evaluates a LIST of candidate param dicts in one vmapped
        # evaluation (PopulationEvaluator); population-aware optimizers use
        # it instead of the one-at-a-time apply+evaluate loop
        self.population_evaluate_fn = population_evaluate_fn
        self.reload_state_fn = reload_state_fn

        self.params = params_to_tune
        self.optim = optimizer if optimizer is not None else CMAESOpt()
        self.optim.tuner = self
        self.results = []

        self.attach_parameters()
        self.optim.setup_optimization()

    def optimize_step(self) -> EvaluationResult:
        res = self.optim.optimize_step()
        return self.log_current_result(res)

    def optimize_all(self, iterations) -> EvaluationResult:
        res = self.optim.optimize_all(iterations)
        return self.log_current_result(res)

    def get_best_result(self) -> EvaluationResult:
        return min(self.results, key=lambda res: mean_cost(res.costs))

    def log_current_result(self, res: EvaluationResult):
        iteration = len(self.results)
        kv = self.get_parameter_values(self.params)
        res = res._replace(iteration=iteration, params=dict(kv))
        logger.info("i:%d cost: %f params:%s", iteration, mean_cost(res.costs), kv)
        self.results.append(res)
        return res

    def get_parameter_values(self, params_to_tune):
        return {p.name(): p.get_current_parameter_value() for p in params_to_tune}

    def flatten_params(self):
        return np.concatenate([np.asarray(_numpy(v), dtype=np.float64).reshape(-1)
                               for v in self.get_parameter_values(self.params).values()])

    def unflatten_params(self, x, apply=True):
        param_values = {}
        i = 0
        for p in self.params:
            raw_value = x[i : i + p.dim()]
            param_values[p.name()] = p.ensure_valid_value(raw_value)
            i += p.dim()
        if apply:
            self.apply_parameters(param_values)
        return param_values

    def apply_parameters(self, param_values):
        for p in self.params:
            p.apply_parameter_value(param_values[p.name()])

    def attach_parameters(self):
        """Reattach parameters after state reload (e.g. worker processes,
        reference autotune.py:329-338)."""
        if self.reload_state_fn is not None:
            state = self.reload_state_fn()
            for p in self.params:
                p.attach_to_state(state)

    def config_to_params(self, config):
        """Configs are scalar-per-name dictionaries (reference autotune.py:340-342)."""
        return {p.name(): p.get_parameter_value_from_config(config) for p in self.params}
