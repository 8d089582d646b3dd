"""Global hyperparameter search with explicit search spaces.

The counterpart of ``pytorch_mppi_tpu/autotune_global.py``: native search
spaces in place of ``ray.tune``'s samplers, and a quasi-random global
optimizer (Sobol, ``scipy.stats.qmc``) in place of ``RayOptimizer``'s
HyperOpt backend.  Where Ray is installed, :class:`RayOptimizer` drives
``ray.tune`` with the same spaces; it imports ``ray`` only when it is set
up, so importing this module never needs it.

Default spaces match the reference exactly (autotune_global.py:51-84):
sigma loguniform(1e-4, 1e2), mu uniform(-1, 1), lambda loguniform(1e-5, 1e3),
horizon randint(1, 50).
"""
from __future__ import annotations

import abc
import logging

import numpy as np

from . import autotune

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Native search spaces (replace ray.tune samplers)
# ---------------------------------------------------------------------------


class SearchSpace(abc.ABC):
    """A 1-D sampling domain with a linearization (log spaces compare/bin in
    log units, reference autotune_global.py:28-48)."""

    lower: float
    upper: float

    @abc.abstractmethod
    def sample(self, rng, size=None):
        ...

    def linearize(self, v):
        return v

    def linearized_bounds(self):
        return self.linearize(self.lower), self.linearize(self.upper)

    def from_unit(self, u):
        """Map u in [0,1] into the space (for quasi-random sequences)."""
        lo, hi = self.linearized_bounds()
        return self.delinearize(lo + u * (hi - lo))

    def delinearize(self, v):
        return v


class Uniform(SearchSpace):
    def __init__(self, lower, upper):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng, size=None):
        return rng.uniform(self.lower, self.upper, size)


class LogUniform(SearchSpace):
    def __init__(self, lower, upper, base=10.0):
        self.lower, self.upper = float(lower), float(upper)
        self.base = float(base)

    def sample(self, rng, size=None):
        lo, hi = np.log(self.lower), np.log(self.upper)
        return np.exp(rng.uniform(lo, hi, size))

    def linearize(self, v):
        return np.log(v) / np.log(self.base)

    def delinearize(self, v):
        return self.base**v


class RandInt(SearchSpace):
    def __init__(self, lower, upper):
        self.lower, self.upper = int(lower), int(upper)

    def sample(self, rng, size=None):
        return rng.randint(self.lower, self.upper, size)

    def from_unit(self, u):
        return int(np.clip(np.floor(self.lower + u * (self.upper - self.lower)),
                           self.lower, self.upper - 1))


def linearize_search_space_value(space, v):
    """Reference ``GlobalTunableParameter._linearize_space_value``
    (autotune_global.py:37-48), for native or ray spaces."""
    if isinstance(space, SearchSpace):
        return space.linearize(v)
    sampler = space.get_sampler()  # ray.tune space duck-typing
    if hasattr(sampler, "base"):
        b = np.log(sampler.base)
        return np.log(v) / b
    if hasattr(sampler, "q"):
        return np.round(np.divide(v, sampler.q)) * sampler.q
    return v


def linearize_search_space(space):
    if isinstance(space, SearchSpace):
        return space.linearized_bounds()
    sampler = space.get_sampler()
    if hasattr(sampler, "base"):
        b = np.log(sampler.base)
        return np.log(space.lower) / b, np.log(space.upper) / b
    return space.lower, space.upper


# ---------------------------------------------------------------------------
# Global tunable parameters (reference autotune_global.py:13-84)
# ---------------------------------------------------------------------------


class GlobalTunableParameter(autotune.TunableParameter, abc.ABC):
    def __init__(self, search_space):
        self.search_space = search_space

    @abc.abstractmethod
    def total_search_space(self) -> dict:
        """Map each of this parameter's config names to its search space."""

    def get_linearized_search_space_value(self, param_values):
        v = param_values[self.name()]
        if self.dim() == 1:
            return [linearize_search_space_value(self.search_space,
                                                 float(np.ravel(autotune._numpy(v))[0]))]
        v = np.ravel(autotune._numpy(v))
        return [linearize_search_space_value(self.search_space, float(v[i]))
                for i in range(self.dim())]

    @staticmethod
    def linearize_search_space(space):
        return linearize_search_space(space)


class SigmaGlobalParameter(autotune.SigmaParameter, GlobalTunableParameter):
    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(
            self, search_space or LogUniform(1e-4, 1e2)
        )

    def total_search_space(self) -> dict:
        return {f"{self.name()}{i}": self.search_space for i in range(self.dim())}


class MuGlobalParameter(autotune.MuParameter, GlobalTunableParameter):
    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or Uniform(-1, 1))

    def total_search_space(self) -> dict:
        return {f"{self.name()}{i}": self.search_space for i in range(self.dim())}


class LambdaGlobalParameter(autotune.LambdaParameter, GlobalTunableParameter):
    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or LogUniform(1e-5, 1e3))

    def total_search_space(self) -> dict:
        return {self.name(): self.search_space}


class HorizonGlobalParameter(autotune.HorizonParameter, GlobalTunableParameter):
    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or RandInt(1, 50))

    def total_search_space(self) -> dict:
        return {self.name(): self.search_space}


class WActionSeqCostGlobalParameter(autotune.WActionSeqCostParameter,
                                    GlobalTunableParameter):
    """SMPPI smoothness weight (net-new tunable, see autotune.py)."""

    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or LogUniform(1e-3, 1e2))

    def total_search_space(self) -> dict:
        return {self.name(): self.search_space}


class DeltaTGlobalParameter(autotune.DeltaTParameter, GlobalTunableParameter):
    """SMPPI integration step (net-new tunable)."""

    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or LogUniform(1e-2, 2.0))

    def total_search_space(self) -> dict:
        return {self.name(): self.search_space}


class KernelSigmaGlobalParameter(autotune.KernelSigmaParameter,
                                 GlobalTunableParameter):
    """KMPPI interpolation-kernel bandwidth (net-new tunable)."""

    def __init__(self, *args, search_space=None, **kwargs):
        super().__init__(*args, **kwargs)
        GlobalTunableParameter.__init__(self, search_space or LogUniform(0.1, 10.0))

    def total_search_space(self) -> dict:
        return {self.name(): self.search_space}


class AutotuneGlobal(autotune.Autotune):
    """Autotune variant that exposes the joint search space
    (reference autotune_global.py:87-111)."""

    def search_space(self):
        space = {}
        for p in self.params:
            assert isinstance(p, GlobalTunableParameter)
            space.update(p.total_search_space())
        return space

    def linearized_search_space(self):
        return {
            k: linearize_search_space(space) for k, space in self.search_space().items()
        }

    def linearize_params(self, param_values):
        v = []
        for p in self.params:
            assert isinstance(p, GlobalTunableParameter)
            v.extend(p.get_linearized_search_space_value(param_values))
        return np.array(v)

    def initial_value(self):
        init = {}
        param_values = self.get_parameter_values(self.params)
        for p in self.params:
            assert isinstance(p, GlobalTunableParameter)
            init.update(p.get_config_from_parameter_value(param_values[p.name()]))
        return init


# ---------------------------------------------------------------------------
# Native global optimizer (replaces RayOptimizer's role; no external deps)
# ---------------------------------------------------------------------------


class GlobalSearchOpt(autotune.Optimizer):
    """Quasi-random (Sobol) global search over the joint space, seeded with the
    current parameter values, followed by greedy tracking of the best candidate.

    Plays the role the reference delegates to Ray Tune + HyperOpt
    (autotune_global.py:114-157) with zero dependencies.  Each ``optimize_step``
    evaluates ``batch_size`` new configurations.
    """

    def __init__(self, batch_size=8, seed=None):
        self.batch_size = batch_size
        self.seed = seed
        self.best_cost = np.inf
        self.best_config = None
        super().__init__()

    def setup_optimization(self):
        if not isinstance(self.tuner, AutotuneGlobal):
            raise RuntimeError(
                "Global optimizers require search space information provided by AutotuneGlobal"
            )
        from scipy.stats import qmc

        self.space = self.tuner.search_space()
        self.names = list(self.space.keys())
        seed = self.seed if self.seed is not None else np.random.randint(0, 10000)
        self.sampler = qmc.Sobol(d=len(self.names), scramble=True, seed=seed)
        # seed with current values (reference points_to_evaluate, autotune_global.py:128)
        self._pending = [self.tuner.initial_value()]

    def _next_configs(self):
        configs = list(self._pending)
        self._pending = []
        while len(configs) < self.batch_size:
            u = self.sampler.random(1)[0]
            configs.append(
                {k: self.space[k].from_unit(u[i]) for i, k in enumerate(self.names)}
            )
        return configs

    def optimize_step(self):
        configs = self._next_configs()
        pop_fn = getattr(self.tuner, "population_evaluate_fn", None)
        if pop_fn is not None:
            # the whole batch in one vmapped evaluation per distinct shape
            # (sigma/mu/lambda batched; horizon groups an outer loop), where
            # the reference spreads its trials over Ray workers
            # (autotune_global.py:128-140)
            dicts = [self.tuner.config_to_params(c) for c in configs]
            costs = np.asarray(autotune.evaluate_population(self.tuner, pop_fn, dicts))
            # nan-safe argmin: a diverging candidate (NaN/inf cost) must neither
            # be selected as 'best' nor silently waste the batch
            finite = np.isfinite(costs)
            if finite.any():
                i_best = int(np.flatnonzero(finite)[np.argmin(costs[finite])])
                if costs[i_best] < self.best_cost:
                    self.best_cost = float(costs[i_best])
                    self.best_config = configs[i_best]
            if self.best_config is None:
                raise RuntimeError(
                    f"all {len(configs)} candidate configurations in the first "
                    f"batch evaluated to non-finite cost (diverging dynamics?); "
                    f"cannot select a best configuration — check the evaluation "
                    f"function or narrow the search space"
                )
            # land on the best seen so far (greedy) and re-evaluate it
            best_values = self.tuner.config_to_params(self.best_config)
            self.tuner.apply_parameters(best_values)
            # config_to_params does no clipping: validate like the batch path
            # so a boundary candidate (sigma/lambda at 0) cannot reach
            # cholesky/exp raw and log NaN costs
            by_name = {p.name(): p for p in self.tuner.params}
            return autotune._evaluate_best(self.tuner, pop_fn, {
                k: by_name[k].ensure_valid_value(v) for k, v in best_values.items()})

        best_res = None
        for config in configs:
            self.tuner.attach_parameters()
            self.tuner.apply_parameters(self.tuner.config_to_params(config))
            res = self.tuner.evaluate_fn()
            c = autotune.mean_cost(res.costs)
            if np.isfinite(c) and c < self.best_cost:
                self.best_cost = c
                self.best_config = config
                best_res = res
        if self.best_config is None:
            raise RuntimeError(
                f"all {len(configs)} candidate configurations in the first "
                f"batch evaluated to non-finite cost (diverging dynamics?); "
                f"cannot select a best configuration — check the evaluation "
                f"function or narrow the search space"
            )
        # land on the best seen so far (greedy)
        self.tuner.apply_parameters(self.tuner.config_to_params(self.best_config))
        if best_res is None:
            best_res = self.tuner.evaluate_fn()
        return best_res


class RayOptimizer(autotune.Optimizer):
    """Optional Ray Tune wrapper (reference autotune_global.py:114-157).  Requires
    ``pip install "ray[tune]" hyperopt``; raises a clear error when absent."""

    def __init__(self, search_alg=None, default_iterations=100):
        self.iterations = default_iterations
        self.search_alg = search_alg
        self.all_res = None
        super().__init__()

    def setup_optimization(self):
        try:
            from ray import tune  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RayOptimizer requires ray[tune]; use GlobalSearchOpt (built-in) "
                "or install ray"
            ) from e
        if not isinstance(self.tuner, AutotuneGlobal):
            raise RuntimeError(
                "Ray optimizers require search space information provided by AutotuneGlobal"
            )

    def optimize_step(self):
        raise RuntimeError("Ray optimizers only allow tuning of all iterations at once")

    def optimize_all(self, iterations):
        from ray import train, tune
        from ray.tune.search.hyperopt import HyperOptSearch

        search_alg = self.search_alg or HyperOptSearch
        # translate native spaces to ray spaces
        def to_ray(space):
            if isinstance(space, LogUniform):
                return tune.loguniform(space.lower, space.upper)
            if isinstance(space, Uniform):
                return tune.uniform(space.lower, space.upper)
            if isinstance(space, RandInt):
                return tune.randint(space.lower, space.upper)
            return space

        space = {k: to_ray(v) for k, v in self.tuner.search_space().items()}
        init = self.tuner.initial_value()
        hyperopt_search = search_alg(
            points_to_evaluate=[init], metric="cost", mode="min"
        )

        def trainable(config):
            self.tuner.attach_parameters()
            self.tuner.apply_parameters(self.tuner.config_to_params(config))
            res = self.tuner.evaluate_fn()
            train.report({"cost": autotune.mean_cost(res.costs)})

        self.optim = tune.Tuner(
            trainable,
            tune_config=tune.TuneConfig(
                num_samples=iterations,
                search_alg=hyperopt_search,
                metric="cost",
                mode="min",
            ),
            param_space=space,
        )
        self.all_res = self.optim.fit()
        self.tuner.apply_parameters(
            self.tuner.config_to_params(self.all_res.get_best_result().config)
        )
        return self.tuner.evaluate_fn()
