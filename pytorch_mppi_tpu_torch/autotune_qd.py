"""Quality-diversity hyperparameter search (CMA-ME style).

The counterpart of ``pytorch_mppi_tpu/autotune_qd.py``, whose grid archive
and evolution-strategy emitter replace the reference's ``pyribs``, with the
same surface:
``CMAMEOpt(population, sigma, bins)`` with ``optimize_step`` and
``get_diverse_top_parameters``.

Behavior descriptors are the linearized hyperparameters themselves — diversity is
sought along each tuned dimension (reference autotune_qd.py:58-69).
"""
from __future__ import annotations

import logging
import typing

import numpy as np

from . import autotune
from .autotune import CMAES
from .autotune_global import AutotuneGlobal

logger = logging.getLogger(__name__)


class GridArchive:
    """Uniform-grid QD archive: keeps the best (elite) solution per behavior bin
    (native replacement for ribs.archives.GridArchive, autotune_qd.py:42-45)."""

    def __init__(self, dims, ranges, qd_score_offset=0.0):
        self.dims = list(dims)
        self.lower = np.array([r[0] for r in ranges], dtype=np.float64)
        self.upper = np.array([r[1] for r in ranges], dtype=np.float64)
        self.qd_score_offset = qd_score_offset
        self._cells: dict = {}  # bin index tuple -> (objective, solution, measures)

    def _index(self, measures):
        m = np.asarray(measures, dtype=np.float64)
        span = np.maximum(self.upper - self.lower, 1e-12)
        frac = np.clip((m - self.lower) / span, 0.0, 1.0 - 1e-9)
        return tuple((frac * np.asarray(self.dims)).astype(int))

    def add(self, solution, objective, measures):
        """Insert; returns the improvement value (CMA-ME ranking signal):
        positive for new bins or improved elites, -inf otherwise."""
        idx = self._index(measures)
        incumbent = self._cells.get(idx)
        if incumbent is None:
            self._cells[idx] = (objective, np.array(solution), np.array(measures))
            return objective - self.qd_score_offset
        if objective > incumbent[0]:
            improvement = objective - incumbent[0]
            self._cells[idx] = (objective, np.array(solution), np.array(measures))
            return improvement
        return -np.inf

    def __len__(self):
        return len(self._cells)

    @property
    def best_elite(self):
        obj, sol, meas = max(self._cells.values(), key=lambda e: e[0])
        return _Elite(sol, obj, meas)

    def elites(self):
        return [
            _Elite(sol, obj, meas) for obj, sol, meas in self._cells.values()
        ]


class _Elite(typing.NamedTuple):
    solution: np.ndarray
    objective: float
    measures: np.ndarray


class CMAMEOpt(autotune.Optimizer):
    """Quality-diversity optimization: find a *set* of good and diverse
    hyperparameters (reference autotune_qd.py:10-90)."""

    def __init__(self, population=10, sigma=1.0, bins=15, seed=None):
        """
        :param population: candidates per ask (scales evaluation cost linearly)
        :param sigma: initial search variance along all dimensions
        :param bins: int or per-dimension sequence of archive bin counts
        """
        self.population = population
        self.sigma = sigma
        self.bins = bins
        self.seed = seed
        self.archive: typing.Optional[GridArchive] = None
        self.qd_score_offset = -3000
        super().__init__()

    def setup_optimization(self):
        if not isinstance(self.tuner, AutotuneGlobal):
            raise RuntimeError(
                "Quality diversity optimizers require global search space information "
                "provided by AutotuneGlobal"
            )
        x = self.tuner.flatten_params()
        ranges = list(self.tuner.linearized_search_space().values())
        param_dim = len(x)
        bins = self.bins
        if isinstance(bins, (int, float)):
            bins = [int(bins)] * param_dim
        seed = self.seed if self.seed is not None else np.random.randint(0, 10000)
        self.archive = GridArchive(
            dims=bins, ranges=ranges, qd_score_offset=self.qd_score_offset
        )
        self.optim = CMAES(x0=x, sigma0=self.sigma, popsize=self.population, seed=seed)

    def optimize_step(self):
        params = self.optim.ask()
        pop_fn = getattr(self.tuner, "population_evaluate_fn", None)
        if pop_fn is not None:
            # the whole emitter population in one vmapped evaluation per
            # distinct shape (autotune.evaluate_population)
            dicts = [self.tuner.unflatten_params(p, apply=False) for p in params]
            costs = autotune.evaluate_population(self.tuner, pop_fn, dicts)
            improvements = [
                self.archive.add(
                    np.asarray(param), -float(c), self.tuner.linearize_params(fp)
                )
                for param, c, fp in zip(params, costs, dicts)
            ]
        else:
            improvements = []
            for param in params:
                full_param = self.tuner.unflatten_params(param)
                res = self.tuner.evaluate_fn()
                cost = autotune.mean_cost(res.costs)
                behavior = self.tuner.linearize_params(full_param)
                imp = self.archive.add(np.asarray(param), -cost, behavior)
                improvements.append(imp)
        # CMA-ME: rank by archive improvement rather than raw objective
        # (emitter restarts implicitly when no improvement: worst rank everywhere)
        fitness = [-i if np.isfinite(i) else 1e9 for i in improvements]
        self.optim.tell(params, fitness)

        best_values = self.tuner.unflatten_params(self.archive.best_elite.solution)
        return autotune._evaluate_best(self.tuner, pop_fn, best_values)

    def get_diverse_top_parameters(self, num_top):
        """Extract the top-n diverse elites (reference autotune_qd.py:81-90)."""
        elites = self.archive.elites()
        objectives = np.array([e.objective for e in elites])
        solutions = np.array([e.solution for e in elites])
        if len(solutions) > num_top:
            order = np.argpartition(-objectives, num_top)
            solutions = solutions[order[:num_top]]
        return [self.tuner.unflatten_params(x, apply=False) for x in solutions]
