"""Hyperparameter autotuning demo (the counterpart of
``examples/auto_tune_parameters.py``, reference
``tests/auto_tune_parameters.py``): tune sigma, lambda and the horizon of an
MPPI controller on the 2-D navigation task with (a) CMA-ES local search,
(b) Sobol global search, (c) CMA-ME quality diversity, (d) the global search
on the population path, one vmapped evaluation a generation
(``autotune.PopulationEvaluator``), and (e) Adam on gradients taken through
the refinement solves (``autotune.GradientOpt``).

Run: python -m pytorch_mppi_tpu_torch.examples.auto_tune_parameters [--fast]
"""
from __future__ import annotations

import logging

import torch

from pytorch_mppi_tpu_torch import MPPI, autotune, autotune_global, autotune_qd
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment

logger = logging.getLogger(__name__)


def _values(params, decimals=None):
    out = {}
    for k, v in params.items():
        v = autotune._numpy(v)
        out[k] = (v.round(decimals) if decimals is not None else v).tolist()
    return out


def main(fast: bool = False, device=None) -> dict:
    """Run the five tuners; ``fast`` cuts the shapes and iterations (the
    same code paths, about 10x less work).  Returns each section's best
    mean cost."""
    dtype = torch.float32
    env = Toy2DEnvironment(terminal_scale=10.0, dtype=dtype, device=device)
    t = dict(dtype=dtype, device=env.device)

    n_iters = 2 if fast else 5
    mppi = MPPI(env.dynamics, env.running_cost, 2,
                noise_sigma=torch.diag(torch.tensor([5.0, 5.0], **t)),
                num_samples=128 if fast else 500, horizon=10 if fast else 20,
                terminal_state_cost=env.terminal_cost, u_max=torch.tensor([2.0, 2.0], **t),
                lambda_=1.0, seed=1, device=env.device)

    # the same nominal trajectory for every evaluation, for fairness
    # (reference auto_tune_parameters.py:256-276)
    nominal_trajectory = mppi.U
    num_refinement_steps = 3 if fast else 10
    num_trajectories = 2 if fast else 5

    def evaluate():
        costs, rollouts = [], []
        for _ in range(num_trajectories):
            mppi.U = nominal_trajectory
            mppi.change_horizon(mppi.T)
            for _ in range(num_refinement_steps):
                mppi.command(env.start, shift_nominal_trajectory=False)
            rollout = mppi.get_rollouts(env.start)[0]
            this_cost = env.running_cost(rollout[:-1], mppi.U[: len(rollout) - 1]).sum()
            this_cost = this_cost + env.terminal_cost(rollout, mppi.U)
            rollouts.append(rollout)
            costs.append(this_cost)
        return autotune.EvaluationResult(torch.stack(costs), torch.stack(rollouts))

    results = {}

    # (a) local CMA-ES search from the current parameters
    tuner = autotune.Autotune(
        [autotune.SigmaParameter(mppi), autotune.HorizonParameter(mppi),
         autotune.LambdaParameter(mppi)],
        evaluate_fn=evaluate, optimizer=autotune.CMAESOpt(sigma=1.0, population=6, seed=1))
    for _ in range(n_iters):
        tuner.optimize_step()
    best = tuner.get_best_result()
    tuner.apply_parameters(best.params)
    results["cmaes"] = autotune.mean_cost(best.costs)
    print(f"CMA-ES best cost {results['cmaes']:.2f} params {_values(best.params)}")

    # (b) global quasi-random (Sobol) search over explicit search spaces
    params_to_tune = [autotune_global.SigmaGlobalParameter(mppi),
                      autotune_global.HorizonGlobalParameter(mppi),
                      autotune_global.LambdaGlobalParameter(mppi)]
    tuner = autotune_global.AutotuneGlobal(
        params_to_tune, evaluate_fn=evaluate,
        optimizer=autotune_global.GlobalSearchOpt(batch_size=8, seed=1))
    tuner.optimize_all(n_iters)
    results["global"] = autotune.mean_cost(tuner.get_best_result().costs)
    print(f"Global search best cost {results['global']:.2f}")

    # (c) quality diversity: a set of good and diverse hyperparameters
    tuner = autotune_global.AutotuneGlobal(
        params_to_tune, evaluate_fn=evaluate,
        optimizer=autotune_qd.CMAMEOpt(population=6, sigma=1.0, bins=10, seed=1))
    tuner.optimize_all(n_iters)
    diverse = tuner.optim.get_diverse_top_parameters(4)
    results["qd_archive"] = len(tuner.optim.archive)
    print(f"QD archive size {results['qd_archive']}; diverse params:")
    for p in diverse:
        print("  ", _values(p))

    # (d) the population path: every generation in one vmapped evaluation;
    # horizon candidates group into one evaluation a distinct effective shape
    evaluator = autotune.PopulationEvaluator(
        mppi, env.start, num_refinement_steps=num_refinement_steps,
        num_trajectories=num_trajectories)
    tuner = autotune_global.AutotuneGlobal(
        [autotune_global.SigmaGlobalParameter(mppi),
         autotune_global.HorizonGlobalParameter(
             mppi, search_space=autotune_global.RandInt(5, 30)),
         autotune_global.LambdaGlobalParameter(mppi)],
        evaluate_fn=evaluate,
        optimizer=autotune_global.GlobalSearchOpt(batch_size=8, seed=1),
        population_evaluate_fn=evaluator)
    tuner.optimize_all(n_iters)
    results["population"] = autotune.mean_cost(tuner.get_best_result().costs)
    print(f"Population-parallel global search best cost {results['population']:.2f}")

    # (e) differentiable tuning (no reference counterpart): gradients through
    # the refinement solves, Adam on log-space (sigma, lambda)
    tuner = autotune.Autotune(
        [autotune.SigmaParameter(mppi), autotune.LambdaParameter(mppi)],
        evaluate_fn=evaluate,
        optimizer=autotune.GradientOpt(lr=0.1, steps_per_iteration=5),
        population_evaluate_fn=evaluator)
    for _ in range(n_iters):
        tuner.optimize_step()
    best = tuner.get_best_result()
    results["gradient"] = autotune.mean_cost(best.costs)
    print(f"Gradient (through-the-solve) best cost {results['gradient']:.2f} params "
          f"{_values(best.params, 3)}")
    return results


if __name__ == "__main__":
    import sys

    logging.basicConfig(level=logging.INFO)
    main(fast="--fast" in sys.argv)
