"""Elite reuse: keep the best plans alive across MPC cycles (the counterpart
of ``examples/elite_reuse.py``).

``num_elites=E`` stores the E lowest-cost perturbed trajectories of each
optimisation cycle, shifts them with the receding horizon and samples them
again as rows of the next cycle (iCEM-style elite reuse, Pinneri et al.
2020, arXiv:2008.06389 §3): a swing-up plan that was found persists until a
fresh sample beats it on total cost, instead of having to be drawn anew
from the re-centred Gaussian every command.

This example A/Bs the pendulum swing-up (the reference's flagship
configuration, ``tests/pendulum.py``) at a starved sample count, where the
effect is largest, on the plain path.

Run: python -m pytorch_mppi_tpu_torch.examples.elite_reuse
"""
from __future__ import annotations

import argparse
import logging
import math

import numpy as np
import torch

from pytorch_mppi_tpu_torch import MPPI
from pytorch_mppi_tpu_torch.models import (
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)
from pytorch_mppi_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def swing_up(num_samples, num_elites, horizon, steps, seed, device=None):
    """One swing-up from hanging still; returns the final |wrapped angle|
    and the accumulated running cost."""
    device = resolve_device(device, "elite_reuse")
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor(4.0), num_samples=num_samples, horizon=horizon,
                lambda_=1.0, u_min=torch.tensor(-2.0), u_max=torch.tensor(2.0), seed=seed,
                num_elites=num_elites, device=device)
    state = torch.tensor([math.pi, 0.0], device=device)  # hanging down
    cost_sum = 0.0
    for _ in range(steps):
        action = ctrl.command(state)
        state = pendulum_dynamics(state[None], action[None])[0]
        cost_sum += float(pendulum_running_cost(state[None], action[None])[0])
    return abs(float(angle_normalize(state[0]))), cost_sum


def main(argv=None, device=None):
    """The A/B over ``--seeds`` seeds; returns the rows ``(num_elites, mean
    accumulated cost, its standard deviation)``, the baseline first."""
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=16,
                   help="deliberately starved K (the reference's flagship uses 100+)")
    p.add_argument("--elites", type=int, default=4)
    p.add_argument("--horizon", type=int, default=25)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seeds", type=int, default=5)
    args = p.parse_args(argv)
    device = resolve_device(device, "elite_reuse")

    rows = []
    for elites in (0, args.elites):
        costs = [swing_up(args.samples, elites, args.horizon, args.steps, s, device)[1]
                 for s in range(args.seeds)]
        rows.append((elites, float(np.mean(costs)), float(np.std(costs))))
        logger.info("K=%d num_elites=%d: mean accumulated cost %.1f +- %.1f (%d seeds)",
                    args.samples, elites, rows[-1][1], rows[-1][2], args.seeds)

    (_, cost_base, std_base), (_, cost_el, std_el) = rows
    print(f"RESULT base_cost={cost_base:.1f} elite_cost={cost_el:.1f} "
          f"base_std={std_base:.1f} elite_std={std_el:.1f}")
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")
    rows = main()
    # the elite-reuse controller must beat the baseline at starved K
    assert rows[1][1] < rows[0][1], rows
