"""Gradient-refined MPPI: rescue a sample-starved controller with autodiff
(the counterpart of ``examples/gradient_refinement.py``).

``gradient_refinement_steps=N`` descends the nominal sequence on the exact
rollout cost after the sampling stage: projected Adam, with
``torch.autograd`` through the same rollout the sampler used (cf. the
Gauss-Newton-accelerated MPPI line of work, arXiv:2512.04579).

This example A/Bs the pendulum swing-up (the reference's flagship
configuration, ``tests/pendulum.py``) at a deliberately starved sample
count, on the plain path.

Run: python -m pytorch_mppi_tpu_torch.examples.gradient_refinement
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


def swing_up(num_samples, refine_steps, refine_lr, steps, seed, device=None):
    """One swing-up from [π, 1]; returns the final |wrapped angle| and the
    accumulated running cost."""
    device = resolve_device(device, "gradient_refinement")
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor(10.0), num_samples=num_samples, horizon=15,
                lambda_=1.0, u_min=torch.tensor(-2.0), u_max=torch.tensor(2.0), seed=seed,
                gradient_refinement_steps=refine_steps, gradient_refinement_lr=refine_lr,
                device=device)
    state = torch.tensor([math.pi, 1.0], device=device)  # hanging down
    cost_sum = 0.0
    for _ in range(steps):
        action = ctrl.command(state)
        state = pendulum_dynamics(state[None], action[None])[0]
        cost_sum += float(pendulum_running_cost(state[None], action[None])[0])
    return abs(float(angle_normalize(state[0]))), cost_sum


def main(argv=None, device=None):
    """The A/B over ``--seeds`` seeds; returns the rows ``(refine_steps,
    mean final |angle|, mean accumulated cost)``, the baseline first."""
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=5,
                   help="deliberately starved K (the reference's flagship uses 100+)")
    p.add_argument("--refine-steps", type=int, default=10)
    p.add_argument("--refine-lr", type=float, default=0.2)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--seeds", type=int, default=3)
    args = p.parse_args(argv)
    device = resolve_device(device, "gradient_refinement")

    rows = []
    for refine in (0, args.refine_steps):
        angles, costs = zip(*(swing_up(args.samples, refine, args.refine_lr, args.steps, s,
                                       device) for s in range(args.seeds)))
        rows.append((refine, float(np.mean(angles)), float(np.mean(costs))))
        logger.info("K=%d refine_steps=%d: mean final |angle| %.4f rad, mean accumulated cost "
                    "%.1f (%d seeds)", args.samples, refine, rows[-1][1], rows[-1][2],
                    args.seeds)

    (_, angle_base, cost_base), (_, angle_ref, cost_ref) = rows
    print(f"RESULT base_angle={angle_base:.4f} refined_angle={angle_ref:.4f} "
          f"base_cost={cost_base:.1f} refined_cost={cost_ref:.1f}")
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")
    rows = main()
    # the refined starved-K controller must complete the swing-up
    assert rows[1][1] < 0.25, rows
