"""Pendulum swing-up with the true dynamics, through the ``run_mppi``
closed loop: nx = 2, nu = 1, K = 100, T = 15, σ = 10, bounds ±2
(the counterpart of ``examples/pendulum.py``, reference
``tests/pendulum.py``).  Gymnasium's ``Pendulum-v1`` is the plant when
gymnasium can be imported, else the built-in ``PendulumEnv``.

Run: python -m pytorch_mppi_tpu_torch.examples.pendulum
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from pytorch_mppi_tpu_torch import MPPI, run_mppi
from pytorch_mppi_tpu_torch.models import (
    PendulumEnv,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)

logger = logging.getLogger(__name__)


def make_env():
    """Gymnasium's Pendulum-v1 from the downward state [π, 1] (the
    reference's env, ``tests/pendulum.py:68-72``), else ``PendulumEnv``."""
    try:
        import gymnasium as gym
    except ImportError:
        return PendulumEnv(downward_start=True)
    env = gym.make("Pendulum-v1").unwrapped
    env.reset()
    env.state = np.array([np.pi, 1.0])
    return env


def main(steps: int = 200, num_samples: int = 100, horizon: int = 15, seed: int = 7,
         device=None, use_pallas=False) -> dict:
    """Swing the pendulum up for ``steps`` steps; returns the total reward
    and the final wrapped angle."""
    env = make_env()
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor(10.0), num_samples=num_samples, horizon=horizon,
                lambda_=1.0, u_min=torch.tensor(-2.0), u_max=torch.tensor(2.0), seed=seed,
                use_pallas=use_pallas, device=device)
    total_reward, _ = run_mppi(ctrl, env, lambda dataset: None, iter=steps, render=False)
    theta = float(angle_normalize(env.state[0]))
    logger.info("Total reward %f; final angle %.4f rad", total_reward, theta)
    print(f"RESULT total_reward={total_reward:.2f} final_angle={theta:.4f}")
    return dict(total_reward=float(total_reward), final_angle=theta)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
