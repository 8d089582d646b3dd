"""Pendulum swing-up: true dynamics, running cost and a dependency-free environment.

The counterpart of ``pytorch_mppi_tpu/models/pendulum.py`` (gym's Pendulum-v1
physics, reference ``tests/pendulum.py:30-60``).  ``pendulum_dynamics`` and
``pendulum_running_cost`` carry the fused kernel's pendulum model
(:data:`PENDULUM_MODEL`), so ``MPPI(pendulum_dynamics, pendulum_running_cost,
..., use_pallas=True)`` runs the CUDA kernel on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.kernel_models import pendulum_model

G = 10.0
M = 1.0
L = 1.0
DT = 0.05
ACTION_LOW = -2.0
ACTION_HIGH = 2.0
MAX_SPEED = 8.0


def angle_normalize(x):
    """((x + pi) mod 2pi) - pi with a floored modulo (reference
    tests/pendulum.py:51-52); works on tensors, numpy arrays and floats."""
    if isinstance(x, torch.Tensor):
        return torch.remainder(x + math.pi, 2 * math.pi) - math.pi
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def pendulum_dynamics(state, action):
    """True gym pendulum dynamics on (K, 2) states / (K, 1) actions."""
    th = state[:, 0:1]
    thdot = state[:, 1:2]
    u = torch.clamp(action[:, 0:1], ACTION_LOW, ACTION_HIGH)
    newthdot = thdot + (3 * G / (2 * L) * torch.sin(th) + 3.0 / (M * L**2) * u) * DT
    newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
    newth = th + newthdot * DT
    return torch.cat((newth, newthdot), dim=1)


def pendulum_running_cost(state, action):
    """angle^2 + 0.1 thdot^2."""
    theta = state[:, 0]
    theta_dt = state[:, 1]
    return angle_normalize(theta) ** 2 + 0.1 * theta_dt**2


PENDULUM_MODEL = pendulum_model(pendulum_dynamics, pendulum_running_cost)


class PendulumEnv:
    """Minimal gym-style pendulum environment (reward = -cost of gym
    Pendulum-v1), the API ``run_mppi`` consumes: ``unwrapped.state``,
    ``step(action) -> (obs, reward, ...)``, ``reset``, ``render`` (no-op)."""

    def __init__(self, downward_start: bool = True, seed: int = 0):
        self._rng = np.random.RandomState(seed)
        self.downward_start = downward_start
        self.state = None
        self.reset()

    @property
    def unwrapped(self):
        return self

    def reset(self):
        if self.downward_start:
            self.state = np.array([np.pi, 1.0])
        else:
            self.state = np.array(
                [self._rng.uniform(-np.pi, np.pi), self._rng.uniform(-1, 1)]
            )
        return self._obs(), {}

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot])

    def step(self, action):
        u = float(np.clip(np.ravel(np.asarray(action))[0], ACTION_LOW, ACTION_HIGH))
        th, thdot = self.state
        cost = float(angle_normalize(th)) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3 * G / (2 * L) * np.sin(th) + 3.0 / (M * L**2) * u) * DT
        newthdot = np.clip(newthdot, -MAX_SPEED, MAX_SPEED)
        newth = th + newthdot * DT
        self.state = np.array([newth, newthdot])
        return self._obs(), -cost, False, False, {}

    def render(self):
        pass
