"""Closed-loop experiment runner (counterpart of ``pytorch_mppi_tpu/runner.py``'s
``run_mppi``; reference ``mppi.py:876-898``)."""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def run_mppi(mppi, env, retrain_dynamics, retrain_after_iter=50, iter=1000, render=True):
    """Run a closed-loop control experiment.

    :param mppi: a controller exposing ``command``/``nx``/``nu``/``dtype``
    :param env: gym-style env with ``unwrapped.state``, ``step``, ``render``
    :param retrain_dynamics: callable(dataset (R, nx+nu)) for online learning
    :returns: (total_reward, dataset)
    """
    dtype = mppi.dtype
    dataset = torch.zeros((retrain_after_iter, mppi.nx + mppi.nu), dtype=dtype)
    total_reward = 0.0
    for i in range(iter):
        state = np.array(env.unwrapped.state).copy()
        command_start = time.perf_counter()
        action = mppi.command(state)
        # the copy to the host waits for the device, so the logged latency
        # covers the whole command (reference mppi.py:884)
        action_np = action.cpu().numpy()
        elapsed = time.perf_counter() - command_start
        res = env.step(action_np)
        s, r = res[0], res[1]
        total_reward += r
        logger.debug(
            "action taken: %.4f cost received: %.4f time taken: %.5fs",
            float(np.ravel(action_np)[0]), -r, elapsed,
        )
        if render:
            env.render()

        di = i % retrain_after_iter
        if di == 0 and i > 0:
            retrain_dynamics(dataset)
            dataset = torch.zeros_like(dataset)
        dataset[di] = torch.cat([
            torch.as_tensor(state, dtype=dtype).reshape(-1),
            torch.as_tensor(action_np, dtype=dtype).reshape(-1),
        ])
    return total_reward, dataset
