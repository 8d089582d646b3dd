"""JAX's ``tests/test_models.py`` classes ``TestPendulum`` (:30-64) and
``TestToy2D`` (:168-197) on the port, on the CPU, in float64 with JAX's
floors: the pendulum swing-up from hanging, the ``run_mppi`` loop's
contract, and the 2-D navigation task.  ``TestLearnedDynamics`` stands in
``test_torch_mlp.py``, ``test_scaled_linear_dynamics`` in
``test_torch_controller.py`` and ``TestDifferentiableClosedLoop`` in
``test_torch_differentiable.py``.  The port's draws are its own, so a floor
holds the port's closed loop, not JAX's.
"""
import math

import numpy as np
import torch

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.models import (
    PendulumEnv,
    Toy2DEnvironment,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)

torch.set_num_threads(1)

SEED = 42
F64 = torch.float64


def _pendulum(num_samples, horizon):
    return P.MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                  noise_sigma=torch.tensor(10.0, dtype=F64), num_samples=num_samples,
                  horizon=horizon, lambda_=1.0, u_min=torch.tensor(-2.0),
                  u_max=torch.tensor(2.0), seed=SEED, device="cpu")


class TestPendulum:
    def test_swing_up_true_dynamics(self):
        """The flagship acceptance problem (nx = 2, nu = 1, K = 100, T = 15,
        sigma = 10, bounds ±2): the pendulum swings up from hanging."""
        ctrl = _pendulum(100, 15)
        state = torch.tensor([math.pi, 1.0], dtype=F64)
        angles = []
        for _ in range(120):
            a = ctrl.command(state)
            state = pendulum_dynamics(state[None], a[None])[0]
            angles.append(abs(float(angle_normalize(state[0]))))
        assert np.mean(angles[-20:]) < 0.3, f"no swing-up: tail angle {np.mean(angles[-20:])}"

    def test_run_mppi_loop(self):
        """The ``run_mppi`` loop: a finite reward, a dataset of
        (retrain_after_iter, nx + nu), retrained at i = 10 and i = 20."""
        env = PendulumEnv(downward_start=True)
        ctrl = _pendulum(50, 10)
        calls = []
        total_reward, dataset = P.run_mppi(ctrl, env, lambda ds: calls.append(ds.shape),
                                           retrain_after_iter=10, iter=25, render=False)
        assert np.isfinite(total_reward)
        assert dataset.shape == (10, 3)
        assert len(calls) == 2


class TestToy2D:
    def test_env_and_mppi(self):
        env = Toy2DEnvironment(dtype=F64, device="cpu")
        ctrl = P.MPPI(env.dynamics, env.running_cost, nx=2, noise_sigma=torch.eye(2, dtype=F64),
                      num_samples=300, horizon=15, lambda_=1.0, seed=SEED,
                      terminal_state_cost=env.terminal_cost, device="cpu")
        state = torch.as_tensor(env.start)
        for _ in range(25):
            a = ctrl.command(state)
            state = env.dynamics(state[None], a[None])[0]
        assert float(torch.linalg.norm(state - env.goal)) < 1.5

    def test_env_step_api(self):
        env = Toy2DEnvironment(dtype=F64, device="cpu")
        env.reset()
        obs2, reward, term, trunc, _ = env.step(np.array([0.1, 0.1]))
        assert obs2.shape == (2,)
        assert np.isfinite(reward)
