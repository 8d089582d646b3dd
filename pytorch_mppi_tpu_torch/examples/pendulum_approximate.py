"""Pendulum swing-up with a learned MLP dynamics model retrained online (the
counterpart of ``examples/pendulum_approximate.py``, reference
``tests/pendulum_approximate.py``): a 2×32-tanh residual network, a
100-step random bootstrap, then Adam retraining on the whole dataset every
50 steps while MPPI plans with the model.

The weights are the controller's ``dynamics_params``, so each retrain swaps
them between commands; that runs the plain path (a kernel's device model
holds its weights as constants: ``examples/fused_kernel_demo.py`` plans
with them closed in).  ``continuous=True`` feeds the network (sin θ, cos θ)
in place of θ (``pendulum_approximate_continuous.py``).

Run: python -m pytorch_mppi_tpu_torch.examples.pendulum_approximate
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from pytorch_mppi_tpu_torch import MPPI, run_mppi
from pytorch_mppi_tpu_torch.models import (
    PendulumEnv,
    angle_normalize,
    make_residual_dynamics,
    make_train_step,
    mlp_init,
    pendulum_dynamics,
    pendulum_running_cost,
    train_epochs,
)
from pytorch_mppi_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

ACTION_LOW, ACTION_HIGH = -2.0, 2.0


def main(timesteps: int = 30, num_samples: int = 1000, iters: int = 300,
         train_epoch: int = 150, bootstrap_iter: int = 100, retrain_after_iter: int = 50,
         h_units: int = 32, validation: int = 1000, seed: int = 25,
         continuous: bool = False, device=None) -> dict:
    """Bootstrap, train, then run ``iters`` closed-loop steps with a
    retrain every ``retrain_after_iter``; returns the total reward, the
    final wrapped angle and the model's validation error (the mean norm of
    its angle-aware one-step error against the true dynamics)."""
    device = resolve_device(device, "pendulum_approximate")
    dtype = torch.float32
    nx, nu = 2, 1
    encode = (0,) if continuous else ()
    # the network's input: (θ or sin θ, cos θ), θ̇, u
    params = mlp_init([nx + len(encode) + nu, h_units, h_units, nx],
                      torch.Generator().manual_seed(seed), dtype, device)
    dynamics = make_residual_dynamics(nx, nu, u_clip=(ACTION_LOW, ACTION_HIGH),
                                      angle_wrap_dims=(0,), angle_encode_dims=encode)
    train_step, init_opt = make_train_step(nx=nx, angle_diff_dims=(0,),
                                           angle_encode_dims=encode)

    # validation set against the true dynamics (reference
    # pendulum_approximate.py:108-116)
    rng = np.random.RandomState(seed)
    statev = torch.tensor(np.concatenate([(rng.rand(validation, 1) - 0.5) * 2 * np.pi,
                                          (rng.rand(validation, 1) - 0.5) * 16], axis=1),
                          dtype=dtype, device=device)
    actionv = torch.tensor((rng.rand(validation, 1) - 0.5) * (ACTION_HIGH - ACTION_LOW),
                           dtype=dtype, device=device)

    def val_error(p):
        diff = dynamics(p, statev, actionv) - pendulum_dynamics(statev, actionv)
        diff = torch.cat([angle_normalize(diff[:, :1]), diff[:, 1:]], dim=1)
        return float(torch.linalg.norm(diff, dim=1).mean())

    env = PendulumEnv(downward_start=True, seed=seed)
    ctrl = MPPI(dynamics, pendulum_running_cost, nx=nx, noise_sigma=torch.tensor(1.0),
                num_samples=num_samples, horizon=timesteps, lambda_=1.0,
                u_min=torch.tensor(ACTION_LOW), u_max=torch.tensor(ACTION_HIGH),
                seed=seed, dynamics_params=params, device=device)

    # the growing dataset of (state, action) rows, angle-normalised as the
    # reference's train() (pendulum_approximate.py:118-134): the network
    # sees the wrapped angles the controller feeds it
    dataset = [None]

    def train(new_data):
        nd = np.asarray(new_data, dtype=np.float64).copy()
        nd[:, 0] = angle_normalize(nd[:, 0])
        nd[:, -1] = np.clip(nd[:, -1], ACTION_LOW, ACTION_HIGH)
        dataset[0] = nd if dataset[0] is None else np.concatenate([dataset[0], nd], 0)
        xu = torch.tensor(dataset[0], dtype=dtype, device=device)
        batch = (xu[:-1, :nx], xu[:-1, nx:], xu[1:, :nx])
        # a fresh optimizer each retrain, on the whole dataset (the reference's)
        p, _, _ = train_epochs(train_step, ctrl.dynamics_params,
                               init_opt(ctrl.dynamics_params), batch, train_epoch)
        ctrl.dynamics_params = p
        logger.info("ds %d; val error %.4f", xu.shape[0], val_error(p))

    # bootstrap with random actions (reference pendulum_approximate.py:169-189)
    new_data = np.zeros((bootstrap_iter, nx + nu))
    s = np.array(env.state)
    for i in range(bootstrap_iter):
        a = rng.uniform(ACTION_LOW, ACTION_HIGH)
        new_data[i, :nx], new_data[i, nx:] = s, a
        s = pendulum_dynamics(torch.tensor(s, dtype=dtype)[None],
                              torch.tensor([[a]], dtype=dtype))[0].numpy()
    train(new_data)
    env.reset()

    total_reward, _ = run_mppi(ctrl, env, train, retrain_after_iter=retrain_after_iter,
                               iter=iters, render=False)
    theta = float(angle_normalize(env.state[0]))
    err = val_error(ctrl.dynamics_params)
    logger.info("Total reward %f; final angle %.4f rad", total_reward, theta)
    print(f"RESULT total_reward={total_reward:.2f} final_angle={theta:.4f} val_error={err:.4f}")
    return dict(total_reward=float(total_reward), final_angle=theta, val_error=err,
                dataset_rows=int(dataset[0].shape[0]))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
