"""Learned MLP dynamics planned through the fused CUDA kernel (the
counterpart of ``examples/fused_kernel_demo.py``).

A [3, 32, 32, 2] residual MLP (u clipped to ±2, the angle wrapped) is
trained for 300 full-batch epochs on 8,192 random pendulum transitions,
then its weights are closed into ``residual_mlp_model`` and MPPI (K =
10,000, T = 30, σ = 10·I, λ = 1, bounds ±2) swings the pendulum up from
[π, 1] for 150 commands: with ``use_pallas=True`` each command is one
launch of kernel A running the network on the card, and on the plain path
the same model in torch ops.  Retraining mid-flight needs the weights as
``dynamics_params``, which runs the plain path
(``examples/pendulum_approximate.py``).

Run: python -m pytorch_mppi_tpu_torch.examples.fused_kernel_demo
"""
from __future__ import annotations

import math
import time

import torch

from pytorch_mppi_tpu_torch import MPPI
from pytorch_mppi_tpu_torch.models import (
    angle_normalize,
    make_train_step,
    mlp_init,
    pendulum_dynamics,
)
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops.kernel_models import residual_mlp_model
from pytorch_mppi_tpu_torch.utils.device import resolve_device

SIZES = [3, 32, 32, 2]


def train_model(epochs: int = 300, transitions: int = 8192, seed: int = 0, device=None):
    """The residual pendulum model trained on ``transitions`` random
    transitions of the true dynamics: ``(params, last loss)``."""
    device = resolve_device(device, "fused_kernel_demo")
    g = torch.Generator().manual_seed(seed)
    params = mlp_init(SIZES, g, torch.float32, device)

    def uniform(lo, hi):
        return (torch.rand(transitions, 1, generator=g) * (hi - lo) + lo).to(device)

    states = torch.cat([uniform(-math.pi, math.pi), uniform(-8.0, 8.0)], dim=1)
    actions = uniform(-2.0, 2.0)
    batch = (states, actions, pendulum_dynamics(states, actions))
    train_step, init_opt = make_train_step(nx=2, angle_diff_dims=(0,))
    opt_state = init_opt(params)
    for _ in range(epochs):
        params, opt_state, loss = train_step(params, opt_state, batch)
    return params, float(loss)


def kernel_model(params):
    """The residual model with ``params`` closed in, as a kernel model."""
    return residual_mlp_model(params, 2, 1, u_clip=(-2.0, 2.0), angle_wrap_dims=(0,))


def planner(params, use_pallas, num_samples: int = 10_000, horizon: int = 30, seed: int = 42,
            device=None) -> MPPI:
    """MPPI on the model with ``params`` closed in (a kernel model, so that
    ``use_pallas=True`` runs kernel A; ``"rollout"`` the legacy pair)."""
    model = kernel_model(params)
    device = resolve_device(device, "fused_kernel_demo")
    return MPPI(model.dynamics, model.running_cost, 2,
                torch.eye(1, device=device) * 10.0, num_samples=num_samples,
                horizon=horizon, lambda_=1.0, u_min=torch.tensor(-2.0),
                u_max=torch.tensor(2.0), seed=seed, use_pallas=use_pallas, device=device)


def run_closed(ctrl: MPPI, commands: int = 150) -> dict:
    """Swing up from [π, 1] for ``commands`` commands on the true plant:
    the host time a command (after one warm-up command, ended by a copy to
    the host), the final |wrapped angle| and the kernel A launches."""
    s = torch.tensor([math.pi, 1.0], device=ctrl.d)
    ctrl.command(s)  # builds and warms up
    before = FS.launches["mppi"]
    t0 = time.perf_counter()
    for _ in range(commands):
        a = ctrl.command(s)
        s = pendulum_dynamics(s[None], a[None])[0]
    angle = abs(float(angle_normalize(s[0])))  # waits for the card
    per = (time.perf_counter() - t0) / commands
    return dict(ms_per_command=per * 1e3, final_angle=angle,
                launches=FS.launches["mppi"] - before, state=s)


def main(epochs: int = 300, transitions: int = 8192, num_samples: int = 10_000,
         horizon: int = 30, commands: int = 150, device=None) -> dict:
    """Train, then plan on the plain path and through the kernel; returns
    each loop's results and the model's loss."""
    params, loss = train_model(epochs, transitions, device=device)
    print(f"model loss after {epochs} epochs: {loss:.5f}")
    out = dict(loss=loss)
    for name, use_pallas in (("plain", False), ("fused", True)):
        ctrl = planner(params, use_pallas, num_samples, horizon, device=device)
        r = out[name] = run_closed(ctrl, commands)
        print(f"{name:5s} path: {r['ms_per_command']:7.2f} ms/command | final |angle| "
              f"{r['final_angle']:.3f} | kernel A launches {r['launches']}")
    return out


if __name__ == "__main__":
    result = main()
    assert result["fused"]["final_angle"] < 0.5 and result["plain"]["final_angle"] < 0.5, \
        "swing-up failed"
