"""2-D navigation task: linear-delta dynamics, LQR and Gaussian-hill costs.

The counterpart of ``pytorch_mppi_tpu/models/toy2d.py`` (the environment of
the reference's SMPPI/KMPPI comparison, ``tests/smooth_mppi.py:30-115``).
``Toy2DEnvironment.dynamics`` and ``Toy2DEnvironment.running_cost`` carry the
fused kernel's toy2d model (``env.kernel_model``), so ``SMPPI(env.dynamics,
env.running_cost, ..., use_pallas=True)`` runs the CUDA kernel on the card.
Like the controllers, the environment lives on the card unless it is given
``device="cpu"``.  Its drawing (``start_visualization``, ``draw_costs``,
``draw_rollouts``, ``draw_trajectory``, ``save_figure``) is the JAX
environment's, headless (matplotlib's Agg backend).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernel_models import toy2d_model
from ..utils.batch import batch_quadratic_product, handle_batch_input
from ..utils.device import resolve_device


class LinearDeltaDynamics:
    """x' = x + u Bᵀ  (smooth_mppi.py:30-37)."""

    def __init__(self, B):
        self.B = torch.as_tensor(B)

    @handle_batch_input(n=2)
    def __call__(self, state, action):
        return state + action @ self.B.to(state.device, state.dtype).T


class LQRCost:
    """dxᵀ Q dx + uᵀ R u toward a goal (smooth_mppi.py:50-62)."""

    def __init__(self, Q, R, goal):
        self.Q = torch.as_tensor(Q)
        self.R = torch.as_tensor(R)
        self.goal = torch.as_tensor(goal)

    @handle_batch_input(n=2)
    def __call__(self, state, action=None):
        dx = self.goal.to(state.device, state.dtype) - state
        c = batch_quadratic_product(dx, self.Q.to(state.device, state.dtype))
        if action is not None:
            c = c + batch_quadratic_product(action, self.R.to(state.device, state.dtype))
        return c


class HillCost:
    """Gaussian cost hill c0·exp(−(x − c)ᵀ Q (x − c))  (smooth_mppi.py:65-76)."""

    def __init__(self, Q, center, cost_at_center=1.0):
        self.Q = torch.as_tensor(Q)
        self.center = torch.as_tensor(center)
        self.cost_at_center = cost_at_center

    @handle_batch_input(n=2)
    def __call__(self, state, action=None):
        dx = self.center.to(state.device, state.dtype) - state
        d = batch_quadratic_product(dx, self.Q.to(state.device, state.dtype))
        return self.cost_at_center * torch.exp(-d)


class Toy2DEnvironment:
    """The 2-D navigation task (smooth_mppi.py:79-200): LQR goal cost plus a
    repulsive hill, linear-delta dynamics, a scaled terminal cost."""

    def __init__(self, start=None, goal=None, dtype=torch.float32, device=None,
                 terminal_scale=100.0, r=0.01):
        self.dtype = dtype
        self.device = resolve_device(device, "Toy2DEnvironment")
        self.nx = 2
        self.state_ranges = [(-5, 5), (-5, 5)]
        t = dict(dtype=dtype, device=self.device)
        self.start = (torch.as_tensor(start, **t) if start is not None
                      else torch.tensor([-3.0, -2.0], **t))
        self.goal = (torch.as_tensor(goal, **t) if goal is not None
                     else torch.tensor([2.0, 2.0], **t))
        self.state = self.start

        eye = torch.eye(2, **t)
        hill_Q = torch.tensor([[0.1, 0.05], [0.05, 0.1]], **t) * 2.5
        hill_center = torch.tensor([-0.5, -1.0], **t)
        # a cost "hill" for difficulty (smooth_mppi.py:106-108)
        self.costs = [LQRCost(eye, eye * r, self.goal),
                      HillCost(hill_Q, hill_center, cost_at_center=200.0)]
        B = torch.tensor([[0.5, 0.0], [0.0, -0.5]], **t)
        self.dynamics = LinearDeltaDynamics(B)
        self.terminal_scale = terminal_scale

        def running_cost(state, action=None):
            c = None
            for cost in self.costs:
                ci = cost(state, action)
                c = ci if c is None else c + ci
            return c

        # a function, not a bound method, so that it can carry the kernel model
        self.running_cost = running_cost
        self.kernel_model = toy2d_model(self.dynamics, self.running_cost, B.cpu(),
                                        self.goal.cpu(), r, hill_Q.cpu(),
                                        hill_center.cpu(), 200.0)

    def terminal_cost(self, states, actions):
        """Scaled running cost of the last state (smooth_mppi.py pattern)."""
        return self.terminal_scale * self.running_cost(states[..., -1, :])

    # -- visualization (reference smooth_mppi.py:127-235; PNG output instead of
    #    interactive windows so it runs headless) ------------------------------

    def start_visualization(self):
        """Create the cost-landscape figure (matplotlib required)."""
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        self.fig, self.ax = plt.subplots(figsize=(7, 7))
        self.ax.set_aspect("equal")
        self.ax.set(xlim=self.state_ranges[0], ylim=self.state_ranges[1])
        self.draw_costs()
        self.ax.scatter([float(self.start[0])], [float(self.start[1])],
                        color="tab:blue", label="start")
        self.ax.scatter([float(self.goal[0])], [float(self.goal[1])],
                        color="tab:green", label="goal")
        self.ax.legend()
        return self.fig

    def draw_costs(self, resolution=0.1):
        """Contour plot of the running-cost landscape (smooth_mppi.py:209-235)."""
        xs = np.arange(*self.state_ranges[0], resolution)
        ys = np.arange(*self.state_ranges[1], resolution)
        XX, YY = np.meshgrid(xs, ys)
        pts = torch.as_tensor(np.stack([XX.ravel(), YY.ravel()], axis=1), dtype=self.dtype,
                              device=self.device)
        val = self.running_cost(pts).cpu().numpy().reshape(XX.shape)
        c = self.ax.contourf(
            XX, YY, val,
            levels=[2, 4, 8, 16, 24, 32, 40, 50, 60, 80, 100, 150, 200, 250],
            cmap="Greys",
        )
        self.ax.contour(XX, YY, val, levels=c.levels, colors="k",
                        linestyles="dashed", linewidths=0.5)
        return c

    def draw_rollouts(self, rollouts, color="skyblue"):
        """Overlay candidate rollouts (R, T, 2), tensors or arrays
        (smooth_mppi.py:199-208)."""
        start = self.start.cpu().numpy()[None]
        for rollout in torch.as_tensor(rollouts).cpu().numpy():
            r = np.concatenate([start, rollout], axis=0)
            self.ax.plot(r[:, 0], r[:, 1], color=color, linewidth=0.8)
            self.ax.scatter(r[-1, 0], r[-1, 1], color="tab:red", s=8)

    def draw_trajectory(self, states, color="tab:orange", label=None):
        s = torch.as_tensor(states).cpu().numpy()
        self.ax.plot(s[:, 0], s[:, 1], color=color, linewidth=2, label=label)

    def save_figure(self, path):
        self.fig.savefig(path, dpi=120, bbox_inches="tight")
        return path

    def reset(self):
        self.state = self.start
        return self.state.cpu().numpy(), {}

    def step(self, action):
        state = self.state.reshape(1, -1)
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device).reshape(1, -1)
        cost = float(self.running_cost(state, action)[0])
        self.state = self.dynamics(state, action)[0]
        return self.state.cpu().numpy(), -cost, False, False, {}

    @property
    def unwrapped(self):
        return self

    def render(self):
        pass

