"""2-D navigation task: linear-delta dynamics, LQR and Gaussian-hill costs.

The counterpart of ``pytorch_mppi_tpu/models/toy2d.py`` (the environment of
the reference's SMPPI/KMPPI comparison, ``tests/smooth_mppi.py:30-115``).
``Toy2DEnvironment.dynamics`` and ``Toy2DEnvironment.running_cost`` carry the
fused kernel's toy2d model (``env.kernel_model``), so ``SMPPI(env.dynamics,
env.running_cost, ..., use_pallas=True)`` runs the CUDA kernel on the card.
Like the controllers, the environment lives on the card unless it is given
``device="cpu"``.  The drawing of the JAX environment is not ported here.
"""
from __future__ import annotations

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

