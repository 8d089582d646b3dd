"""Built-in models: the gym pendulum (true dynamics, cost, environment) and
the 2-D navigation task of the SMPPI/KMPPI comparison."""
from .pendulum import (
    PENDULUM_MODEL,
    PendulumEnv,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)
from .toy2d import HillCost, LinearDeltaDynamics, LQRCost, Toy2DEnvironment

__all__ = [
    "PENDULUM_MODEL",
    "PendulumEnv",
    "pendulum_dynamics",
    "pendulum_running_cost",
    "angle_normalize",
    "LinearDeltaDynamics",
    "LQRCost",
    "HillCost",
    "Toy2DEnvironment",
]
