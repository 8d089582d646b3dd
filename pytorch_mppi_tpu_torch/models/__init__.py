"""Built-in models: the gym pendulum (true dynamics, cost, environment)."""
from .pendulum import (
    PENDULUM_MODEL,
    PendulumEnv,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)

__all__ = [
    "PENDULUM_MODEL",
    "PendulumEnv",
    "pendulum_dynamics",
    "pendulum_running_cost",
    "angle_normalize",
]
