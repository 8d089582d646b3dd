"""Built-in models: the gym pendulum (true dynamics, cost, environment), the
2-D navigation task of the SMPPI/KMPPI comparison, and the learned
residual-dynamics MLP with its training step."""
from .mlp import (
    make_residual_dynamics,
    make_train_step,
    mlp_apply,
    mlp_init,
    train_epochs,
)
from .pendulum import (
    PENDULUM_MODEL,
    PendulumEnv,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)
from .toy2d import HillCost, LinearDeltaDynamics, LQRCost, ScaledLinearDynamics, Toy2DEnvironment

__all__ = [
    "PENDULUM_MODEL",
    "PendulumEnv",
    "pendulum_dynamics",
    "pendulum_running_cost",
    "angle_normalize",
    "LinearDeltaDynamics",
    "LQRCost",
    "ScaledLinearDynamics",
    "HillCost",
    "Toy2DEnvironment",
    "mlp_init",
    "mlp_apply",
    "make_residual_dynamics",
    "make_train_step",
    "train_epochs",
]
