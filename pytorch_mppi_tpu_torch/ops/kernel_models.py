"""The dynamics bridge between user models and the fused CUDA kernel.

The JAX package evaluates any traceable dynamics inside its fused kernel by
interpreting the traced jaxpr batch-axis-last (``pytorch_mppi_tpu/ops/
batch_last.py``).  A CUDA kernel cannot evaluate a Python callable, so the port
names its models instead: a :class:`KernelModel` pairs a C++ device model
compiled into ``csrc/fused_mppi.cu`` (selected by ``model_id``, fed the float32
``consts``) with the plain torch ``dynamics`` and ``running_cost`` that compute
the same thing.  The plain pair is what the controller is given, what the
plain solve path runs, and what the kernel's plain version runs on the CPU.

:func:`find_kernel_model` recovers the model from a ``(dynamics,
running_cost)`` pair; any other callable has no kernel model, and
``use_pallas`` then takes the plain path with a warning.

Final-state terminal costs are named the same way: :func:`quadratic_terminal`
returns a plain torch ``terminal_final_cost`` tagged with the
:class:`KernelTerminal` the kernels evaluate after the last rollout step
(JAX traces any terminal cost into its kernel, ``pallas_rollout.py:349-372``);
:func:`find_kernel_terminal` recovers it, and any other callable takes the
plain path with a warning.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

# model ids of the device models in csrc/fused_mppi.cu
LINEAR_QUADRATIC = 0
PENDULUM = 1
TOY2D = 2


@dataclasses.dataclass(frozen=True, eq=False)
class KernelModel:
    """A dynamics + running-cost pair the fused kernel can evaluate.

    ``dynamics(state (K, nx), action (K, nu)) -> (K, nx)`` and
    ``running_cost(state, action) -> (K,)`` are the plain torch versions;
    the kernel runs the device model ``model_id`` with ``consts``."""

    name: str
    model_id: int
    nx: int
    nu: int
    consts: torch.Tensor  # float32, 1-D, on the CPU
    dynamics: Callable
    running_cost: Callable
    _device_consts: dict = dataclasses.field(default_factory=dict, repr=False)

    def consts_on(self, device) -> torch.Tensor:
        """The constants as a contiguous float32 tensor on ``device`` (copied
        once per device)."""
        return _consts_on(self.consts, self._device_consts, device)


def _consts_on(consts: torch.Tensor, cache: dict, device) -> torch.Tensor:
    device = torch.device(device)
    c = cache.get(device)
    if c is None:
        c = cache[device] = consts.to(device=device, dtype=torch.float32).contiguous()
    return c


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTerminal:
    """A final-state terminal cost the kernels can evaluate.

    ``cost(final_state (K, nx), final_action (K, nu)) -> (K,)`` is the plain
    torch version, given the last ``u_scale``-scaled action as JAX's
    ``terminal_final_cost``; the kernels run ``csrc/fused_mppi.cu``'s
    ``quadratic_terminal`` with ``consts``."""

    name: str
    nx: int
    consts: torch.Tensor  # float32, 1-D, on the CPU
    cost: Callable
    _device_consts: dict = dataclasses.field(default_factory=dict, repr=False)

    def consts_on(self, device) -> torch.Tensor:
        """The constants as a contiguous float32 tensor on ``device`` (copied
        once per device)."""
        return _consts_on(self.consts, self._device_consts, device)


def _tag(model: KernelModel) -> KernelModel:
    model.dynamics.kernel_model = model
    model.running_cost.kernel_model = model
    return model


def find_kernel_model(dynamics, running_cost) -> Optional[KernelModel]:
    """The kernel model both callables belong to, or None."""
    m = getattr(dynamics, "kernel_model", None)
    if m is not None and getattr(running_cost, "kernel_model", None) is m:
        return m
    return None


def find_kernel_terminal(terminal_final_cost) -> Optional[KernelTerminal]:
    """The kernel terminal cost a ``terminal_final_cost`` callable carries,
    or None."""
    return getattr(terminal_final_cost, "kernel_terminal", None)


def quadratic_terminal(goal, w_state: float, w_action: float) -> Callable:
    """The final-state terminal cost ``w_state·‖x_T − goal‖² +
    w_action·‖u_T‖²`` as a plain torch ``terminal_final_cost(final_state
    (K, nx), final_action (K, nu)) -> (K,)``, tagged with its
    :class:`KernelTerminal` (``.kernel_terminal``) so that ``use_pallas``
    keeps the fused kernel.  ``goal`` is (nx,) (a tensor or a numpy array);
    ``final_action`` is the last ``u_scale``-scaled action."""
    goal = torch.as_tensor(goal, dtype=torch.float32).cpu()
    if goal.ndim != 1:
        raise ValueError(f"quadratic_terminal needs goal (nx,), got {tuple(goal.shape)}")
    w_state, w_action = float(w_state), float(w_action)

    def terminal_final_cost(state, action):
        g = goal.to(state.device, state.dtype)
        return w_state * ((state - g) ** 2).sum(dim=-1) + w_action * (action ** 2).sum(dim=-1)

    consts = torch.cat([goal, torch.tensor([w_state, w_action])])
    terminal_final_cost.kernel_terminal = KernelTerminal(
        "quadratic_terminal", goal.numel(), consts, terminal_final_cost)
    return terminal_final_cost


def linear_quadratic(B, goal) -> KernelModel:
    """``x' = x + u Bᵀ`` with cost ``‖goal − x'‖²`` (the flagship problem of
    ``bench.py``).  ``B`` is (nx, nu), ``goal`` is (nx,)."""
    B = torch.as_tensor(B)
    goal = torch.as_tensor(goal)
    if B.ndim != 2 or goal.shape != (B.shape[0],):
        raise ValueError(
            f"linear_quadratic needs B (nx, nu) and goal (nx,); got "
            f"{tuple(B.shape)} and {tuple(goal.shape)}"
        )
    nx, nu = B.shape

    def dynamics(state, action):
        return state + action @ B.to(state.device, state.dtype).T

    def running_cost(state, action):
        return ((goal.to(state.device, state.dtype) - state) ** 2).sum(dim=-1)

    consts = torch.cat([B.reshape(-1), goal.reshape(-1)]).to(torch.float32).cpu()
    return _tag(KernelModel("linear_quadratic", LINEAR_QUADRATIC, nx, nu,
                            consts, dynamics, running_cost))


def pendulum_model(dynamics: Callable, running_cost: Callable) -> KernelModel:
    """Tag the gym pendulum's plain functions (``models/pendulum.py``) with
    the kernel's pendulum model; its constants are compiled into the kernel."""
    return _tag(KernelModel("pendulum", PENDULUM, 2, 1, torch.zeros(1),
                            dynamics, running_cost))


def toy2d_model(dynamics: Callable, running_cost: Callable, B, goal, r: float,
                hill_Q, hill_center, hill_cost: float) -> KernelModel:
    """Tag the 2-D navigation task's plain functions (``models/toy2d.py``)
    with the kernel's toy2d model: ``x' = x + u Bᵀ`` and the cost
    ``‖goal − x'‖² + r‖u‖² + c0·exp(−(c − x')ᵀ Q_h (c − x'))``."""
    B = torch.as_tensor(B, dtype=torch.float32)
    nx, nu = B.shape
    consts = torch.cat([
        B.reshape(-1), torch.as_tensor(goal, dtype=torch.float32).reshape(-1),
        torch.tensor([float(r)]),
        torch.as_tensor(hill_Q, dtype=torch.float32).reshape(-1),
        torch.as_tensor(hill_center, dtype=torch.float32).reshape(-1),
        torch.tensor([float(hill_cost)]),
    ]).cpu()
    if consts.numel() != nx * nu + 2 * nx + 2 + nx * nx:
        raise ValueError("toy2d_model needs goal (nx,), hill_Q (nx, nx) and hill_center (nx,)")
    return _tag(KernelModel("toy2d", TOY2D, nx, nu, consts, dynamics, running_cost))
