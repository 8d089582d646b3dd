"""The dynamics bridge between user models and the fused CUDA kernel.

The JAX package evaluates any traceable dynamics inside its fused kernel by
interpreting the traced jaxpr batch-axis-last (``pytorch_mppi_tpu/ops/
batch_last.py``).  A CUDA kernel cannot evaluate a Python callable, so the port
names its models instead (the linear-quadratic, pendulum, toy2d and
residual-MLP models): a :class:`KernelModel` pairs a C++ device model
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
RESIDUAL_MLP = 3

# csrc/fused_mppi.cu's ResidualMLP: the floats of its constants' header, its
# compile-time bounds on a layer's width and on the layers, and the outputs
# a thread computes together (the padded widths of the weights' rows)
MLP_HEAD = 16
MLP_MAX_WIDTH = 64
MLP_MAX_LAYERS = 4
MLP_GROUP = 8
MLP_COSTS = ("pendulum", "quadratic")


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


def mlp_header(consts: torch.Tensor) -> dict:
    """What ``ResidualMLP``'s header says: the layer ``widths`` (the inputs,
    then each layer's outputs), ``clip``, the ``wrap`` and ``encode``
    state dimensions, and the ``cost``."""
    layers = int(consts[0])

    def bits(v):
        return tuple(d for d in range(int(v).bit_length()) if int(v) >> d & 1)

    return dict(widths=[int(w) for w in consts[1:2 + min(layers, MLP_MAX_LAYERS)]],
                layers=layers, clip=bool(consts[6]), wrap=bits(consts[9]),
                encode=bits(consts[10]), cost=MLP_COSTS[int(consts[11])])


def _mlp_consts(params, nx: int, nu: int, u_clip, angle_wrap_dims, angle_encode_dims,
                cost: str, goal) -> torch.Tensor:
    """The float32 constants of ``ResidualMLP``: a header of ``MLP_HEAD``
    floats (the layer count L, the L + 1 widths, the clip flag and bounds,
    the wrap and encode masks as bits of the state dimensions, the cost, 0
    for the pendulum's or 1 for the quadratic's, and its goal), then each
    layer's W as (n_in, p) rows and b as p floats, p = n_out rounded up to
    ``MLP_GROUP`` with zeros.  Fields a model beyond the kernel's bounds
    cannot hold are left out: such a model never reaches the kernel
    (``fused_solve.check_kernel_model``)."""
    widths = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params]
    head = torch.zeros(MLP_HEAD)
    head[0] = len(params)
    for i, w in enumerate(widths[:MLP_MAX_LAYERS + 1]):
        head[1 + i] = w
    if u_clip is not None:
        head[6:9] = torch.tensor([1.0, float(u_clip[0]), float(u_clip[1])])
    head[9] = sum(1 << d for d in angle_wrap_dims)
    head[10] = sum(1 << d for d in angle_encode_dims)
    head[11] = MLP_COSTS.index(cost)
    if cost == "quadratic":
        head[12:12 + min(nx, 2)] = goal[:2]
    blocks = [head]
    for W, b in params:
        n_in, n_out = W.shape
        pad = -(-n_out // MLP_GROUP) * MLP_GROUP
        Wp = torch.zeros(n_in, pad)
        Wp[:, :n_out] = W.detach().float().cpu()
        bp = torch.zeros(pad)
        bp[:n_out] = b.detach().float().cpu()
        blocks += [Wp.reshape(-1), bp]
    return torch.cat(blocks)


def residual_mlp_model(params, nx: int, nu: int, u_clip=None, angle_wrap_dims=(),
                       angle_encode_dims=(), cost: str = "pendulum", goal=None) -> KernelModel:
    """The learned residual model of ``models/mlp.py`` with its weights
    closed in, as a kernel model: the plain ``dynamics(state, action)`` is
    ``make_residual_dynamics(nx, nu, u_clip, angle_wrap_dims,
    angle_encode_dims)`` on a snapshot of ``params`` (``[(W (n_in, n_out),
    b (n_out,)), ...]``), as JAX bakes a closure's weights into its kernel,
    and the kernel runs ``csrc/fused_mppi.cu``'s ``ResidualMLP`` on the
    same weights in float32.  ``cost`` is ``"pendulum"`` (the gym
    pendulum's running cost, ``models/pendulum.py``; nx = 2) or
    ``"quadratic"`` (``‖goal − x'‖²``, ``goal`` (nx,)).

    The kernels take up to ``MLP_MAX_LAYERS`` layers of up to
    ``MLP_MAX_WIDTH`` units and nx, nu ≤ 2; a larger model plans on the
    plain path with a warning.  Retraining between commands needs the
    weights as ``dynamics_params``, which takes the plain path."""
    from ..models.mlp import make_residual_dynamics

    if cost not in MLP_COSTS:
        raise ValueError(f"cost must be one of {MLP_COSTS}, got {cost!r}")
    params = [(W.detach().clone(), b.detach().clone()) for W, b in params]
    wrap, encode = tuple(angle_wrap_dims), tuple(angle_encode_dims)
    n_in = nx + len(encode) + nu
    widths = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params] if params else []
    if (not params or widths[0] != n_in or widths[-1] != nx
            or any(W.shape != (a, c) or b.shape != (c,)
                   for (W, b), a, c in zip(params, widths, widths[1:]))):
        raise ValueError(
            f"residual_mlp_model needs layers [(W (n_in, n_out), b (n_out,)), ...] from "
            f"{n_in} inputs (nx + encoded dims + nu) to nx = {nx} outputs; got "
            f"{[tuple(W.shape) for W, _ in params]}")
    if not set(wrap + encode) <= set(range(nx)):
        raise ValueError(f"angle dims {wrap}, {encode} must be state dims of nx = {nx}")
    if cost == "pendulum" and nx != 2:
        raise ValueError("the pendulum cost needs nx = 2")
    if cost == "quadratic":
        goal = torch.as_tensor(goal, dtype=torch.float32).cpu()
        if goal.shape != (nx,):
            raise ValueError(f"the quadratic cost needs goal (nx,) = ({nx},)")
    dyn = make_residual_dynamics(nx, nu, u_clip, wrap, encode)
    on = {}

    def weights(device, dtype):
        key = (device, dtype)
        if key not in on:  # copied once, so that a CUDA graph captures no copy
            on[key] = [(W.to(device, dtype), b.to(device, dtype)) for W, b in params]
        return on[key]

    def dynamics(state, action):
        return dyn(weights(state.device, state.dtype), state, action)

    if cost == "pendulum":
        from ..models.pendulum import pendulum_running_cost

        def running_cost(state, action):  # its own function: _tag marks it
            return pendulum_running_cost(state, action)
    else:
        goals = {}

        def running_cost(state, action):
            key = (state.device, state.dtype)
            if key not in goals:
                goals[key] = goal.to(state.device, state.dtype)
            return ((goals[key] - state) ** 2).sum(dim=-1)

    consts = _mlp_consts(params, nx, nu, u_clip, wrap, encode, cost, goal)
    return _tag(KernelModel("residual_mlp", RESIDUAL_MLP, nx, nu, consts, dynamics,
                            running_cost))


_PLAIN = {}  # the models plain_model rebuilt, by id, sizes and constants


def plain_model(model_id: int, consts: torch.Tensor, nx: int, nu: int) -> KernelModel:
    """The kernel model that ``model_id`` and its constants name, rebuilt
    from them alone (a process that holds none of the user's code, as the
    operators of ``ops/library.py`` run a deployed command): its plain
    ``dynamics`` and ``running_cost`` compute what the constructors above
    give on the same constants, in the same operations.  The pendulum's
    constants are compiled into the kernel: it is ``models/pendulum.py``'s
    model."""
    consts = consts.detach().to("cpu", torch.float32)
    key = (int(model_id), int(nx), int(nu), consts.numpy().tobytes())
    model = _PLAIN.get(key)
    if model is not None:
        return model
    c = consts.tolist()
    if model_id == LINEAR_QUADRATIC:
        model = linear_quadratic(consts[:nx * nu].reshape(nx, nu), consts[nx * nu:nx * nu + nx])
    elif model_id == PENDULUM:
        from ..models.pendulum import PENDULUM_MODEL as model
    elif model_id == TOY2D:
        from ..models.toy2d import HillCost, LinearDeltaDynamics, LQRCost

        o = nx * nu
        B, goal, r = consts[:o].reshape(nx, nu), consts[o:o + nx], c[o + nx]
        Q = consts[o + nx + 1:o + nx + 1 + nx * nx].reshape(nx, nx)
        center, hill = consts[o + nx + 1 + nx * nx:o + 2 * nx + 1 + nx * nx], c[-1]
        eye = torch.eye(nx)
        costs = [LQRCost(eye, eye * r, goal), HillCost(Q, center, cost_at_center=hill)]

        def running_cost(state, action=None):
            return costs[0](state, action) + costs[1](state, action)

        model = toy2d_model(LinearDeltaDynamics(B), running_cost, B, goal, r, Q, center, hill)
    elif model_id == RESIDUAL_MLP:
        head = mlp_header(consts)
        params, at = [], MLP_HEAD
        for n_in, n_out in zip(head["widths"], head["widths"][1:]):
            pad = -(-n_out // MLP_GROUP) * MLP_GROUP
            W = consts[at:at + n_in * pad].reshape(n_in, pad)[:, :n_out].contiguous()
            b = consts[at + n_in * pad:at + n_in * pad + n_out].clone()
            params.append((W, b))
            at += n_in * pad + pad
        model = residual_mlp_model(
            params, nx, nu, u_clip=(c[7], c[8]) if head["clip"] else None,
            angle_wrap_dims=head["wrap"], angle_encode_dims=head["encode"], cost=head["cost"],
            goal=consts[12:12 + nx] if head["cost"] == "quadratic" else None)
    else:
        raise ValueError(f"no device model has id {model_id}")
    _PLAIN[key] = model
    return model


def plain_terminal(consts: torch.Tensor, nx: int) -> KernelTerminal:
    """The kernel terminal cost its constants name (``quadratic_terminal``'s
    goal and weights), rebuilt from them alone as :func:`plain_model`."""
    c = consts.detach().to("cpu", torch.float32)
    return quadratic_terminal(c[:nx], float(c[nx]), float(c[nx + 1])).kernel_terminal
