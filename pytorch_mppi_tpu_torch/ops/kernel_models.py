"""The dynamics bridge between user models and the fused CUDA kernel.

The JAX package evaluates any traceable dynamics inside its fused kernel by
interpreting the traced jaxpr batch-axis-last (``pytorch_mppi_tpu/ops/
batch_last.py``).  A CUDA kernel cannot evaluate a Python callable, so the port
names these models (the linear-quadratic, pendulum, toy2d and
residual-MLP models, the last in two forms: one thread a sample, or its
layers split over a block's threads): a :class:`KernelModel` pairs a C++ device model
compiled into ``csrc/fused_mppi.cu`` (selected by ``model_id``, fed the float32
``consts``) with the plain torch ``dynamics`` and ``running_cost`` that compute
the same thing.  The plain pair is what the controller is given, what the
plain solve path runs, and what the kernel's plain version runs on the CPU.

:func:`find_kernel_model` recovers the model from a ``(dynamics,
running_cost)`` pair; any other pair is traced into a generated device
model by ``ops/batch_last.py`` (the port's counterpart of JAX's
``batch_last.py``), and one the tracer refuses takes the plain path with a
warning.

Final-state terminal costs are named the same way: :func:`quadratic_terminal`
returns a plain torch ``terminal_final_cost`` tagged with the
:class:`KernelTerminal` the kernels evaluate after the last rollout step
(JAX traces any terminal cost into its kernel, ``pallas_rollout.py:349-372``);
:func:`find_kernel_terminal` recovers it; any other callable is traced by
``ops/batch_last.py``, and one the tracer refuses takes the plain path
with a warning.
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
RESIDUAL_MLP_BLOCK = 4  # the residual MLP with its layers split over a block's threads
GENERATED = 1000  # and above: the generated kernels of ops/batch_last.py

# csrc/fused_mppi.cu's ResidualMLP: the floats of its constants' header and
# the goal's offset in it, its compile-time bounds on a layer's width, on
# the layers and on nx and nu, and the outputs a thread computes together
# (the padded widths of the weights' rows)
MLP_HEAD = 20
MLP_GOAL = 12
MLP_MAX_WIDTH = 64
MLP_MAX_LAYERS = 4
MLP_MAX_N = 8
MLP_GROUP = 8
MLP_COSTS = ("pendulum", "quadratic")
# csrc/fused_mppi.cu's ResidualMLPBlock: the fixed floats of its constants'
# header, and the least group of a block model's samples whose layers the
# block computes together (its activations' rows; DENSE_ROWS): half an m16
# tile of the tensor cores' products, taken only where a whole tile,
# DENSE_TILE rows, does not fit (fused_solve.activation_rows)
BMLP_FIXED = 8
DENSE_ROWS = 8
DENSE_TILE = 16


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

    def rollout_step(self, state, action, t: int):
        """One step of the plain rollout: ``(next state, its running cost)``
        at step ``t``, which a named model does not read."""
        state = self.dynamics(state, action)
        return state, self.running_cost(state, action)


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
    ``‖goal − x'‖² + r‖u‖² + c0·exp(−(c − x')ᵀ Q_h (c − x'))``.  The
    constants may be on any device (the functions' own, as
    :func:`linear_quadratic`'s); they are kept on the CPU."""
    def flat(v):
        return torch.as_tensor(v, dtype=torch.float32).detach().reshape(-1).cpu()

    nx, nu = torch.as_tensor(B).shape
    consts = torch.cat([flat(B), flat(goal), torch.tensor([float(r)]), flat(hill_Q),
                        flat(hill_center), torch.tensor([float(hill_cost)])])
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
    for the pendulum's or 1 for the quadratic's, and from ``MLP_GOAL`` on
    its goal's nx floats), then each layer's W as (n_in, p) rows and b as p
    floats, p = n_out rounded up to ``MLP_GROUP`` with zeros.  Fields a
    model beyond the kernel's bounds cannot hold are left out: such a model
    never reaches the kernel (``fused_solve.check_kernel_model``)."""
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
        n = min(nx, MLP_MAX_N)
        head[MLP_GOAL:MLP_GOAL + n] = goal[:n]
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
                       angle_encode_dims=(), cost: str = "pendulum", goal=None,
                       block: bool = None) -> KernelModel:
    """The learned residual model of ``models/mlp.py`` with its weights
    closed in, as a kernel model: the plain ``dynamics(state, action)`` is
    ``make_residual_dynamics(nx, nu, u_clip, angle_wrap_dims,
    angle_encode_dims)`` on a snapshot of ``params`` (``[(W (n_in, n_out),
    b (n_out,)), ...]``), as JAX bakes a closure's weights into its kernel,
    and the kernel runs ``csrc/fused_mppi.cu``'s ``ResidualMLP`` on the
    same weights in float32.  ``cost`` is ``"pendulum"`` (the gym
    pendulum's running cost, ``models/pendulum.py``; nx = 2) or
    ``"quadratic"`` (``‖goal − x'‖²``, ``goal`` (nx,)).

    Two device models run it.  Within ``MLP_MAX_LAYERS`` layers of at
    most ``MLP_MAX_WIDTH`` units and nx, nu ≤ ``MLP_MAX_N`` (8)
    (:func:`per_thread_bounds`) it is ``ResidualMLP``, one thread a sample
    (``model_id`` ``RESIDUAL_MLP``); beyond them ``ResidualMLPBlock``
    (``RESIDUAL_MLP_BLOCK``), whose layers a block's threads compute
    together: nx, nu ≤ 32, any number of layers, and widths bounded only by
    shared memory (two activation rows of the widest layer for each of at
    least ``DENSE_ROWS`` samples beside the kernel's own use,
    ``fused_solve.check_kernel_model``, which names the bound).  The two
    compute the same function (the block model's layers on the tensor
    cores in 3xTF32, its sums in another order); ``block=True`` forces the
    block model on a small one (to compare them).  A larger model plans on
    the plain path with a warning.  Retraining between commands needs the
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

    # ``t``: a step_dependent_dynamics config passes the timestep, which the
    # model does not read (and which keeps it off the kernels: a named model
    # takes none, fused_solve.check_kernel_model)
    def dynamics(state, action, t=None):
        weights = _on_device(on, state, lambda *key: [(W.to(*key), b.to(*key))
                                                      for W, b in params])
        return dyn(weights, state, action)

    if cost == "pendulum":
        from ..models.pendulum import pendulum_running_cost

        def running_cost(state, action, t=None):  # its own function: _tag marks it
            return pendulum_running_cost(state, action)
    else:
        goals = {}

        def running_cost(state, action, t=None):
            return ((_on_device(goals, state, goal.to) - state) ** 2).sum(dim=-1)

    if block is None:
        block = not per_thread_bounds(widths, nx, nu)
    if block:
        consts = _block_mlp_consts(params, nx, u_clip, wrap, encode, cost, goal)
        return _tag(KernelModel("residual_mlp_block", RESIDUAL_MLP_BLOCK, nx, nu, consts,
                                dynamics, running_cost))
    consts = _mlp_consts(params, nx, nu, u_clip, wrap, encode, cost, goal)
    return _tag(KernelModel("residual_mlp", RESIDUAL_MLP, nx, nu, consts, dynamics,
                            running_cost))


def per_thread_bounds(widths, nx: int, nu: int) -> bool:
    """Whether ``ResidualMLP`` (one thread a sample) takes a network of these
    layer ``widths`` (the inputs, then each layer's outputs): at most
    ``MLP_MAX_LAYERS`` layers of at most ``MLP_MAX_WIDTH`` units, nx, nu ≤
    ``MLP_MAX_N``."""
    return (len(widths) - 1 <= MLP_MAX_LAYERS and max(widths) <= MLP_MAX_WIDTH
            and max(nx, nu) <= MLP_MAX_N)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def block_mlp_head(layers: int, nx: int) -> int:
    """Floats of ``ResidualMLPBlock``'s constants before the first layer's
    weights (``bmlp_head`` in fused_mppi.cu)."""
    return _pad4(BMLP_FIXED + layers + 1 + 2 * nx)


def _block_mlp_consts(params, nx: int, u_clip, angle_wrap_dims, angle_encode_dims, cost: str,
                      goal) -> torch.Tensor:
    """The float32 constants of ``ResidualMLPBlock``: a header of
    ``BMLP_FIXED`` floats (the layer count L, the clip flag and bounds, the
    cost, 0 for the pendulum's or 1 for the quadratic's, three zeros), the
    L + 1 widths, a flag for each state dimension (bit 0: wrapped, bit 1:
    encoded as sin, cos), the quadratic cost's goal (nx floats; zeros for
    the pendulum's), zeros to :func:`block_mlp_head`, then each layer's W as
    (n_in, p) rows and b as p floats, p = n_out rounded up to four with
    zeros."""
    widths = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params]
    L = len(params)
    head = torch.zeros(block_mlp_head(L, nx))
    head[0] = L
    if u_clip is not None:
        head[1:4] = torch.tensor([1.0, float(u_clip[0]), float(u_clip[1])])
    head[4] = MLP_COSTS.index(cost)
    at = BMLP_FIXED
    head[at:at + L + 1] = torch.tensor(widths, dtype=torch.float32)
    at += L + 1
    for d in range(nx):
        head[at + d] = (1 if d in angle_wrap_dims else 0) + (2 if d in angle_encode_dims else 0)
    if cost == "quadratic":
        head[at + nx:at + 2 * nx] = goal
    blocks = [head]
    for W, b in params:
        n_in, n_out = W.shape
        pad = _pad4(n_out)
        Wp = torch.zeros(n_in, pad)
        Wp[:, :n_out] = W.detach().float().cpu()
        bp = torch.zeros(pad)
        bp[:n_out] = b.detach().float().cpu()
        blocks += [Wp.reshape(-1), bp]
    return torch.cat(blocks)


def block_mlp_header(consts: torch.Tensor, nx: int) -> dict:
    """What ``ResidualMLPBlock``'s constants say (the keys of
    :func:`mlp_header`, the clip's bounds, the goal, the offset of the
    first layer's weights)."""
    c = consts.detach().to("cpu", torch.float32)
    L = int(c[0])
    widths = [int(w) for w in c[BMLP_FIXED:BMLP_FIXED + L + 1]]
    flags = [int(f) for f in c[BMLP_FIXED + L + 1:BMLP_FIXED + L + 1 + nx]]
    at = BMLP_FIXED + L + 1 + nx
    return dict(widths=widths, layers=L, clip=bool(c[1]), lo=float(c[2]), hi=float(c[3]),
                wrap=tuple(d for d, f in enumerate(flags) if f & 1),
                encode=tuple(d for d, f in enumerate(flags) if f & 2),
                cost=MLP_COSTS[int(c[4])], goal=c[at:at + nx].clone(),
                weights=block_mlp_head(L, nx))


def mlp_layout(model: KernelModel) -> dict:
    """The layer ``widths``, ``layers``, ``clip``, ``wrap``, ``encode`` and
    ``cost`` of either residual-MLP device model."""
    if model.model_id == RESIDUAL_MLP_BLOCK:
        return block_mlp_header(model.consts, model.nx)
    return mlp_header(model.consts)


def activation_ld(model: KernelModel) -> int:
    """Floats of an activation row of a block model (its widest layer,
    rounded up to four): ``ResidualMLPBlock``'s, or a generated model's
    with dense layers (``ops/batch_last.py``); 0 for a per-sample model."""
    if model.model_id == RESIDUAL_MLP_BLOCK:
        return _pad4(max(block_mlp_header(model.consts, model.nx)["widths"]))
    ld = getattr(model, "activation_ld", None)
    return ld() if callable(ld) else 0


def _on_device(cache: dict, state: torch.Tensor, make: Callable):
    """``make(device, dtype)`` for ``state``'s device and dtype, made once
    and kept in ``cache`` (so that a CUDA graph captures no copy), or made
    anew while ``state`` belongs to a trace (``ops/batch_last.py`` traces the
    user's callables with ``make_fx`` over ``functionalize``;
    ``torch.export`` runs on fake tensors): a tensor of the trace must not
    outlive it in the cache."""
    key = (state.device, state.dtype)
    hit = cache.get(key)
    if hit is None:
        hit = make(*key)
        if not (torch._C._functorch.is_functorch_wrapped_tensor(state)
                or isinstance(state, torch._subclasses.fake_tensor.FakeTensor)):
            cache[key] = hit
    return hit


_PLAIN = {}  # the models plain_model rebuilt, by id, sizes and constants


def plain_model(model_id: int, consts: torch.Tensor, nx: int, nu: int) -> KernelModel:
    """The kernel model that ``model_id`` and its constants name, rebuilt
    from them alone (a process that holds none of the user's code, as the
    operators of ``ops/library.py`` run a deployed command): its plain
    ``dynamics`` and ``running_cost`` compute what the constructors above
    give on the same constants, in the same operations.  The pendulum's
    constants are compiled into the kernel: it is ``models/pendulum.py``'s
    model.  A generated id (``GENERATED`` and above) names an entry of
    ``ops/batch_last.py``'s registry: a model this process traced, or one
    a loaded deploy artifact carried (``batch_last.load_kernel``); its
    constants are part of the id, so ``consts`` is not read."""
    if model_id >= GENERATED:  # a traced or loaded model (ops/batch_last.py)
        from .batch_last import kernel_of

        return kernel_of(model_id).model
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
    elif model_id == RESIDUAL_MLP_BLOCK:
        head = block_mlp_header(consts, nx)
        params, at = [], head["weights"]
        for n_in, n_out in zip(head["widths"], head["widths"][1:]):
            pad = _pad4(n_out)
            W = consts[at:at + n_in * pad].reshape(n_in, pad)[:, :n_out].contiguous()
            b = consts[at + n_in * pad:at + n_in * pad + n_out].clone()
            params.append((W, b))
            at += n_in * pad + pad
        model = residual_mlp_model(
            params, nx, nu, u_clip=(head["lo"], head["hi"]) if head["clip"] else None,
            angle_wrap_dims=head["wrap"], angle_encode_dims=head["encode"], cost=head["cost"],
            goal=head["goal"] if head["cost"] == "quadratic" else None, block=True)
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
            goal=consts[MLP_GOAL:MLP_GOAL + nx] if head["cost"] == "quadratic" else None,
            block=False)
    else:
        raise ValueError(f"no device model has id {model_id}")
    _PLAIN[key] = model
    return model


def plain_terminal(consts: torch.Tensor, nx: int) -> KernelTerminal:
    """The kernel terminal cost its constants name (``quadratic_terminal``'s
    goal and weights), rebuilt from them alone as :func:`plain_model`."""
    c = consts.detach().to("cpu", torch.float32)
    return quadratic_terminal(c[:nx], float(c[nx]), float(c[nx + 1])).kernel_terminal
