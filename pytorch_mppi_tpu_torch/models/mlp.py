"""Learned residual-dynamics MLP with online training.

The counterpart of ``pytorch_mppi_tpu/models/mlp.py`` (reference
``tests/pendulum_approximate.py:44-52,119-167``): a tanh MLP predicting the
state residual, retrained online with Adam on the (state, action) dataset
that ``run_mppi`` collects.

Parameters are JAX's layout, a list of ``(W (n_in, n_out), b (n_out,))``
tensors, passed first to the dynamics (``MPPI(..., dynamics_params=params)``),
so that a retrain swaps them between commands.  The training step is
functional, as JAX's: ``train_step(params, opt_state, batch)`` returns new
parameters and a new optimizer state (a ``torch.optim`` ``state_dict``) and
changes neither argument.  To plan with the weights inside the fused CUDA
kernels, close them into ``ops.kernel_models.residual_mlp_model``.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Optional, Sequence

import torch

from ..utils.device import resolve_device
from .pendulum import angle_normalize


def mlp_init(sizes: Sequence[int], generator: torch.Generator, dtype=torch.float32,
             device=None):
    """``[(W, b), ...]`` for the layer widths ``sizes``, each drawn uniform in
    ±1/√fan_in (the ``torch.nn.Linear`` scheme of the reference network),
    on ``generator``'s device and moved to ``device`` (``None``: the card)."""
    device = resolve_device(device, "mlp_init")
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(n_in)
        W, b = (torch.empty(shape, dtype=dtype, device=generator.device).uniform_(
            -bound, bound, generator=generator).to(device) for shape in ((n_in, n_out), (n_out,)))
        params.append((W, b))
    return params


def mlp_apply(params, x):
    """Tanh-hidden MLP forward: ``tanh(x W + b)`` for each layer but the
    last, which is linear."""
    for W, b in params[:-1]:
        x = torch.tanh(x @ W + b)
    W, b = params[-1]
    return x @ W + b


def encode_features(state, action, angle_encode_dims: Sequence[int] = ()):
    """The network's input: the state and the action, with each dimension
    of ``angle_encode_dims`` given as the pair (sin, cos) (the continuous
    angle of the reference's ``pendulum_approximate_continuous.py:60-74``)."""
    if not angle_encode_dims:
        return torch.cat((state, action), dim=1)
    cols = []
    for d in range(state.shape[1]):
        col = state[:, d:d + 1]
        cols += [torch.sin(col), torch.cos(col)] if d in angle_encode_dims else [col]
    cols.append(action)
    return torch.cat(cols, dim=1)


def make_residual_dynamics(nx: int, nu: int, u_clip=None,
                           angle_wrap_dims: Sequence[int] = (),
                           angle_encode_dims: Sequence[int] = ()) -> Callable:
    """``dynamics(params, state (B, nx), action (B, nu)) -> (B, nx)``: the
    state plus the MLP's residual.  The action is clipped to ``u_clip``; the
    dimensions of ``angle_wrap_dims`` are wrapped to [-π, π) on the way in
    (the network was trained on wrapped angles) and on the way out; the
    features are :func:`encode_features` of the wrapped state.  Pass it as
    ``MPPI(dynamics=fn, dynamics_params=params)``."""
    wrap = tuple(angle_wrap_dims)
    encode = tuple(angle_encode_dims)

    def wrap_cols(x):
        # the wrapped columns beside the others: an exact select, as JAX's
        # one-hot select, with no index tensor to copy to the device
        return torch.cat([angle_normalize(x[:, d:d + 1]) if d in wrap else x[:, d:d + 1]
                          for d in range(x.shape[1])], dim=1)

    def dynamics(params, state, action):
        u = action[:, :nu]
        if u_clip is not None:
            u = torch.clamp(u, u_clip[0], u_clip[1])
        if wrap:
            state = wrap_cols(state)
        next_state = state + mlp_apply(params, encode_features(state, u, encode))
        return wrap_cols(next_state) if wrap else next_state

    return dynamics


def _default_optimizer(params):
    # optax.adam(1e-3)'s b1, b2 and eps, and no eps_root
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(dynamics_loss: Optional[Callable] = None,
                    optimizer: Optional[Callable] = None, nx: int = 2,
                    angle_diff_dims: Sequence[int] = (),
                    angle_encode_dims: Sequence[int] = (), mesh=None,
                    data_axis: str = "data"):
    """``(train_step, init_opt)`` for the residual model on batches
    ``(state, action, next_state)``.

    The default loss is the mean squared error of the predicted residual
    against ``next_state − state``, that difference wrapped on
    ``angle_diff_dims``; ``angle_encode_dims`` must match the dynamics'.
    ``dynamics_loss(params, batch)`` replaces it.  ``optimizer(params) ->
    torch.optim.Optimizer`` builds the optimizer (default Adam at lr 1e-3,
    optax's ``adam(1e-3)``).  ``init_opt(params)`` returns the optimizer's
    initial ``state_dict``; ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` takes one step on copies and leaves its
    arguments as they were.

    With ``mesh`` (``parallel.make_mesh``) the step is data-parallel over
    the ranks of its ``data_axis`` (JAX's sharded batch, ``mlp.py:144-160``):
    each rank takes its equal slice of the batch's rows, and the gradients,
    each of a mean over the rank's rows, are averaged with one
    ``all_reduce`` before the optimizer's step, so every rank takes the step
    one process takes on the whole batch (a loss must be a mean over the
    rows); the returned loss is the whole batch's."""
    del nx  # the JAX signature's; the loss reads the shapes
    build = optimizer or _default_optimizer
    diff_dims = tuple(angle_diff_dims)
    encode = tuple(angle_encode_dims)

    def default_loss(params, batch):
        state, action, next_state = batch
        target = next_state - state
        if diff_dims:
            target = target.clone()
            for d in diff_dims:
                target[:, d] = angle_normalize(target[:, d])
        pred = mlp_apply(params, encode_features(state, action, encode))
        return torch.mean((pred - target) ** 2)

    loss_fn = dynamics_loss or default_loss

    def working_copy(params):
        return [(W.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True))
                for W, b in params]

    def init_opt(params):
        return build([t for layer in working_copy(params) for t in layer]).state_dict()

    rows = None if mesh is None else _DataSplit(mesh, data_axis)

    def train_step(params, opt_state, batch):
        work = working_copy(params)
        flat = [t for layer in work for t in layer]
        opt = build(flat)
        opt.load_state_dict(copy.deepcopy(opt_state))
        if rows is not None:
            batch = rows.take(batch)
        loss = loss_fn(work, batch)
        grads = torch.autograd.grad(loss, flat)
        if rows is not None:
            loss, grads = rows.mean(loss.detach(), grads)
        for t, g in zip(flat, grads):
            t.grad = g
        opt.step()
        new = [(W.detach(), b.detach()) for W, b in work]
        return new, opt.state_dict(), loss.detach()

    return train_step, init_opt


class _DataSplit:
    """The rows of a batch split over the ranks of a mesh axis, and the
    mean of the ranks' losses and gradients (one ``all_reduce``)."""

    def __init__(self, mesh, axis: str):
        from ..parallel import mesh as PM

        self.group = PM.axis_group(mesh, axis)
        self.rank, self.n = PM.axis_rank(mesh, axis), PM.axis_size(mesh, axis)

    def take(self, batch):
        rows = batch[0].shape[0]
        if rows % self.n:
            raise ValueError(f"a batch of {rows} rows does not split evenly over the "
                             f"{self.n} ranks of the data axis")
        chunk = rows // self.n
        return tuple(t.narrow(0, self.rank * chunk, chunk) for t in batch)

    def mean(self, loss, grads):
        import torch.distributed as dist

        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        flat = flat / self.n
        out, at = [], 1
        for g in grads:
            out.append(flat[at:at + g.numel()].reshape(g.shape))
            at += g.numel()
        return flat[0], out


def train_epochs(train_step: Callable, params, opt_state, batch, epochs: int):
    """Full-batch training for ``epochs`` steps (the reference trains 150
    epochs full-batch, ``pendulum_approximate.py:119-167``).  Returns
    ``(params, opt_state, losses (epochs,))``."""
    losses = []
    for _ in range(epochs):
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(loss)
    return params, opt_state, torch.stack(losses)
