"""Closed-loop experiment runners (counterpart of ``pytorch_mppi_tpu/runner.py``).

:func:`run_mppi_jit` runs a whole closed loop against a plant written in
torch: on the CPU as an eager loop, on the card as a CUDA graph of one loop
step (the command's device body, the plant steps and the cost), replayed
once a command after the command's host prologue.  :func:`run_mppi` drives a
gym-style environment (reference ``mppi.py:876-898``).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .config import BatchedState
from .ops import fused_solve as FS
from .ops.solve import wrap_cost

logger = logging.getLogger(__name__)


def _spec(tree):
    """A hashable description of a pytree of tensors (None, a tensor, or a
    tuple, NamedTuple, list or dict of them): each tensor's shape, dtype and
    device, and every other leaf's value."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_spec(v) for v in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree), tuple(_spec(v) for v in tree.values()))
    return ("value", tree)


def _loop_spec(params, state, dyn_params):
    """What a captured loop step depends on beyond its buffers' values: the
    structure of the parameters, of the controller's state (its stream
    position aside, which the prologue reads) and of ``dynamics_params``."""
    return _spec(params), _spec(state._replace(seed=0, counter=0)), _spec(dyn_params)


def _tensors(tree) -> list:
    """The tensors of a pytree, in :func:`_spec`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by those of the
    iterator ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, tensors) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, tensors) for v in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    return tree


def _copy_into(dst, src):
    """Copy the tensors of the pytree ``src`` into those of ``dst``."""
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _clone(tree):
    return _rebuild(tree, (t.clone() for t in _tensors(tree)))


def _capture_into(graph, step):
    """Capture ``step()`` into the CUDA graph ``graph``, in the "relaxed"
    mode that chip_smoke.py's kernel timings capture the kernels in."""
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        step()


class _Loop:
    """One closed-loop step of a controller against a plant: the command's
    body, then its block of ``u_per_command`` actions applied in order, the
    running cost taken at the state after each plant step (JAX's
    ``runner.py:101-136``)."""

    def __init__(self, mppi, plant_dynamics, cost, steps: int):
        self.fns = mppi._fns
        self.plant, self.cost, self.steps = plant_dynamics, cost, steps
        self.upc, self.nu = int(mppi.u_per_command), mppi.nu
        self.n_iter = mppi.config.num_iterations
        self.batched = isinstance(mppi._state, BatchedState)
        self.N = mppi.N if self.batched else None

    def solve(self, params, state, x, dyn_params):
        """The command's device body at ``state``'s stream position."""
        if self.batched:
            return self.fns.body(params, state, x, dyn_params, True)
        return self.fns.body(params, state, x, None, dyn_params, True)

    def block(self, a):
        """The command's actions as ``u_per_command`` rows of plant actions:
        (upc, nu), or (upc, N, nu) for N plants."""
        if self.batched:
            return a.reshape(self.N, self.upc, self.nu).transpose(0, 1)
        return a.reshape(self.upc, self.nu)

    def apply(self, x, acc, a_j, j: int):
        """One plant step and its cost: ``(next state, accumulated cost)``."""
        x_next = self.plant(x, a_j)
        if self.batched:
            return x_next, acc + self.cost(x_next, a_j, j)
        return x_next, acc + self.cost(x_next[None], a_j[None], j)[0]

    def acc0(self, x):
        shape = (self.N,) if self.batched else ()
        return torch.zeros(shape, dtype=x.dtype, device=x.device)


class _EagerLoop(_Loop):
    """The closed loop as a Python loop of commands (the CPU)."""

    def __call__(self, params, state, x0, dyn_params):
        x, acc = x0, self.acc0(x0)
        xs, acts = [], []
        for _ in range(self.steps // self.upc):
            self.fns.streams.prologue(state.seed, state.counter, x0.device)
            state, a, _ = self.solve(params, state, x, dyn_params)
            for j, a_j in enumerate(self.block(a)):
                x, acc = self.apply(x, acc, a_j, j)
                xs.append(x)
                acts.append(a_j)
        return state, torch.stack(xs), torch.stack(acts), acc


class _GraphLoop(_Loop):
    """The closed loop as a CUDA graph of one loop step, replayed once a
    command.

    The graph reads and writes static buffers: the parameters, the
    controller state's tensors, ``dynamics_params``, the plant state, the
    accumulated cost and the (steps, ...) trajectories, which each replay
    writes at a slot that the graph itself advances on the device.  Before
    each replay the host runs the command's prologue (the kernels' keys
    and the generators' seeds, which the graph reads: the generators are
    registered with it), so every replay draws fresh noise.  A run starts
    by copying the controller's current parameters, state and
    ``dynamics_params`` into the buffers, and ends by giving the
    controller clones of the state buffers.  The launch counters of
    ``fused_solve.launches`` advance by the captured launches at each
    replay; warming up and capturing count nothing."""

    graph = None

    def _step(self):
        """The captured work: the command's body, its plant steps and
        their costs, written at the slot."""
        new_state, a, _ = self.solve(self.params, self.state, self.x, self.dyn_params)
        _copy_into(self.state, new_state)
        x, acc = self.x, self.acc
        for j, a_j in enumerate(self.block(a)):
            x, acc = self.apply(x, acc, a_j, j)
            self.xs.index_copy_(0, self.slot + j, x[None])
            self.acts.index_copy_(0, self.slot + j, a_j[None])
        self.x.copy_(x)
        self.acc.copy_(acc)
        self.slot.add_(self.upc)

    def _capture(self, params, state, x0, dyn_params):
        device = x0.device
        self.spec = _loop_spec(params, state, dyn_params)
        self.params, self.state = _clone(params), _clone(state)
        self.dyn_params, self.x = _clone(dyn_params), x0.clone()
        self.acc = self.acc0(x0)
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)
        a_shape = (self.N, self.nu) if self.batched else (self.nu,)
        self.xs = torch.empty((self.steps, *x0.shape), dtype=x0.dtype, device=device)
        self.acts = torch.empty((self.steps, *a_shape), dtype=x0.dtype, device=device)
        streams = self.fns.streams
        before = dict(FS.launches)
        # PyTorch's warm-up before a capture, on a side stream, on the
        # buffers alone: the controller's state is copied in again below
        streams.prologue(state.seed, state.counter, device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.slot.zero_()
                self._step()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in streams.on(device).generators():
            graph.register_generator_state(g)
        warm = dict(FS.launches)
        try:
            _capture_into(graph, self._step)
        except RuntimeError as e:
            raise RuntimeError(
                "run_mppi_jit could not capture this controller's command in a CUDA graph; "
                "see ROADMAP.md Queue 1 item 9a") from e
        finally:
            self.launched = {k: FS.launches[k] - warm[k] for k in FS.launches}
            FS.launches.update(before)
        self.graph = graph

    def __call__(self, params, state, x0, dyn_params):
        if self.graph is None or _loop_spec(params, state, dyn_params) != self.spec:
            self._capture(params, state, x0, dyn_params)
        _copy_into(self.params, params)
        _copy_into(self.state, state)
        _copy_into(self.dyn_params, dyn_params)
        self.x.copy_(x0)
        self.acc.zero_()
        self.slot.zero_()
        counter = state.counter
        for _ in range(self.steps // self.upc):
            self.fns.streams.prologue(state.seed, counter, x0.device)
            self.graph.replay()
            counter += self.n_iter
            for name, n in self.launched.items():
                FS.launches[name] += n
        end = _clone(self.state)._replace(counter=counter)
        return end, self.xs.clone(), self.acts.clone(), self.acc.clone()


def run_mppi_jit(mppi, plant_dynamics, x0, steps: int, running_cost=None):
    """Run a closed-loop control experiment against a plant written in torch
    (the counterpart of JAX's ``runner.run_mppi_jit``, which runs it as one
    jitted dispatch).

    With ``u_per_command > 1`` each command returns a block of actions that
    is applied to the plant in order (reference mppi.py:271-275); ``steps``
    counts plant steps and must be a multiple of ``u_per_command``.

    On the CPU the loop runs eagerly.  On the card it runs as a CUDA graph
    of one loop step (the command's device body, ``u_per_command`` plant
    steps and the cost), captured once and replayed once a command after
    the command's host prologue (``ops/solve.CommandStreams``), so every
    command draws the noise the eager ``command()`` loop would.  A
    configuration whose command cannot be captured raises.  The loop is
    cached per (plant, cost, steps, step functions) in
    ``mppi._runner_cache``; ``mppi.dynamics_params`` is read at every run
    (copied into the graph's buffers, or captured again when its structure
    changed), as are the controller's parameters and state.

    :param mppi: an MPPI, SMPPI or KMPPI controller, or MPPI_Batched (the N
        plants' loop, with a cost per plant)
    :param plant_dynamics: ``fn(state (nx,), action (nu,)) -> next state``;
        for a batched controller ``fn((N, nx), (N, nu)) -> (N, nx)``.  It
        may differ from the controller's model.
    :param x0: (nx,) initial plant state, (N, nx) for a batched controller
    :param steps: plant steps
    :param running_cost: ``fn(state, action) -> cost`` accumulated along the
        executed trajectory, at the state after each plant step.  Defaults
        to the controller's running cost; for ``step_dependent_dynamics``
        controllers it receives the action's index within its command's
        block as the time argument.
    :returns: (states (steps+1, nx), actions (steps, nu), total cost (0-d));
        batched: (states (steps+1, N, nx), actions (steps, N, nu), total
        cost (N,)).  The controller's state is advanced to the end of the
        run.
    """
    upc = int(mppi.u_per_command)
    if steps % upc != 0:
        raise ValueError(
            f"steps={steps} must be a multiple of u_per_command={upc}: each "
            f"solve commits a block of {upc} actions to the plant")
    cache = mppi.__dict__.setdefault("_runner_cache", {})
    key = (plant_dynamics, running_cost, int(steps), mppi._fns)
    loop = cache.get(key)
    if loop is None:
        if running_cost is None:
            # the controller's own cost, with the solve's resolution of
            # step-dependent signatures
            cost = wrap_cost(mppi.config, mppi.running_cost)
        else:
            cost = lambda s, u, t: running_cost(s, u)
        loop_cls = _GraphLoop if mppi.d.type == "cuda" else _EagerLoop
        loop = cache[key] = loop_cls(mppi, plant_dynamics, cost, int(steps))
    params = mppi._full_params() if hasattr(mppi, "_full_params") else mppi._params
    x0 = torch.as_tensor(x0, dtype=mppi.dtype, device=mppi.d)
    want = (mppi.N, mppi.nx) if isinstance(mppi._state, BatchedState) else (mppi.nx,)
    if tuple(x0.shape) != want:
        raise ValueError(f"x0 must have shape {want}, got {tuple(x0.shape)}")
    state, xs, actions, total = loop(params, mppi._state, x0, mppi.dynamics_params)
    mppi._state = state
    return torch.cat([x0[None], xs]), actions, total


def run_mppi(mppi, env, retrain_dynamics, retrain_after_iter=50, iter=1000, render=True):
    """Run a closed-loop control experiment.

    :param mppi: a controller exposing ``command``/``nx``/``nu``/``dtype``
    :param env: gym-style env with ``unwrapped.state``, ``step``, ``render``
    :param retrain_dynamics: callable(dataset (R, nx+nu)) for online learning
    :returns: (total_reward, dataset)
    """
    dtype = mppi.dtype
    dataset = torch.zeros((retrain_after_iter, mppi.nx + mppi.nu), dtype=dtype)
    total_reward = 0.0
    for i in range(iter):
        state = np.array(env.unwrapped.state).copy()
        command_start = time.perf_counter()
        action = mppi.command(state)
        # the copy to the host waits for the device, so the logged latency
        # covers the whole command (reference mppi.py:884)
        action_np = action.cpu().numpy()
        elapsed = time.perf_counter() - command_start
        res = env.step(action_np)
        s, r = res[0], res[1]
        total_reward += r
        logger.debug(
            "action taken: %.4f cost received: %.4f time taken: %.5fs",
            float(np.ravel(action_np)[0]), -r, elapsed,
        )
        if render:
            env.render()

        di = i % retrain_after_iter
        if di == 0 and i > 0:
            retrain_dynamics(dataset)
            dataset = torch.zeros_like(dataset)
        dataset[di] = torch.cat([
            torch.as_tensor(state, dtype=dtype).reshape(-1),
            torch.as_tensor(action_np, dtype=dtype).reshape(-1),
        ])
    return total_reward, dataset
