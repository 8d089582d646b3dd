"""Ahead-of-time export of a controller's command for serving (counterpart
of ``pytorch_mppi_tpu/utils/deploy.py``).

:func:`export_solver` exports the device body of the controller's command
(``ops/solve.StepFns.body``, which the host prologue ``CommandStreams``
precedes) with ``torch.export``, once with the nominal-trajectory shift and
once without, and writes both programs with the controller's current
parameters and state into ONE self-describing file (``utils/checkpoint``'s
format).  A serving process loads it with :func:`load_solver` and runs it
with none of the user's code: the dynamics and costs are operations of the
programs, and the kernels are operators of the ``mppi_torch`` namespace,
which importing this package registers (``ops/library.py``).

    ctrl = MPPI(dynamics, running_cost, nx, sigma, ..., use_pallas=True)
    deploy.export_solver(ctrl, "solver.mppi.npz")

    # on the serving host (no dynamics or cost code anywhere):
    solver = deploy.load_solver("solver.mppi.npz")
    action = solver.command(x0)

Guarantees and limits:

- a program takes the parameters' tensors, the state's tensors (``U``,
  ``elites``, ``action_sequence``, ``theta``), ``x0`` and the
  ``dynamics_params`` tensors, then what the prologue made: on a kernel
  route the (n_iter, 2) int32 key buffer, on the plain path each
  iteration's N(0, 1) draws (what ``solve.standard_normal`` returns).  It
  returns the new state's tensors, the action and the artifacts;
- the state's ``seed`` and ``counter`` stay host ints: the
  :class:`ServingSolver` runs the port's own prologue on them, so its draws
  come in the live controller's order and it replays the live controller
  bit for bit;
- shapes, dtypes, the route and every configuration flag are fixed at
  export (the kernel's tile and plant group too); the parameters,
  ``dynamics_params`` and the state stay runtime inputs, each settable;
- an artifact exported on the card runs on the card, and loading it where
  there is no card raises: it is never moved to the CPU;
- a live ``info`` payload raises a ValueError (the exported body takes
  ``info=None``), a file of another version a ValueError;
- stochastic dynamics (their per-step generators are arguments of the
  user's code) and gradient refinement (``torch.autograd`` inside the body)
  cannot be exported yet: :func:`export_solver` raises
  ``NotImplementedError`` (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import io
import json
import logging
from typing import Optional

import numpy as np
import torch

from ..config import Artifacts, MPPIConfig
from ..ops import fused_solve as FS
from ..ops import library as _library
from ..ops.solve import CommandStreams
from . import checkpoint as _ckpt

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
_UNEXPORTABLE = "ROADMAP.md Queue 1 item 10"


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by those of the
    iterator ``tensors`` (the file's order: a dict's sorted keys)."""
    return _ckpt.map_tensors(tree, lambda _: next(tensors))


class _Command(torch.nn.Module):
    """One command's device body on a flat list of tensors: the parameters',
    the state's, ``x0``, the ``dynamics_params``' and the prologue's feeds
    (``CommandStreams.feeds``).  Returns the new state's tensors, the action
    and the artifacts that are not None, and records which are
    (``artifacts``)."""

    def __init__(self, fns, params, state, dyn_params, shift: bool, takes_info: bool):
        super().__init__()
        self.fns, self.shift, self.takes_info = fns, shift, takes_info
        self.params, self.state, self.dyn_params = params, state, dyn_params
        self.artifacts = None

    def forward(self, flat):
        it = iter(flat)
        params = _rebuild(self.params, it)
        state = _rebuild(self.state, it)
        x0 = next(it)
        dyn_params = _rebuild(self.dyn_params, it)
        with self.fns.streams.fed(x0.device, list(it)):
            if self.takes_info:
                new_state, action, artifacts = self.fns.body(params, state, x0, None,
                                                             dyn_params, self.shift)
            else:
                new_state, action, artifacts = self.fns.body(params, state, x0, dyn_params,
                                                             self.shift)
        self.artifacts = [a is not None for a in artifacts]
        return (*_ckpt.tensors(new_state), action, *(a for a in artifacts if a is not None))


class ServingSolver:
    """A loaded deployment artifact: the exported command, its parameters
    and its state.

    Mirrors the controller's ``command`` contract (reference
    mppi.py:240-252) with none of the user's code: the dynamics and costs
    live inside the exported programs.  ``params``, ``state`` and
    ``dyn_params`` may be replaced between commands with trees of the same
    structure and shapes (a tuner's parameters, a forked state, retrained
    weights)."""

    def __init__(self, program_shift, program_no_shift, params, state, dyn_params, meta):
        self._programs = {True: program_shift, False: program_no_shift}
        self._modules = {k: p.module() for k, p in self._programs.items()}
        self.meta = dict(meta)
        self.device = torch.device(meta["device"])
        self.dtype = getattr(torch, meta["dtype"])
        self._streams = CommandStreams(MPPIConfig(**meta["streams"], dtype=self.dtype),
                                       kernel_keys=meta["kernel_keys"], noise=meta["noise"])
        self.params, self.state, self.dyn_params = params, state, dyn_params
        # per-solve artifact surface, same names as the controller
        self.cost_total = None
        self.cost_total_non_zero = None
        self.omega = None
        self.noise = None
        self.perturbed_action = None
        self.states = None
        self.actions = None

    @property
    def programs(self) -> tuple:
        """The two ``torch.export.ExportedProgram``s: with the shift, without."""
        return self._programs[True], self._programs[False]

    def command(self, x0, shift_nominal_trajectory: bool = True):
        """One MPC solve; threads the state exactly as the live controller
        does."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        state = self.state
        feeds = self._streams.feeds(state.seed, state.counter, self.device)
        flat = [*_ckpt.tensors(self.params), *_ckpt.tensors(state), x0,
                *_ckpt.tensors(self.dyn_params), *feeds]
        out = iter(self._modules[bool(shift_nominal_trajectory)](flat))
        self.state = _rebuild(state, out)._replace(
            counter=state.counter + self.meta["streams"]["num_iterations"])
        action = next(out)
        artifacts = Artifacts(*(next(out) if present else None
                                for present in self.meta["artifacts"]))
        for name, value in artifacts._asdict().items():
            setattr(self, name, value)
        return action


def _route(ctrl) -> str:
    from .. import controller as _c

    if not ctrl._fns.fused:
        return "plain"
    if isinstance(ctrl, _c.MPPI_Batched):
        return "batched seed" if ctrl.use_pallas == "kernel_rng" else "batched operand"
    return "rollout" if ctrl.use_pallas == "rollout" else "fused"


def export_solver(ctrl, path: Optional[str] = None, x0_example=None) -> ServingSolver:
    """Export ``ctrl``'s command (+ current params/state) for serving.

    :param ctrl: a live ``MPPI``/``SMPPI``/``KMPPI``/``MPPI_Batched``, on
        any route (the plain path, the fused kernel, the legacy pair, the
        batched pair).
    :param path: optional ``.npz`` destination (written with the same
        self-describing format as ``utils.checkpoint``).
    :param x0_example: example state for the shapes; default zeros of
        ``(nx,)`` (``(N, nx)`` batched).  A ``(K, nx)`` example exports the
        per-sample-state entry point.
    :returns: the in-memory :class:`ServingSolver` (already usable).
    """
    from .. import controller as _c

    if getattr(ctrl, "info", None) is not None:
        raise ValueError(
            "export_solver freezes info=None into the artifact, but this "
            "controller carries a live info payload; serving-side samplers "
            "cannot receive per-call info through an exported program")
    if getattr(ctrl, "mesh", None) is not None:
        raise NotImplementedError(
            "export_solver cannot export a controller with a mesh yet (its command calls "
            "collectives); see ROADMAP.md Queue 1 item 12b")
    config = ctrl.config
    if config.stochastic_dynamics or config.gradient_refinement_steps:
        what = ("stochastic dynamics (their per-step generators are arguments of the "
                "dynamics)" if config.stochastic_dynamics else
                "gradient refinement (torch.autograd runs inside the command)")
        raise NotImplementedError(f"export_solver cannot export {what} yet; see {_UNEXPORTABLE}")
    batched = isinstance(ctrl, _c.MPPI_Batched)
    takes_info = not batched
    fns, device = ctrl._fns, ctrl.d
    shape = (ctrl.N, ctrl.nx) if batched else (ctrl.nx,)
    x0 = (torch.zeros(shape, dtype=ctrl.dtype, device=device) if x0_example is None
          else torch.as_tensor(x0_example, dtype=ctrl.dtype, device=device))
    params = ctrl._full_params() if hasattr(ctrl, "_full_params") else ctrl._params
    state, dyn_params = ctrl._state, ctrl.dynamics_params
    flat = [*_ckpt.tensors(params), *_ckpt.tensors(state), x0, *_ckpt.tensors(dyn_params),
            *fns.streams.feeds(state.seed, state.counter, device)]
    programs, launched = {}, dict(FS.launches)  # put back after the set-up runs
    try:
        with _library.exporting():
            for shift in (True, False):
                module = _Command(fns, params, state, dyn_params, shift, takes_info)
                # a run on the real tensors first: it fills every cache of
                # device constants with real tensors, which the trace then
                # takes as the program's constants
                module(flat)
                programs[shift] = torch.export.export(module, (flat,), strict=False)
                # the example inputs (the plain path's draws among them) stay
                # out of the file: the state and parameters are saved apart
                programs[shift].example_inputs = None
    finally:
        FS.launches.update(launched)
    meta = {
        "version": _FORMAT_VERSION,
        "class": type(ctrl).__name__,
        "route": _route(ctrl),
        "device": str(x0.device),
        "dtype": str(ctrl.dtype).removeprefix("torch."),
        "takes_info": takes_info,
        "torch_version": torch.__version__,
        "artifacts": module.artifacts,
        "kernel_keys": fns.streams.kernel_keys,
        "noise": fns.streams.noise,
        "streams": dict(nx=config.nx, nu=config.nu, K=config.K, T=config.T,
                        antithetic=config.antithetic,
                        num_support_pts=config.num_support_pts,
                        num_iterations=config.num_iterations),
    }
    solver = ServingSolver(programs[True], programs[False], params, state, dyn_params, meta)
    if path is not None:
        blobs = {}
        for shift, name in ((True, "blob_shift"), (False, "blob_no_shift")):
            buf = io.BytesIO()
            torch.export.save(programs[shift], buf)
            blobs[name] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        _ckpt.save(path, {"meta": json.dumps(meta), **blobs, "params": params,
                          "state": state, "dyn_params": dyn_params})
        logger.info("exported the %s command (%s route, %s) to %s", meta["class"],
                    meta["route"], meta["device"], path)
    return solver


def load_solver(path: str) -> ServingSolver:
    """Load an :func:`export_solver` artifact.  Requires no user code: the
    dynamics and costs are operations of the programs, the kernels
    operators that importing this package registered.  An artifact
    exported on the card needs a card."""
    tree = _ckpt.load(path)
    meta = json.loads(tree["meta"])
    if meta.get("version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported deploy-artifact version {meta.get('version')!r} "
            f"(this build reads version {_FORMAT_VERSION})")
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"this artifact was exported on {device} and runs there; no CUDA device is "
            f"available (it is never moved to the CPU: export it on the CPU to serve there)")
    programs = [torch.export.load(io.BytesIO(tree[name].numpy().tobytes()))
                for name in ("blob_shift", "blob_no_shift")]
    on = (_ckpt.map_tensors(tree[k], lambda t: t.to(device))
          for k in ("params", "state", "dyn_params"))
    return ServingSolver(*programs, *on, meta)
