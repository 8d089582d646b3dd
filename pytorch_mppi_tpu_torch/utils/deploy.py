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
  iteration's N(0, 1) draws (what ``solve.standard_normal`` returns), and
  with stochastic dynamics the draws the dynamics make at each rollout
  step and descent step (``CommandStreams.feeds``).  It returns the new
  state's tensors, the action and the artifacts;
- the state's ``seed`` and ``counter`` stay host ints: the
  :class:`ServingSolver` runs the port's own prologue on them, so its draws
  come in the live controller's order and it replays the live controller
  bit for bit;
- shapes, dtypes, the route and every configuration flag are fixed at
  export (the kernel's tile and plant group too); the parameters,
  ``dynamics_params`` and the state stay runtime inputs, each settable;
- kernels that run the user's own code (a device model or a terminal cost
  traced by ``ops/batch_last.py``) travel as their programs: the file
  lists every generated kernel the two programs launch
  (``GeneratedKernel.describe``), and :func:`load_solver` registers each
  in the serving process (``batch_last.load_kernel``).  A generated id is
  a hash of the kernel's source and constants, so the ids the loaded
  programs carry name these entries with no rewriting; on the CPU the
  operators evaluate the rebuilt program, on the card ``nvcc`` builds its
  library from it at the first launch (a warm ``build/kernels/`` reuses
  the exporter's, named by the same header).  No compiled code goes into
  the file, as JAX's serving host compiles the StableHLO it loads;
- gradient refinement exports: ``torch.export`` records the
  ``torch.autograd.grad`` of the refiner in the body;
- stochastic dynamics export (version 6): the set-up run records the plan
  of the draws the dynamics make from their per-step generators (op,
  shape, dtype and scalar arguments of each ``torch.randn``,
  ``torch.rand``, ``torch.randint``, ``torch.normal`` with scalar mean and
  std, ``Tensor.normal_`` and ``Tensor.uniform_``: ``solve.Draw``), the
  programs take those draws as inputs, and the file keeps the plan, from
  which the :class:`ServingSolver` draws them on the seeded generators in
  the live order, with no user code.  Another draw from the generator
  raises ``NotImplementedError`` naming ROADMAP.md Queue 1 item 10;
- an artifact exported on the card runs on the card, and loading it where
  there is no card raises: it is never moved to the CPU;
- a live ``info`` payload raises a ValueError (the exported body takes
  ``info=None``), a file of a version this build does not read a
  ValueError (it reads versions 1, without kernels, 2, 3, 4, 5, 6 and 7;
  version 4 adds the block models, the residual MLP beyond its per-thread
  bounds and traced programs with dense layers, version 5 traced programs
  with a LayerNorm's statistics, dense layers in a running or terminal
  cost and more than 32 states or actions, version 6 stochastic dynamics,
  version 7 programs with ``erfinv``, ``nextafter`` or an integer shift and
  per-sample programs beyond 32 states or actions, which a build before
  each does not run, so it refuses their files by their version).  A file of version 1 or 2 whose programs run the
  residual MLP's device model raises a ValueError too: its constants hold
  the goal in the 16-float header of before, which the kernels no longer
  read (export it again);
- a controller with a mesh cannot be exported yet (its command calls
  collectives; ROADMAP.md Queue 1 item 12b): :func:`export_solver` raises
  ``NotImplementedError``.
"""
from __future__ import annotations

import io
import json
import logging
from typing import Optional

import numpy as np
import torch

from ..config import Artifacts, MPPIConfig
from ..ops import batch_last as BL
from ..ops import fused_solve as FS
from ..ops import kernel_models as KM
from ..ops import library as _library
from ..ops.solve import CommandStreams, plan_from_json
from . import checkpoint as _ckpt

logger = logging.getLogger(__name__)

# version 4: block models (kernel_models.RESIDUAL_MLP_BLOCK, generated programs
# with dense layers), the launch spec's act_ld and the rollout's; version 5:
# programs with the nodes lnmean and lnrstd (a LayerNorm), dense layers in a
# running or terminal cost (struct Terminal) and block models beyond 32 states
# or actions; version 6: stochastic dynamics (the plan of their draws, fed to
# the programs); version 7: programs with the nodes erfinv, nextafter, shl and
# shr, per-sample programs beyond 32 states or actions (block programs without
# layers) and the round-1 solve of a block model; a build before each refuses
# such a file by its version
_FORMAT_VERSION = 7
_READS = (1, 2, 3, 4, 5, 6, 7)  # version 1 carries no generated kernels
# the first version whose residual-MLP constants have the header of
# kernel_models.MLP_HEAD floats (20, the goal's nx <= 8 floats from 12 on)
_MLP_LAYOUT = 3
# the operators whose launches name a device model, and the argument that does
_MODEL_ARG = {"kernel_a": "spec", "batched": "spec", "rollout": "model_id"}


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by those of the
    iterator ``tensors`` (the file's order: a dict's sorted keys)."""
    return _ckpt.map_tensors(tree, lambda _: next(tensors))


class _Command(torch.nn.Module):
    """One command's device body on a flat list of tensors: the parameters',
    the state's, ``x0``, the ``dynamics_params``' and the prologue's feeds
    (``CommandStreams.feeds``, with the draws of ``plan``).  Returns the
    new state's tensors, the action and the artifacts that are not None, and
    records which are (``artifacts``)."""

    def __init__(self, fns, params, state, dyn_params, shift: bool, takes_info: bool,
                 plan=None):
        super().__init__()
        self.fns, self.shift, self.takes_info = fns, shift, takes_info
        self.params, self.state, self.dyn_params = params, state, dyn_params
        self.plan = plan
        self.artifacts = None

    def body(self, params, state, x0, dyn_params):
        if self.takes_info:
            return self.fns.body(params, state, x0, None, dyn_params, self.shift)
        return self.fns.body(params, state, x0, dyn_params, self.shift)

    def forward(self, flat):
        it = iter(flat)
        params = _rebuild(self.params, it)
        state = _rebuild(self.state, it)
        x0 = next(it)
        dyn_params = _rebuild(self.dyn_params, it)
        with self.fns.streams.fed(x0.device, list(it), self.plan):
            new_state, action, artifacts = self.body(params, state, x0, dyn_params)
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
        # version 6 adds the stochastic streams (the streams' refinement
        # steps are those of stochastic dynamics) and the plan of their draws
        self._streams = CommandStreams(MPPIConfig(**meta["streams"], dtype=self.dtype),
                                       kernel_keys=meta["kernel_keys"], noise=meta["noise"],
                                       refine=True)
        self._plan = plan_from_json(meta["draws"]) if "draws" in meta else None
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

    @property
    def kernels(self) -> tuple:
        """The generated kernels the programs launch, as registered in this
        process (``ops/batch_last.GeneratedKernel``; none for an artifact of
        named models)."""
        return tuple(BL.kernel_of(d["id"]) for d in self.meta.get("kernels", ()))

    def feeds(self) -> list:
        """What the next command's program takes in place of its random
        streams (``CommandStreams.feeds`` at the state's position): the key
        buffer or the noise, and the draws of stochastic dynamics."""
        return self._streams.feeds(self.state.seed, self.state.counter, self.device,
                                   self._plan)

    def command(self, x0, shift_nominal_trajectory: bool = True):
        """One MPC solve; threads the state exactly as the live controller
        does."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        state = self.state
        flat = [*_ckpt.tensors(self.params), *_ckpt.tensors(state), x0,
                *_ckpt.tensors(self.dyn_params), *self.feeds()]
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


def _launched_models(programs) -> list:
    """The device models that the programs' operator nodes launch, by id:
    the ``LaunchSpec.model_id`` of kernel A's and the batched pair's, the
    rollout's ``model_id``."""
    ids = set()
    for program in programs:
        for node in program.graph.nodes:
            name = str(node.target).split(".")
            if node.op != "call_function" or name[0] != _library.NAMESPACE \
                    or name[1] not in _MODEL_ARG:
                continue
            arg = _MODEL_ARG[name[1]]
            at = [a.name for a in node.target._schema.arguments].index(arg)
            value = node.args[at] if at < len(node.args) else node.kwargs[arg]
            # a spec is LaunchSpec(variant, model_id, ...)
            ids.add(int(value[1] if arg == "spec" else value))
    return sorted(ids)


def _launched_kernels(programs) -> list:
    """The generated kernels (``ops/batch_last.py``) that the programs
    launch, by id."""
    return [i for i in _launched_models(programs) if i >= BL.GENERATED]


def export_solver(ctrl, path: Optional[str] = None, x0_example=None) -> ServingSolver:
    """Export ``ctrl``'s command (+ current params/state) for serving.

    :param ctrl: a live ``MPPI``/``SMPPI``/``KMPPI``/``MPPI_Batched`` on
        the plain path or a kernel route (the fused kernel, the legacy
        pair, the batched pair), with a named device model or one traced
        from its callables, a traced terminal cost, elites, iterations,
        gradient refinement or stochastic dynamics (the plain path; the
        draws of the dynamics become inputs).  A mesh (ROADMAP.md Queue 1
        item 12b), or a draw outside ``solve.Draw``'s vocabulary (item 10),
        raises ``NotImplementedError``; a live ``info`` payload a
        ValueError.
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
    batched = isinstance(ctrl, _c.MPPI_Batched)
    takes_info = not batched
    fns, device = ctrl._fns, ctrl.d
    shape = (ctrl.N, ctrl.nx) if batched else (ctrl.nx,)
    x0 = (torch.zeros(shape, dtype=ctrl.dtype, device=device) if x0_example is None
          else torch.as_tensor(x0_example, dtype=ctrl.dtype, device=device))
    params = ctrl._full_params() if hasattr(ctrl, "_full_params") else ctrl._params
    state, dyn_params = ctrl._state, ctrl.dynamics_params
    streams, plan = fns.streams, None
    programs, launched = {}, dict(FS.launches)  # put back after the set-up runs
    try:
        if streams.stochastic:
            # the draws of the dynamics, on a live run of the command
            module = _Command(fns, params, state, dyn_params, True, takes_info)
            plan = streams.record(lambda: module.body(params, state, x0, dyn_params),
                                  state.seed, state.counter, device)
        flat = [*_ckpt.tensors(params), *_ckpt.tensors(state), x0, *_ckpt.tensors(dyn_params),
                *streams.feeds(state.seed, state.counter, device, plan)]
        with _library.exporting():
            for shift in (True, False):
                module = _Command(fns, params, state, dyn_params, shift, takes_info, plan)
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
        "kernels": [BL.kernel_of(i).describe() for i in _launched_kernels(programs.values())],
        "kernel_keys": streams.kernel_keys,
        "noise": streams.noise,
        "streams": dict(nx=config.nx, nu=config.nu, K=config.K, T=config.T,
                        antithetic=config.antithetic,
                        num_support_pts=config.num_support_pts,
                        num_iterations=config.num_iterations,
                        stochastic_dynamics=config.stochastic_dynamics,
                        gradient_refinement_steps=streams.refine_steps),
    }
    if plan is not None:
        meta["draws"] = plan
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
    operators that importing this package registered, and the generated
    kernels the file carries are registered here (``batch_last.
    load_kernel``).  An artifact exported on the card needs a card."""
    tree = _ckpt.load(path)
    meta = json.loads(tree["meta"])
    if meta.get("version") not in _READS:
        raise ValueError(
            f"unsupported deploy-artifact version {meta.get('version')!r} "
            f"(this build reads versions {', '.join(map(str, _READS))})")
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"this artifact was exported on {device} and runs there; no CUDA device is "
            f"available (it is never moved to the CPU: export it on the CPU to serve there)")
    for desc in meta.get("kernels", ()):
        BL.load_kernel(desc)
    programs = [torch.export.load(io.BytesIO(tree[name].numpy().tobytes()))
                for name in ("blob_shift", "blob_no_shift")]
    if meta["version"] < _MLP_LAYOUT and (
            KM.RESIDUAL_MLP in _launched_models(programs)
            or any(d["model"].get("named") == KM.RESIDUAL_MLP for d in meta.get("kernels", ()))):
        raise ValueError(
            f"this version-{meta['version']} artifact runs the residual MLP's device model with "
            f"the constants' layout of before version {_MLP_LAYOUT} (the goal in a 16-float "
            f"header); export it again with this build")
    on = (_ckpt.map_tensors(tree[k], lambda t: t.to(device))
          for k in ("params", "state", "dyn_params"))
    return ServingSolver(*programs, *on, meta)
