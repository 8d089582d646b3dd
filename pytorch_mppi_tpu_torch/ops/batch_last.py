"""The dynamics bridge: a user's own torch dynamics, running cost and
terminal cost traced and compiled into the CUDA kernels.

The counterpart of ``pytorch_mppi_tpu/ops/batch_last.py``.  The JAX package
traces the user's callables to a jaxpr and re-derives every equation with
the batch axis moved last (K on the TPU's lanes), so that the Pallas kernels
can evaluate them on whole blocks of samples.  In a CUDA kernel one thread
rolls one sample out, so there is no batch axis to move: here the batch axis
is dropped, and the traced program becomes a per-sample scalar program;
where that program would be too long, each product with a constant matrix
becomes one dense layer that a block's threads compute for its samples
together, JAX's batched @ constant (``_dot_general_batch_last``).

1. **Trace.** :func:`trace_model` traces ``dynamics(state (B, nx), action
   (B, nu)[, t])`` and ``running_cost(next_state, action[, t])`` through the
   port's :func:`~.solve.wrap_dynamics` and :func:`~.solve.wrap_cost` with
   ``torch.fx.experimental.proxy_tensor.make_fx`` over ``torch.func.
   functionalize`` (no in-place op is left), at the probe batch size
   ``PROBE_BATCH``.  The timestep ``t`` is a 0-d int64 tensor, so it stays
   symbolic; code that needs a real ``int`` of it (``range(t)``, ``if t >
   3:``) or of any traced value (``.item()``) cannot be traced.  Tensors
   that the callables close over become constants.  :func:`trace_terminal`
   traces a ``terminal_final_cost(final_state, final_action)``.
2. **Lower.** Every value of the aten graph gets its full shape and the
   position of its batch axis (or none); operations on constants alone are
   folded; every other value is held as an array of scalar nodes of its
   per-sample shape.  The nodes (:class:`Program`) are elementwise
   arithmetic, transcendentals, comparisons, selects and casts, in three
   kinds: float, integer and bool, and dense layers: where the program's
   scalar lowering would exceed ``MAX_OPS`` operations a step, each ``mm``
   or ``addmm`` (what ``nn.Linear`` lowers to) of a batched (B, n_in)
   value with a constant (n_in, n_out) matrix (and a constant bias) is one
   ``dense`` node with n_out outputs, whose weights stay in the constants
   (in the dynamics, the running cost and the terminal cost alike; beyond
   ``MAXN`` states or actions always, so that a product's weights stay in
   the constants and its multiply-adds on the tensor cores).  The
   vocabulary, in aten terms:
   elementwise arithmetic and transcendentals (``elu``, ``silu``,
   ``gelu``, ``softplus``, ``leaky_relu`` and ``erfinv`` among them),
   comparisons, ``where`` / ``clamp`` / ``remainder`` / ``fmod`` /
   ``atan2`` / ``nextafter``, the integer shifts (``bitwise_left_shift``,
   ``bitwise_right_shift``, ``<<``, ``>>``: JAX's ``shift_left`` and
   ``shift_right_arithmetic``) and casts; reductions over feature axes
   (``sum``, ``mean``, ``amax``, ``amin``, ``prod``, ``any``, ``all``,
   vector norms, ``softmax``), and ``native_layer_norm`` over trailing
   feature axes (its row's statistics, ``lnmean`` and ``lnrstd`` nodes, then
   elementwise); ``mm`` / ``bmm`` / ``addmm`` / ``mv`` / ``dot`` of a
   batched value with a constant on either side and the per-sample
   contractions that ``einsum`` quadratic forms lower to; ``expand``,
   ``view`` / ``reshape`` on feature axes, ``permute``, ``select`` /
   ``slice`` with constant indices and their scatters (a ``slice_scatter``
   with a step into a ``new_zeros`` is interior padding, JAX's ``pad`` with
   interior padding), ``cat`` / ``stack`` / ``split`` / ``unbind``,
   ``unsqueeze`` / ``squeeze``, ``constant_pad_nd``, ``flip`` and the scans
   ``cumsum`` / ``cumprod`` / ``cummax`` / ``cummin`` (their values) /
   ``logcumsumexp`` over a feature axis.  What stays refused raises
   :class:`UnsupportedPrimitive` naming the op, each as JAX's interpreter
   refuses it (``pytorch_mppi_tpu/ops/batch_last.py``): anything that
   reduces, indexes, sorts, contracts or concatenates along the batch axis
   (JAX: "... along the batch axis"); the indices of ``max`` / ``min`` over
   a dim and of ``cummax`` / ``cummin``, indexing with anything but one
   constant 1-D index, and sorting (JAX has no rule for ``argmax``,
   ``gather`` or ``sort`` on a batched operand); any other op with a
   batched operand (JAX: "primitive ... with batched operands"); a random
   op (JAX's kernels take no key inside the user's code); and a program
   whose scalar operations a step, besides its dense layers' multiply-adds,
   exceed ``MAX_OPS`` (the dynamics and the running cost together; the
   terminal cost alone), a bound of the port's alone.  A program within
   ``MAX_OPS`` as scalars is emitted as scalars.
3. **Plain version.** :meth:`Program.evaluate` runs the nodes on
   ``(K,)``-batched torch tensors, one torch op a node (a dense node one
   product plus its bias, a statistic one reduction).  It is the generated
   device model's plain ``dynamics`` / ``running_cost``, so the CPU tests
   exercise the translation and not the user's callable.
4. **Emit.** :meth:`GeneratedKernel.header` writes the nodes as the C++
   struct ``Generated`` with the interface of ``csrc/fused_mppi.cu``'s named
   device models, plus the timestep: one statement a node, standard C math
   functions only (no intrinsics, no fast math), so the same text compiles
   as host C++; a program with dense layers as a block model
   (:meth:`Program.emit_block`: its segments between the layers, the
   ``block_dense`` calls, a LayerNorm between two layers as ``block_norm``
   with its unit-wise epilogue, ``kBlock``; a running cost with dense
   layers runs in the step after the dynamics, ``kStepCost``, and a
   terminal cost with them as ``struct Terminal``, ``kBlockTerminal``).  A
   program without dense layers within ``MAXN`` states and actions runs on
   the per-sample models' register arrays; beyond them it is a block model
   without layers (``kPerSample``: its state and action in a row of shared
   memory, each owner stepping its sample alone), as a block model keeps
   them.  Tensor constants are read from the model's float32
   ``consts`` buffer (the terminal cost's from its own), never written as
   literals, so two models that differ only in their weights give the same
   source and share one library; Python numbers in the callables are code,
   and are written as exact float32 literals.
5. **Build.** :meth:`GeneratedKernel.library` compiles ``fused_mppi.cu``
   with that header and the variants a route asks for (``ops/_build.
   build_generated``), on first use, into ``build/kernels/``; a failed
   build raises with the compiler's output.
6. **Ids.** A launch names its kernel by ``LaunchSpec.model_id``, and a
   deploy artifact's exported programs carry that integer
   (``utils/deploy.py``).  So a generated kernel's id is derived from its
   content: ``GENERATED`` plus a hash of its header and its float32
   constants (:class:`GeneratedKernel`), and :func:`kernel_of` looks it
   up in a registry of the process.  An id written at export then names
   the same kernel in any process that registers the artifact's kernels
   (:func:`load_kernel`, from :meth:`GeneratedKernel.describe`), with no
   rewriting of the loaded programs: two artifacts, and a process's own
   traces, share the registry without clashing, and loading an artifact
   again finds every entry present.  The constants are part of the id
   because the operators' CPU implementations evaluate the registered
   entry's own program and constants (``kernel_models.plain_model``); the
   library is named by the header alone (``ops/_build.generated_path``),
   so kernels that differ only in their weights share it.  Two sources
   that hash to one id raise, and never share an entry.

A pair of callables that carries a named kernel model
(:func:`~.kernel_models.find_kernel_model`) keeps it (:func:`kernel_model`);
the tracer is tried only where there is none, and where a named per-sample
model's struct cannot run (beyond ``MAXN``, or beside a traced terminal
cost with dense layers: :func:`kernel_device_model` traces its callables).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import operator
import struct
import types
from typing import Callable, Optional

import numpy as np
import torch

from .kernel_models import GENERATED, KernelModel, KernelTerminal, find_kernel_model

PROBE_BATCH = 509  # the batch the callables are traced at (a prime no feature axis is)
MAX_OPS = 16_384  # scalar operations of one step besides dense layers: dynamics and running cost
CHUNK = 4_096  # the most statements of one emitted function (Program.emit_parts)
MAXN = 32  # the largest nx or nu of a per-sample device model (MAXN in fused_mppi.cu)
# the activation row of a per-sample program beyond MAXN, which keeps its state
# in the block kernels' shared memory and writes no activation: the least row
# the kernels lay out (valid_activations in fused_mppi.cu)
ROWS_LD = 4

F, I, B = "f", "i", "b"  # the kinds of a scalar node: float, integer, bool


class UnsupportedPrimitive(Exception):
    """Raised when a traced user function uses an operation this bridge
    cannot write as a per-sample program (the routing then takes the plain
    path with a warning naming it)."""


# ---------------------------------------------------------------------------
# The scalar program
# ---------------------------------------------------------------------------

# op -> (C expression with {0}, {1}, {2}, result kind or None for the operand kind)
_UNARY_F = {
    "exp": "expf({0})", "exp2": "exp2f({0})", "expm1": "expm1f({0})", "log": "logf({0})",
    "log2": "log2f({0})", "log10": "log10f({0})", "log1p": "log1pf({0})",
    "sqrt": "sqrtf({0})", "rsqrt": "(1.0f / sqrtf({0}))", "sin": "sinf({0})",
    "cos": "cosf({0})", "tan": "tanf({0})", "asin": "asinf({0})", "acos": "acosf({0})",
    "atan": "atanf({0})", "sinh": "sinhf({0})", "cosh": "coshf({0})", "tanh": "tanhf({0})",
    "asinh": "asinhf({0})", "acosh": "acoshf({0})", "atanh": "atanhf({0})",
    "sigmoid": "(1.0f / (1.0f + expf(-{0})))", "erf": "erff({0})", "erfc": "erfcf({0})",
    "erfinv": "erfinv_f({0})",
    "floor": "floorf({0})", "ceil": "ceilf({0})", "round": "rintf({0})",
    "trunc": "truncf({0})", "reciprocal": "(1.0f / {0})", "abs": "fabsf({0})",
    "sign": "(float)(({0} > 0.0f) - ({0} < 0.0f))",
}
_TORCH_UNARY = {
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "sigmoid": torch.sigmoid, "erf": torch.erf, "erfc": torch.erfc,
    "erfinv": torch.erfinv,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round, "trunc": torch.trunc,
    "reciprocal": torch.reciprocal, "abs": torch.abs, "sign": torch.sign,
    "neg": torch.neg, "not": torch.logical_not, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
}
_BINARY_C = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})", "div": "({0} / {1})",
    "eq": "({0} == {1})", "ne": "({0} != {1})", "lt": "({0} < {1})", "le": "({0} <= {1})",
    "gt": "({0} > {1})", "ge": "({0} >= {1})", "and": "({0} && {1})", "or": "({0} || {1})",
    "xor": "({0} != {1})",
}
_BINARY_F = {"pow": "powf({0}, {1})", "atan2": "atan2f({0}, {1})", "max": "fmaxf({0}, {1})",
             "min": "fminf({0}, {1})", "fmod": "fmodf({0}, {1})",
             "remainder": "rem_f({0}, {1})", "hypot": "hypotf({0}, {1})",
             "copysign": "copysignf({0}, {1})", "nextafter": "nextafterf({0}, {1})"}
_BINARY_I = {"max": "({0} > {1} ? {0} : {1})", "min": "({0} < {1} ? {0} : {1})",
             "fmod": "({0} % {1})", "remainder": "rem_i({0}, {1})",
             "floordiv": "div_floor_i({0}, {1})", "shl": "shl_i({0}, {1})",
             "shr": "shr_i({0}, {1})"}
_TORCH_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "pow": torch.pow, "atan2": torch.atan2, "max": torch.maximum, "min": torch.minimum,
    "fmod": torch.fmod, "remainder": torch.remainder, "hypot": torch.hypot,
    "copysign": torch.copysign, "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge, "and": torch.logical_and,
    "or": torch.logical_or, "xor": torch.logical_xor,
    "floordiv": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "nextafter": torch.nextafter, "shl": torch.bitwise_left_shift,
    "shr": torch.bitwise_right_shift,
}
_COMPARE = {"eq", "ne", "lt", "le", "gt", "ge"}
_LOGICAL = {"and", "or", "xor", "not"}
_C_TYPE = {F: "float", I: "long long", B: "bool"}
_HELPERS = """\
  // Python's float remainder (torch.remainder): the sign of the divisor
  __device__ static float rem_f(float a, float b) {
    const float r = fmodf(a, b);
    return r != 0.0f && ((r < 0.0f) != (b < 0.0f)) ? r + b : r;
  }
  __device__ static long long rem_i(long long a, long long b) {
    const long long r = a % b;
    return r != 0 && ((r < 0) != (b < 0)) ? r + b : r;
  }
  __device__ static long long div_floor_i(long long a, long long b) {
    return (a - rem_i(a, b)) / b;
  }
  // torch's shifts of int64 (JAX's shift_left, shift_right_arithmetic): a
  // shift outside [0, 64) gives 0 to the left and the sign to the right
  __device__ static long long shl_i(long long a, long long b) {
    return b < 0 || b >= 64 ? 0LL : (long long)((unsigned long long)a << b);
  }
  __device__ static long long shr_i(long long a, long long b) {
    return a >> (b < 0 || b >= 64 ? 63 : b);
  }
  // torch.erfinv (JAX's erf_inv): Giles' single-precision polynomial, the
  // one XLA uses for float32 ("Approximating the erfinv function", GPU
  // Computing Gems, 2011); +-infinity at +-1, NaN beyond
  __device__ static float erfinv_f(float x) {
    float w = -log1pf(-x * x), p;
    if (w < 5.0f) {
      w = w - 2.5f;
      p = 2.81022636e-08f;
      p = 3.43273939e-07f + p * w;
      p = -3.5233877e-06f + p * w;
      p = -4.39150654e-06f + p * w;
      p = 0.00021858087f + p * w;
      p = -0.00125372503f + p * w;
      p = -0.00417768164f + p * w;
      p = 0.246640727f + p * w;
      p = 1.50140941f + p * w;
    } else {
      w = sqrtf(w) - 3.0f;
      p = -0.000200214257f;
      p = 0.000100950558f + p * w;
      p = 0.00134934322f + p * w;
      p = -0.00367342844f + p * w;
      p = 0.00573950773f + p * w;
      p = -0.0076224613f + p * w;
      p = 0.00943887047f + p * w;
      p = 1.00167406f + p * w;
      p = 2.83297682f + p * w;
    }
    return fabsf(x) < 1.0f ? p * x : fabsf(x) == 1.0f ? x * INFINITY : NAN;
  }
"""


def _float_literal(v: float) -> str:
    """``v`` rounded to float32 as an exact C literal."""
    f = struct.unpack("f", struct.pack("f", v))[0]
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    return f"{f.hex()}f" if f >= 0 else f"(-{(-f).hex()}f)"


_LEAVES = ("x", "u", "t", "const", "lit")
_STATS = ("lnmean", "lnrstd")  # a LayerNorm's statistics of a row of nodes


class Program:
    """A straight-line program of scalar nodes over the inputs ``x`` (nx
    states), ``u`` (nu actions) and the timestep ``t``.  A node is a tuple
    ``(op, kind, *args)``: ``("x", F, i)``, ``("u", F, j)``, ``("t", I)``,
    ``("const", F, k)`` (entry k of the constants buffer), ``("lit", kind,
    value)``, ``("cast", kind, a)``, ``("where", kind, c, a, b)`` and the
    unary and binary ops of the tables above, whose args are node ids; and a
    dense layer, ``("dense", F, w, b, n_out, *inputs)``, the product of its
    n_in input nodes with the (n_in, n_out) row-major matrix at entry ``w``
    of the constants, plus the n_out floats at ``b`` (none where ``b`` is
    -1), whose outputs are the nodes ``("dout", F, dense, j)``; and a
    LayerNorm's statistics of a row of nodes, ``("lnmean", F, *row)``, its
    mean, and ``("lnrstd", F, eps, mean, *row)``, 1 / sqrt(the biased
    variance + eps), ``eps`` a literal node.  Equal nodes are one node
    (common subexpressions are shared)."""

    def __init__(self):
        self.nodes: list = []
        self._ids: dict = {}

    @classmethod
    def from_nodes(cls, nodes) -> "Program":
        """The program of ``nodes`` as :attr:`nodes` lists them (lists or
        tuples: a deploy artifact carries them as JSON)."""
        prog = cls()
        for node in nodes:
            prog._ids[tuple(node)] = len(prog.nodes)
            prog.nodes.append(tuple(node))
        return prog

    def add(self, op: str, kind: str, *args) -> int:
        key = (op, kind, *args)
        nid = self._ids.get(key)
        if nid is None:
            nid = self._ids[key] = len(self.nodes)
            self.nodes.append(key)
        return nid

    def kind(self, nid: int) -> str:
        return self.nodes[nid][1]

    def live(self, outputs) -> list:
        """The ids of the nodes the outputs need, in order."""
        need = set()
        stack = list(outputs)
        while stack:
            n = stack.pop()
            if n in need:
                continue
            need.add(n)
            op = self.nodes[n][0]
            if op == "dense":
                stack.extend(self.nodes[n][5:])
            elif op == "dout":
                stack.append(self.nodes[n][2])
            elif op not in _LEAVES:
                stack.extend(self.nodes[n][2:])
        return sorted(need)

    def dense_layers(self, outputs) -> list:
        """The live dense nodes, in order, as ``(id, w, b, n_in, n_out)``."""
        return [(n, node[2], node[3], len(node) - 5, node[4])
                for n in self.live(outputs) for node in (self.nodes[n],) if node[0] == "dense"]

    def evaluate(self, outputs, consts: torch.Tensor, x: torch.Tensor, u: torch.Tensor, t):
        """The outputs' values on ``(K, nx)`` states and ``(K, nu)`` actions
        in their dtype, one torch op a node (a node of a batched input is a
        (K,) tensor, one of constants a 0-d one); ``consts`` is the constants
        buffer in that dtype, ``t`` an int or a 0-d integer tensor."""
        fdt, dev = x.dtype, x.device
        dtypes = {F: fdt, I: torch.int64, B: torch.bool}
        vals = {}
        for n in self.live(outputs):
            op, kind, *a = self.nodes[n]
            if op == "x":
                v = x[:, a[0]]
            elif op == "u":
                v = u[:, a[0]]
            elif op == "t":
                v = torch.as_tensor(t, dtype=torch.int64, device=dev)
            elif op == "const":
                v = consts[a[0]]
            elif op == "lit":
                v = torch.tensor(a[0], dtype=dtypes[kind], device=dev)
            elif op == "cast":
                v = vals[a[0]].to(dtypes[kind])
            elif op == "where":
                v = torch.where(vals[a[0]], vals[a[1]], vals[a[2]])
            elif op == "dense":  # one product plus the bias
                w, b, n_out, *ins = a
                X = torch.stack([_broadcast(vals[i], x[:, 0]) for i in ins], dim=1)
                W = consts[w:w + len(ins) * n_out].reshape(len(ins), n_out)
                v = X @ W if b < 0 else torch.addmm(consts[b:b + n_out], X, W)
            elif op == "dout":
                v = vals[a[0]][:, a[1]]
            elif op in _STATS:  # a row's mean, or 1 / sqrt(its biased variance + eps)
                rows = a[2:] if op == "lnrstd" else a
                X = torch.stack([_broadcast(vals[i], x[:, 0]) for i in rows], dim=1)
                v = X.mean(1) if op == "lnmean" else torch.rsqrt(
                    ((X - vals[a[1]][..., None]) ** 2).mean(1) + vals[a[0]])
            elif op == "neg":
                v = -vals[a[0]]
            elif len(a) == 1:
                v = _TORCH_UNARY[op](vals[a[0]])
            else:
                v = _TORCH_BINARY[op](vals[a[0]], vals[a[1]])
            vals[n] = v
        return [vals[o] for o in outputs]

    def emit(self, outputs, indent: str = "    ") -> tuple:
        """(statements, names): one C statement a live node, and the C names
        of the outputs.  A program with dense layers is emitted by
        :meth:`emit_block`."""
        lines = []
        for n in self.live(outputs):
            if self.nodes[n][0] in ("dense", "dout"):
                raise ValueError("a program with dense layers is emitted by emit_block")
            lines.append(f"{indent}const {_C_TYPE[self.kind(n)]} v{n} = "
                         f"{self._expr(n, lambda i: f'v{i}')};")
        return lines, [f"v{o}" for o in outputs]

    def emit_parts(self, outputs, name: str, t: str = "t") -> tuple:
        """(members, statements, names): :meth:`emit`'s statements and names,
        and no members, where the program has at most ``CHUNK`` live nodes;
        else the program as a run of ``__noinline__`` functions ``{name}0``,
        ``{name}1``, ... (the members), each of at most ``CHUNK``
        statements, and statements that call them in order (``t`` the
        enclosing function's step).  One long run of statements costs
        ``nvcc``'s front end (``cudafe++``, ``cicc``) far more than linear
        time (``PERF.md`` §6); so each part holds consecutive nodes
        of :meth:`_depth_first`'s order, each node's expression as
        :meth:`emit` writes it (the same float32 operations on the same
        operands), reading the leaves where it uses them and a value of an
        earlier part from the caller's scratch rows (``sf``, ``si``,
        ``sb``: float, integer and bool, in local memory), where a part
        writes each value that a later part or an output reads.  A slot
        serves again once the last part that reads its value has run.  The
        names of the outputs are their slots; a leaf output (a state
        element moved unchanged, as a shift or a roll of the state moves
        it) is copied into a local first, as :meth:`emit` copies it, since
        the caller may write ``x`` in place."""
        live = self.live(outputs)
        if len(live) <= CHUNK:
            body, names = self.emit(outputs)
            return [], body, names
        if any(self.nodes[n][0] in ("dense", "dout") for n in live):
            raise ValueError("a program with dense layers is emitted by emit_block")
        comp = self._depth_first(outputs)
        at = {n: i for i, n in enumerate(comp)}
        last = dict(at)  # node -> the last position that reads it
        for i, n in enumerate(comp):
            for a in self.nodes[n][2:]:
                if a in at:
                    last[a] = i
        for o in outputs:
            if o in at:
                last[o] = len(comp)
        # consecutive runs of at most CHUNK statements: a node and, where a
        # later run reads it, its store
        parts, start = [], 0
        while start < len(comp):
            end, stores, ending = start, 0, {}  # ending: last read -> stores it ends
            while end < len(comp):
                n = comp[end]
                # node `end` joins: the values it reads last need no store
                grown = stores - ending.get(end, 0) + (last[n] > end)
                if end + 1 - start + grown > CHUNK and end > start:
                    break
                if last[n] > end:
                    ending[last[n]] = ending.get(last[n], 0) + 1
                stores, end = grown, end + 1
            parts.append((start, end))
            start = end
        part_of = [p for p, (a, b) in enumerate(parts) for _ in range(a, b)]
        # the slots: a value written by part p and last read by part q (or the
        # caller, len(parts)) holds its slot from p to q
        arrays = {F: "sf", I: "si", B: "sb"}
        size, free, slot, release = {F: 0, I: 0, B: 0}, {F: [], I: [], B: []}, {}, {}
        for p, (a, b) in enumerate(parts):
            for n in release.pop(p, []):
                free[self.kind(n)].append(slot[n])
            for i in range(a, b):
                n = comp[i]
                if last[n] < b:
                    continue
                kind = self.kind(n)
                if free[kind]:
                    slot[n] = free[kind].pop()
                else:
                    slot[n], size[kind] = size[kind], size[kind] + 1
                reader = len(parts) if last[n] == len(comp) else part_of[last[n]]
                release.setdefault(reader + 1, []).append(n)

        def leaf_or_slot(p):
            def name(a):
                if a not in at:
                    return self._expr(a, None)
                return f"v{a}" if part_of[at[a]] == p else f"{arrays[self.kind(a)]}[{slot[a]}]"
            return name

        members = []
        for p, (a, b) in enumerate(parts):
            members += [f"  __device__ __noinline__ static void {name}{p}(const float* c, "
                        "const float* x, const float* u, int t, float* sf, long long* si, "
                        "bool* sb) {"]
            name_of = leaf_or_slot(p)
            for i in range(a, b):
                n = comp[i]
                members.append(f"    const {_C_TYPE[self.kind(n)]} v{n} = "
                               f"{self._expr(n, name_of)};")
                if last[n] >= b:
                    members.append(f"    {arrays[self.kind(n)]}[{slot[n]}] = v{n};")
            members.append("  }")
        body = [f"    {_C_TYPE[k]} {arrays[k]}[{size[k]}];" for k in (F, I, B) if size[k]]
        args = ", ".join(arrays[k] if size[k] else "nullptr" for k in (F, I, B))
        body += [f"    {name}{p}(c, x, u, {t}, {args});" for p in range(len(parts))]
        caller, names = leaf_or_slot(len(parts)), []
        for o in outputs:
            if o not in at and f"v{o}" not in names:
                body.append(f"    const {_C_TYPE[self.kind(o)]} v{o} = {self._expr(o, None)};")
            names.append(f"v{o}" if o not in at else caller(o))
        return members, body, names

    def _depth_first(self, outputs) -> list:
        """The live nodes but the leaves, each after its operands and as
        soon after them as a depth-first walk from the outputs allows: a
        value is used near where it is made, so few values cross from one
        part to another (:meth:`live`'s order, the tracer's, makes each
        torch op's nodes for every element in turn).  Every node keeps its
        expression and operands: only independent statements move."""
        order, done = [], set()
        for o in outputs:
            stack = [(o, False)]
            while stack:
                n, ready = stack.pop()
                if ready:
                    order.append(n)
                    continue
                if n in done or self.nodes[n][0] in _LEAVES:
                    continue
                done.add(n)
                stack.append((n, True))
                stack += [(a, False) for a in reversed(self.nodes[n][2:]) if a not in done]
        return order

    def _expr(self, n: int, name) -> str:
        """Node ``n``'s C expression, its arguments named by ``name(id)``."""
        op, kind, *a = self.nodes[n]
        ty = _C_TYPE[kind]
        v = [name(i) for i in a] if op not in ("x", "u", "const", "lit") else []
        if op == "x":
            e = f"x[{a[0]}]"
        elif op == "u":
            e = f"u[{a[0]}]"
        elif op == "t":
            e = "(long long)t"
        elif op == "const":
            e = f"c[{a[0]}]"
        elif op == "lit":
            e = (_float_literal(a[0]) if kind == F else
                 ("true" if a[0] else "false") if kind == B else f"{int(a[0])}LL")
        elif op == "cast":
            e = f"(({ty})({v[0]}))" if kind != B else f"({v[0]} != 0)"
        elif op == "where":
            e = f"({v[0]} ? {v[1]} : {v[2]})"
        elif op == "lnmean":
            e = f"(({' + '.join(v)}) / {_float_literal(len(v))})"
        elif op == "lnrstd":
            sq = " + ".join(f"({r} - {v[1]}) * ({r} - {v[1]})" for r in v[2:])
            e = f"(1.0f / sqrtf(({sq}) / {_float_literal(len(v) - 2)} + {v[0]}))"
        elif op == "neg":
            e = f"(-{v[0]})"
        elif op == "not":
            e = f"(!{v[0]})"
        elif op in ("isnan", "isinf", "isfinite"):
            e = f"{op}({v[0]})"
        elif len(a) == 1:
            if self.kind(a[0]) == F:
                e = _UNARY_F[op].format(*v)
            elif op == "abs":
                e = f"llabs({v[0]})"
            elif op == "sign":
                e = f"(long long)(({v[0]} > 0) - ({v[0]} < 0))"
            else:
                raise UnsupportedPrimitive(f"{op} of an integer value")
        elif op in _BINARY_C:
            e = _BINARY_C[op].format(*v)
        else:
            table = _BINARY_F if self.kind(a[0]) == F else _BINARY_I
            if op not in table:
                raise UnsupportedPrimitive(f"{op} of integer values")
            e = table[op].format(*v)
        return e

    def unit_wise(self, outputs) -> list:
        """Each live dense layer's unit-wise epilogue, in order, or None: the
        scalar nodes that read one unit j of the layer's output and
        constants only (a bias, a scale, a SiLU), the same expression for
        every unit, with constants at offsets affine in j.  An epilogue is a
        dict: ``nodes``, each unit-wise node -> its unit (the layer's
        outputs among them); ``results``, unit j -> the one node of unit j
        that anything else reads (the epilogue leaves its value in unit j's
        activation);
        ``stride``, a constant node of unit 0 -> its offset's step a unit.
        None where a unit has no such node or two, where the units'
        expressions differ, or where the result is the output itself.

        A layer whose results a LayerNorm reads (:meth:`_norm_epilogue`:
        ``lnmean`` and ``lnrstd`` of one result a unit, in order) has a
        ``norm`` (its statistics ``mean`` and ``rstd``, either None, and
        ``eps``): its ``nodes``, ``results`` and ``stride`` are then the
        epilogue after the norm, whose nodes read one unit's result, the
        statistics and constants, and ``pre`` the epilogue before it (its
        ``results`` and ``stride``; None where the norm reads the layer's
        outputs themselves)."""
        live = self.live(outputs)
        dense = [n for n in live if self.nodes[n][0] == "dense"]
        users = {}
        for n in live:
            op = self.nodes[n][0]
            if op in _LEAVES:
                continue
            args = (self.nodes[n][5:] if op == "dense" else (self.nodes[n][2],) if op == "dout"
                    else self.nodes[n][2:])
            for arg in args:
                users.setdefault(arg, []).append(n)
        out_set = set(outputs)
        epilogues = []
        for d in dense:
            n_out = self.nodes[d][4]
            unit = {n: self.nodes[n][3] for n in live
                    if self.nodes[n][0] == "dout" and self.nodes[n][2] == d}
            for n in live:
                op = self.nodes[n][0]
                if op in _LEAVES or op in ("dense", "dout"):
                    continue
                js = {unit.get(a) for a in self.nodes[n][2:]
                      if self.nodes[a][0] not in ("const", "lit")}
                if len(js) == 1 and None not in js:
                    unit[n] = js.pop()
            norm = self._norm_epilogue(live, unit, n_out, users, out_set)
            if norm is not None:
                epilogues.append(norm)
                continue
            results = {}
            for n, j in unit.items():
                if n in out_set or any(u not in unit for u in users.get(n, ())):
                    results.setdefault(j, []).append(n)
            if (sorted(results) != list(range(n_out)) or any(len(r) != 1 for r in results.values())
                    or any(self.kind(r[0]) != F for r in results.values())):
                epilogues.append(None)
                continue
            results = {j: r[0] for j, r in results.items()}
            stride = self._uniform(results, n_out, self._dout_leaf)
            epilogues.append(None if stride is None else
                             dict(nodes=unit, results=results, stride=stride))
        return epilogues

    def _dout_leaf(self, n):
        return ("v",) if self.nodes[n][0] == "dout" else None

    def _uniform(self, results, n_out: int, leaf):
        """The strides of the constants of ``results`` (unit j -> node): a
        constant node of unit 0 -> its offset's step a unit, where every
        unit's result is the same expression of its unit's leaf
        (``leaf(node)``: its signature, or None for an inner node) with
        constants at offsets affine in j; None where they differ, or where
        the result is the leaf itself."""
        def sig(n, idx):
            s = leaf(n)
            if s is not None:
                return s
            node = self.nodes[n]
            if node[0] == "const":
                idx.append((n, node[2]))
                return ("c",)
            if node[0] == "lit":
                return node
            return (node[0], node[1], *(sig(a, idx) for a in node[2:]))

        idx0 = []
        shape = sig(results[0], idx0)
        if leaf(results[0]) is not None:
            return None
        stride = {}
        for j in range(1, n_out):
            idx = []
            if sig(results[j], idx) != shape:
                return None
            for (n0, i0), (_, ij) in zip(idx0, idx):
                step = stride.setdefault(n0, ij - i0)
                if ij != i0 + step * j:
                    return None
        return stride

    def _norm_epilogue(self, live, unit: dict, n_out: int, users: dict, out_set: set):
        """A dense layer's epilogue around a LayerNorm of its units (see
        :meth:`unit_wise`), or None where there is none or where it is not
        unit-wise: the statistics must read one result of each unit in
        order and be read by the post-norm nodes alone, and no node before
        the norm may be read beyond it but the results."""
        stats = {}
        for n in live:
            node = self.nodes[n]
            if node[0] in _STATS:
                row = node[2:] if node[0] == "lnmean" else node[4:]
                if len(row) == n_out and all(unit.get(i) == j for j, i in enumerate(row)):
                    stats[n] = tuple(row)
        if not stats or len(set(stats.values())) != 1:
            return None
        row = next(iter(stats.values()))
        mean = [n for n in stats if self.nodes[n][0] == "lnmean"]
        rstd = [n for n in stats if self.nodes[n][0] == "lnrstd"]
        if len(mean) > 1 or len(rstd) > 1 or (rstd and mean != [self.nodes[rstd[0]][3]]):
            return None
        at = {r: j for j, r in enumerate(row)}
        post = {}
        for n in live:
            op = self.nodes[n][0]
            if op in _LEAVES or op in ("dense", "dout") or n in unit or n in stats:
                continue
            args = [a for a in self.nodes[n][2:]
                    if self.nodes[a][0] not in ("const", "lit") and a not in stats]
            js = {post[a] if a in post else at.get(a) for a in args}
            if len(js) == 1 and None not in js:
                post[n] = js.pop()
        inside = set(unit) | set(post) | set(stats)
        if any(u not in inside for s in stats for u in users.get(s, ())):
            return None
        if any(n in out_set or any(u not in inside for u in users.get(n, ()))
               for n in unit if n not in at):
            return None
        results = {}
        for n, j in post.items():
            if n in out_set or any(u not in inside for u in users.get(n, ())):
                results.setdefault(j, []).append(n)
        if (sorted(results) != list(range(n_out)) or any(len(r) != 1 for r in results.values())
                or any(self.kind(r[0]) != F for r in results.values())
                or any(r in out_set or any(u not in inside for u in users.get(r, ()))
                       for r in row)):
            return None
        results = {j: r[0] for j, r in results.items()}
        stride = self._uniform(results, n_out, lambda n: ("v",) if n in at else
                               ("s", self.nodes[n][0]) if n in stats else None)
        if stride is None:
            return None
        pre = None
        if any(self.nodes[r][0] != "dout" for r in row):
            pre_stride = self._uniform(dict(enumerate(row)), n_out, self._dout_leaf)
            if pre_stride is None:
                return None
            pre = dict(results=dict(enumerate(row)), stride=pre_stride)
        eps = self.nodes[self.nodes[rstd[0]][2]][2] if rstd else 0.0
        return dict(nodes={**unit, **post}, results=results, stride=stride, pre=pre,
                    norm=dict(mean=mean[0] if mean else None, rstd=rstd[0] if rstd else None,
                              eps=eps, stats=sorted(stats)), post=post)

    def _block_phase(self, outputs, final: str, prefix: str):
        """One program of a block model's struct (:meth:`emit_block`): the
        live dense nodes of ``outputs`` in order, layer l after segment l,
        each with its unit-wise epilogue (:meth:`unit_wise`) on all the
        block's threads; segment 0 and segment l + 1 (after layer l) hold
        the per-sample rest, the scalar nodes whose latest input is layer
        l's output (segment 0: none), run by each sample's owner; each
        segment ends by writing the next layer's inputs into the sample's
        activation row, unless they are the previous layer's results in
        order (the next layer then reads them where the epilogue left them),
        and the last one by writing x (``final`` "x": the next state) or the
        carry's ``cost`` (``final`` "cost").  Layer l reads half h_l of the
        activations and writes the other.  A node that a later segment
        reads stays in the owner's registers in ``Carry``, as ``prefix`` and
        its id; a leaf is read where it is used."""
        live = self.live(outputs)
        dense = [n for n in live if self.nodes[n][0] == "dense"]
        phase = {d: i for i, d in enumerate(dense)}
        last = len(dense)
        epi = self.unit_wise(outputs)
        hidden = set().union(*(set(e["nodes"]) - set(e["results"].values())
                               | set(e["norm"]["stats"] if "norm" in e else ())
                               for e in epi if e))
        result_at = {r: j for e in epi if e for j, r in e["results"].items()}
        # a layer reads its inputs where the previous layer left them: direct
        direct = [False]
        for l in range(1, last):
            ins, prev = list(self.nodes[dense[l]][5:]), dense[l - 1]
            res = (epi[l - 1]["results"] if epi[l - 1] else
                   {self.nodes[n][3]: n for n in live
                    if self.nodes[n][0] == "dout" and self.nodes[n][2] == prev})
            direct.append(ins == [res.get(j) for j in range(self.nodes[prev][4])])
        half = [0]
        for l in range(1, last):
            half.append(1 - half[-1] if direct[l] else half[-1])
        seg = {}
        for n in live:
            op = self.nodes[n][0]
            if op in _LEAVES or op == "dense":
                continue
            seg[n] = (phase[self.nodes[n][2]] + 1 if op == "dout" else
                      max((seg.get(a, 0) for a in self.nodes[n][2:]), default=0))
        uses = {}  # node -> the segments that read it
        for n in live:
            op = self.nodes[n][0]
            if op in _LEAVES or n in hidden:
                continue
            if op == "dense":
                args, at = ((), 0) if direct[phase[n]] else (self.nodes[n][5:], phase[n])
            elif op == "dout" or n in result_at:
                args, at = (), 0
            else:
                args, at = self.nodes[n][2:], seg[n]
            for a in args:
                uses.setdefault(a, set()).add(at)
        for o in outputs:
            uses.setdefault(o, set()).add(last)
        carried = [n for n in live if n in seg and max(uses.get(n, {0})) > seg[n]]
        # an activation read (a layer's output or result) only where something reads it
        loads = {n for n in live if self.nodes[n][0] == "dout"} | set(result_at)

        def segment(s: int) -> list:
            mine = [n for n in live if seg.get(n) == s and n not in hidden
                    and (n in uses or n not in loads)]
            writes = s < last and not direct[s]
            ins = (list(self.nodes[dense[s]][5:]) if writes else [] if s < last
                   else list(outputs))
            leaves = sorted({a for n in mine if self.nodes[n][0] != "dout" and n not in result_at
                             for a in self.nodes[n][2:] if self.nodes[a][0] in _LEAVES}
                            | {a for a in ins if self.nodes[a][0] in _LEAVES})

            def name(a):
                return f"v{a}" if a not in seg or seg[a] == s else f"k.{prefix}{a}"

            body = [f"    const {_C_TYPE[self.kind(a)]} v{a} = {self._expr(a, name)};"
                    for a in leaves]
            for n in mine:
                node = self.nodes[n]
                e = (f"out[{node[3]}]" if node[0] == "dout" else
                     f"out[{result_at[n]}]" if n in result_at else self._expr(n, name))
                body.append(f"    const {_C_TYPE[self.kind(n)]} v{n} = {e};")
                if n in carried:
                    body.append(f"    k.{prefix}{n} = v{n};")
            if s < last:
                body += [f"    row[{half[s]} * half + {i}] = {name(a)};" for i, a in enumerate(ins)]
            elif final == "x":
                body += [f"    x[{i}] = {name(a)};" for i, a in enumerate(ins)]
            else:
                body.append(f"    k.cost = {name(ins[0])};")
            if s > 0 and any("out[" in line for line in body):
                body.insert(0, f"    const float* out = row + {1 - half[s - 1]} * half;")
            return body

        def functor(nodes, v0, result0, stride, named) -> list:
            """An epilogue as statements of unit j's input ``v`` (the
            node ``v0`` of unit 0), its nodes of unit 0 renamed in order (so
            that layers with the same expression give the same text)."""
            mine = [n for n in live if nodes.get(n) == 0 and n != v0]
            local = {n: f"w{i}" for i, n in enumerate(mine)}

            def name(a):
                node = self.nodes[a]
                if a == v0:
                    return "v"
                if a in named:
                    return named[a]
                if node[0] == "const":
                    return f"c[{node[2]} + {stride.get(a, 0)} * j]"
                return self._expr(a, None) if node[0] == "lit" else local[a]

            body = [f"      const {_C_TYPE[self.kind(n)]} {local[n]} = {self._expr(n, name)};"
                    for n in mine]
            return body + [f"      return {local[result0]};"]

        def pre_unit(l: int):
            """Layer l's epilogue before any norm (``block_dense``'s), or None."""
            e = epi[l]
            if e is None:
                return None
            if "norm" in e:
                e = e["pre"]
                if e is None:
                    return None
            d0 = next(n for n in live if self.nodes[n][0] == "dout"
                      and self.nodes[n][2] == dense[l] and self.nodes[n][3] == 0)
            nodes = {n: j for n, j in epi[l]["nodes"].items() if n not in epi[l].get("post", {})}
            return functor(nodes, d0, e["results"][0], e["stride"], {})

        def post_unit(l: int):
            """Layer l's epilogue after its norm (``block_norm``'s), or None."""
            e = epi[l]
            if e is None or "norm" not in e:
                return None
            nm = e["norm"]
            r0 = e["pre"]["results"][0] if e["pre"] else next(
                n for n in live if self.nodes[n][0] == "dout"
                and self.nodes[n][2] == dense[l] and self.nodes[n][3] == 0)
            named = {nm["mean"]: "mean", nm["rstd"]: "rstd"}
            return functor(e["post"], r0, e["results"][0], e["stride"], named), nm["eps"]

        return types.SimpleNamespace(layers=self.dense_layers(outputs), half=half, last=last,
                                     outputs=list(outputs),
                                     carried=carried, prefix=prefix, final=final,
                                     segment=segment, pre=pre_unit, post=post_unit)

    def emit_block(self, outputs, cost=None) -> list:
        """The members of a block model's struct ``Generated`` (the
        interface of ``csrc/fused_mppi.cu``'s block models) for the step
        whose next-state nodes are ``outputs`` (:meth:`_block_phase`), and
        where ``cost`` is given (a running cost with dense layers) the
        cost's program after it, its layers after the dynamics' and its
        first segment after their last, leaving the cost in the carry
        (``kStepCost``)."""
        phases = [self._block_phase(list(outputs), "x", "v")]
        head = ["  static constexpr bool kBlock = true;"]
        if cost is not None:
            phases.append(self._block_phase([cost], "cost", "c"))
            head.append("  static constexpr bool kStepCost = true;")
        return self._emit_phases(phases, head)

    def emit_terminal(self, output) -> list:
        """The members of ``Generated`` for a terminal cost with dense
        layers: the struct ``Terminal``, a block program
        (:meth:`_block_phase`) over the terminal's own constants that leaves
        the cost in its carry, which the kernels run on every thread once
        after the last step."""
        body = self._emit_phases([self._block_phase([output], "cost", "v")],
                                 ["  static constexpr bool kStepCost = true;"])
        return ["  static constexpr bool kBlockTerminal = true;",
                "  // the terminal cost's program: block_step over its own constants",
                "  struct Terminal {", *[f"  {line}" for line in body], "  };"]

    def _emit_phases(self, phases, head) -> list:
        """The struct members of block programs run one after the other in
        one step (``layers``, ``dense``, ``begin``, ``after``, ``Carry``):
        program i's layers after program i - 1's, its first segment joined
        to the last segment of the one before."""
        units, norms, rows = [], [], []
        for ph in phases:
            for l, (_, w, b, n_in, n_out) in enumerate(ph.layers):
                body, post = ph.pre(l), ph.post(l)
                if body is not None and body not in units:
                    units.append(body)
                f = units.index(body) if body is not None else -1
                g = eps = None
                if post is not None:
                    if post[0] not in norms:
                        norms.append(post[0])
                    g, eps = norms.index(post[0]), post[1]
                rows.append((w, b, n_in, n_out, ph.half[l], f, g, eps))
        members = [f"    {_C_TYPE[self.kind(n)]} {ph.prefix}{n};" for ph in phases
                   for n in ph.carried]
        if any(ph.final == "cost" for ph in phases):
            members.append("    float cost;")
        total = len(rows)
        if not total:  # begin steps the sample: its owner needs no other thread
            head = [*head, "  static constexpr bool kPerSample = true;  // no layers"]
        lines = [*head, "  struct Carry {", *members, "  };",
                 f"  __device__ static int layers(const float*) {{ return {total}; }}"]
        for i, body in enumerate(units):
            lines += [f"  // a layer's unit-wise epilogue on unit j's output v (block_dense)",
                      f"  struct Unit{i} {{",
                      "    const float* c;",
                      "    __device__ float operator()(int j, float v) const {", *body, "    }",
                      "  };"]
        for i, body in enumerate(norms):
            lines += ["  // a LayerNorm's epilogue on unit j's output v and its row's statistics "
                      "(block_norm)",
                      f"  struct Norm{i} {{",
                      "    const float* c;",
                      "    __device__ float operator()(int j, float v, float mean, float rstd) "
                      "const {", *body, "    }",
                      "  };"]
        lines += ["  __device__ static void dense(int l, const float* c, float* act, int ld, "
                  "int rows, int) {",
                  "    int w = 0, b = -1, n_in = 0, n_out = 0, h = 0, f = -1;"]
        if norms:
            lines += ["    int g = -1;", "    float eps = 0.0f;"]
        lines.append("    switch (l) {")
        for i, (w, b, n_in, n_out, h, f, g, eps) in enumerate(rows):
            norm = "" if g is None else f" g = {g}; eps = {_float_literal(eps)};"
            lines.append(f"      case {i}: w = {w}; b = {b}; n_in = {n_in}; n_out = {n_out}; "
                         f"h = {h}; f = {f};{norm} break;")
        call = ("block_dense(c + w, b >= 0 ? c + b : nullptr, n_in, n_out, n_out, act + h * half, "
                "act + (1 - h) * half, ld, rows, ")
        lines += ["    }", "    const int half = rows * ld;"]
        for i in range(len(units)):
            lines.append(f"    {'if' if i == 0 else 'else if'} (f == {i}) {call}Unit{i}{{c}});")
        lines.append(f"    {'else ' if units else ''}{call}DenseLinear{{}});")
        if norms:
            lines.append("    if (g >= 0) __syncthreads();  // the layer's outputs are written")
            for i in range(len(norms)):
                lines.append(f"    {'if' if i == 0 else 'else if'} (g == {i}) block_norm("
                             f"act + (1 - h) * half, ld, rows, n_out, eps, Norm{i}{{c}});")
        lines.append("  }")

        def combined(s: int) -> list:
            """Segment s of the programs together: each program's own."""
            parts, at = [], 0
            for ph in phases:
                if at <= s <= at + ph.last:
                    parts.append(ph.segment(s - at))
                at += ph.last
            if len(parts) == 1:
                return parts[0]
            return [line for part in parts for line in ("    {", *[f"  {x}" for x in part],
                                                        "    }")]

        first = combined(0)
        if not total and phases[0].final == "x":  # beyond CHUNK: begin calls its parts
            parts, body, names = self.emit_parts(phases[0].outputs, "begin_part")
            if parts:
                lines += parts
                first = [*body, *[f"    x[{i}] = {nm};" for i, nm in enumerate(names)]]
        lines += ["  template <int N>",  # without layers, begin steps the state: x is written
                  f"  __device__ static void begin(const float* c, {'const ' if total else ''}"
                  "float* x, const float* u, int, int, int t, Carry& k, float* row, int half) {",
                  *first, "  }",
                  "  template <int N>",
                  "  __device__ static void after(int l, const float* c, float* x, const float* u, "
                  "int, int, int t, Carry& k, float* row, int half) {",
                  "    switch (l) {"]
        for s in range(1, total + 1):
            lines += [f"      case {s - 1}: {{", *[f"    {b}" for b in combined(s)],
                      "        break;", "      }"]
        lines += ["    }", "  }"]
        return lines


# ---------------------------------------------------------------------------
# Lowering an aten graph to a program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Sym:
    """A traced value: its full ``shape``, the position ``bdim`` of its batch
    axis in it (None: the value is the same for every sample), and the node
    ids of one sample's elements, ``elems``, an object array of the shape
    without the batch axis."""

    shape: tuple
    bdim: Optional[int]
    elems: np.ndarray
    kind: str

    def __post_init__(self):
        if not isinstance(self.elems, np.ndarray):  # a 0-d result of indexing
            e = np.empty((), dtype=object)
            e[()] = self.elems
            self.elems = e


def _kind_of(dtype) -> str:
    if dtype == torch.bool:
        return B
    if dtype.is_floating_point:
        return F
    if dtype.is_complex:
        raise UnsupportedPrimitive(f"complex values ({dtype})")
    return I


def _promote(*kinds) -> str:
    return F if F in kinds else I if I in kinds else B


def _drop(seq, i):
    return tuple(s for j, s in enumerate(seq) if j != i)


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


_RANDOM = ("rand", "randn", "randint", "randperm", "normal", "bernoulli", "uniform",
           "exponential", "multinomial", "poisson", "cauchy", "geometric", "log_normal",
           "random", "native_dropout", "dropout", "rrelu")


class _Lowering:
    """Lowers one traced graph into a :class:`Program`, registering the
    tensor constants it reads in ``pool`` (a list of float values).  With
    ``dense``, each product of a batched (B, n_in) value with a constant
    (n_in, n_out) matrix becomes one dense node (:meth:`dense`) instead of
    n_out scalar dot products."""

    def __init__(self, prog: Program, pool: list, batch: int, dense: bool = False):
        self.p = prog
        self.pool = pool
        self.batch = batch
        self.dense_products = dense
        self._consts: dict = {}

    # -- leaves --------------------------------------------------------------

    def lit(self, value, kind: str) -> int:
        if kind == F:
            return self.p.add("lit", F, float(value))
        if kind == I:
            return self.p.add("lit", I, int(value))
        return self.p.add("lit", B, bool(value))

    def const_offset(self, t: torch.Tensor) -> int:
        """The offset in the constants buffer of a float tensor's elements
        (row-major), registered once for the tensor."""
        key = (id(t), t.data_ptr() if t.numel() else 0)
        hit = self._consts.get(key)
        if hit is None:
            off = len(self.pool)
            self.pool.extend(t.detach().reshape(-1).cpu().to(torch.float64).tolist())
            hit = self._consts[key] = (off, t)  # keep t alive: the key holds its id
        return hit[0]

    def const_elems(self, t: torch.Tensor) -> np.ndarray:
        """The node ids of a constant tensor's elements: float tensors from
        the constants buffer, integer and bool tensors as literals."""
        kind = _kind_of(t.dtype)
        flat = t.detach().reshape(-1).cpu()
        if kind == F:
            off = self.const_offset(t)
            ids = [self.p.add("const", F, off + i) for i in range(flat.numel())]
        else:
            ids = [self.lit(v, kind) for v in flat.tolist()]
        out = np.empty(len(ids), dtype=object)
        out[:] = ids
        return out.reshape(tuple(t.shape))

    def cast(self, nid: int, kind: str) -> int:
        if self.p.kind(nid) == kind:
            return nid
        node = self.p.nodes[nid]
        if node[0] == "lit":
            return self.lit(node[2], kind)
        return self.p.add("cast", kind, nid)

    # -- alignment -------------------------------------------------------------

    def uniform_along(self, elems: np.ndarray, axis: int) -> np.ndarray:
        """``elems`` with ``axis`` (of the batch's size) taken to size 1,
        where every slice along it holds the same nodes; else unsupported."""
        first = np.take(elems, [0], axis=axis)
        if not np.all(elems == first):
            raise UnsupportedPrimitive(
                "a value that is not batched varies along a batch-sized axis")
        return first

    def uniform_tensor(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """A constant with ``axis`` (of the batch's size) taken to size 1,
        where it holds the same values along it; else unsupported."""
        first = t.narrow(axis, 0, 1)
        if not torch.equal(t, first.expand_as(t)):
            raise UnsupportedPrimitive(
                "a constant that varies along a batch-sized axis")
        return first

    def full_elems(self, v) -> np.ndarray:
        """The node ids of a value that is not batched (a _Sym without a
        batch axis or a constant), over its full shape."""
        if isinstance(v, _Sym):
            assert v.bdim is None
            return v.elems
        return self.const_elems(v)

    def aligned(self, v, out_shape: tuple, q: Optional[int]) -> np.ndarray:
        """Operand ``v`` (a _Sym, a constant tensor or a Python number)
        broadcast to one sample's elements of the full shape ``out_shape``
        whose batch axis is ``q``."""
        r = len(out_shape)
        per = out_shape if q is None else _drop(out_shape, q)
        if isinstance(v, (bool, int, float)):
            kind = B if isinstance(v, bool) else I if isinstance(v, int) else F
            return np.full(per, self.lit(v, kind), dtype=object)
        if isinstance(v, _Sym) and v.bdim is not None:
            pad = r - len(v.shape)
            if v.bdim + pad != q:
                raise UnsupportedPrimitive("operands with different batch-axis positions")
            return np.broadcast_to(v.elems.reshape((1,) * pad + v.elems.shape), per)
        if isinstance(v, torch.Tensor):
            v = v.reshape((1,) * (r - v.ndim) + tuple(v.shape))
            if q is not None and v.shape[q] == self.batch:
                v = self.uniform_tensor(v, q)
        e = self.full_elems(v)
        e = e.reshape((1,) * (r - e.ndim) + e.shape)
        if q is not None:
            if e.shape[q] != 1:
                if e.shape[q] != self.batch:
                    raise UnsupportedPrimitive("operands with different batch-axis positions")
                e = self.uniform_along(e, q)
            e = np.squeeze(e, axis=q)
        return np.broadcast_to(e, per)

    def batch_position(self, vals, out_shape: tuple) -> Optional[int]:
        """The batch axis of an elementwise result: that of its batched
        operands, aligned at the right."""
        r = len(out_shape)
        qs = {v.bdim + r - len(v.shape) for v in vals
              if isinstance(v, _Sym) and v.bdim is not None}
        if len(qs) > 1:
            raise UnsupportedPrimitive("operands with different batch-axis positions")
        return qs.pop() if qs else None

    def elementwise(self, fn, vals, out_shape: tuple, kind: str) -> _Sym:
        """``fn(*node ids) -> node id`` over the broadcast operands."""
        q = self.batch_position(vals, out_shape)
        arrs = [self.aligned(v, out_shape, q) for v in vals]
        per = out_shape if q is None else _drop(out_shape, q)
        out = np.empty(per, dtype=object)
        for idx in itertools.product(*(range(n) for n in per)):
            out[idx] = fn(*(a[idx] for a in arrs))
        return _Sym(tuple(out_shape), q, out, kind)

    # -- scalar nodes --------------------------------------------------------

    def unary(self, op: str, a: int) -> int:
        if op in ("neg", "abs", "sign"):
            return self.p.add(op, self.p.kind(a), a)
        if op in ("not",):
            return self.p.add(op, B, self.cast(a, B))
        if op in ("isnan", "isinf", "isfinite"):
            return self.p.add(op, B, self.cast(a, F))
        return self.p.add(op, F, self.cast(a, F))

    def binary(self, op: str, a: int, b: int) -> int:
        if op == "div":
            return self.p.add("div", F, self.cast(a, F), self.cast(b, F))
        if op in _LOGICAL:
            return self.p.add(op, B, self.cast(a, B), self.cast(b, B))
        k = _promote(self.p.kind(a), self.p.kind(b))
        if op in ("pow", "atan2", "hypot", "copysign", "nextafter"):
            k = F if op != "pow" or k != I else I
        if op == "pow":
            node = self.p.nodes[b]
            if node[0] == "lit" and node[1] != B:
                e = float(node[2])
                if e == 2.0:
                    return self.p.add("mul", k, self.cast(a, k), self.cast(a, k))
                if e == 1.0:
                    return self.cast(a, k)
                if e == 0.5 and k == F:
                    return self.p.add("sqrt", F, self.cast(a, F))
            if k == I:
                raise UnsupportedPrimitive("pow of integer values")
        a, b = self.cast(a, k), self.cast(b, k)
        if k == B and op in ("add", "mul", "max", "min"):  # torch's bool arithmetic
            op = {"add": "or", "mul": "and", "max": "or", "min": "and"}[op]
        return self.p.add(op, B if op in _COMPARE else k, a, b)

    def where(self, c: int, a: int, b: int) -> int:
        k = _promote(self.p.kind(a), self.p.kind(b))
        return self.p.add("where", k, self.cast(c, B), self.cast(a, k), self.cast(b, k))

    def chain(self, op: str, ids, kind: str, empty) -> int:
        ids = list(ids)
        if not ids:
            return self.lit(empty, kind)
        acc = self.cast(ids[0], kind)
        for i in ids[1:]:
            acc = self.binary(op, acc, self.cast(i, kind))
        return acc

    def dot(self, a_ids, b_ids, kind: str) -> int:
        prods = [self.binary("mul", self.cast(x, kind), self.cast(y, kind))
                 for x, y in zip(a_ids, b_ids)]
        return self.chain("add", prods, kind, 0)

    def dense(self, ins, W: torch.Tensor, bias: Optional[torch.Tensor]) -> list:
        """The n_out output nodes of one dense node: the inputs ``ins`` (n_in
        node ids) times the constant (n_in, n_out) ``W``, plus the constant
        (n_out,) ``bias`` where given."""
        w = self.const_offset(W)
        b = -1 if bias is None else self.const_offset(bias)
        d = self.p.add("dense", F, w, b, int(W.shape[1]), *(self.cast(i, F) for i in ins))
        return [self.p.add("dout", F, d, j) for j in range(int(W.shape[1]))]


def _is_sym(v) -> bool:
    return isinstance(v, _Sym)


def _map_args(args, fn):
    if isinstance(args, (list, tuple)):
        return type(args)(_map_args(a, fn) for a in args)
    return fn(args)


class _Tracer:
    """Lowers the nodes of one make_fx graph."""

    def __init__(self, lowering: _Lowering, gm):
        self.L = lowering
        self.gm = gm
        self.env: dict = {}

    def run(self, inputs: dict) -> list:
        outs = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = inputs[node.target]
            elif node.op == "get_attr":
                self.env[node] = getattr(self.gm, node.target)
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                outs = _map_args(node.args[0], lambda a: self.env[a] if hasattr(a, "op") else a)
            else:
                raise UnsupportedPrimitive(f"graph node {node.op}")
        return outs

    def call(self, node):
        args = _map_args(node.args, lambda a: self.env[a] if hasattr(a, "op") else a)
        kwargs = {k: _map_args(v, lambda a: self.env[a] if hasattr(a, "op") else a)
                  for k, v in node.kwargs.items()}
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        name = getattr(target, "__name__", str(target))
        base = name.split(".")[0]
        if base.endswith("_copy") and base not in ("_to_copy", "lift_fresh_copy"):
            base = base[:-len("_copy")]
        if any(base == r or base.startswith(r + "_") or base == "_" + r for r in _RANDOM):
            raise UnsupportedPrimitive(f"random op {name}")
        if base in ("_local_scalar_dense", "item", "nonzero", "masked_select", "unique",
                    "_assert_async"):
            raise UnsupportedPrimitive(f"{name}: a value read back from a traced tensor")
        flat = []
        _map_args((args, tuple(kwargs.values())), lambda a: flat.append(a))
        for a in flat:
            if isinstance(a, _Unsupported):
                raise UnsupportedPrimitive(a.what)
        if not any(_is_sym(a) for a in flat):
            return target(*args, **kwargs)  # constants alone: fold
        meta = node.meta.get("val")
        handler = getattr(self, "op_" + base, None)
        if handler is None:
            raise UnsupportedPrimitive(f"aten op {base!r} with batched operands")
        return handler(meta, *args, **kwargs)

    # -- helpers -----------------------------------------------------------------

    def out_kind(self, meta) -> str:
        return _kind_of(meta.dtype)

    def ew(self, meta, fn, *vals):
        return self.L.elementwise(fn, vals, tuple(meta.shape), self.out_kind(meta))

    def sym(self, v) -> _Sym:
        """Any value as a _Sym (constants without a batch axis)."""
        if _is_sym(v):
            return v
        t = torch.as_tensor(v)
        return _Sym(tuple(t.shape), None, self.L.const_elems(t), _kind_of(t.dtype))

    def per_sample_op(self, v: _Sym, fn, out_shape, out_bdim, kind=None):
        """A shape op on a _Sym: ``fn`` maps its elements (per-sample for a
        batched value, full for one that is not) to the result's."""
        return _Sym(tuple(out_shape), out_bdim, np.asarray(fn(v.elems), dtype=object),
                    kind or v.kind)

    def finish(self, meta, s: _Sym) -> _Sym:
        """Cast a result's nodes to the traced dtype's kind."""
        k = self.out_kind(meta)
        if s.kind == k:
            return s
        e = np.vectorize(lambda n: self.L.cast(n, k), otypes=[object])(s.elems) \
            if s.elems.size else s.elems
        return _Sym(s.shape, s.bdim, e, k)

    # -- elementwise -------------------------------------------------------------

    def _bin(self, op):
        return lambda meta, a, b, **kw: self.finish(
            meta, self.ew(meta, lambda x, y: self.L.binary(op, x, y), a, b))

    def _un(self, op):
        return lambda meta, a, **kw: self.finish(
            meta, self.ew(meta, lambda x: self.L.unary(op, x), a))

    def __getattr__(self, name):
        if not name.startswith("op_"):
            raise AttributeError(name)
        op = name[3:]
        binary = {"mul": "mul", "div": "div", "true_divide": "div", "pow": "pow",
                  "atan2": "atan2", "arctan2": "atan2", "maximum": "max", "minimum": "min",
                  "fmax": "max", "fmin": "min", "fmod": "fmod", "remainder": "remainder",
                  "hypot": "hypot", "copysign": "copysign", "eq": "eq", "ne": "ne",
                  "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "logical_and": "and",
                  "logical_or": "or", "logical_xor": "xor", "bitwise_and": "and",
                  "bitwise_or": "or", "bitwise_xor": "xor", "floor_divide": "floordiv",
                  "__and__": "and", "__or__": "or", "__xor__": "xor", "nextafter": "nextafter",
                  "bitwise_left_shift": "shl", "__lshift__": "shl",
                  "bitwise_right_shift": "shr", "__rshift__": "shr"}
        unary = {"neg": "neg", "negative": "neg", "abs": "abs", "absolute": "abs",
                 "exp": "exp", "exp2": "exp2", "expm1": "expm1", "log": "log",
                 "log2": "log2", "log10": "log10", "log1p": "log1p", "sqrt": "sqrt",
                 "rsqrt": "rsqrt", "sin": "sin", "cos": "cos", "tan": "tan", "asin": "asin",
                 "acos": "acos", "atan": "atan", "arcsin": "asin", "arccos": "acos",
                 "arctan": "atan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
                 "asinh": "asinh", "acosh": "acosh", "atanh": "atanh", "sigmoid": "sigmoid",
                 "erf": "erf", "erfc": "erfc", "erfinv": "erfinv", "floor": "floor",
                 "ceil": "ceil",
                 "trunc": "trunc", "fix": "trunc", "sign": "sign", "sgn": "sign",
                 "reciprocal": "reciprocal", "logical_not": "not", "bitwise_not": "not",
                 "isnan": "isnan", "isinf": "isinf", "isfinite": "isfinite"}
        if op in binary:
            return self._bin(binary[op])
        if op in unary:
            return self._un(unary[op])
        raise AttributeError(name)

    def scaled(self, v, alpha):
        """``v * alpha`` for the ``alpha`` of add and sub."""
        if alpha == 1:
            return v
        if not _is_sym(v):
            return v * alpha
        return self.L.elementwise(lambda x: self.L.binary("mul", x, self.L.lit(
            alpha, F if isinstance(alpha, float) else I)), [v], v.shape, v.kind)

    def op_add(self, meta, a, b, alpha=1):
        return self._bin("add")(meta, a, self.scaled(b, alpha))

    def op_sub(self, meta, a, b, alpha=1):
        return self._bin("sub")(meta, a, self.scaled(b, alpha))

    def op_rsub(self, meta, a, b, alpha=1):
        return self.op_sub(meta, b, a, alpha)

    def op_mul(self, meta, a, b):
        return self._bin("mul")(meta, a, b)

    def op_div(self, meta, a, b, rounding_mode=None):
        if rounding_mode is None:
            return self._bin("div")(meta, a, b)
        if self.out_kind(meta) == F:
            q = self.ew(meta, lambda x, y: self.L.binary("div", x, y), a, b)
            r = "floor" if rounding_mode == "floor" else "trunc"
            return self.finish(meta, self.per_sample_op(
                q, np.vectorize(lambda n: self.L.unary(r, n), otypes=[object]), q.shape,
                q.bdim, F))
        if rounding_mode == "floor":
            return self._bin("floordiv")(meta, a, b)
        raise UnsupportedPrimitive("integer division with rounding_mode='trunc'")

    def op_round(self, meta, a, decimals=0):
        if decimals:
            raise UnsupportedPrimitive("round with decimals")
        return self._un("round")(meta, a)

    def op_square(self, meta, a):
        return self.op_mul(meta, a, a)

    def op_relu(self, meta, a):
        return self._bin("max")(meta, a, 0.0)

    def op_silu(self, meta, a):
        return self.finish(meta, self.ew(
            meta, lambda x: self.L.binary("mul", x, self.L.unary("sigmoid", x)), a))

    def op_softplus(self, meta, a, beta=1, threshold=20):
        def f(x):
            bx = self.L.binary("mul", x, self.L.lit(beta, F))
            soft = self.L.binary("div", self.L.unary("log1p", self.L.unary("exp", bx)),
                                 self.L.lit(beta, F))
            return self.L.where(self.L.binary("gt", bx, self.L.lit(threshold, F)), x, soft)
        return self.finish(meta, self.ew(meta, f, a))

    def op_gelu(self, meta, a, approximate="none"):
        L = self.L
        if approximate == "tanh":
            def f(x):
                x3 = L.binary("mul", L.binary("mul", x, x), x)
                inner = L.binary("mul", L.lit(math.sqrt(2 / math.pi), F),
                                 L.binary("add", x, L.binary("mul", L.lit(0.044715, F), x3)))
                return L.binary("mul", L.binary("mul", L.lit(0.5, F), x),
                                L.binary("add", L.lit(1.0, F), L.unary("tanh", inner)))
        else:
            def f(x):
                e = L.unary("erf", L.binary("mul", x, L.lit(math.sqrt(0.5), F)))
                return L.binary("mul", L.binary("mul", x, L.lit(0.5, F)),
                                L.binary("add", L.lit(1.0, F), e))
        return self.finish(meta, self.ew(meta, f, a))

    def op_leaky_relu(self, meta, a, negative_slope=0.01):
        return self.finish(meta, self.ew(meta, lambda x: self.L.where(
            self.L.binary("gt", x, self.L.lit(0.0, F)), x,
            self.L.binary("mul", x, self.L.lit(negative_slope, F))), a))

    def op_elu(self, meta, a, alpha=1.0, scale=1.0, input_scale=1.0):
        # torch's elu: x > 0 ? scale x : alpha scale (exp(input_scale x) - 1)
        L = self.L

        def f(x):
            pos = x if scale == 1 else L.binary("mul", x, L.lit(scale, F))
            neg = L.unary("expm1", x if input_scale == 1 else
                          L.binary("mul", x, L.lit(input_scale, F)))
            if alpha * scale != 1:
                neg = L.binary("mul", neg, L.lit(alpha * scale, F))
            return L.where(L.binary("gt", x, L.lit(0.0, F)), pos, neg)
        return self.finish(meta, self.ew(meta, f, a))

    def op_native_layer_norm(self, meta, a, normalized_shape, weight=None, bias=None, eps=1e-5):
        """LayerNorm over the trailing ``normalized_shape`` feature axes:
        per row the statistics ``lnmean`` and ``lnrstd`` (1 / sqrt(var +
        eps), the biased variance), then (x - mean) rstd (times the weight,
        plus the bias) elementwise; also the (.., 1) mean and rstd."""
        a = self.sym(a)
        nd, r = len(normalized_shape), len(a.shape)
        if a.bdim is not None and a.bdim >= r - nd:
            raise UnsupportedPrimitive("layer_norm over the batch axis")
        if any(_is_sym(v) and v.bdim is not None for v in (weight, bias)):
            raise UnsupportedPrimitive("layer_norm with a batched weight or bias")
        L = self.L
        e = a.elems
        lead = e.shape[:e.ndim - nd]
        flat = e.reshape(lead + (-1,))
        n = flat.shape[-1]
        w, b = (None if v is None else L.full_elems(v).reshape(-1) for v in (weight, bias))
        out = np.empty(flat.shape, dtype=object)
        mean = np.empty(lead, dtype=object)
        rstd = np.empty(lead, dtype=object)
        for idx in itertools.product(*(range(k) for k in lead)):
            row = [L.cast(i, F) for i in flat[idx]]
            m = self.L.p.add("lnmean", F, *row)
            s = self.L.p.add("lnrstd", F, L.lit(eps, F), m, *row)
            mean[idx], rstd[idx] = m, s
            for j, x in enumerate(row):
                y = L.binary("mul", L.binary("sub", x, m), s)
                if w is not None:
                    y = L.binary("mul", y, w[j])
                if b is not None:
                    y = L.binary("add", y, b[j])
                out[idx + (j,)] = y
        stat_shape = lead + (1,) * nd
        return (self.finish(meta[0], _Sym(tuple(meta[0].shape), a.bdim, out.reshape(e.shape), F)),
                self.finish(meta[1], _Sym(tuple(meta[1].shape), a.bdim,
                                          mean.reshape(stat_shape), F)),
                self.finish(meta[2], _Sym(tuple(meta[2].shape), a.bdim,
                                          rstd.reshape(stat_shape), F)))

    def op_where(self, meta, c, a, b):
        return self.finish(meta, self.ew(meta, self.L.where, c, a, b))

    def op_masked_fill(self, meta, a, mask, value):
        return self.op_where(meta, mask, value, a)

    def op_clamp(self, meta, a, lo=None, hi=None):
        def f(x, *bounds):
            it = iter(bounds)
            if lo is not None:
                x = self.L.binary("max", x, next(it))
            if hi is not None:
                x = self.L.binary("min", x, next(it))
            return x
        vals = [a] + [b for b in (lo, hi) if b is not None]
        return self.finish(meta, self.ew(meta, f, *vals))

    def op_clip(self, meta, a, lo=None, hi=None):
        return self.op_clamp(meta, a, lo, hi)

    def op_clamp_min(self, meta, a, lo):
        return self.op_clamp(meta, a, lo, None)

    def op_clamp_max(self, meta, a, hi):
        return self.op_clamp(meta, a, None, hi)

    def op_hardtanh(self, meta, a, lo=-1.0, hi=1.0):
        return self.op_clamp(meta, a, lo, hi)

    def op_addcmul(self, meta, a, t1, t2, value=1):
        def f(x, y, z):
            return self.L.binary("add", x, self.L.binary(
                "mul", self.L.binary("mul", y, z), self.L.lit(value, F)))
        return self.finish(meta, self.ew(meta, f, a, t1, t2))

    def op_addcdiv(self, meta, a, t1, t2, value=1):
        def f(x, y, z):
            return self.L.binary("add", x, self.L.binary(
                "mul", self.L.binary("div", y, z), self.L.lit(value, F)))
        return self.finish(meta, self.ew(meta, f, a, t1, t2))

    def op__to_copy(self, meta, a, dtype=None, **kw):
        return self.finish(meta, self.sym(a))

    def op_to(self, meta, a, *args, **kw):
        return self.finish(meta, self.sym(a))

    def op_type_as(self, meta, a, b):
        return self.finish(meta, self.sym(a))

    def op_copy(self, meta, dst, src, non_blocking=False):
        # dst's shape and dtype with src's values (a functionalized in-place copy)
        return self.finish(meta, self.ew(meta, lambda d, s: s, dst, src))

    def _identity(self, meta, a, *args, **kw):
        return self.finish(meta, self.sym(a))

    op_clone = op_alias = op_detach = op_lift_fresh = op_contiguous = _identity
    op_lift_fresh_copy = op_positive = op_resolve_conj = op_resolve_neg = _identity

    def _like(self, meta, a, value):
        s = self.sym(a)
        k = self.out_kind(meta)
        per = s.elems.shape
        return _Sym(s.shape, s.bdim, np.full(per, self.L.lit(value, k), dtype=object), k)

    def op_zeros_like(self, meta, a, **kw):
        return self._like(meta, a, 0)

    def op_empty_like(self, meta, a, **kw):
        return self._like(meta, a, 0)

    def op_ones_like(self, meta, a, **kw):
        return self._like(meta, a, 1)

    def op_full_like(self, meta, a, value, **kw):
        if _is_sym(value):
            raise UnsupportedPrimitive("full_like with a traced fill value")
        return self._like(meta, a, value)

    def _new(self, meta, value):
        """A new tensor of the traced shape filled with ``value`` (``new_zeros``
        and its kin take a batched value's dtype and device, not its
        values): its batch-sized axis, where it has one, is the batch axis.
        ``out = s.new_zeros(B, 2 n - 1); out[:, ::2] = s``, torch's interior
        padding (JAX's ``pad`` with interior padding), lowers to one of
        these and a ``slice_scatter`` with a step."""
        shape, k = tuple(meta.shape), self.out_kind(meta)
        axes = [d for d, n in enumerate(shape) if n == self.L.batch]
        if len(axes) > 1:
            raise UnsupportedPrimitive("a new tensor with several batch-sized axes")
        q = axes[0] if axes else None
        per = shape if q is None else _drop(shape, q)
        return _Sym(shape, q, np.full(per, self.L.lit(value, k), dtype=object), k)

    def op_new_zeros(self, meta, a, size, **kw):
        return self._new(meta, 0)

    def op_new_empty(self, meta, a, size, **kw):
        return self._new(meta, 0)

    def op_new_ones(self, meta, a, size, **kw):
        return self._new(meta, 1)

    def op_new_full(self, meta, a, size, value, **kw):
        if _is_sym(value):
            raise UnsupportedPrimitive("new_full with a traced fill value")
        return self._new(meta, value)

    # -- shapes ------------------------------------------------------------------

    def op_view(self, meta, a, size, *args):
        a = self.sym(a)
        new = tuple(meta.shape)
        if a.bdim is None:
            return _Sym(new, None, a.elems.reshape(new), a.kind)
        p, old = a.bdim, a.shape
        pre = math.prod(old[:p])
        for q in range(len(new)):
            if new[q] == old[p] and math.prod(new[:q]) == pre:
                return _Sym(new, q, a.elems.reshape(_drop(new, q)), a.kind)
        raise UnsupportedPrimitive(f"view/reshape merging the batch axis into features "
                                   f"({old} -> {new})")

    op_reshape = op__unsafe_view = op_view

    def op_permute(self, meta, a, dims):
        a = self.sym(a)
        r = len(a.shape)
        dims = [_norm_dim(d, r) for d in dims]
        if a.bdim is None:
            return _Sym(tuple(meta.shape), None, np.transpose(a.elems, dims), a.kind)
        q = dims.index(a.bdim)
        sub = [d - (d > a.bdim) for d in dims if d != a.bdim]
        return _Sym(tuple(meta.shape), q, np.transpose(a.elems, sub), a.kind)

    def op_t(self, meta, a):
        a = self.sym(a)
        return self.op_permute(meta, a, list(range(len(a.shape)))[::-1])

    def op_transpose(self, meta, a, d0, d1):
        a = self.sym(a)
        dims = list(range(len(a.shape)))
        d0, d1 = _norm_dim(d0, len(dims)), _norm_dim(d1, len(dims))
        dims[d0], dims[d1] = dims[d1], dims[d0]
        return self.op_permute(meta, a, dims)

    def op_expand(self, meta, a, size, implicit=False):
        new = tuple(meta.shape)
        s = self.sym(a)
        r = len(new)
        if s.bdim is not None:
            q = s.bdim + r - len(s.shape)
            return _Sym(new, q, self.L.aligned(s, new, q), s.kind)
        # a value that is not batched, broadcast: a new batch-sized axis is the batch
        e = s.elems.reshape((1,) * (r - s.elems.ndim) + s.elems.shape)
        cands = [d for d in range(r) if new[d] == self.L.batch and e.shape[d] == 1]
        if len(cands) > 1:
            raise UnsupportedPrimitive("expand introducing several batch-sized axes")
        if not cands:
            return _Sym(new, None, np.broadcast_to(e, new), s.kind)
        q = cands[0]
        return _Sym(new, q, np.broadcast_to(np.squeeze(e, q), _drop(new, q)), s.kind)

    def op_broadcast_to(self, meta, a, size):
        return self.op_expand(meta, a, size)

    def op_unsqueeze(self, meta, a, dim):
        a = self.sym(a)
        r = len(a.shape) + 1
        d = _norm_dim(dim, r)
        if a.bdim is None:
            return _Sym(tuple(meta.shape), None, np.expand_dims(a.elems, d), a.kind)
        q = a.bdim + (d <= a.bdim)
        return _Sym(tuple(meta.shape), q, np.expand_dims(a.elems, d - (d > q)), a.kind)

    def op_squeeze(self, meta, a, dims=None):
        a = self.sym(a)
        r = len(a.shape)
        if dims is None:
            dims = [d for d in range(r) if a.shape[d] == 1]
        elif isinstance(dims, int):
            dims = [dims]
        dims = sorted({_norm_dim(d, r) for d in dims if a.shape[_norm_dim(d, r)] == 1})
        if a.bdim is not None and a.bdim in dims:
            raise UnsupportedPrimitive("squeeze of the batch axis")
        if a.bdim is None:
            return _Sym(tuple(meta.shape), None,
                        a.elems.reshape(tuple(meta.shape)), a.kind)
        q = a.bdim - sum(d < a.bdim for d in dims)
        return _Sym(tuple(meta.shape), q, a.elems.reshape(_drop(tuple(meta.shape), q)),
                    a.kind)

    def _feature_axis(self, a: _Sym, dim: int, what: str) -> int:
        """The axis of the per-sample elements that is axis ``dim`` of the
        full value; unsupported where it is the batch axis."""
        d = _norm_dim(dim, len(a.shape))
        if a.bdim is None:
            return d
        if d == a.bdim:
            raise UnsupportedPrimitive(f"{what} along the batch axis")
        return d - (d > a.bdim)

    def op_select(self, meta, a, dim, index):
        a = self.sym(a)
        ax = self._feature_axis(a, dim, "select")
        d = _norm_dim(dim, len(a.shape))
        q = None if a.bdim is None else a.bdim - (d < a.bdim)
        return _Sym(tuple(meta.shape), q, np.take(a.elems, index, axis=ax), a.kind)

    def op_slice(self, meta, a, dim=0, start=None, end=None, step=1):
        a = self.sym(a)
        d = _norm_dim(dim, len(a.shape))
        if a.bdim is not None and d == a.bdim:
            n = a.shape[d]
            s0, e0 = slice(start, end, step).indices(n)[:2]
            if s0 == 0 and e0 == n and step == 1:
                return a
            raise UnsupportedPrimitive("slice along the batch axis")
        ax = self._feature_axis(a, dim, "slice")
        idx = [slice(None)] * a.elems.ndim
        idx[ax] = slice(start, end, step)
        return _Sym(tuple(meta.shape), a.bdim, a.elems[tuple(idx)], a.kind)

    def op_narrow(self, meta, a, dim, start, length):
        return self.op_slice(meta, a, dim, start, start + length)

    def _scatter(self, meta, base, src, dim, index):
        """``base`` with ``src`` written at ``index`` of axis ``dim``."""
        b = self.sym(base)
        full = tuple(meta.shape)
        q = b.bdim
        if q is None and _is_sym(src) and src.bdim is not None:
            d = _norm_dim(dim, len(full))
            q = src.bdim + (d <= src.bdim) if isinstance(index, int) else src.bdim
        if q is not None and b.bdim is None:
            e = self.L.aligned(b, full, q)
        else:
            e = b.elems
        e = np.array(e, dtype=object)
        d = _norm_dim(dim, len(full))
        if q is not None and d == q:
            raise UnsupportedPrimitive("scatter along the batch axis")
        ax = d if q is None else d - (d > q)
        idx = [slice(None)] * e.ndim
        idx[ax] = index
        sub_shape = list(full)
        if isinstance(index, int):
            sub_shape.pop(d)
        else:
            sub_shape[d] = len(range(*index.indices(full[d])))
        sub_q = None if q is None else (q - (d < q) if isinstance(index, int) else q)
        kind = _promote(b.kind)
        src_e = self.L.aligned(src, tuple(sub_shape), sub_q)
        vals = np.vectorize(lambda n: self.L.cast(n, kind), otypes=[object])(src_e) \
            if src_e.size else src_e
        e[tuple(idx)] = vals if vals.ndim else vals[()]  # one element: the node, not an array
        return self.finish(meta, _Sym(full, q, e, kind))

    def op_select_scatter(self, meta, base, src, dim, index):
        return self._scatter(meta, base, src, dim, index)

    def op_slice_scatter(self, meta, base, src, dim=0, start=None, end=None, step=1):
        return self._scatter(meta, base, src, dim, slice(start, end, step))

    def op_cat(self, meta, tensors, dim=0):
        full = tuple(meta.shape)
        r = len(full)
        d = _norm_dim(dim, r)
        parts = [t for t in tensors if not (hasattr(t, "shape") and tuple(t.shape) == (0,))]
        q = self.L.batch_position([p for p in parts if _is_sym(p)], full)
        if q is not None and d == q:
            raise UnsupportedPrimitive("cat along the batch axis")
        arrs = []
        for p in parts:
            shp = list(full)
            shp[d] = p.shape[d] if len(p.shape) == r else 1
            arrs.append(self.L.aligned(p, tuple(shp), q))
        ax = d if q is None else d - (d > q)
        kind = _promote(*[self.sym(p).kind if _is_sym(p) else _kind_of(p.dtype)
                          for p in parts])
        return self.finish(meta, _Sym(full, q, np.concatenate(arrs, axis=ax), kind))

    op_concat = op_concatenate = op_cat

    def op_stack(self, meta, tensors, dim=0):
        d = _norm_dim(dim, len(meta.shape))
        ups = [self.op_unsqueeze(_Meta(t.shape[:d] + (1,) + t.shape[d:], None), t, d)
               if _is_sym(t) else torch.as_tensor(t).unsqueeze(d) for t in tensors]
        return self.op_cat(meta, ups, d)

    def op_split(self, meta, a, split_size, dim=0):
        a = self.sym(a)
        d = _norm_dim(dim, len(a.shape))
        n = a.shape[d]
        sizes = [min(split_size, n - i) for i in range(0, n, split_size)] if \
            isinstance(split_size, int) else list(split_size)
        return self.op_split_with_sizes(meta, a, sizes, dim)

    def op_split_with_sizes(self, meta, a, sizes, dim=0):
        a = self.sym(a)
        d = _norm_dim(dim, len(a.shape))
        outs, at = [], 0
        for sz, m in zip(sizes, meta):
            outs.append(self.op_slice(m, a, d, at, at + sz))
            at += sz
        return outs

    def op_unbind(self, meta, a, dim=0):
        a = self.sym(a)
        return [self.op_select(m, a, dim, i) for i, m in enumerate(meta)]

    def op_chunk(self, meta, a, chunks, dim=0):
        return self.op_split_with_sizes(meta, a, [m.shape[_norm_dim(dim, len(m.shape))]
                                                  for m in meta], dim)

    def op_flip(self, meta, a, dims):
        a = self.sym(a)
        axes = [self._feature_axis(a, d, "flip") for d in dims]
        return _Sym(a.shape, a.bdim, np.flip(a.elems, axes), a.kind)

    def op_constant_pad_nd(self, meta, a, pad, value=0):
        a = self.sym(a)
        r = len(a.shape)
        widths = [(0, 0)] * r
        for i in range(len(pad) // 2):
            widths[r - 1 - i] = (pad[2 * i], pad[2 * i + 1])
        if a.bdim is not None:
            if widths[a.bdim] != (0, 0):
                raise UnsupportedPrimitive("pad along the batch axis")
            widths = _drop(widths, a.bdim)
        e = a.elems
        for ax, (lo, hi) in enumerate(widths):
            if lo < 0 or hi < 0:
                idx = [slice(None)] * e.ndim
                idx[ax] = slice(-lo if lo < 0 else 0, e.shape[ax] + hi if hi < 0 else None)
                e = e[tuple(idx)]
                lo, hi = max(lo, 0), max(hi, 0)
            if lo or hi:
                fill = self.L.lit(value, a.kind)
                shp_lo = list(e.shape)
                shp_lo[ax] = lo
                shp_hi = list(e.shape)
                shp_hi[ax] = hi
                e = np.concatenate([np.full(shp_lo, fill, dtype=object), e,
                                    np.full(shp_hi, fill, dtype=object)], axis=ax)
        return _Sym(tuple(meta.shape), a.bdim, e, a.kind)

    def op_index_select(self, meta, a, dim, index):
        if _is_sym(index):
            raise UnsupportedPrimitive("index_select with a traced index")
        a = self.sym(a)
        ax = self._feature_axis(a, dim, "index_select")
        return _Sym(tuple(meta.shape), a.bdim,
                    np.take(a.elems, index.reshape(-1).tolist(), axis=ax), a.kind)

    def op_index(self, meta, a, indices):
        a = self.sym(a)
        live = [(d, i) for d, i in enumerate(indices) if i is not None]
        if len(live) != 1 or _is_sym(live[0][1]) or live[0][1].ndim != 1 or \
                live[0][1].dtype == torch.bool:
            raise UnsupportedPrimitive("index with anything but one constant 1-D index")
        d, idx = live[0]
        ax = self._feature_axis(a, d, "index")
        return _Sym(tuple(meta.shape), a.bdim, np.take(a.elems, idx.tolist(), axis=ax), a.kind)

    # -- reductions ----------------------------------------------------------------

    def _reduce(self, meta, a, dims, keepdim, fn, name):
        """``fn(list of node ids) -> node id`` over the feature axes ``dims``
        of ``a`` (all of them for None)."""
        a = self.sym(a)
        r = len(a.shape)
        dims = list(range(r)) if dims is None or dims == [] else \
            [_norm_dim(d, r) for d in ([dims] if isinstance(dims, int) else dims)]
        if a.bdim is not None and a.bdim in dims:
            raise UnsupportedPrimitive(f"{name} over the batch axis")
        axes = dims if a.bdim is None else [d - (d > a.bdim) for d in dims]
        keep = [ax for ax in range(a.elems.ndim) if ax not in axes]
        moved = np.transpose(a.elems, keep + axes)
        lead = moved.shape[:len(keep)]
        flat = moved.reshape(lead + (-1,))
        out = np.empty(lead, dtype=object)
        for idx in itertools.product(*(range(n) for n in lead)):
            out[idx] = fn(list(flat[idx]))
        q = a.bdim
        if q is not None and not keepdim:
            q -= sum(d < q for d in dims)
        if keepdim:
            for ax in sorted(axes):
                out = np.expand_dims(out, ax)
        return self.finish(meta, _Sym(tuple(meta.shape), q, out, self.out_kind(meta)))

    def op_sum(self, meta, a, dims=None, keepdim=False, dtype=None):
        k = self.out_kind(meta)
        return self._reduce(meta, a, dims, keepdim, lambda ids: self.L.chain("add", ids, k, 0),
                            "sum")

    def op_mean(self, meta, a, dims=None, keepdim=False, dtype=None):
        def f(ids):
            s = self.L.chain("add", ids, F, 0)
            return self.L.binary("div", s, self.L.lit(float(len(ids)), F))
        return self._reduce(meta, a, dims, keepdim, f, "mean")

    def op_prod(self, meta, a, dim=None, keepdim=False, dtype=None):
        k = self.out_kind(meta)
        return self._reduce(meta, a, dim, keepdim, lambda ids: self.L.chain("mul", ids, k, 1),
                            "prod")

    def op_amax(self, meta, a, dims=(), keepdim=False):
        k = self.out_kind(meta)
        return self._reduce(meta, a, list(dims) or None, keepdim,
                            lambda ids: self.L.chain("max", ids, k, -math.inf), "amax")

    def op_amin(self, meta, a, dims=(), keepdim=False):
        k = self.out_kind(meta)
        return self._reduce(meta, a, list(dims) or None, keepdim,
                            lambda ids: self.L.chain("min", ids, k, math.inf), "amin")

    def op_max(self, meta, a, dim=None, keepdim=False):
        if _is_sym(dim) or not isinstance(dim, (int, type(None))):
            return self.op_maximum(meta, a, dim)
        if dim is None:
            return self.op_amax(meta, a, (), False)
        return (self.op_amax(meta[0], a, (dim,), keepdim),
                _Unsupported("the indices of max over a dim"))

    def op_min(self, meta, a, dim=None, keepdim=False):
        if _is_sym(dim) or not isinstance(dim, (int, type(None))):
            return self.op_minimum(meta, a, dim)
        if dim is None:
            return self.op_amin(meta, a, (), False)
        return (self.op_amin(meta[0], a, (dim,), keepdim),
                _Unsupported("the indices of min over a dim"))

    def op_any(self, meta, a, dim=None, keepdim=False):
        return self._reduce(meta, a, dim, keepdim, lambda ids: self.L.chain("or", ids, B, False),
                            "any")

    def op_all(self, meta, a, dim=None, keepdim=False):
        return self._reduce(meta, a, dim, keepdim,
                            lambda ids: self.L.chain("and", ids, B, True), "all")

    def op_linalg_vector_norm(self, meta, a, ord=2, dim=None, keepdim=False, dtype=None):
        L = self.L

        def f(ids):
            ab = [L.unary("abs", i) for i in ids]
            if ord == 2:
                return L.unary("sqrt", L.chain("add", [L.binary("mul", i, i) for i in ids],
                                               F, 0))
            if ord == 1:
                return L.chain("add", ab, F, 0)
            if ord == math.inf:
                return L.chain("max", ab, F, 0)
            if ord == 0:
                return L.chain("add", [L.cast(L.binary("ne", i, L.lit(0.0, F)), F)
                                       for i in ids], F, 0)
            p = L.lit(float(ord), F)
            s = L.chain("add", [L.binary("pow", i, p) for i in ab], F, 0)
            return L.binary("pow", s, L.lit(1.0 / ord, F))
        return self._reduce(meta, a, dim, keepdim, f, "norm")

    def op_logsumexp(self, meta, a, dims, keepdim=False):
        L = self.L

        def f(ids):
            m = L.chain("max", ids, F, -math.inf)
            s = L.chain("add", [L.unary("exp", L.binary("sub", i, m)) for i in ids], F, 0)
            return L.binary("add", L.unary("log", s), m)
        return self._reduce(meta, a, dims, keepdim, f, "logsumexp")

    def op_var(self, meta, a, dims=None, correction=None, keepdim=False, unbiased=None):
        L = self.L
        corr = 1 if correction is None else correction

        def f(ids):
            n = L.lit(float(len(ids)), F)
            mean = L.binary("div", L.chain("add", ids, F, 0), n)
            dev = [L.binary("sub", i, mean) for i in ids]
            ss = L.chain("add", [L.binary("mul", d, d) for d in dev], F, 0)
            return L.binary("div", ss, L.lit(float(max(len(ids) - corr, 0)), F))
        return self._reduce(meta, a, dims, keepdim, f, "var")

    def op_std(self, meta, a, dims=None, correction=None, keepdim=False, unbiased=None):
        v = self.op_var(meta, a, dims, correction, keepdim)
        return self.per_sample_op(v, np.vectorize(lambda n: self.L.unary("sqrt", n),
                                                  otypes=[object]), v.shape, v.bdim, F)

    def op_roll(self, meta, a, shifts, dims=()):
        a = self.sym(a)
        if not dims:
            raise UnsupportedPrimitive("roll of the flattened value (over the batch axis)")
        shifts = [shifts] if isinstance(shifts, int) else list(shifts)
        axes = [self._feature_axis(a, d, "roll") for d in dims]
        return _Sym(a.shape, a.bdim, np.roll(a.elems, shifts, axes), a.kind)

    def op_repeat(self, meta, a, repeats):
        a = self.sym(a)
        reps = list(repeats)
        r = len(reps)
        e = a.elems
        if a.bdim is None:
            e = e.reshape((1,) * (r - e.ndim) + e.shape)
            return _Sym(tuple(meta.shape), None, np.tile(e, reps), a.kind)
        q = a.bdim + r - len(a.shape)
        if reps[q] != 1:
            raise UnsupportedPrimitive("repeat along the batch axis")
        per = reps[:q] + reps[q + 1:]
        e = e.reshape((1,) * (len(per) - e.ndim) + e.shape)
        return _Sym(tuple(meta.shape), q, np.tile(e, per), a.kind)

    def _softmax(self, meta, a, dim, log):
        a = self.sym(a)
        ax = self._feature_axis(a, dim, "softmax")
        L = self.L
        e = np.moveaxis(a.elems, ax, -1)
        out = np.empty(e.shape, dtype=object)
        for idx in itertools.product(*(range(n) for n in e.shape[:-1])):
            row = list(e[idx])
            m = L.chain("max", row, F, -math.inf)
            sh = [L.binary("sub", i, m) for i in row]
            ex = [L.unary("exp", i) for i in sh]
            s = L.chain("add", ex, F, 0)
            out[idx] = [L.binary("sub", i, L.unary("log", s)) for i in sh] if log else \
                [L.binary("div", i, s) for i in ex]
        return self.finish(meta, _Sym(a.shape, a.bdim, np.moveaxis(out, -1, ax), F))

    def op__softmax(self, meta, a, dim, half_to_float=False):
        return self._softmax(meta, a, dim, False)

    def op__log_softmax(self, meta, a, dim, half_to_float=False):
        return self._softmax(meta, a, dim, True)

    op_softmax = op__softmax
    op_log_softmax = op__log_softmax

    def _scan(self, meta, a, dim, op, name):
        """The inclusive scan of ``a`` along feature axis ``dim``: each
        element the binary ``op`` (a node op, or ``fn(acc, x) -> node``) of
        the one before and itself."""
        a = self.sym(a)
        ax = self._feature_axis(a, dim, name)
        k = self.out_kind(meta)
        combine = op if callable(op) else (lambda x, y: self.L.binary(op, x, y))
        e = np.moveaxis(a.elems, ax, -1)
        out = np.empty(e.shape, dtype=object)
        for idx in itertools.product(*(range(n) for n in e.shape[:-1])):
            acc = None
            for j, n in enumerate(e[idx]):
                acc = self.L.cast(n, k) if acc is None else combine(acc, n)
                out[idx + (j,)] = acc
        return self.finish(meta, _Sym(a.shape, a.bdim, np.moveaxis(out, -1, ax), k))

    def op_cumsum(self, meta, a, dim, dtype=None):
        return self._scan(meta, a, dim, "add", "cumsum")

    def op_cumprod(self, meta, a, dim, dtype=None):
        return self._scan(meta, a, dim, "mul", "cumprod")

    def op_cummax(self, meta, a, dim):
        return (self._scan(meta[0], a, dim, "max", "cummax"),
                _Unsupported("the indices of cummax"))

    def op_cummin(self, meta, a, dim):
        return (self._scan(meta[0], a, dim, "min", "cummin"),
                _Unsupported("the indices of cummin"))

    def op_logcumsumexp(self, meta, a, dim):
        """log(sum of exp) of each prefix, a step at a time as torch's scan:
        max + log1p(exp(min - max)), the infinite max kept."""
        L = self.L

        def logaddexp(x, y):
            m = L.binary("max", x, y)
            r = L.binary("add", m, L.unary("log1p", L.unary(
                "exp", L.binary("sub", L.binary("min", x, y), m))))
            return L.where(L.unary("isinf", m), m, r)
        return self._scan(meta, a, dim, logaddexp, "logcumsumexp")

    # -- contractions ------------------------------------------------------------

    def _unit(self, v, partner_bdim=None):
        """A matmul operand as (an object array over its full shape with the
        batch axis of size 1, that axis or None)."""
        if _is_sym(v) and v.bdim is not None:
            return np.expand_dims(v.elems, v.bdim), v.bdim
        if isinstance(v, torch.Tensor) and partner_bdim is not None and \
                v.ndim > partner_bdim and v.shape[partner_bdim] == self.L.batch:
            v = self.L.uniform_tensor(v, partner_bdim)
        e = self.L.full_elems(v)
        if partner_bdim is not None and e.ndim > partner_bdim and \
                e.shape[partner_bdim] == self.L.batch:
            return self.L.uniform_along(e, partner_bdim), None
        return e, None

    def _matmul(self, meta, a, b, kind=None):
        """The batched matrix product of ``a`` (..., i, k) and ``b`` (..., k,
        j), leading axes broadcast (``mm``, ``bmm``)."""
        ea, pa = self._unit(a)
        eb, pb = self._unit(b)
        if pa is None and pb is None:
            raise UnsupportedPrimitive("matmul of values that are not batched")
        if pa is not None and pb is None:
            eb, _ = self._unit(b, pa if pa < ea.ndim - 2 else None)
        if pb is not None and pa is None:
            ea, _ = self._unit(a, pb if pb < eb.ndim - 2 else None)
        ra, rb = ea.ndim, eb.ndim
        if (pa is not None and pa == ra - 1) or (pb is not None and pb == rb - 2):
            raise UnsupportedPrimitive("matmul contracting the batch axis")
        out_shape = tuple(meta.shape)
        r = len(out_shape)
        qa = None if pa is None else (pa + r - ra if pa < ra - 2 else r - 2)
        qb = None if pb is None else (pb + r - rb if pb < rb - 2 else r - 1)
        if qa is not None and qb is not None and qa != qb:
            raise UnsupportedPrimitive("matmul of two batched operands outside a per-sample "
                                       "contraction")
        q = qa if qa is not None else qb
        k = kind or self.out_kind(meta)
        lead = np.broadcast_shapes(ea.shape[:-2], eb.shape[:-2])
        ea = np.broadcast_to(ea, lead + ea.shape[-2:])
        eb = np.broadcast_to(eb, lead + eb.shape[-2:])
        out = np.empty(lead + (ea.shape[-2], eb.shape[-1]), dtype=object)
        for idx in itertools.product(*(range(n) for n in out.shape)):
            row = ea[idx[:-2] + (idx[-2], slice(None))]
            col = eb[idx[:-2] + (slice(None), idx[-1])]
            out[idx] = self.L.dot(row, col, k)
        return _Sym(out_shape, q, np.squeeze(out, q), k)

    def _dense(self, meta, a, b, bias=None):
        """``a @ b (+ bias)`` as one dense node where the lowering takes
        products as dense nodes and ``a`` is a batched (B, n_in) value, ``b``
        a constant float (n_in, n_out) matrix and ``bias`` a constant of
        n_out floats or None; else None."""
        if not (self.L.dense_products and _is_sym(a) and a.bdim == 0 and len(a.shape) == 2
                and isinstance(b, torch.Tensor) and b.ndim == 2 and b.dtype.is_floating_point
                and b.shape[0] == a.shape[1] and meta.dtype.is_floating_point):
            return None
        if bias is not None and not (isinstance(bias, torch.Tensor)
                                     and bias.dtype.is_floating_point
                                     and tuple(bias.shape) in ((b.shape[1],), (1, b.shape[1]))):
            return None
        outs = self.L.dense(list(a.elems.reshape(-1)), b,
                            None if bias is None else bias.reshape(-1))
        return self.finish(meta, _Sym(tuple(meta.shape), 0, np.array(outs, dtype=object), F))

    def op_mm(self, meta, a, b):
        dense = self._dense(meta, a, b)
        if dense is not None:
            return dense
        return self.finish(meta, self._matmul(meta, a, b))

    op_bmm = op_mm

    def op_matmul(self, meta, a, b):
        ra = len(self.sym(a).shape) if _is_sym(a) else a.ndim
        rb = len(self.sym(b).shape) if _is_sym(b) else b.ndim
        if ra == 1 or rb == 1:
            raise UnsupportedPrimitive("matmul with a 1-D operand (use mv or dot)")
        return self.op_mm(meta, a, b)

    def op_mv(self, meta, a, v):
        vs = self.sym(v)
        col = _Sym(vs.shape + (1,), vs.bdim, np.expand_dims(vs.elems, -1), vs.kind)
        out = self._matmul(_Meta(tuple(meta.shape) + (1,), meta.dtype), a, col)
        return self.finish(meta, _Sym(tuple(meta.shape), out.bdim,
                                      out.elems.reshape(_drop(tuple(meta.shape), out.bdim)
                                                        if out.bdim is not None
                                                        else tuple(meta.shape)),
                                      out.kind))

    def op_dot(self, meta, a, b):
        sa, sb = self.sym(a), self.sym(b)
        if sa.bdim is not None or sb.bdim is not None:
            raise UnsupportedPrimitive("dot contracting the batch axis")
        k = self.out_kind(meta)
        return _Sym((), None, np.array(self.L.dot(sa.elems.reshape(-1), sb.elems.reshape(-1), k),
                                       dtype=object), k)

    def op_addmm(self, meta, bias, a, b, beta=1, alpha=1):
        if beta == 1 and alpha == 1:
            dense = self._dense(meta, a, b, bias)
            if dense is not None:
                return dense
        prod = self._dense(meta, a, b) or self._matmul(meta, a, b)
        L = self.L

        def f(c, m):
            m = L.binary("mul", m, L.lit(alpha, F)) if alpha != 1 else m
            c = L.binary("mul", c, L.lit(beta, F)) if beta != 1 else c
            return L.binary("add", c, m) if beta != 0 else m
        return self.finish(meta, self.ew(meta, f, bias, prod))

    op_baddbmm = op_addmm


class _Unsupported:
    """A result the lowering cannot give; raises where the program reads it."""

    def __init__(self, what: str):
        self.what = what
        self.shape = ()


class _Meta:
    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def _make_fx(fn, args):
    """The functionalized aten graph of ``fn`` at ``args`` and the device it
    was traced on; a user's
    ValueError or TypeError surfaces, anything else that stops the trace is
    unsupported.  Traced on the CPU, or on the card where the callables
    read CUDA tensors (a closure's constants on the controller's device)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        try:
            return make_fx(torch.func.functionalize(fn))(*args), args[0].device
        except RuntimeError as e:
            if not (torch.cuda.is_available() and "device" in str(e)):
                raise
            args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
            return make_fx(torch.func.functionalize(fn))(*args), args[0].device
    except (ValueError, TypeError):
        raise
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e) or "data-dependent" in str(e):
            raise UnsupportedPrimitive(
                "a Python number read from a traced value (.item(), float(), int(), "
                "range(t) or an if on a tensor): the program would depend on the data"
            ) from None
        raise UnsupportedPrimitive(f"tracing failed: {type(e).__name__}: {e}") from None
    except NotImplementedError as e:
        raise UnsupportedPrimitive(f"tracing failed: {e}") from None


def _probe(n: int, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(PROBE_BATCH, n, generator=g, dtype=torch.float64).to(dtype)


def _lower_outputs(lowering: _Lowering, gm, inputs: dict, want: list) -> list:
    """The traced graph's outputs as one sample's node ids: ``want`` gives
    each output's per-sample element count (nx for the state, 1 for a
    cost), its batch axis leading."""
    outs = _Tracer(lowering, gm).run(inputs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if len(outs) != len(want):
        raise UnsupportedPrimitive(f"expected {len(want)} outputs, got {len(outs)}")
    flat = []
    for v, n in zip(outs, want):
        if isinstance(v, _Unsupported):
            raise UnsupportedPrimitive(v.what)
        shape = tuple(v.shape)
        if not shape or shape[0] != lowering.batch or math.prod(shape[1:]) != n:
            raise UnsupportedPrimitive(
                f"an output of shape {shape}: expected ({lowering.batch}, ...) with {n} "
                f"element(s) a sample")
        e = lowering.aligned(v, shape, 0).reshape(-1)
        flat.append([lowering.cast(i, F) for i in e])
    return flat


@dataclasses.dataclass(frozen=True, eq=False)
class GeneratedModel(KernelModel):
    """A device model traced from the user's callables: ``dynamics(state,
    action, t=0)`` and ``running_cost(next_state, action, t=0)`` are the
    program's plain version (:meth:`Program.evaluate`); ``consts`` its
    constants buffer in float32 (the kernels'), ``consts64`` in float64;
    ``program`` its nodes with ``outputs`` (the nx next-state nodes, then
    the cost node)."""

    program: Program = None
    outputs: tuple = ()
    consts64: torch.Tensor = None

    def rollout_step(self, state, action, t):
        ns = self.dynamics(state, action, t)
        return ns, self.running_cost(ns, action, t)

    def activation_ld(self) -> int:
        """Floats of an activation row of its dense layers, the dynamics' and
        the running cost's (the widest, in or out, rounded up to four); for a
        program without dense layers, ``ROWS_LD`` beyond ``MAXN`` states or
        actions (a per-sample program whose state lives in shared memory,
        run by the block kernels) and 0 within (the per-sample kernels)."""
        widest = _widest(self.program, self.outputs)
        return widest or (ROWS_LD if max(self.nx, self.nu) > MAXN else 0)


def _widest(prog: Program, outputs) -> int:
    """The widest dense layer of the outputs, in or out, rounded up to four
    floats; 0 for none."""
    widest = max((max(n_in, n_out) for *_, n_in, n_out in prog.dense_layers(outputs)),
                 default=0)
    return -(-widest // 4) * 4


def _stack(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([_broadcast(v, like) for v in vals], dim=1)


def _broadcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(like.dtype).expand(like.shape[0]) if v.ndim == 0 else v.to(like.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class GeneratedTerminal(KernelTerminal):
    """A final-state terminal cost traced from the user's callable: ``cost
    (final_state, final_action)`` is the program's plain version."""

    program: Program = None
    output: int = -1
    consts64: torch.Tensor = None

    def activation_ld(self) -> int:
        """Floats of an activation row of its dense layers (0 for none): a
        terminal cost with dense layers runs as a block program after the
        last step (``struct Terminal``)."""
        return _widest(self.program, [self.output])


def _inputs(prog: Program, nx: int, nu: int) -> tuple:
    """The traced program's inputs: the state, the action and the timestep."""
    xs = _Sym((PROBE_BATCH, nx), 0, np.array([prog.add("x", F, i) for i in range(nx)],
                                             dtype=object), F)
    us = _Sym((PROBE_BATCH, nu), 0, np.array([prog.add("u", F, j) for j in range(nu)],
                                             dtype=object), F)
    return xs, us, _Sym((), None, np.array(prog.add("t", I), dtype=object), I)


def _trace_into(prog: Program, pool: list, fn: Callable, nx: int, nu: int, want: list,
                dtype, with_t: bool, seed: int = 0, state=None, dense: bool = False) -> list:
    """Trace ``fn(state (B, nx), action (B, nu)[, t])`` into ``prog``, its
    constants into ``pool`` (its products as dense nodes where ``dense``);
    ``want`` is each output's elements a sample.  Returns each output's node
    ids and the device the trace ran on."""
    s = _probe(nx, dtype, seed) if state is None else state
    u = _probe(nu, dtype, seed + 1).to(s.device)
    args = (s, u, torch.tensor(0, dtype=torch.int64, device=s.device)) if with_t else (s, u)
    gm, device = _make_fx(fn, args)
    names = [n.target for n in gm.graph.nodes if n.op == "placeholder"]
    return _lower_outputs(_Lowering(prog, pool, PROBE_BATCH, dense), gm,
                          dict(zip(names, _inputs(prog, nx, nu))), want), device


def _lower(trace: Callable, what: str, wide: bool = False):
    """``trace(dense) -> (program, pool, outputs, ...)`` lowered as the
    kernels take it: the scalar program where it has at most ``MAX_OPS``
    operations, as without dense nodes; else with each product of a batched
    value and a constant matrix as one dense node, whose multiply-adds
    ``MAX_OPS`` does not count (the scalar operations left must fit it).
    The scalar lowering is tried only where the dense one's operations,
    with the products counted as their scalar dot products, come within
    twice the bound (sharing common subexpressions, a scalar lowering only
    shrinks that count), and never for a model ``wide`` beyond ``MAXN``
    states or actions, which only a block model holds."""
    dense = trace(True)
    prog, outs = dense[0], dense[2]
    n_ops = _count_ops(prog, outs)
    layers = prog.dense_layers(outs)
    if not layers or wide:
        out, n_scalar = dense, n_ops
    else:
        out = None
        if n_ops + sum(n_out * (2 * n_in - 1 + (b >= 0)) for _, _, b, n_in, n_out in layers) \
                <= 2 * MAX_OPS:
            scalar = trace(False)
            n_scalar = _count_ops(scalar[0], scalar[2])
            if n_scalar <= MAX_OPS:
                out = scalar
        if out is None:
            out, n_scalar = dense, n_ops
    if n_scalar > MAX_OPS:
        raise UnsupportedPrimitive(f"{what} of {n_scalar} scalar operations beside its dense "
                                   f"layers (the bound is {MAX_OPS})" if out is dense and layers
                                   else f"{what} of {n_scalar} scalar operations (the bound "
                                   f"is {MAX_OPS})")
    return out


def trace_program(fn: Callable, nx: int, nu: int, want: list, dtype=torch.float32,
                  with_t: bool = False):
    """Trace any ``fn(state (B, nx), action (B, nu)[, t]) -> output or
    tuple`` into ``(program, constants (float64), outputs)``, where
    ``want`` lists each output's elements a sample and ``outputs`` their
    node ids; :meth:`Program.evaluate` computes them.  Raises
    :class:`UnsupportedPrimitive` as :func:`trace_model`."""
    def trace(dense):
        prog, pool = Program(), []
        outs, _ = _trace_into(prog, pool, fn, nx, nu, want, dtype, with_t, dense=dense)
        return prog, pool, [i for o in outs for i in o], outs

    prog, pool, _, outs = _lower(trace, "a program")
    return prog, torch.tensor(pool or [0.0], dtype=torch.float64), outs


def _trace_pair(config, dynamics: Callable, running_cost: Callable, dense: bool = False):
    """The program of the dynamics and then of the running cost (their
    products as dense nodes where ``dense``), ``(program, pool, next-state
    nodes + (cost node,))``."""
    from .solve import wrap_cost, wrap_dynamics

    nx, nu, dtype = config.nx, config.nu, config.dtype
    dyn = wrap_dynamics(config, dynamics)
    cost = wrap_cost(config, running_cost)
    prog, pool = Program(), []
    (step_out,), device = _trace_into(prog, pool, lambda s_, u_, t_: dyn(s_, u_, t_), nx, nu,
                                      [nx], dtype, True, dense=dense)
    with torch.no_grad():  # the cost is traced at states the dynamics give
        ns = dyn(_probe(nx, dtype, 0).to(device), _probe(nu, dtype, 1).to(device), 0)
    (cost_out,), _ = _trace_into(prog, pool, lambda s_, u_, t_: cost(s_, u_, t_), nx, nu, [1],
                                 dtype, True, state=ns.detach(), dense=dense)
    return prog, pool, tuple(step_out) + (cost_out[0],)


def _count_ops(prog: Program, outputs) -> int:
    """The scalar operations of the program's live nodes: every node but the
    leaves and the dense layers (:func:`dense_ops` counts those), a
    LayerNorm's statistics of n values as n (the mean) and 3n + 2 (the
    rstd)."""
    ops = {"lnmean": lambda n: n, "lnrstd": lambda n: 3 * (n - 2) + 2}
    return sum(ops[prog.nodes[n][0]](len(prog.nodes[n]) - 2) if prog.nodes[n][0] in ops else 1
               for n in prog.live(outputs)
               if prog.nodes[n][0] not in _LEAVES + ("dense", "dout"))


def dense_ops(prog: Program, outputs) -> int:
    """The operations of the program's dense layers: two for each
    multiply-add, and one for each bias."""
    return sum(n_out * (2 * n_in + (b >= 0))
               for _, _, b, n_in, n_out in prog.dense_layers(outputs))


def trace_model(config, dynamics: Callable, running_cost: Callable) -> GeneratedModel:
    """Trace the user's ``dynamics`` and ``running_cost`` (their signatures
    as :func:`~.solve.wrap_dynamics` and :func:`~.solve.wrap_cost` take
    them under ``config``) into a :class:`GeneratedModel`.  Raises
    :class:`UnsupportedPrimitive` for a program outside the vocabulary (see
    the module docstring), and lets a ValueError or TypeError of the user's
    code through."""
    nx, nu = config.nx, config.nu
    prog, pool, outputs = _lower(
        lambda dense: _trace_pair(config, dynamics, running_cost, dense), "a program",
        max(nx, nu) > MAXN)[:3]
    return generated_model(prog, outputs, nx, nu, torch.tensor(pool or [0.0], dtype=torch.float64))


def generated_model(prog: Program, outputs, nx: int, nu: int,
                    consts64: torch.Tensor) -> GeneratedModel:
    """The :class:`GeneratedModel` of a traced program: ``outputs`` the nx
    next-state nodes, then the cost node; ``consts64`` its constants in
    float64 (the kernels read them in float32)."""
    outputs = tuple(outputs)
    on = _evaluation_consts(consts64)

    def plain_dynamics(state, action, t=0):
        return _stack(prog.evaluate(list(outputs[:nx]), on(state), state, action, t), state)

    def plain_cost(state, action, t=0):
        return _broadcast(prog.evaluate([outputs[nx]], on(state), state, action, t)[0], state)

    return GeneratedModel("generated", -1, nx, nu, consts64.to(torch.float32),
                          plain_dynamics, plain_cost, program=prog, outputs=outputs,
                          consts64=consts64)


def _evaluation_consts(consts64: torch.Tensor) -> Callable:
    """``on(like)``: the constants in ``like``'s dtype (float64 kept exact,
    others from float32, the kernels' rounding) on its device, copied once
    for each."""
    cache = {}

    def on(like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in cache:
            c = consts64 if like.dtype == torch.float64 else consts64.to(torch.float32)
            cache[key] = c.to(like.device, like.dtype)
        return cache[key]

    return on


def trace_terminal(config, terminal_final_cost: Callable) -> GeneratedTerminal:
    """Trace a ``terminal_final_cost(final_state (K, nx), final_action (K,
    nu)) -> (K,)`` into a :class:`GeneratedTerminal`; raises as
    :func:`trace_model`."""
    from .solve import wrap_final_cost

    nx, nu, dtype = config.nx, config.nu, config.dtype
    term = wrap_final_cost(terminal_final_cost)

    def trace(dense):
        prog, pool = Program(), []
        (out,), _ = _trace_into(prog, pool, lambda s_, u_: term(s_, u_), nx, nu, [1], dtype,
                                False, seed=2, dense=dense)
        return prog, pool, out

    prog, pool, out = _lower(trace, "a terminal cost", max(nx, nu) > MAXN)
    return generated_terminal(prog, out[0], nx, torch.tensor(pool or [0.0], dtype=torch.float64))


def generated_terminal(prog: Program, output: int, nx: int,
                       consts64: torch.Tensor) -> GeneratedTerminal:
    """The :class:`GeneratedTerminal` of a traced program whose node
    ``output`` is the cost; ``consts64`` as :func:`generated_model`."""
    on = _evaluation_consts(consts64)

    def cost(state, action):
        return _broadcast(prog.evaluate([output], on(state), state, action, 0)[0], state)

    return GeneratedTerminal("generated_terminal", nx, consts64.to(torch.float32), cost,
                             program=prog, output=output, consts64=consts64)


def supports_batch_last(fn: Callable, nx: int, nu: int, want: list, dtype=torch.float32,
                        with_t: bool = False):
    """Probe whether ``fn`` traces into a per-sample program
    (:func:`trace_program`'s arguments); returns ``(ok, message)``.  A
    ValueError or TypeError of the user's code is reported too, as JAX's
    probe reports its evaluation gaps."""
    try:
        trace_program(fn, nx, nu, want, dtype, with_t)
        return True, ""
    except UnsupportedPrimitive as e:
        return False, str(e)
    except (TypeError, ValueError, NotImplementedError) as e:
        return False, f"tracing failed: {type(e).__name__}: {e}"


def kernel_model(config, dynamics: Callable, running_cost: Callable) -> KernelModel:
    """The device model of a ``(dynamics, running_cost)`` pair: the named
    one it carries (:func:`~.kernel_models.find_kernel_model`), else its
    trace (:func:`trace_model`, which raises :class:`UnsupportedPrimitive`
    for a program outside the vocabulary)."""
    model = find_kernel_model(dynamics, running_cost)
    return model if model is not None else trace_model(config, dynamics, running_cost)


def kernel_act_ld(model: KernelModel, terminal: Optional[KernelTerminal]) -> int:
    """Floats of an activation row of the kernel of a model and a terminal
    cost: the widest of their dense layers (``kernel_models.
    activation_ld``; a traced terminal cost's run after the last step,
    :meth:`Program.emit_terminal`), 0 for a per-sample kernel.  Raises
    :class:`UnsupportedPrimitive` for a terminal cost with dense layers
    beside a named per-sample model, whose kernels hold no activations."""
    from .kernel_models import activation_ld

    ld = activation_ld(model)
    term = terminal.activation_ld() if isinstance(terminal, GeneratedTerminal) else 0
    if term and not ld and not isinstance(model, GeneratedModel):
        raise UnsupportedPrimitive(
            f"a traced terminal cost with dense layers beside the per-sample kernel model "
            f"{model.name!r}, whose kernels hold no activations: run the trace of its "
            f"callables (kernel_device_model)")
    return max(ld, term)


def kernel_device_model(config, model: KernelModel,
                        terminal: Optional[KernelTerminal] = None) -> KernelModel:
    """The device model the kernels run for ``model`` beside ``terminal``:
    ``model`` itself, or the trace of its own callables (:func:`trace_model`
    of its plain ``dynamics`` and ``running_cost``) for a named per-sample
    model whose struct cannot run there: beyond ``MAXN`` states or actions
    (its register arrays), or beside a traced terminal cost with dense
    layers (its kernels hold no activations).  The trace keeps its state in
    shared memory (a block model).  A step-dependent config keeps the named
    model, which takes no timestep (``fused_solve.check_kernel_model``
    refuses it).  Raises :class:`UnsupportedPrimitive` where the trace
    does."""
    from .kernel_models import activation_ld

    if (isinstance(model, GeneratedModel) or activation_ld(model)
            or config.step_dependent_dynamics or (model.nx, model.nu) != (config.nx, config.nu)):
        return model
    dense_terminal = isinstance(terminal, GeneratedTerminal) and terminal.activation_ld() > 0
    if max(model.nx, model.nu) > MAXN or dense_terminal:
        return trace_model(config, model.dynamics, model.running_cost)
    return model


def kernel_terminal(config, terminal_final_cost: Callable) -> Optional[KernelTerminal]:
    """The kernel terminal cost of a ``terminal_final_cost``: the named one it
    carries (:func:`~.kernel_models.quadratic_terminal`), else its trace
    (:func:`trace_terminal`); None for None, and a kernel terminal cost
    itself for one."""
    if terminal_final_cost is None or isinstance(terminal_final_cost, KernelTerminal):
        return terminal_final_cost
    from .kernel_models import find_kernel_terminal

    named = find_kernel_terminal(terminal_final_cost)
    if named is not None:
        return named
    try:
        return trace_terminal(config, terminal_final_cost)
    except UnsupportedPrimitive as e:
        name = getattr(terminal_final_cost, "__name__", terminal_final_cost)
        raise UnsupportedPrimitive(f"terminal_final {name!r} cannot be traced: {e}") from None


# ---------------------------------------------------------------------------
# The generated kernels: emission, registry, build
# ---------------------------------------------------------------------------

_NAMED_STRUCTS = {0: "LinearQuadratic", 1: "Pendulum", 2: "Toy2D", 3: "ResidualMLP",
                  4: "ResidualMLPBlock"}
ID_SPACE = 1 << 30  # a generated id is GENERATED + a 30-bit hash: an int32, as the kernels take it
_KERNELS: dict = {}  # id -> the GeneratedKernel registered under it, in the order registered
_BY_SOURCE: dict = {}


def _header(model: KernelModel, terminal: Optional[GeneratedTerminal]) -> str:
    """The C++ struct ``Generated`` of a model and a traced terminal cost
    (or None) for ``csrc/fused_mppi.cu``."""
    generated = isinstance(model, GeneratedModel)
    n = max(model.nx, model.nu)
    base = "" if generated else f" : {_NAMED_STRUCTS[model.model_id]}"
    dense_terminal = terminal is not None and terminal.activation_ld() > 0
    ld = kernel_act_ld(model, terminal) if dense_terminal or generated else 0
    lines = [
        "// A device model generated by pytorch_mppi_tpu_torch/ops/batch_last.py from",
        "// the user's torch callables: one statement a node of the traced program.",
        f"struct Generated{base} {{",
        f"  static constexpr bool kTerminal = {'true' if terminal else 'false'};",
        f"  static constexpr int kN = {n};  // the register arrays: max(nx, nu)",
        _HELPERS,
    ]
    if generated:
        prog, nx = model.program, model.nx
        cost = model.outputs[nx]
        dense_cost = bool(prog.dense_layers([cost]))
        if ld:  # a block model (fused_mppi.cu), its state in shared memory
            # a running cost with dense layers runs in the step, after the dynamics
            lines += prog.emit_block(list(model.outputs[:nx]), cost if dense_cost else None)
        else:
            parts, body, names = prog.emit_parts(list(model.outputs[:nx]), "step_part")
            lines += [*parts, "  template <int N>",
                      "  __device__ static void step(const float* c, float* x, const float* u, "
                      "int, int, int t) {", *body,
                      *[f"    x[{i}] = {nm};" for i, nm in enumerate(names)], "  }"]
        if not dense_cost:
            parts, body, names = prog.emit_parts([cost], "cost_part")
            lines += [*parts, "  template <int N>",
                      "  __device__ static float cost(const float* c, const float* x, "
                      "const float* u, int, int, int t) {", *body,
                      f"    return {names[0]};", "  }"]
    if ld:
        from .fused_solve import KERNEL_A_BLOCK_BLOCKS, kernel_a_blocks

        blocks = kernel_a_blocks(ld, model.nx, model.nu)
        if blocks != KERNEL_A_BLOCK_BLOCKS:
            lines.append(f"  static constexpr int kBlocks = {blocks};  // kernel A's blocks an SM")
    if dense_terminal:
        lines += terminal.program.emit_terminal(terminal.output)
    elif terminal:
        parts, body, names = terminal.program.emit_parts([terminal.output], "terminal_part", "0")
        lines += [*parts, "  template <int N>",
                  "  __device__ static float terminal(const float* c, const float* x, "
                  "const float* u, int, int) {", *body, f"    return {names[0]};", "  }"]
    lines.append("};")
    return "\n".join(lines) + "\n"


def _f32_bytes(consts: torch.Tensor) -> bytes:
    return consts.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()


class GeneratedKernel:
    """The device code of one pair of a model and a terminal cost where
    either is generated: the named model's struct or the generated
    model's program, and the generated terminal cost or the named
    ``quadratic_terminal`` (by ``p.terminal``) or none.  ``id`` is the
    ``LaunchSpec.model_id`` its launches carry, a hash of its source and
    its float32 constants (see the module docstring); :meth:`library`
    builds the kernels of a variant."""

    def __init__(self, model: KernelModel, terminal: Optional[KernelTerminal]):
        self.model = model
        self.terminal = terminal if isinstance(terminal, GeneratedTerminal) else None
        self._header = _header(model, self.terminal)
        consts = [_f32_bytes(model.consts)]
        if self.terminal is not None:
            consts.append(_f32_bytes(self.terminal.consts))
        self.source = (self._header, *consts)
        digest = hashlib.sha256()
        for part in (self._header.encode(), *consts):
            digest.update(len(part).to_bytes(8, "little") + part)
        self.id = GENERATED + int.from_bytes(digest.digest()[:8], "little") % ID_SPACE
        self._libraries: dict = {}
        self.build_seconds: dict = {}

    @property
    def generated_model(self) -> bool:
        return isinstance(self.model, GeneratedModel)

    @property
    def block(self) -> bool:
        """Whether its kernels run a block model (dense layers, or the named
        ``ResidualMLPBlock``): their launches count under ``*_block``."""
        return kernel_act_ld(self.model, self.terminal) > 0

    def header(self) -> str:
        """The C++ struct ``Generated`` for ``csrc/fused_mppi.cu``."""
        return self._header

    def library(self, variant: int, together=()):
        """The loaded library of ``variant``'s kernels (``fused_solve``'s
        MPPI, SMPPI, KMPPI, BATCHED, or 4 for the legacy rollout), built with
        ``nvcc`` on first use, with the kernels of the variants ``together``
        in the same library (one ``nvcc``, which then serves them too);
        raises with the compiler's output if the build fails."""
        lib = self._libraries.get(variant)
        if lib is None:
            from . import _build

            variants = (variant, *together)
            lib, seconds = _build.load_generated(self.header(),
                                                 sum({1 << v for v in variants}))
            for v in variants:
                if seconds is not None:
                    self.build_seconds[v] = seconds
                self._libraries.setdefault(v, lib)
        return lib

    def describe(self) -> dict:
        """What rebuilds this kernel without the user's code, as JSON
        values (:func:`load_kernel`): the generated model's program (its
        nodes, the outputs, nx, nu, whether it reads the timestep, its
        float64 constants), or the named model's id, sizes and float32
        constants; and the traced terminal cost's program, or None."""
        m, term = self.model, self.terminal
        if self.generated_model:
            uses_t = any(m.program.nodes[n][0] == "t" for n in m.program.live(m.outputs))
            model = dict(nodes=[list(n) for n in m.program.nodes], outputs=list(m.outputs),
                         nx=m.nx, nu=m.nu, uses_t=uses_t, consts64=m.consts64.tolist())
        else:
            model = dict(named=m.model_id, nx=m.nx, nu=m.nu, consts=m.consts.tolist())
        terminal = None if term is None else dict(
            nodes=[list(n) for n in term.program.nodes], output=term.output, nx=term.nx,
            consts64=term.consts64.tolist())
        return dict(id=self.id, model=model, terminal=terminal)


def _register(kernel: GeneratedKernel) -> GeneratedKernel:
    """The kernel registered under ``kernel.id``: ``kernel`` itself where
    the id is new, else the one of the same source registered before."""
    hit = _KERNELS.setdefault(kernel.id, kernel)
    if hit.source != kernel.source:
        raise RuntimeError(f"two generated kernels of different sources hash to the id "
                           f"{kernel.id}; trace one of them again with other constants")
    return hit


def generated_kernel(model: KernelModel, terminal: Optional[KernelTerminal]):
    """The :class:`GeneratedKernel` of a model and a terminal cost where
    either is generated, made once for the pair and registered under its
    id; None where both are named (the named library runs them)."""
    traced = terminal if isinstance(terminal, GeneratedTerminal) else None
    if not isinstance(model, GeneratedModel) and traced is None:
        return None
    # keyed by the objects the kernel holds, so that their ids stay theirs
    key = (id(model), id(traced))
    hit = _BY_SOURCE.get(key)
    if hit is None or hit.model is not model or hit.terminal is not traced:
        hit = _BY_SOURCE[key] = GeneratedKernel(model, traced)
        _register(hit)
    return hit


def launch_id(model: KernelModel, terminal: Optional[KernelTerminal] = None) -> int:
    """The ``LaunchSpec.model_id`` a launch of the pair carries: the named
    model's id, or its generated kernel's (:func:`generated_kernel`)."""
    kernel = generated_kernel(model, terminal)
    return model.model_id if kernel is None else kernel.id


def kernel_of(model_id: int) -> GeneratedKernel:
    """The generated kernel a launch's ``model_id`` names: traced in this
    process, or loaded from a deploy artifact (:func:`load_kernel`)."""
    kernel = _KERNELS.get(model_id)
    if kernel is None:
        raise ValueError(f"no generated kernel has id {model_id} (a deploy artifact's are "
                         f"registered when utils/deploy.load_solver loads it)")
    return kernel


def load_kernel(desc: dict) -> GeneratedKernel:
    """Register the kernel that :meth:`GeneratedKernel.describe` wrote, in a
    process that holds none of the user's code, and return the kernel
    registered under its id (one of the same source registered before is
    kept: nothing new is registered).  Raises ValueError where the
    description rebuilds to another id: this build emits another source
    for the program than the exporter's did."""
    from .kernel_models import plain_model

    m, t = desc["model"], desc.get("terminal")
    if "named" in m:
        model = plain_model(int(m["named"]), torch.tensor(m["consts"], dtype=torch.float32),
                            int(m["nx"]), int(m["nu"]))
    else:
        model = generated_model(Program.from_nodes(m["nodes"]), m["outputs"], int(m["nx"]),
                                int(m["nu"]), torch.tensor(m["consts64"], dtype=torch.float64))
    terminal = None if t is None else generated_terminal(
        Program.from_nodes(t["nodes"]), int(t["output"]), int(t["nx"]),
        torch.tensor(t["consts64"], dtype=torch.float64))
    kernel = GeneratedKernel(model, terminal)
    if kernel.id != desc["id"]:
        raise ValueError(f"the generated kernel {desc['id']} rebuilds to the id {kernel.id}: "
                         f"this build emits another source for its program (export it again)")
    return _register(kernel)
