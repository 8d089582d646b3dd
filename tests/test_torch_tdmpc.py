"""A TD-MPC world model in the kernels, on the CPU, at a small size.

The model is TD-MPC's (Hansen, Wang & Su, "Temporal Difference Learning for
Model Predictive Control", ICML 2022; github.com/nicklashansen/tdmpc,
``src/algorithm/helper.py`` and ``tdmpc.py``): a latent dynamics network
``mlp`` (Linear, ELU, Linear, ELU, Linear) on (z, u), a reward network of
the same shape, and two Q networks ``q`` (Linear, LayerNorm, Tanh, Linear,
ELU, Linear) whose minimum values the last latent state.  Here at nx = 40
latent states and nu = 36 actions (both beyond the per-sample device
models' 32), hidden widths 32, K = 256, T = 3; the running cost is
``-gamma^t r(z', u)`` (gamma^t as ``exp(t log gamma)``, a step-dependent
cost) and the terminal cost ``-gamma^T min(Q1, Q2)(z_T, u_T)`` (TD-MPC
feeds its policy's action there; the port's ``terminal_final_cost`` takes
the last action).  The same numpy weights go into jnp functions and into
``nn.Module``s.

* The tracer's new vocabulary (``ops/batch_last.py``): ``elu`` (alpha,
  scale, input_scale) and ``native_layer_norm`` with and without an affine,
  each against torch in float64; dense nodes in the running and the
  terminal cost; the LayerNorm of a dense layer's units as a unit-wise
  epilogue around its row's statistics (``Program.unit_wise``'s ``norm``),
  so that no unit is left to the owner thread; a program of LayerNorm and
  ELU within ``MAX_OPS`` stays scalar.
* The emitted block struct (the dynamics' layers, the running cost's after
  them leaving the cost in the carry, the terminal cost's ``struct
  Terminal``) compiled with the host ``g++`` and run by a one-thread
  ``block_step`` and ``block_norm``, against the programs' evaluators.
* The plain versions of kernel A (MPPI, SMPPI, KMPPI), the batched pair
  and the legacy rollout with the traced model against JAX's
  ``make_transposed_{fused,smppi,kmppi,batched}_solve`` and
  ``make_fused_rollout`` in Pallas interpret mode on the same bits
  (``rng_in_kernel=False``) or noise, with the terminal cost in kernel A
  and the pair.
* The controllers route the untagged callables to the kernels with no
  warning, and both sides of the block models' bound on nx and nu (shared
  memory's): just inside runs in the kernels, just outside takes the plain
  path and the warning names the bound; a program without dense layers
  beyond 32 states runs in the kernels as a block program without layers,
  and a named per-sample model beside a dense terminal cost as the trace
  of its callables.

Tolerances: those of ``tests/test_torch_block_mlp.py`` (costs rtol 2e-5 /
atol 1e-5, m the same, s rtol 2e-5, delta/s rtol 2e-4 / atol 2e-6), float32
on both sides.  The CUDA kernels are held against these plain versions on
the card by ``chip_smoke.py`` (phase 4f, at TD-MPC's full width).
"""
import logging
import math
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import kernel_models as KM
from pytorch_mppi_tpu_torch.ops import kernels as PK
from pytorch_mppi_tpu_torch.ops import legacy as LG

torch.set_num_threads(1)

F32 = jnp.float32
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
NX, NU, H = 40, 36, 32
K, T, NSP = 256, 3, 2
GAMMA = 0.99
LN_EPS = 1e-5


def _linear(rs, a, b):
    return ((rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
            (rs.randn(b) * 0.1).astype(np.float32))


class World:
    """TD-MPC's networks on one set of seeded numpy weights, as jnp
    functions (:meth:`jax_fns`) and as the user's torch callables
    (:meth:`torch_fns`): the dynamics and reward ``mlp``s and the twin
    ``q``s, each Q's LayerNorm with a weight and a bias."""

    def __init__(self, seed=0, nx=NX, nu=NU, h=H, horizon=T):
        rs = np.random.RandomState(seed)
        n_in = nx + nu
        self.nx, self.nu, self.T = nx, nu, horizon
        self.dyn = [_linear(rs, n_in, h), _linear(rs, h, h), _linear(rs, h, nx)]
        self.rew = [_linear(rs, n_in, h), _linear(rs, h, h), _linear(rs, h, 1)]
        self.qs = []
        for _ in range(2):
            ln = ((1.0 + 0.1 * rs.randn(h)).astype(np.float32),
                  (0.1 * rs.randn(h)).astype(np.float32))
            self.qs.append(([_linear(rs, n_in, h), _linear(rs, h, h), _linear(rs, h, 1)], ln))

    def jax_fns(self):
        j = lambda layers: [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]  # noqa: E731
        dyn, rew = j(self.dyn), j(self.rew)
        qs = [(j(layers), tuple(jnp.asarray(v) for v in ln)) for layers, ln in self.qs]

        def mlp(p, h):
            h = jax.nn.elu(h @ p[0][0] + p[0][1])
            h = jax.nn.elu(h @ p[1][0] + p[1][1])
            return h @ p[2][0] + p[2][1]

        def q(p, ln, h):
            h = h @ p[0][0] + p[0][1]
            mean = h.mean(axis=-1, keepdims=True)
            var = ((h - mean) ** 2).mean(axis=-1, keepdims=True)
            h = jnp.tanh((h - mean) / jnp.sqrt(var + LN_EPS) * ln[0] + ln[1])
            h = jax.nn.elu(h @ p[1][0] + p[1][1])
            return h @ p[2][0] + p[2][1]

        def dynamics(z, u, t):
            return mlp(dyn, jnp.concatenate([z, u], axis=-1))

        def cost(z, u, t):
            return -jnp.exp(t * math.log(GAMMA)) * mlp(rew, jnp.concatenate([z, u], axis=-1))[..., 0]

        def terminal(z, u):
            zu = jnp.concatenate([z, u], axis=-1)
            return -(GAMMA ** self.T) * jnp.minimum(q(*qs[0], zu), q(*qs[1], zu))[..., 0]

        return dynamics, cost, terminal

    def torch_fns(self):
        def linear(W, b):
            lin = torch.nn.Linear(*W.shape)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(W.T.copy()))
                lin.bias.copy_(torch.from_numpy(b))
            return lin

        def mlp(layers):
            return torch.nn.Sequential(linear(*layers[0]), torch.nn.ELU(), linear(*layers[1]),
                                       torch.nn.ELU(), linear(*layers[2]))

        def q(layers, ln):
            norm = torch.nn.LayerNorm(layers[0][0].shape[1], eps=LN_EPS)
            with torch.no_grad():
                norm.weight.copy_(torch.from_numpy(ln[0]))
                norm.bias.copy_(torch.from_numpy(ln[1]))
            return torch.nn.Sequential(linear(*layers[0]), norm, torch.nn.Tanh(),
                                       linear(*layers[1]), torch.nn.ELU(), linear(*layers[2]))

        dyn_net, rew_net = mlp(self.dyn), mlp(self.rew)
        q1, q2 = (q(*p) for p in self.qs)
        horizon = self.T

        def dynamics(z, u, t):
            return dyn_net(torch.cat([z, u], dim=-1))

        def cost(z, u, t):  # t: a 0-d tensor in the trace, an int on the plain path
            discount = torch.exp(torch.as_tensor(t) * math.log(GAMMA))
            return -discount * rew_net(torch.cat([z, u], dim=-1))[..., 0]

        # TD-MPC values the last latent with its policy's action; the
        # port's terminal_final_cost takes the last action
        def terminal(z, u):
            zu = torch.cat([z, u], dim=-1)
            return -(GAMMA ** horizon) * torch.minimum(q1(zu), q2(zu))[..., 0]

        return dynamics, cost, terminal


def _configs(variant="mppi", K_=K, **extra):
    nsp = NSP if variant == "kmppi" else 0
    flags = dict(num_support_pts=nsp, smppi=variant == "smppi", step_dependent_dynamics=True,
                 **extra)
    return (JConfig(nx=NX, nu=NU, K=K_, T=T, dtype=F32, diag_sigma=True, **flags),
            MPPIConfig(nx=NX, nu=NU, K=K_, T=T, diag_sigma=True, **flags))


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _operands(variant, rs):
    """Kernel A's operands: a nominal U, sigma 0.25 (TD-MPC's), the drawn
    rows' and the actions' bounds [-1, 1], the action cost, lambda."""
    D = T * NU
    R = NSP * NU if variant == "kmppi" else D
    full = lambda v, n=D: np.full(n, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.3).astype(np.float32)
    a_flat, lam = U2 * 0.7, np.float32(0.8)
    if variant == "mppi":
        rest = (U2, full(0.25), full(0.0), full(-1.0), full(1.0), a_flat, lam)
    elif variant == "smppi":
        rest = (U2, (rs.randn(D) * 0.3).astype(np.float32), full(0.25), full(0.0), full(-1.0),
                full(1.0), full(-1.0), full(1.0), a_flat, lam, np.float32(2.0), np.float32(0.5))
    else:
        interp, _ = PK.interpolation_operators(PK.RBFKernel(2.0), T, NSP, torch.float32)
        Wt = np.kron(interp.numpy(), np.eye(NU, dtype=np.float32))
        rest = (U2, (rs.randn(R) * 0.3).astype(np.float32), full(0.25, R), full(0.0, R),
                full(-1.0, R), full(1.0, R), full(-1.0), full(1.0), a_flat, Wt, lam)
    x0 = (rs.randn(NX) * 0.5).astype(np.float32)
    return R, x0, rest


# ---------------------------------------------------------------------------
# The tracer's new vocabulary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(alpha=0.7), dict(alpha=1.3, scale=1.5, input_scale=0.8)])
def test_elu_lowering(kw):
    """``elu`` is x > 0 ? scale x : alpha scale expm1(input_scale x), a
    unit-wise node chain; the evaluator matches torch in float64."""
    W = torch.randn(3, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(1))

    def fn(s, u):
        return torch.ops.aten.elu(s @ W, **kw) if kw else torch.nn.functional.elu(s @ W)

    prog, consts, (out,) = BL.trace_program(fn, 3, 2, [5], torch.float64)
    assert {prog.nodes[n][0] for n in prog.live(out)} >= {"expm1", "where", "gt"}
    s = torch.randn(64, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    u = torch.zeros(64, 2, dtype=torch.float64)
    got = torch.stack(prog.evaluate(out, consts, s, u, 0), 1)
    torch.testing.assert_close(got, fn(s, u), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_lowering(affine):
    """``native_layer_norm`` over the last feature axis (with and without
    an affine): the statistics nodes ``lnmean`` and ``lnrstd`` (its eps a
    literal), then (x - mean) rstd (w, b) elementwise; the evaluator and the
    mean and rstd outputs match torch in float64."""
    g = torch.Generator().manual_seed(3)
    W = torch.randn(4, 6, dtype=torch.float64, generator=g)
    w = torch.rand(6, dtype=torch.float64, generator=g) + 0.5 if affine else None
    b = torch.randn(6, dtype=torch.float64, generator=g) if affine else None

    def fn(s, u):
        h = s @ W
        out, mean, rstd = torch.ops.aten.native_layer_norm(h, [6], w, b, 1e-3)
        return out, mean[:, 0] + rstd[:, 0]

    prog, consts, (out, stat) = BL.trace_program(fn, 4, 2, [6, 1], torch.float64)
    ops = [prog.nodes[n][0] for n in prog.live(out)]
    assert ops.count("lnmean") == 1 and ops.count("lnrstd") == 1
    (rstd,) = [n for n in prog.live(out) if prog.nodes[n][0] == "lnrstd"]
    assert prog.nodes[prog.nodes[rstd][2]] == ("lit", "f", 1e-3)
    # the product's 24 (scalar: within MAX_OPS), one rstd a unit, the weight
    assert ops.count("mul") == 24 + 6 + (6 if affine else 0)
    s = torch.randn(64, 4, dtype=torch.float64, generator=g)
    u = torch.zeros(64, 2, dtype=torch.float64)
    ref_out, ref_stat = fn(s, u)
    torch.testing.assert_close(torch.stack(prog.evaluate(out, consts, s, u, 0), 1), ref_out,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(prog.evaluate(stat, consts, s, u, 0)[0], ref_stat,
                               rtol=1e-12, atol=1e-12)


def test_world_model_traces_into_one_block_model():
    """At nx = 40, nu = 36 the dynamics, the running cost and the terminal
    cost each trace with dense nodes (beyond 32 the tracer lowers products
    with dense nodes only), no ``UnsupportedPrimitive``; the kernel is one
    generated block model whose struct runs the cost's layers after the
    dynamics' (``kStepCost``) and the terminal's in ``struct Terminal``;
    each Q's LayerNorm is its first layer's epilogue around the row's
    statistics, the Tanh after it, and every hidden layer's ELU its
    epilogue: nothing of a hidden unit is left to the owner thread."""
    dyn, cost, term = World().torch_fns()
    _, cfg = _configs()
    model = BL.kernel_model(cfg, dyn, cost)
    terminal = BL.kernel_terminal(cfg, term)
    shapes = lambda prog, outs: [(a, b) for *_, a, b in prog.dense_layers(outs)]  # noqa: E731
    n_in = NX + NU
    assert shapes(model.program, model.outputs[:NX]) == [(n_in, H), (H, H), (H, NX)]
    assert shapes(model.program, [model.outputs[NX]]) == [(n_in, H), (H, H), (H, 1)]
    assert shapes(terminal.program, [terminal.output]) == [(n_in, H), (H, H), (H, 1)] * 2
    assert model.activation_ld() == terminal.activation_ld() == 76
    assert BL._count_ops(model.program, model.outputs) < BL.MAX_OPS
    epi = terminal.program.unit_wise([terminal.output])
    for e in (epi[0], epi[3]):  # Linear, LayerNorm, Tanh
        assert e["pre"] is None and e["norm"]["mean"] is not None
        assert e["norm"]["eps"] == pytest.approx(LN_EPS)
        assert {terminal.program.nodes[n][0] for n in e["post"]} == {"sub", "mul", "add", "tanh"}
        assert e["stride"] and set(e["stride"].values()) == {1}  # the affine, a float a unit
    for e in (epi[1], epi[4]):  # Linear, ELU
        assert {terminal.program.nodes[n][0] for n in e["nodes"]} == {"dout", "expm1", "gt",
                                                                      "where"}
    for e in model.program.unit_wise(model.outputs[:NX])[:2]:
        assert e is not None and "norm" not in e
    kernel = BL.generated_kernel(model, terminal)
    assert kernel.block and FS.launch_name(kernel.id, "mppi") == "generated_mppi_block"
    header = kernel.header()
    for text in ("kBlock = true", "kStepCost = true", "kBlockTerminal = true", "struct Terminal",
                 "block_norm(", "expm1f(v)", "k.cost = "):
        assert text in header, text
    assert "static float cost(" not in header and "static float terminal(" not in header
    step = header[:header.index("struct Terminal")]
    assert "block_norm(" not in step and "layers(const float*) { return 6; }" in step
    assert BL.kernel_act_ld(model, terminal) == 76


def test_layer_norm_within_max_ops_stays_scalar(tmp_path):
    """A small program with a LayerNorm and an ELU within ``MAX_OPS`` is the
    scalar program (its statistics as C expressions), compiled with the host
    ``g++``, against the evaluator (rtol 1e-5 / atol 1e-5)."""
    g = torch.Generator().manual_seed(4)
    W = torch.randn(4, 8, generator=g) * 0.5
    V = torch.randn(8, 2, generator=g) * 0.5
    norm = torch.nn.LayerNorm(8)

    def dyn(s, a):
        return s + torch.nn.functional.elu(norm(torch.cat([s, a], -1) @ W)) @ V

    def cost(s, a):
        return (s ** 2).sum(-1)

    cfg = MPPIConfig(nx=2, nu=2, K=64, T=5)
    model = BL.kernel_model(cfg, dyn, cost)
    assert not model.program.dense_layers(model.outputs)
    ops = {model.program.nodes[n][0] for n in model.program.live(model.outputs)}
    assert {"lnmean", "lnrstd", "expm1"} <= ops
    kernel = BL.generated_kernel(model, None)
    assert "kBlock" not in kernel.header()
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "harness.cpp").write_text(_SCALAR_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                    str(tmp_path / "harness.cpp")], check=True, capture_output=True, timeout=300)
    x, u = torch.randn(32, 2, generator=g), torch.randn(32, 2, generator=g)
    blob = struct.pack("2i", 32, model.consts.numel())
    blob += b"".join(a.float().contiguous().numpy().tobytes() for a in (model.consts, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(32, 3)
    ns, c = model.rollout_step(x, u, 0)
    np.testing.assert_allclose(res[:, :2], ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, 2], c.numpy(), rtol=1e-5, atol=1e-5)


_SCALAR_HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
namespace fused_mppi {
#include "model.cuh"
}
using fused_mppi::Generated;
int main() {
  int h[2];
  if (fread(h, sizeof(int), 2, stdin) != 2) return 1;
  const int K = h[0];
  float* c = (float*)malloc(sizeof(float) * (h[1] + 1));
  float* xs = (float*)malloc(sizeof(float) * K * 2);
  float* us = (float*)malloc(sizeof(float) * K * 2);
  if (fread(c, sizeof(float), h[1], stdin) != (size_t)h[1]) return 1;
  if (fread(xs, sizeof(float), K * 2, stdin) != (size_t)(K * 2)) return 1;
  if (fread(us, sizeof(float), K * 2, stdin) != (size_t)(K * 2)) return 1;
  for (int k = 0; k < K; ++k) {
    Generated::step<2>(c, xs + 2 * k, us + 2 * k, 2, 2, 0);
    const float cost = Generated::cost<2>(c, xs + 2 * k, us + 2 * k, 2, 2, 0);
    fwrite(xs + 2 * k, sizeof(float), 2, stdout);
    fwrite(&cost, sizeof(float), 1, stdout);
  }
  return 0;
}
"""

# block_step and block_norm for one thread (every sample of one group in
# turn), block_dense in input order: the emitted struct on the host
_BLOCK_HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
static inline void __syncthreads() {}
namespace fused_mppi {
struct DenseLinear {
  float operator()(int, float v) const { return v; }
};
template <class Epi>
inline void block_dense(const float* W, const float* b, int n_in, int n_out, int p,
                        const float* in, float* out, int ld, int rows, Epi epi) {
  for (int j = 0; j < n_out; ++j)
    for (int s = 0; s < rows; ++s) {
      float acc = 0.0f;
      for (int i = 0; i < n_in; ++i) acc = fmaf(in[s * ld + i], W[i * p + j], acc);
      out[s * ld + j] = epi(j, acc + (b ? b[j] : 0.0f));
    }
}
template <class Post>
inline void block_norm(float* out, int ld, int rows, int n, float eps, Post post) {
  for (int r = 0; r < rows; ++r) {
    float* v = out + r * ld;
    float sum = 0.0f, sq = 0.0f;
    for (int j = 0; j < n; ++j) sum += v[j];
    const float mean = sum / (float)n;
    for (int j = 0; j < n; ++j) sq += (v[j] - mean) * (v[j] - mean);
    const float rstd = 1.0f / sqrtf(sq / (float)n + eps);
    for (int j = 0; j < n; ++j) v[j] = post(j, v[j], mean, rstd);
  }
}
#include "model.cuh"
}
using fused_mppi::Generated;
template <class Prog>
void run(const float* c, float* xs, const float* us, int K, int nx, int nu, int t, int ld,
         float* act, float* cost) {
  typename Prog::Carry* k = new typename Prog::Carry[K];
  for (int s = 0; s < K; ++s)
    Prog::template begin<1>(c, xs + s * nx, us + s * nu, nx, nu, t, k[s], act + s * ld, K * ld);
  for (int l = 0; l < Prog::layers(c); ++l) {
    Prog::dense(l, c, act, ld, K, nx);
    for (int s = 0; s < K; ++s)
      Prog::template after<1>(l, c, xs + s * nx, us + s * nu, nx, nu, t, k[s], act + s * ld,
                              K * ld);
  }
  for (int s = 0; s < K; ++s) cost[s] = k[s].cost;
  delete[] k;
}
int main() {
  int h[7];  // K, nx, nu, constants, terminal constants, activation row, t
  if (fread(h, sizeof(int), 7, stdin) != 7) return 1;
  const int K = h[0], nx = h[1], nu = h[2], ld = h[5], t = h[6];
  float* c = (float*)malloc(sizeof(float) * (h[3] + 1));
  float* tc = (float*)malloc(sizeof(float) * (h[4] + 1));
  float* xs = (float*)malloc(sizeof(float) * K * nx);
  float* us = (float*)malloc(sizeof(float) * K * nu);
  float* act = (float*)calloc(2 * K * ld, sizeof(float));
  float* cost = (float*)malloc(sizeof(float) * K);
  float* tcost = (float*)malloc(sizeof(float) * K);
  if (fread(c, sizeof(float), h[3], stdin) != (size_t)h[3]) return 1;
  if (fread(tc, sizeof(float), h[4], stdin) != (size_t)h[4]) return 1;
  if (fread(xs, sizeof(float), K * nx, stdin) != (size_t)(K * nx)) return 1;
  if (fread(us, sizeof(float), K * nu, stdin) != (size_t)(K * nu)) return 1;
  run<Generated>(c, xs, us, K, nx, nu, t, ld, act, cost);  // the step and its cost
  run<Generated::Terminal>(tc, xs, us, K, nx, nu, 0, ld, act, tcost);  // on the new state
  for (int s = 0; s < K; ++s) {
    fwrite(xs + s * nx, sizeof(float), nx, stdout);
    fwrite(cost + s, sizeof(float), 1, stdout);
    fwrite(tcost + s, sizeof(float), 1, stdout);
  }
  return 0;
}
"""


def test_block_struct_on_the_host(tmp_path):
    """The world model's struct compiled with the host ``g++``: one step of
    the dynamics' and the reward's layers (the cost in the carry), then the
    terminal program on the new state, each against the evaluators
    (rtol 1e-5 / atol 1e-5: the sums in another order)."""
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    dyn, cost, term = World(seed=1).torch_fns()
    _, cfg = _configs()
    model, terminal = BL.kernel_model(cfg, dyn, cost), BL.kernel_terminal(cfg, term)
    kernel = BL.generated_kernel(model, terminal)
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "harness.cpp").write_text(_BLOCK_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                    str(tmp_path / "harness.cpp")], check=True, capture_output=True, timeout=300)
    g = torch.Generator().manual_seed(8)
    Kh, t = 24, 2
    x, u = torch.randn(Kh, NX, generator=g), torch.rand(Kh, NU, generator=g) * 2 - 1
    blob = struct.pack("7i", Kh, NX, NU, model.consts.numel(), terminal.consts.numel(),
                       BL.kernel_act_ld(model, terminal), t)
    blob += b"".join(a.float().contiguous().numpy().tobytes()
                     for a in (model.consts, terminal.consts, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(Kh, NX + 2)
    ns, c = model.rollout_step(x, u, t)
    np.testing.assert_allclose(res[:, :NX], ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, NX], c.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, NX + 1], terminal.cost(ns, u).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The kernels' plain versions against JAX's kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_kernel_a_plain_matches_jax_kernel(variant):
    world = World(seed=2)
    jdyn, jcost, jterm = world.jax_fns()
    tdyn, tcost, tterm = world.torch_fns()
    jcfg, cfg = _configs(variant, sample_null_action=variant == "mppi")
    jmake = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
             "kmppi": PR.make_transposed_kmppi_solve}[variant]
    pmake = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
             "kmppi": FS.make_transposed_kmppi_solve}[variant]
    solve_j = jmake(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                    rng_in_kernel=False, terminal_final=JS.wrap_final_cost(jterm))
    solve_p = pmake(cfg, (tdyn, tcost), pair_block=solve_j.block_k, terminal_final=tterm)
    assert isinstance(solve_p.model, BL.GeneratedModel) and solve_p.spec.act_ld == 76
    rs = np.random.RandomState(7)
    R, x0, rest = _operands(variant, rs)
    bits = _rand_bits(rs, (R, solve_j.K_pad))
    x0T = np.broadcast_to(x0[:, None], (NX, K))
    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in rest))
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0)[:, None].expand(NX, K),
                    *(torch.from_numpy(np.array(v)) for v in rest))
    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    assert np.ptp(ct_j) > 0.1  # the costs spread: the softmax weighs many samples
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(m_p, m_j, **TOL_C)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, **TOL_U)


@pytest.mark.parametrize("mode", ["bits", "operand"])
def test_batched_plain_matches_jax_kernel(mode):
    world = World(seed=3)
    jdyn, jcost, jterm = world.jax_fns()
    tdyn, tcost, tterm = world.torch_fns()
    jcfg, cfg = _configs()
    rs = np.random.RandomState(13)
    N, D = 3, T * NU
    operand = mode == "operand"
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=operand, noise_operand=operand, terminal_final=JS.wrap_final_cost(jterm))
    solve_p = FS.make_transposed_batched_solve(cfg, N, (tdyn, tcost), noise_operand=operand,
                                               pair_block=None if operand else solve_j.block_k,
                                               terminal_final=tterm)
    lead = ((rs.randn(D, solve_j.K_pad) * 0.25).astype(np.float32) if operand
            else _rand_bits(rs, (D, solve_j.K_pad)))
    args = ((rs.randn(NX, N) * 0.5).astype(np.float32), (rs.randn(D, N) * 0.3).astype(np.float32),
            np.full(D, 0.25, np.float32), np.full(D, 0.0, np.float32),
            np.full(D, -1.0, np.float32), np.full(D, 1.0, np.float32),
            (rs.randn(D, N) * 0.5).astype(np.float32), np.float32(0.8))
    out_j = solve_j(jnp.asarray(lead), *(jnp.asarray(v) for v in args))
    out_p = solve_p(torch.from_numpy(lead), *(torch.from_numpy(np.array(v)) for v in args))
    delta_p, ms_p, ct_p = (v.numpy() for v in out_p)
    delta_j, ms_j, ct_j = (np.asarray(v) for v in out_j)
    assert ct_p.shape == ct_j.shape == (N, K) and delta_p.shape == delta_j.shape == (D, N)
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(ms_p[0], ms_j[0], **TOL_C)
    np.testing.assert_allclose(ms_p[1], ms_j[1], rtol=2e-5)
    np.testing.assert_allclose(delta_p / ms_p[1], delta_j / ms_j[1], **TOL_U)


def test_rollout_plain_matches_jax_kernel():
    """The legacy rollout (which takes no terminal cost, as its TPU
    kernel): the dynamics' and the reward's layers."""
    world = World(seed=4)
    jdyn, jcost, _ = world.jax_fns()
    tdyn, tcost, _ = world.torch_fns()
    rs = np.random.RandomState(11)
    Kr = 200
    jcfg, cfg = _configs(K_=Kr)
    x0_K = (rs.randn(Kr, NX) * 0.5).astype(np.float32)
    u = np.clip(rs.randn(Kr, T, NU) * 0.5, -1, 1).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    rollout = LG.make_fused_rollout(cfg, (tdyn, tcost))
    cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
    np.testing.assert_allclose(cost_p.numpy(), cost_j, **TOL_C)


# ---------------------------------------------------------------------------
# Routing, and the bound on nx and nu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["MPPI", "SMPPI", "KMPPI", "MPPI_Batched"])
def test_controllers_take_the_kernels(cls, caplog):
    """TD-MPC's planner (sigma 0.25 I, actions in [-1, 1], six iterations
    of MPPI a command, as its default config) on the untagged callables:
    every controller plans on the kernels' route with no warning, and its
    commands are finite and within the bounds."""
    dyn, cost, term = World(seed=5).torch_fns()
    lim = torch.ones(NU)
    kw = dict(num_samples=64, horizon=T, lambda_=0.5, u_min=-lim, u_max=lim, seed=1,
              use_pallas=True if cls != "MPPI_Batched" else "kernel_rng", device="cpu",
              step_dependent_dynamics=True, terminal_final_cost=term, num_iterations=6)
    if cls == "SMPPI":
        kw.update(action_min=-lim, action_max=lim, delta_t=1.0, w_action_seq_cost=0.1)
    if cls == "KMPPI":
        kw.update(num_support_pts=NSP, kernel=P.RBFKernel(2.0))
    if cls == "MPPI_Batched":  # the batched kernel's route from K = 256
        kw.update(num_envs=2, num_samples=256)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = getattr(P, cls)(dyn, cost, NX, 0.25 ** 2 * torch.eye(NU), **kw)
    assert ctrl._fns.fused
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING], caplog.text
    z = torch.randn(2, NX, generator=torch.Generator().manual_seed(0)) * 0.5
    with torch.no_grad():
        for _ in range(2):
            a = ctrl.command(z if cls == "MPPI_Batched" else z[0])
            assert bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 1.0
            z = dyn(z, a.expand(2, NU), 0)


def _edge_model(nx, nu, h=8):
    """A residual ``mlp`` of TD-MPC's shape, traced, at nx, nu."""
    world = World(seed=6, nx=nx, nu=nu, h=h)
    dyn, cost, _ = world.torch_fns()
    return lambda z, u, t: z + 0.1 * dyn(z, u, t), cost


# nx + 2 nu at the edge of the block models' shared memory: the largest nx at
# nu = 2 whose 128 rows of state and action fit beside 8 samples' activations
EDGE_NU = 2


def _edge_nx():
    room = FS.MAX_SMEM_BYTES - 4 * FS._HEAD
    nx = 32
    while FS.activation_bytes(0, KM.DENSE_ROWS, -(-(nx + 1 + EDGE_NU) // 4) * 4, FS._BLOCK,
                              nx + 1, EDGE_NU) <= room:
        nx += 1
    return nx


@pytest.mark.parametrize("side", ["inside", "outside"])
def test_the_bound_on_nx_and_nu(side, caplog):
    """Beyond 32 states and actions a block model keeps them in shared
    memory: at the largest nx (nu = 2) whose 128 rows of state and action
    (nx + 2 nu floats each) fit beside 8 samples' activations, kernel A,
    the batched pair and the rollout take it; one state more, their
    factories refuse it and the controller's warning names the bound."""
    nx = _edge_nx() + (side == "outside")
    assert nx > 64
    dyn, cost = _edge_model(nx, EDGE_NU)
    cfg = MPPIConfig(nx=nx, nu=EDGE_NU, K=64, T=2, step_dependent_dynamics=True)
    model = BL.kernel_model(cfg, dyn, cost)
    makes = (FS.make_transposed_fused_solve, LG.make_fused_rollout,
             lambda c, m: FS.make_transposed_batched_solve(c, 2, m))
    if side == "inside":
        for make in makes:
            make(cfg, model)
    else:
        for make in makes:
            with pytest.raises(FS.FusedSolveUnavailable, match="nx \\+ 2 nu up to about"):
                make(cfg, model)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI(dyn, cost, nx, torch.eye(EDGE_NU), num_samples=64, horizon=2, seed=1,
                      use_pallas=True, device="cpu", step_dependent_dynamics=True)
    assert ctrl._fns.fused == (side == "inside")
    assert ("nx + 2 nu up to about" in caplog.text) == (side == "outside"), caplog.text
    assert bool(torch.isfinite(ctrl.command(torch.zeros(nx))).all())


@pytest.mark.parametrize("which", ["traced", "named"])
def test_nx_64_in_every_kernel(which):
    """nx = nu = 64 (TD-MPC's latent and the DMControl dog's 38 actions are
    below it) runs in kernel A's three variants, the batched pair and the
    rollout (as block models), for a traced program with dense layers and
    for the named ``ResidualMLPBlock``."""
    if which == "traced":
        dyn, cost = _edge_model(64, 64)
        model = BL.kernel_model(MPPIConfig(nx=64, nu=64, K=64, T=2,
                                           step_dependent_dynamics=True), dyn, cost)
    else:
        rs = np.random.RandomState(9)
        model = KM.residual_mlp_model(
            [(torch.from_numpy(W), torch.from_numpy(b))
             for W, b in (_linear(rs, 128, 96), _linear(rs, 96, 64))], 64, 64,
            cost="quadratic", goal=np.zeros(64, np.float32))
        assert model.model_id == KM.RESIDUAL_MLP_BLOCK
    sd = which == "traced"
    cfgs = {v: MPPIConfig(nx=64, nu=64, K=64, T=2, step_dependent_dynamics=sd, smppi=v == "smppi",
                          num_support_pts=2 if v == "kmppi" else 0)
            for v in ("mppi", "smppi", "kmppi")}
    solves = [FS.make_transposed_fused_solve(cfgs["mppi"], model),
              FS.make_transposed_smppi_solve(cfgs["smppi"], model),
              FS.make_transposed_kmppi_solve(cfgs["kmppi"], model),
              LG.make_fused_rollout(cfgs["mppi"], model),
              FS.make_transposed_batched_solve(cfgs["mppi"], 2, model)]
    assert all(FS.is_block(s.spec.model_id) for s in solves if hasattr(s, "spec"))


def test_scalar_program_beyond_32_takes_the_plain_path(caplog):
    """(Its name is the refusal it pinned before ROADMAP.md Queue 2a step
    3b.)  A program without dense layers beyond 32 states keeps its state
    in shared memory: it traces into a block program without layers
    (``kPerSample``, an activation row of ``ROWS_LD``), and the controller
    takes the kernel with no warning."""
    nx = 40
    model = BL.trace_model(MPPIConfig(nx=nx, nu=2, K=64, T=2), lambda s, a: s * 0.9,
                           lambda s, a: (s ** 2).sum(-1))
    assert not model.program.dense_layers(model.outputs)
    assert model.activation_ld() == BL.ROWS_LD
    assert "kPerSample = true" in BL.generated_kernel(model, None).header()
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI(lambda s, a: s * 0.9, lambda s, a: (s ** 2).sum(-1), nx, torch.eye(2),
                      num_samples=32, horizon=2, use_pallas=True, device="cpu")
    assert ctrl._fns.fused and not caplog.text, caplog.text
    assert bool(torch.isfinite(ctrl.command(torch.ones(nx))).all())


def test_dense_terminal_beside_a_named_per_sample_model(caplog):
    """A traced terminal cost with dense layers beside a named per-sample
    model (``linear_quadratic``), whose kernels hold no activations: the
    factory runs the trace of the named model's callables, a block program
    without layers whose kernels hold the terminal's, and the controller
    takes the kernel with no warning; its plain version is the named
    model's arithmetic."""
    lq = P.linear_quadratic(torch.eye(2), torch.zeros(2))
    g = torch.Generator().manual_seed(1)
    W1, W2 = torch.randn(4, 200, generator=g) * 0.5, torch.randn(200, 200, generator=g) * 0.07

    def term(s, a):
        return torch.tanh(torch.tanh(torch.cat([s, a], -1) @ W1) @ W2).sum(-1)

    cfg = MPPIConfig(nx=2, nu=2, K=64, T=4)
    assert BL.trace_terminal(cfg, term).activation_ld() == 200
    with pytest.raises(BL.UnsupportedPrimitive, match="per-sample kernel model"):
        BL.kernel_act_ld(lq, BL.trace_terminal(cfg, term))
    solve = FS.make_transposed_fused_solve(cfg, lq, terminal_final=term)
    assert isinstance(solve.model, BL.GeneratedModel) and solve.spec.act_ld == 200
    header = BL.kernel_of(solve.spec.model_id).header()
    assert "kPerSample = true" in header and "kBlockTerminal = true" in header
    x, u = torch.randn(64, 2), torch.randn(64, 2)
    torch.testing.assert_close(solve.model.dynamics(x, u), lq.dynamics(x, u))
    torch.testing.assert_close(solve.model.running_cost(x, u), lq.running_cost(x, u))
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI(lq.dynamics, lq.running_cost, 2, torch.eye(2), num_samples=64, horizon=4,
                      use_pallas=True, device="cpu", terminal_final_cost=term)
    assert ctrl._fns.fused and not caplog.text, caplog.text
