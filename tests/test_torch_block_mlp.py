"""Learned dynamics of any width in the kernels: the block residual MLP
(``kernel_models.RESIDUAL_MLP_BLOCK``, ``ResidualMLPBlock`` in
``csrc/fused_mppi.cu``) and traced programs with dense layers
(``ops/batch_last.py``), on the CPU.

* A residual MLP beyond all three of the per-thread model's bounds (nx =
  10, nu = 4, [14, 72, 72, 72, 72, 72, 10]: more than 8 states, 64 units
  and 4 layers) routes to the block model, and the plain versions of kernel
  A's three variants (bits), of the batched kernel (bits and operand) and
  of the legacy rollout hold against JAX's
  ``make_transposed_{fused,smppi,kmppi,batched}_solve`` and
  ``make_fused_rollout`` in Pallas interpret mode with the same network
  closed in, fed the same int32 bits or noise.
* A traced [16, 96, 96, 96, 12] tanh network (about 21,000 multiply-adds a
  step, beyond ``MAX_OPS``) passed untagged becomes a program with dense
  nodes, with no plain-path warning, and kernel A's and the batched
  kernel's plain versions (the program's evaluator) hold against JAX's
  kernels with the same network in interpret mode.
* A network within ``MAX_OPS`` is the scalar program of before; lowered
  with dense nodes instead, it computes the same (float32, rtol 1e-5 /
  atol 1e-5: the dense node's product sums in another order than the scalar
  dot products), and its block header compiled with the host ``g++``
  (``block_dense`` and ``block_step`` written out for one thread) computes
  what the evaluator does.
* A traced network of MBPO's shape ([16, 200 x 4, 12], SiLU) splits each
  segment into a unit-wise part, the SiLU, which the kernels run as the
  dense layer's epilogue on all threads, and the per-sample rest (the
  residual state update); its header, compiled with the host ``g++``, too.
* The kernels' dense layers run on the tensor cores in 3xTF32: a plain
  mirror of that arithmetic (each operand split into two TF32 values,
  rounded to nearest with 10 mantissa bits, three products a multiply-add,
  float32 sums a k-step of eight) stays within ``chip_smoke.F64_FACTOR``
  times the float32 product's error against float64 on the quadrotor's and
  MBPO's layer shapes, where one TF32 product does not.
* The block model's constants, ``plain_model``'s rebuild, the launch
  geometry (the group of samples and the tiles' place, by occupancy), the
  launch counters' names, the widest layers' groups of 8 samples (half an
  m16 tile), the round-1 solve of the block model, and the refusal of
  activations beyond shared memory.

Tolerances.  Float32 on both sides.  Costs rtol 2e-5 / atol 1e-5, m the
same, s rtol 2e-5, delta/s rtol 2e-4 / atol 2e-6: those of
``tests/test_torch_mlp_kernel.py``, whose docstring gives the reason (each
step's state differs by the summation order of the matrix products and by
``tanh`` rounding, carried through T steps; the costs stay at tens, near
the goal, so that the softmax at lambda = 0.8 weighs many samples).  The
networks are wider here (72 and 96 units, where a product's rounding error
grows with the square root of its length); T = 5 keeps the carried error
within the same bounds.  The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py`` phase 4e.
"""
import logging
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mppi_tpu import models as JM
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
from pytorch_mppi_tpu_torch.ops import rowmajor as RM
from pytorch_mppi_tpu_torch.utils.convert import mlp_params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
K, T, NSP = 256, 5, 3
NX, NU = 10, 4
SIZES = [14, 72, 72, 72, 72, 72, 10]
GOAL = np.array([1.0, -1.0, 3.0, 0.5, 1.5, -0.5, 0.25, 1.0, 2.0, -2.0], np.float32)
X0 = np.array([0.8, -0.7, 2.9, 0.4, 1.3, -0.3, 0.2, 0.9, 1.8, -1.9], np.float32)
KW = dict(angle_wrap_dims=(2,))
OUT_SCALE = 0.1  # a residual model's step is small (tests/test_torch_mlp_kernel.py)
# the traced network: [16, 96, 96, 96, 12] tanh on (state, action), residual
T_NX, T_NU, T_SIZES = 12, 4, [16, 96, 96, 96, 12]
T_GOAL = np.linspace(-1.0, 1.0, T_NX).astype(np.float32)


def _weights(sizes, seed, out_scale=OUT_SCALE):
    rs = np.random.RandomState(seed)
    w = [((rs.randn(a, b) / np.sqrt(a)).astype(np.float32), (rs.randn(b) * 0.1).astype(np.float32))
         for a, b in zip(sizes[:-1], sizes[1:])]
    W, b = w[-1]
    w[-1] = ((W * out_scale).astype(np.float32), (b * out_scale).astype(np.float32))
    return w


def _pair(seed=0):
    """The JAX (dynamics, cost) with the network closed in, and the port's
    kernel model on the same weights."""
    w = _weights(SIZES, seed)
    jw = [(jnp.asarray(W), jnp.asarray(b)) for W, b in w]
    jdyn_p = JM.make_residual_dynamics(NX, NU, **KW)
    goal = jnp.asarray(GOAL)
    model = KM.residual_mlp_model(mlp_params_from_numpy(w), NX, NU, cost="quadratic",
                                  goal=GOAL, **KW)
    return (lambda s, a: jdyn_p(jw, s, a)), (lambda s, a: ((goal - s) ** 2).sum(axis=-1)), model


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _traced_pair(seed=5):
    """The traced network as JAX functions and as the user's torch
    callables, untagged, on the same weights."""
    w = _weights(T_SIZES, seed)
    jw = [(jnp.asarray(W), jnp.asarray(b)) for W, b in w]
    tw = [(torch.from_numpy(W), torch.from_numpy(b)) for W, b in w]
    jgoal, tgoal = jnp.asarray(T_GOAL), torch.from_numpy(T_GOAL)

    def jdyn(s, a):
        h = jnp.concatenate([s, a], axis=-1)
        for i, (W, b) in enumerate(jw):
            h = h @ W + b
            if i + 1 < len(jw):
                h = jnp.tanh(h)
        return s + h

    def tdyn(s, a):
        h = torch.cat([s, a], dim=-1)
        for i, (W, b) in enumerate(tw):
            h = h @ W + b
            if i + 1 < len(tw):
                h = torch.tanh(h)
        return s + h

    return (jdyn, lambda s, a: ((jgoal - s) ** 2).sum(axis=-1), tdyn,
            lambda s, a: ((tgoal - s) ** 2).sum(-1))


def _operands(variant, rs, nu, nx, x0):
    D = T * nu
    R = NSP * nu if variant == "kmppi" else D
    full = lambda v, n=D: np.full(n, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.3).astype(np.float32)
    a_flat, lam = U2 * 0.7, np.float32(0.8)
    if variant == "mppi":
        rest = (U2, full(1.0), full(0.05), full(-2.0), full(2.0), a_flat, lam)
    elif variant == "smppi":
        rest = (U2, (rs.randn(D) * 0.3).astype(np.float32), full(0.8), full(0.05), full(-2.0),
                full(2.0), full(-2.5), full(2.5), a_flat, lam, np.float32(2.0), np.float32(0.5))
    else:
        interp, _ = PK.interpolation_operators(PK.RBFKernel(2.0), T, NSP, torch.float32)
        Wt = np.kron(interp.numpy(), np.eye(nu, dtype=np.float32))
        rest = (U2, (rs.randn(R) * 0.3).astype(np.float32), full(1.0, R), full(0.05, R),
                full(-2.5, R), full(2.5, R), full(-2.0), full(2.0), a_flat, Wt, lam)
    return R, np.broadcast_to(x0[:, None], (nx, K)), rest


def _kernel_a_against_jax(variant, jdyn, jcost, model, nx, nu, x0, seed):
    rs = np.random.RandomState(seed)
    nsp = NSP if variant == "kmppi" else 0
    flags = dict(num_support_pts=nsp, smppi=variant == "smppi",
                 sample_null_action=variant == "mppi")
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True, **flags)
    jmake = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
             "kmppi": PR.make_transposed_kmppi_solve}[variant]
    pmake = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
             "kmppi": FS.make_transposed_kmppi_solve}[variant]
    solve_j = jmake(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                    rng_in_kernel=False)
    solve_p = pmake(cfg, model, pair_block=solve_j.block_k)
    R, x0T, rest = _operands(variant, rs, nu, nx, x0)
    bits = _rand_bits(rs, (R, solve_j.K_pad))
    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in rest))
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0)[:, None].expand(nx, K),
                    *(torch.from_numpy(np.array(v)) for v in rest))
    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(m_p, m_j, **TOL_C)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, **TOL_U)
    return solve_p


def _batched_against_jax(mode, jdyn, jcost, model, nx, nu, x0, seed):
    rs = np.random.RandomState(seed)
    N, D = 3, T * nu
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True)
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True)
    operand = mode == "operand"
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=operand, noise_operand=operand)
    solve_p = FS.make_transposed_batched_solve(cfg, N, model, noise_operand=operand,
                                               pair_block=None if operand else solve_j.block_k)
    lead = ((rs.randn(D, solve_j.K_pad) * 0.9).astype(np.float32) if operand
            else _rand_bits(rs, (D, solve_j.K_pad)))
    x0T = (x0[:, None] + rs.randn(nx, N) * 0.2).astype(np.float32)
    args = (x0T, (rs.randn(D, N) * 0.3).astype(np.float32), np.full(D, 1.0, np.float32),
            np.full(D, 0.05, np.float32), np.full(D, -2.0, np.float32),
            np.full(D, 2.0, np.float32), (rs.randn(D, N) * 0.5).astype(np.float32),
            np.float32(0.8))
    out_j = solve_j(jnp.asarray(lead), *(jnp.asarray(v) for v in args))
    out_p = solve_p(torch.from_numpy(lead), *(torch.from_numpy(np.array(v)) for v in args))
    delta_p, ms_p, ct_p = (v.numpy() for v in out_p)
    delta_j, ms_j, ct_j = (np.asarray(v) for v in out_j)
    assert ct_p.shape == ct_j.shape == (N, K) and delta_p.shape == delta_j.shape == (D, N)
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(ms_p[0], ms_j[0], **TOL_C)
    np.testing.assert_allclose(ms_p[1], ms_j[1], rtol=2e-5)
    np.testing.assert_allclose(delta_p / ms_p[1], delta_j / ms_j[1], **TOL_U)
    return solve_p


# ---------------------------------------------------------------------------
# The block residual MLP against JAX
# ---------------------------------------------------------------------------


def test_beyond_every_per_thread_bound_routes_to_the_block_model():
    _, _, model = _pair()
    assert model.model_id == KM.RESIDUAL_MLP_BLOCK and model.name == "residual_mlp_block"
    assert not KM.per_thread_bounds(SIZES, NX, NU)
    assert KM.activation_ld(model) == 72
    FS.check_kernel_model(MPPIConfig(nx=NX, nu=NU, K=K, T=T), model)


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_kernel_a_plain_matches_jax_kernel(variant):
    jdyn, jcost, model = _pair()
    solve = _kernel_a_against_jax(variant, jdyn, jcost, model, NX, NU, X0, 7)
    assert solve.spec.act_ld == 72 and solve.act_rows == 32


@pytest.mark.parametrize("mode", ["bits", "operand"])
def test_batched_plain_matches_jax_kernel(mode):
    jdyn, jcost, model = _pair(seed=2)
    solve = _batched_against_jax(mode, jdyn, jcost, model, NX, NU, GOAL, 13)
    assert solve.spec.act_ld == 72 and solve.act_rows == 128


def test_rollout_plain_matches_jax_kernel():
    rs = np.random.RandomState(11)
    jdyn, jcost, model = _pair(seed=1)
    Kr = 200
    jcfg = JConfig(nx=NX, nu=NU, K=Kr, T=T, dtype=F32)
    x0_K = (GOAL[None] + rs.randn(Kr, NX) * 0.3).astype(np.float32)
    u = (rs.randn(Kr, T, NU) * 1.5).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    rollout = LG.make_fused_rollout(MPPIConfig(nx=NX, nu=NU, K=Kr, T=T), model)
    cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
    np.testing.assert_allclose(cost_p.numpy(), cost_j, **TOL_C)


# ---------------------------------------------------------------------------
# A traced network beyond MAX_OPS: dense nodes
# ---------------------------------------------------------------------------


def test_traced_network_beyond_max_ops_takes_dense_nodes(caplog):
    _, _, tdyn, tcost = _traced_pair()
    cfg = MPPIConfig(nx=T_NX, nu=T_NU, K=K, T=T)
    model = BL.kernel_model(cfg, tdyn, tcost)
    layers = model.program.dense_layers(model.outputs[:T_NX])
    assert [(n_in, n_out) for *_, n_in, n_out in layers] == list(zip(T_SIZES, T_SIZES[1:]))
    macs = sum(a * b for a, b in zip(T_SIZES, T_SIZES[1:]))
    assert macs > BL.MAX_OPS > BL._count_ops(model.program, model.outputs)
    assert BL.dense_ops(model.program, model.outputs) == 2 * macs
    assert model.activation_ld() == 96
    kernel = BL.generated_kernel(model, None)
    assert kernel.block and "kBlock = true" in kernel.header()
    assert FS.launch_name(kernel.id, "mppi") == "generated_mppi_block"
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI(tdyn, tcost, T_NX, torch.eye(T_NU), num_samples=64, horizon=4,
                      lambda_=1.0, seed=1, use_pallas=True, device="cpu")
    assert ctrl._fns.fused
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING], caplog.text
    assert bool(torch.isfinite(ctrl.command(torch.from_numpy(T_GOAL) * 0.5)).all())


def test_traced_network_kernel_a_matches_jax_kernel():
    jdyn, jcost, tdyn, tcost = _traced_pair()
    x0 = (T_GOAL + 0.3).astype(np.float32)
    solve = _kernel_a_against_jax("mppi", jdyn, jcost, (tdyn, tcost), T_NX, T_NU, x0, 17)
    assert isinstance(solve.model, BL.GeneratedModel) and solve.spec.act_ld == 96


def test_traced_network_batched_matches_jax_kernel():
    jdyn, jcost, tdyn, tcost = _traced_pair(seed=6)
    solve = _batched_against_jax("bits", jdyn, jcost, (tdyn, tcost), T_NX, T_NU, T_GOAL, 19)
    # groups of 64 by occupancy: 128 rows of 104 floats would leave one block an SM
    assert isinstance(solve.model, BL.GeneratedModel) and solve.act_rows == 64


def _small_net():
    g = torch.Generator().manual_seed(3)
    W1, b1 = torch.randn(6, 16, generator=g) * 0.4, torch.randn(16, generator=g) * 0.1
    W2, b2 = torch.randn(16, 4, generator=g) * 0.4, torch.randn(4, generator=g) * 0.1

    def dyn(s, a):
        return s + torch.tanh(torch.cat([s, a], -1) @ W1 + b1) @ W2 + b2

    def cost(s, a):
        return (s ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)

    return dyn, cost


def test_within_max_ops_stays_scalar_and_dense_agrees():
    """A network within MAX_OPS is emitted as the scalar program (no dense
    node, no block struct); its dense lowering computes the same."""
    dyn, cost = _small_net()
    cfg = MPPIConfig(nx=4, nu=2, K=64, T=5)
    model = BL.kernel_model(cfg, dyn, cost)
    assert not model.program.dense_layers(model.outputs)
    assert "kBlock" not in BL.generated_kernel(model, None).header()
    prog, pool, outputs = BL._trace_pair(cfg, dyn, cost, dense=True)
    assert len(prog.dense_layers(outputs)) == 2
    dense = BL.generated_model(prog, outputs, 4, 2, torch.tensor(pool, dtype=torch.float64))
    g = torch.Generator().manual_seed(9)
    s, a = torch.randn(128, 4, generator=g), torch.randn(128, 2, generator=g)
    torch.testing.assert_close(dense.dynamics(s, a), model.dynamics(s, a), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dense.running_cost(s, a), model.running_cost(s, a), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        torch.testing.assert_close(dense.dynamics(s, a), dyn(s, a), rtol=1e-5, atol=1e-5)
    # in float64 the two lowerings agree to the last bits of the sums' order
    s64, a64 = s.double(), a.double()
    torch.testing.assert_close(dense.dynamics(s64, a64), model.dynamics(s64, a64),
                               rtol=1e-12, atol=1e-12)


_BLOCK_HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
namespace fused_mppi {
// block_dense for one thread: every unit and sample, in input order, then
// the bias and the unit-wise epilogue
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
#include "model.cuh"
}
using fused_mppi::Generated;
int main() {
  int h[5];  // K, nx, nu, constants, activation row
  if (fread(h, sizeof(int), 5, stdin) != 5) return 1;
  const int K = h[0], nx = h[1], nu = h[2], ld = h[4];
  float* c = (float*)malloc(sizeof(float) * (h[3] + 1));
  float* xs = (float*)malloc(sizeof(float) * K * nx);
  float* us = (float*)malloc(sizeof(float) * K * nu);
  float* act = (float*)calloc(2 * K * ld, sizeof(float));
  if (fread(c, sizeof(float), h[3], stdin) != (size_t)h[3]) return 1;
  if (fread(xs, sizeof(float), K * nx, stdin) != (size_t)(K * nx)) return 1;
  if (fread(us, sizeof(float), K * nu, stdin) != (size_t)(K * nu)) return 1;
  Generated::Carry* carry = new Generated::Carry[K];
  // block_step for one group of K samples, the threads one after another
  for (int k = 0; k < K; ++k)
    Generated::begin<Generated::kN>(c, xs + k * nx, us + k * nu, nx, nu, 0, carry[k],
                                    act + k * ld, K * ld);
  for (int l = 0; l < Generated::layers(c); ++l) {
    Generated::dense(l, c, act, ld, K, nx);
    for (int k = 0; k < K; ++k)
      Generated::after<Generated::kN>(l, c, xs + k * nx, us + k * nu, nx, nu, 0, carry[k],
                                      act + k * ld, K * ld);
  }
  for (int k = 0; k < K; ++k) {
    const float cost = Generated::cost<Generated::kN>(c, xs + k * nx, us + k * nu, nx, nu, 0);
    fwrite(xs + k * nx, sizeof(float), nx, stdout);
    fwrite(&cost, sizeof(float), 1, stdout);
  }
  return 0;
}
"""


class _Gain(torch.nn.Module):
    """A per-unit scale: a unit-wise node that reads a constant of its own
    unit (an epilogue whose constants lie at offsets affine in the unit)."""

    def __init__(self, gain):
        super().__init__()
        self.gain = gain

    def forward(self, h):
        return h * self.gain


def _mbpo_shape(sizes=(16, 200, 200, 200, 200, 12), nx=12, nu=4, gain=False):
    """A user's ``nn.Sequential`` of MBPO's shape (Linear layers with SiLU
    between them, with ``gain`` each scaled by a vector of its own) on
    (state, action), a residual model, untagged, and its traced kernel
    model."""
    g = torch.Generator().manual_seed(23)
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        lin = torch.nn.Linear(a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(b, a, generator=g) / np.sqrt(a))
            lin.bias.copy_(torch.randn(b, generator=g) * 0.1)
        layers += [lin, torch.nn.SiLU()]
        if gain:
            layers.append(_Gain(torch.rand(b, generator=g) + 0.5))
    net = torch.nn.Sequential(*layers[:-2 if gain else -1])
    goal = torch.linspace(-1.0, 1.0, nx)

    def dyn(s, a):
        return s + 0.1 * net(torch.cat([s, a], dim=-1))

    def cost(s, a):
        return ((goal - s) ** 2).sum(-1)

    return BL.kernel_model(MPPIConfig(nx=nx, nu=nu, K=64, T=5), dyn, cost), dyn, cost


@pytest.mark.parametrize("net", ["traced", "small_forced_dense", "mbpo_shape", "mbpo_gain"])
def test_block_header_on_the_host(tmp_path, net):
    """The emitted block struct (segments, carries, dense layers) compiled
    with the host ``g++`` and stepped by a one-thread ``block_step``, held
    against the program's evaluator (rtol 1e-5 / atol 1e-5: the evaluator's
    products sum in another order)."""
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    if net == "traced":
        _, _, dyn, cost = _traced_pair()
        nx, nu = T_NX, T_NU
        model = BL.kernel_model(MPPIConfig(nx=nx, nu=nu, K=64, T=5), dyn, cost)
    elif net.startswith("mbpo"):
        nx, nu = 12, 4
        model = _mbpo_shape((16, 96, 96, 12), gain=net == "mbpo_gain")[0]
        # each layer's epilogue: the SiLU (with the gain, its constant a unit)
        # and the last layer's scale by 0.1
        strides = [set(e["stride"].values()) for e in model.program.unit_wise(model.outputs[:nx])]
        assert strides == [{1} if net == "mbpo_gain" else set()] * 2 + [set()], strides
    else:
        dyn, cost = _small_net()
        nx, nu = 4, 2
        prog, pool, outputs = BL._trace_pair(MPPIConfig(nx=nx, nu=nu, K=64, T=5), dyn, cost,
                                             dense=True)
        model = BL.generated_model(prog, outputs, nx, nu, torch.tensor(pool, dtype=torch.float64))
    kernel = BL.generated_kernel(model, None)
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "harness.cpp").write_text(_BLOCK_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(exe),
                    str(tmp_path / "harness.cpp")], check=True, capture_output=True, timeout=300)
    g = torch.Generator().manual_seed(7)
    Kh = 32
    x, u = torch.randn(Kh, nx, generator=g), torch.randn(Kh, nu, generator=g)
    blob = struct.pack("5i", Kh, nx, nu, model.consts.numel(), model.activation_ld())
    blob += b"".join(a.float().contiguous().numpy().tobytes() for a in (model.consts, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(Kh, nx + 1)
    ns, c = model.rollout_step(x, u, 0)
    np.testing.assert_allclose(res[:, :nx], ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, nx], c.numpy(), rtol=1e-5, atol=1e-5)


def test_unit_wise_split_of_the_mbpo_shape_network():
    """``emit_block`` splits the MBPO-shape network: each hidden layer's
    SiLU (``x * sigmoid(x)``, its bias inside the dense node) is unit-wise,
    the same expression for every unit, and runs in the kernels as the
    layer's epilogue (the struct's ``unit``), the next layer reading the
    epilogue's results where it left them (no owner segment between the
    hidden layers); the last layer's scale by 0.1 is its epilogue, and the
    residual state update x + 0.1 out stays per-sample, in the owner's last
    segment."""
    model, _, _ = _mbpo_shape()
    prog, outs = model.program, model.outputs[:12]
    epi = prog.unit_wise(outs)
    assert len(epi) == 5 and all(e is not None for e in epi)
    for e in epi[:4]:
        ops = {prog.nodes[n][0] for n in e["nodes"]}
        assert ops == {"dout", "sigmoid", "mul"}, ops
        assert len(e["nodes"]) == 3 * 200 and sorted(e["results"]) == list(range(200))
        assert all(prog.nodes[r][0] == "mul" for r in e["results"].values())
        assert e["stride"] == {}  # no constant beside the unit's output
    assert {prog.nodes[n][0] for n in epi[4]["nodes"]} == {"dout", "mul"}
    assert sorted(epi[4]["results"]) == list(range(12))
    header = BL.generated_kernel(model, None).header()
    # one functor a distinct epilogue: the four SiLUs share one, the scale has its own
    unit = header[header.index("struct Unit0"):header.index("static void dense(")]
    assert unit.count("expf(-v)") == 1 and "struct Unit1" in unit and "x[" not in unit
    assert "(v * 0x1.99999a0000000p-4f)" in unit.split("struct Unit1")[1]  # 0.1
    after = header[header.index("static void after("):header.index("static float cost(")]
    cases = after.split("case ")[1:]
    assert len(cases) == 5 and all("out[" not in c and "row[" not in c for c in cases[:4])
    assert "x[11] = " in cases[4] and "out[11]" in cases[4] and "expf" not in cases[4]
    # layer l reads half h_l and writes the other: 0, 1, 0, 1, 0
    assert [f"h = {h};" in header for h in (0, 1)] == [True, True]
    dense = header[header.index("static void dense("):header.index("static void begin(")]
    cases = [line for line in dense.splitlines() if "case" in line]
    assert [c.split("h = ")[1][0] for c in cases] == ["0", "1", "0", "1", "0"]
    assert [c.split("f = ")[1].split(";")[0] for c in cases] == ["0", "0", "0", "0", "1"]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, keeping 10 mantissa bits."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma_3xtf32(x: torch.Tensor, w: torch.Tensor, products=3) -> torch.Tensor:
    """x @ w as ``block_dense`` computes it on the tensor cores: each
    operand split as hi + lo in TF32, a k-step of eight inputs at a time,
    each of its products (a_lo b_hi, a_hi b_lo, a_hi b_hi; or a_hi b_hi
    alone, ``products=1``) summed exactly and added to the float32
    accumulator."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    terms = ((xl, wh), (xh, wl), (xh, wh)) if products == 3 else ((xh, wh),)
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], 8):
        for a, b in terms:
            acc = (acc.double() + a[:, k0:k0 + 8].double() @ b[k0:k0 + 8].double()).float()
    return acc


@pytest.mark.parametrize("shapes", [[16, 256, 256, 12], [16, 200, 200, 200, 200, 12]],
                         ids=["quadrotor", "mbpo"])
def test_3xtf32_keeps_float32_accuracy(shapes):
    """On each layer shape, 256 rows of inputs of a hidden layer's scale and
    weights of scale 1/sqrt(fan-in): the 3xTF32 mirror's largest error
    against float64 is within F64_FACTOR times the float32 product's (the
    criterion phase 4e holds the kernels to), and one TF32 product's is
    not."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(21)
    for n_in, n_out in zip(shapes, shapes[1:]):
        x = torch.randn(256, n_in, generator=g)
        w = torch.randn(n_in, n_out, generator=g) / n_in ** 0.5
        ref = x.double() @ w.double()
        e_f32 = float(((x @ w).double() - ref).abs().max())
        e_3x = float((_mma_3xtf32(x, w).double() - ref).abs().max())
        e_1x = float((_mma_3xtf32(x, w, products=1).double() - ref).abs().max())
        assert e_3x <= smoke.F64_FACTOR * e_f32, (n_in, n_out, e_3x, e_f32)
        assert e_1x > smoke.F64_FACTOR * e_f32, (n_in, n_out, e_1x, e_f32)


# ---------------------------------------------------------------------------
# Layout, geometry, counters, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nx", [1, 7, 12, 32])
def test_block_constants_and_rebuild(nx):
    """``ResidualMLPBlock``'s constants: the header (layers, clip, cost,
    widths, the state dimensions' flags, the goal of nx floats), rows
    padded to four floats; ``plain_model`` rebuilds the model exactly."""
    rs = np.random.RandomState(nx)
    nu = 3
    wrap, encode = (0,), ((nx - 1,) if nx > 1 else ())
    sizes = [nx + len(encode) + nu, 9, nx]
    goal = (rs.randn(nx) * 3).astype(np.float32)
    w = _weights(sizes, nx)
    model = KM.residual_mlp_model(mlp_params_from_numpy(w), nx, nu, u_clip=(-1.5, 2.5),
                                  angle_wrap_dims=wrap, angle_encode_dims=encode,
                                  cost="quadratic", goal=goal, block=True)
    c = model.consts
    head = KM.block_mlp_header(c, nx)
    assert head["widths"] == sizes and head["layers"] == 2 and head["clip"]
    assert (head["lo"], head["hi"]) == (-1.5, 2.5) and head["cost"] == "quadratic"
    assert head["wrap"] == wrap and head["encode"] == encode
    assert head["goal"].numpy().tobytes() == goal.tobytes()
    assert head["weights"] == KM.block_mlp_head(2, nx) and head["weights"] % 4 == 0
    at = head["weights"]
    for (W, b), n_in, n_out in zip(w, sizes, sizes[1:]):
        p = -(-n_out // 4) * 4
        Wc = c[at:at + n_in * p].reshape(n_in, p)
        assert torch.equal(Wc[:, :n_out], torch.from_numpy(W)) and not Wc[:, n_out:].any()
        assert torch.equal(c[at + n_in * p:at + n_in * p + n_out], torch.from_numpy(b))
        at += (n_in + 1) * p
    assert at == c.numel()
    rebuilt = KM.plain_model(KM.RESIDUAL_MLP_BLOCK, c, nx, nu)
    assert rebuilt.model_id == KM.RESIDUAL_MLP_BLOCK and torch.equal(rebuilt.consts, c)
    s, a = torch.from_numpy(rs.randn(16, nx).astype(np.float32)), torch.randn(16, nu)
    assert torch.equal(rebuilt.dynamics(s, a), model.dynamics(s, a))
    assert torch.equal(rebuilt.running_cost(s, a), model.running_cost(s, a))
    assert KM.mlp_layout(model)["widths"] == sizes


def test_forced_block_model_computes_the_per_thread_model():
    """``block=True`` on a network within the per-thread bounds: another
    device model and layout, the same plain functions; on the card the
    kernels agree within ``chip_smoke.F64_FACTOR`` of the plain version's
    error against float64 (``chip_smoke.py`` phase 4e)."""
    w = mlp_params_from_numpy(_weights([3, 32, 32, 2], 0, 1.0))
    kw = dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,))
    per_thread = KM.residual_mlp_model(w, 2, 1, **kw)
    block = KM.residual_mlp_model(w, 2, 1, block=True, **kw)
    assert (per_thread.model_id, block.model_id) == (KM.RESIDUAL_MLP, KM.RESIDUAL_MLP_BLOCK)
    s, a = torch.randn(64, 2) * 3, torch.randn(64, 1) * 3
    assert torch.equal(block.dynamics(s, a), per_thread.dynamics(s, a))
    assert torch.equal(block.running_cost(s, a), per_thread.running_cost(s, a))
    assert KM.mlp_layout(per_thread)["widths"] == KM.mlp_layout(block)["widths"]


def test_activation_groups():
    """A block model's group of samples and the tiles' place, by occupancy
    (the most blocks an SM up to a target, then the larger group): kernel
    A's S = 32 samples at 256 units (MPPI, and KMPPI with its operator
    panel) with its tiles in the global scratch and three blocks an SM
    (``KERNEL_A_BLOCK_BLOCKS``; the merge's block scales and the products'
    panel lie in its activations, which hold neither while the layers
    run); the batched
    kernel's 128 at 64 units and 32 at 256, each with its noise tile in the
    global scratch and two blocks an SM (``OCCUPANCY_TARGET``; one before:
    a shared tile and 64 rows of 256 floats took 199 KB); S = 128 at 1,000
    units takes groups of 16; the rollout beside its staged rows.  Rows of
    activations are padded to 8 mod 32 floats, and the per-sample values
    take an odd row each."""
    assert [FS.act_stride(ld) for ld in (4, 72, 200, 256, 1000)] == [8, 72, 200, 264, 1000]
    assert all(FS.act_stride(ld) % 32 == 8 and FS.act_stride(ld) >= -(-ld // 8) * 8
               for ld in range(4, 1100, 4))
    assert FS.state_ld(12, 4) == 21 and FS.state_ld(2, 1) == 5
    assert FS.activation_bytes(4000, 32, 256) == 4000 + 2 * 32 * 264 * 4
    assert FS.activation_bytes(4000, 32, 256, 32, 12, 4) == 4000 + (2 * 32 * 264 + 32 * 21) * 4
    assert FS.activation_bytes(4001, 16, 4) == 4016 + 2 * 16 * 8 * 4
    # kernel A's operator panel lies in a block model's activations
    assert FS.activation_bytes(4000, 16, 4, least=5000) == 4000 + 5000 * 4
    assert FS.panel_floats(FS.KMPPI, False, 60, 32) == 32 * 60
    assert FS.panel_floats(FS.MPPI, False, 120, 32) == 0
    assert FS.blocks_per_sm(FS.MAX_SMEM_BYTES) == 1 and FS.blocks_per_sm(100_000) == 2
    for variant, S, ld, rows, shared, blocks in ((FS.MPPI, 32, 256, 32, False, 3),
                                                 (FS.KMPPI, 32, 256, 32, False, 3),
                                                 (FS.BATCHED, 128, 64, 128, False, 2),
                                                 (FS.BATCHED, 128, 256, 32, False, 2),
                                                 (FS.MPPI, 128, 1000, 16, True, 1)):
        spec = FS.LaunchSpec(variant, KM.RESIDUAL_MLP_BLOCK, 10_000, 30, 12, 4, 120, 10_000, 0,
                             0, 0, 0, 0, 16 if variant == FS.BATCHED else 1, 4, S, 0, 0,
                             act_ld=ld)
        geo = FS.launch_geometry(spec)
        assert (geo["act_rows"], geo["shared"]) == (rows, shared), (variant, S, ld)
        # kernel A's merge scales and operator panel lie in the activations
        panel = 0 if variant == FS.BATCHED else FS.panel_floats(variant, False, 120, S)
        head = 0 if variant == FS.BATCHED else 4 * (512 + panel)
        base = FS.base_smem_bytes(variant, 120, 120, False, S, shared) - head
        smem = FS.activation_bytes(base, rows, ld, S, 12, 4, panel)
        assert smem == geo["block_smem"] <= FS.MAX_SMEM_BYTES
        assert FS.blocks_per_sm(smem) >= blocks, (ld, smem)
    assert LG.rollout_act_rows(30, 4, 32, 256, 12) == 32
    assert LG.rollout_act_rows(30, 4, 128, 256, 12) == 16
    assert LG.rollout_act_rows(30, 4, 32, 0, 12) == 0


@pytest.mark.parametrize("width, rows", [(1_000, 16), (2_048, 8), (3_300, 8), (3_600, 0)])
def test_widest_layers_take_half_tile_groups(width, rows):
    """Where no whole m16 tile of a layer's activations fits, a group of
    ``DENSE_ROWS`` = 8 samples (half a tile) does: a [16, width, 12]
    residual MLP at nx = 12, nu = 4 runs in kernel A, the batched pair and
    the rollout up to about 3,380 units (``check_kernel_model``'s bound; in
    groups of 8 beyond about 1,700-1,770), and beyond it (3,600) their
    factories refuse it, naming the bound."""
    model = KM.residual_mlp_model(mlp_params_from_numpy(_weights([16, width, 12], 0)), 12, 4,
                                  cost="quadratic", goal=np.zeros(12, np.float32))
    assert model.model_id == KM.RESIDUAL_MLP_BLOCK and KM.activation_ld(model) == width
    cfg = MPPIConfig(nx=12, nu=4, K=256, T=5)
    makes = (FS.make_transposed_fused_solve, LG.make_fused_rollout,
             lambda c, m: FS.make_transposed_batched_solve(c, 3, m))
    if not rows:
        for make in makes:
            with pytest.raises(FS.FusedSolveUnavailable, match="widths up to about 33"):
                make(cfg, model)
        return
    FS.check_kernel_model(cfg, model)
    for make in makes:
        make(cfg, model)
    for variant, S, group in ((FS.MPPI, 32, 1), (FS.BATCHED, 128, 3)):
        spec = FS.LaunchSpec(variant, KM.RESIDUAL_MLP_BLOCK, 256, 5, 12, 4, 20, 256, 0, 0, 0, 0,
                             0, group, group, S, 0, 0, act_ld=width)
        geo = FS.launch_geometry(spec)
        assert geo["act_rows"] == rows and geo["block_smem"] <= FS.MAX_SMEM_BYTES, variant
    assert LG.rollout_act_rows(5, 4, 32, width, 12) == rows


def test_launch_counters_name_the_block_kernels():
    assert FS.launch_name(KM.RESIDUAL_MLP_BLOCK, "mppi") == "mppi_block"
    assert FS.launch_name(KM.RESIDUAL_MLP_BLOCK, "batched") == "batched_block"
    assert FS.launch_name(KM.RESIDUAL_MLP_BLOCK, "rollout") == "rollout_block"
    assert FS.launch_name(KM.RESIDUAL_MLP, "mppi") == "mppi"
    for name in FS.BLOCK_KERNELS + FS.GENERATED_BLOCK_KERNELS:
        assert name in FS.launches


def test_round_one_solve_refuses_block_models():
    """(Its name is the refusal it pinned before ROADMAP.md Queue 2a step
    6.)  The round-1 solve takes the block model: kernel A's block path
    with its ``rowmajor`` flag, its group of samples chosen as kernel A's
    MPPI's, and its plain version runs the block model's.
    ``tests/test_torch_wide_programs.py`` holds it against JAX's kernel."""
    _, _, model = _pair()
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
    solve = RM.make_fused_solve(cfg, model)
    assert solve.spec.rowmajor and solve.spec.act_ld == KM.activation_ld(model) > 0
    assert solve.act_rows == FS.make_transposed_fused_solve(cfg, model).act_rows
    D = T * NU
    out = solve((1, 2), torch.zeros(NX), torch.zeros(T, NU), torch.eye(NU), torch.zeros(NU),
                -1.0, 1.0, torch.zeros(D), 1.0)
    assert out[3].shape == (K,) and bool(torch.isfinite(out[3]).all())


@pytest.mark.parametrize("use_pallas", [True, "rollout"])
def test_block_model_routes_to_the_kernels(use_pallas, caplog):
    """``use_pallas`` with the block MLP takes kernel A or the legacy
    rollout (on CPU tensors their plain versions) with no plain-path
    warning (the legacy route warns that it is the legacy pair); SMPPI,
    KMPPI and MPPI_Batched take their kernels too."""
    _, _, model = _pair()
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrls = [P.MPPI(model.dynamics, model.running_cost, NX, torch.eye(NU),
                        num_samples=64, horizon=4, seed=3, use_pallas=use_pallas, device="cpu")]
        if use_pallas is True:
            ctrls += [P.SMPPI(model.dynamics, model.running_cost, NX, torch.eye(NU),
                              num_samples=64, horizon=4, seed=3, use_pallas=True, device="cpu",
                              w_action_seq_cost=1.0, delta_t=1.0),
                      P.KMPPI(model.dynamics, model.running_cost, NX, torch.eye(NU),
                              num_samples=64, horizon=4, seed=3, use_pallas=True, device="cpu",
                              num_support_pts=3, kernel=P.RBFKernel(2.0)),
                      P.MPPI_Batched(model.dynamics, model.running_cost, NX, torch.eye(NU),
                                     num_envs=2, num_samples=256, horizon=4, seed=3,
                                     use_pallas="kernel_rng", device="cpu")]
    assert "plain torch path" not in caplog.text, caplog.text
    x = torch.from_numpy(X0)
    for ctrl in ctrls:
        assert ctrl._fns.fused
        xs = torch.stack([x, x]) if isinstance(ctrl, P.MPPI_Batched) else x
        assert bool(torch.isfinite(ctrl.command(xs)).all())


def test_bound_counts_the_block_models():
    """``chip_smoke._per_step``, the bounds' operations a step: the block
    MLP counts as the per-thread MLP on the same network, and a traced
    program's dense layers count two operations a multiply-add and one a
    bias beside its scalar nodes."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    w = mlp_params_from_numpy(_weights([3, 32, 32, 2], 0, 1.0))
    kw = dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,))
    per_thread = KM.residual_mlp_model(w, 2, 1, **kw)
    block = KM.residual_mlp_model(w, 2, 1, block=True, **kw)
    assert smoke._per_step(block, 2, 1) == smoke._per_step(per_thread, 2, 1) > 2 * 32 * 32
    # the dense / scalar split: the block model's layers run on the tensor
    # cores, the per-thread model's in float32
    assert smoke._dense_macs(block) == 3 * 32 + 32 * 32 + 32 * 2
    assert smoke._dense_macs(per_thread) == 0
    ops, macs = 10 ** 9, 10 ** 8
    assert smoke.tc_bound((ops, 0), macs)[0] == pytest.approx(
        max((ops - 2 * macs) / smoke.H100_F32_PER_S, 6 * macs / smoke.H100_TF32_PER_S) * 1e3)
    assert smoke.tc_bound((ops, 0), 0) == smoke.bound((ops, 0))
    _, _, tdyn, tcost = _traced_pair()
    model = BL.kernel_model(MPPIConfig(nx=T_NX, nu=T_NU, K=64, T=5), tdyn, tcost)
    macs = sum(a * b for a, b in zip(T_SIZES, T_SIZES[1:]))
    assert BL.dense_ops(model.program, model.outputs) == 2 * macs  # the biases add as nodes
    assert smoke._per_step(model, T_NX, T_NU) == (
        T_NU + BL._count_ops(model.program, model.outputs) + 2 * macs + 1)
    assert smoke._dense_macs(model) == macs
