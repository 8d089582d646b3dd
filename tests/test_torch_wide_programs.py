"""The dynamics bridge's last refusals lifted, on the CPU, at a small size.

* **Per-sample programs beyond 32 states or actions.**  A traced program
  without dense layers beyond the per-sample models' 32 (``MAXN``) runs as
  a block program without layers (``kPerSample`` in its struct): its state
  and action live in a row of the block kernels' shared memory, and each
  owner thread steps its sample alone.  A planar swarm of 10 double
  integrators (nx = 40 positions and velocities, nu = 20 accelerations,
  pairwise collision costs, written as a user would: ``view``,
  broadcasting, a constant upper-triangle mask, no matrix product) goes
  through the plain versions of kernel A's three variants, the batched
  pair and the legacy rollout against JAX's
  ``make_transposed_{fused,smppi,kmppi,batched}_solve`` and
  ``make_fused_rollout`` in Pallas interpret mode on the same bits (or
  noise).  The named ``linear_quadratic`` at nx = 40 runs the trace of its
  own callables, against JAX's kernel with the same callables; JAX's
  ``TestFuzzFused`` programs at nx drawn in 33-48 the same way.  A deploy
  artifact of the swarm's fused MPPI (format 7) replays it bit for bit.
* **JAX's remaining primitives.**  ``erfinv`` (JAX's ``erf_inv``),
  ``nextafter``, the integer shifts (``shift_left``,
  ``shift_right_arithmetic``), ``cummax``, ``cummin``, ``logcumsumexp``
  (``cumlogsumexp``) and interior padding (``out[:, ::2] = s``: a
  ``new_zeros`` and a ``slice_scatter`` with a step; JAX's ``pad`` with
  interior padding) trace, against torch in float64 (rtol 1e-12) and in a
  program against JAX's kernel in interpret mode; the emitted C++ of such a
  program and of the swarm's layer-less block struct is compiled with the
  host ``g++`` and held against the program's evaluator (rtol 1e-5).  The
  refusals that JAX shares still raise and name the op: the indices of
  ``max`` and of ``cummax`` (JAX's interpreter has no rule for ``argmax``
  on a batched operand), indexing with a traced index (nor for ``gather``),
  and a program whose rows of state do not fit in shared memory.
* **Programs beyond ``CHUNK`` statements.**  A function of the generated
  struct beyond ``batch_last.CHUNK`` statements is emitted as
  ``__noinline__`` parts in depth-first order, values between them in
  scratch rows: the 38-agent swarm near ``MAX_OPS`` (its running cost in
  parts) and, at a small ``CHUNK``, the 10-agent swarm's ``begin`` and a
  per-sample program's ``step`` on register arrays, each compiled with the
  host ``g++`` and held against the program's evaluator (rtol 1e-5); no
  function holds more than ``CHUNK`` statements; a program within it
  emits the header it emits as one function.
* **The round-1 solve of a block model.**  ``ops/rowmajor.make_fused_solve``
  with the block residual MLP (``ResidualMLPBlock``) and with an nx = 33
  program, against JAX's ``make_fused_solve`` with the same functions
  closed in, interpret mode, same (K_pad, D) bits.

Tolerances: kernel A, the pair and the rollout as
``tests/test_torch_tdmpc.py`` (costs rtol 2e-5 / atol 1e-5, m the same, s
rtol 2e-5, delta/s rtol 2e-4 / atol 2e-6), where s and delta/s may also
move as far as the costs' largest difference e moves the softmax weights,
a factor e^(±e/λ) (``chip_smoke.agree``'s rule: s within 2e/λ, delta/s
within 2e/λ of its largest element): these programs' costs are tens, summed
in another order than JAX's, so e reaches a few 1e-5; the round-1 solve as
``tests/test_torch_rowmajor_solve.py`` (costs rtol 1e-5 / atol 1e-4, delta/s
rtol 1e-4 / atol 1e-5); float32 on both sides.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py`` (phase 4g, a
16-agent swarm at K = 10,000, T = 30).
"""
import logging
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

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

torch.set_num_threads(1)

F32 = jnp.float32
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
AGENTS, DT_SWARM = 10, 0.05
NX, NU = 4 * AGENTS, 2 * AGENTS
K, T, NSP = 64, 3, 2
LAM = np.float32(0.8)
GOAL_NP = np.random.RandomState(21).uniform(-1.0, 1.0, (AGENTS, 2)).astype(np.float32)
MASK_NP = np.triu(np.ones((AGENTS, AGENTS), np.float32), 1)


def swarm_torch(agents=AGENTS, goal=None, mask=None):
    """A planar swarm of double integrators as a user writes it in torch:
    the state (positions, then velocities), the actions accelerations;
    the cost |p - goal|² + 0.1 |v|² + Σ_{i<j} exp(-|p_i - p_j|² / 0.25)."""
    goal = torch.from_numpy(GOAL_NP) if goal is None else goal
    mask = torch.from_numpy(MASK_NP) if mask is None else mask
    half = 2 * agents

    def dynamics(s, u):
        p, v = s[:, :half].view(-1, agents, 2), s[:, half:].view(-1, agents, 2)
        v2 = v + u.view(-1, agents, 2) * DT_SWARM
        p2 = p + v2 * DT_SWARM
        return torch.cat([p2.reshape(-1, half), v2.reshape(-1, half)], dim=-1)

    def cost(s, u):
        p, v = s[:, :half].view(-1, agents, 2), s[:, half:].view(-1, agents, 2)
        d = p[:, :, None, :] - p[:, None, :, :]
        near = (torch.exp(-(d ** 2).sum(-1) / 0.25) * mask).sum((-1, -2))
        return ((p - goal) ** 2).sum((-1, -2)) + 0.1 * (v ** 2).sum((-1, -2)) + near

    return dynamics, cost


def swarm_jax():
    goal, mask = jnp.asarray(GOAL_NP), jnp.asarray(MASK_NP)
    half = 2 * AGENTS

    def dynamics(s, u):
        p, v = s[:, :half].reshape(-1, AGENTS, 2), s[:, half:].reshape(-1, AGENTS, 2)
        v2 = v + u.reshape(-1, AGENTS, 2) * DT_SWARM
        p2 = p + v2 * DT_SWARM
        return jnp.concatenate([p2.reshape(-1, half), v2.reshape(-1, half)], axis=-1)

    def cost(s, u):
        p, v = s[:, :half].reshape(-1, AGENTS, 2), s[:, half:].reshape(-1, AGENTS, 2)
        d = p[:, :, None, :] - p[:, None, :, :]
        near = (jnp.exp(-(d ** 2).sum(-1) / 0.25) * mask).sum((-1, -2))
        return ((p - goal) ** 2).sum((-1, -2)) + 0.1 * (v ** 2).sum((-1, -2)) + near

    return dynamics, cost


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _x0(rs):
    return np.concatenate([rs.uniform(-1.5, 1.5, 2 * AGENTS),
                           rs.randn(2 * AGENTS) * 0.3]).astype(np.float32)


def _operands(variant, rs, nx=NX, nu=NU):
    """Kernel A's operands: a nominal U, sigma 0.5, the drawn rows' and
    the actions' bounds [-2, 2], the action cost, lambda."""
    D = T * nu
    R = NSP * nu if variant == "kmppi" else D
    full = lambda v, n=D: np.full(n, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.3).astype(np.float32)
    a_flat, lam = U2 * 0.7, LAM
    if variant == "mppi":
        rest = (U2, full(0.5), full(0.0), full(-2.0), full(2.0), a_flat, lam)
    elif variant == "smppi":
        rest = (U2, (rs.randn(D) * 0.3).astype(np.float32), full(0.5), full(0.0), full(-2.0),
                full(2.0), full(-2.0), full(2.0), a_flat, lam, np.float32(2.0), np.float32(0.5))
    else:
        interp, _ = PK.interpolation_operators(PK.RBFKernel(2.0), T, NSP, torch.float32)
        Wt = np.kron(interp.numpy(), np.eye(nu, dtype=np.float32))
        rest = (U2, (rs.randn(R) * 0.3).astype(np.float32), full(0.5, R), full(0.0, R),
                full(-2.0, R), full(2.0, R), full(-2.0), full(2.0), a_flat, Wt, lam)
    return R, rest


_JMAKE = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
          "kmppi": PR.make_transposed_kmppi_solve}
_PMAKE = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
          "kmppi": FS.make_transposed_kmppi_solve}


def _kernel_a_against_jax(variant, jdyn, jcost, model, x0, seed, nx=NX, nu=NU, spread=0.1):
    """One iteration of kernel A's plain version with ``model`` (a kernel
    model or the user's pair) against JAX's kernel in interpret mode with
    the jnp callables, on the same bits.  Returns the port's solve."""
    rs = np.random.RandomState(seed)
    flags = dict(num_support_pts=NSP if variant == "kmppi" else 0, smppi=variant == "smppi",
                 sample_null_action=variant == "mppi")
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True, **flags)
    solve_j = _JMAKE[variant](jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                              rng_in_kernel=False)
    solve_p = _PMAKE[variant](cfg, model, pair_block=solve_j.block_k)
    R, rest = _operands(variant, rs, nx, nu)
    bits = _rand_bits(rs, (R, solve_j.K_pad))
    x0T = np.broadcast_to(x0[:, None], (nx, K))
    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in rest))
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0)[:, None].expand(nx, K),
                    *(torch.from_numpy(np.array(v)) for v in rest))
    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    assert np.ptp(ct_j) > spread  # the costs spread: the softmax weighs many samples
    _assert_update(ct_p, ct_j, m_p, m_j, s_p, s_j, delta_p / s_p, delta_j / s_j, LAM)
    return solve_p


def _assert_update(ct_p, ct_j, m_p, m_j, s_p, s_j, upd_p, upd_j, lam):
    """Costs, m, s and the update delta/s (see the module docstring)."""
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(m_p, m_j, **TOL_C)
    moved = 2 * float(np.abs(ct_p - ct_j).max()) / float(lam)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5 + moved)
    scale = np.abs(upd_j).max(axis=0)
    assert (np.abs(upd_p - upd_j) <= TOL_U["atol"] + TOL_U["rtol"] * np.abs(upd_j)
            + moved * scale).all(), np.abs(upd_p - upd_j).max()


# ---------------------------------------------------------------------------
# Step 3b: per-sample programs beyond 32 states or actions
# ---------------------------------------------------------------------------


def test_swarm_traces_into_a_block_program_without_layers():
    """The swarm has no product with a constant matrix: no dense layer, so
    beyond 32 states it is a block program without layers, which its kernels
    count under ``*_block``; its activation row is ``ROWS_LD``."""
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
    model = BL.kernel_model(cfg, *swarm_torch())
    assert isinstance(model, BL.GeneratedModel)
    assert not model.program.dense_layers(model.outputs)
    assert BL._count_ops(model.program, model.outputs) < BL.MAX_OPS
    assert KM.activation_ld(model) == BL.ROWS_LD
    kernel = BL.generated_kernel(model, None)
    header = kernel.header()
    assert "kBlock = true" in header and "kPerSample = true" in header
    assert "layers(const float*) { return 0; }" in header
    assert kernel.block and FS.launch_name(kernel.id, "mppi") == "generated_mppi_block"
    solve = FS.make_transposed_fused_solve(cfg, model)
    assert solve.spec.act_ld == BL.ROWS_LD and solve.act_rows > 0


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_swarm_kernel_a_plain_matches_jax_kernel(variant):
    jdyn, jcost = swarm_jax()
    solve = _kernel_a_against_jax(variant, jdyn, jcost, swarm_torch(),
                                  _x0(np.random.RandomState(1)), seed=7)
    assert isinstance(solve.model, BL.GeneratedModel) and solve.spec.act_ld == BL.ROWS_LD


@pytest.mark.parametrize("mode", ["bits", "operand"])
def test_swarm_batched_plain_matches_jax_kernel(mode):
    rs = np.random.RandomState(13)
    jdyn, jcost = swarm_jax()
    N, D = 3, T * NU
    jcfg = JConfig(nx=NX, nu=NU, K=K, T=T, dtype=F32, diag_sigma=True)
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
    operand = mode == "operand"
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=operand, noise_operand=operand)
    solve_p = FS.make_transposed_batched_solve(cfg, N, swarm_torch(), noise_operand=operand,
                                               pair_block=None if operand else solve_j.block_k)
    assert solve_p.plant_group == 1 and solve_p.spec.act_ld == BL.ROWS_LD
    lead = ((rs.randn(D, solve_j.K_pad) * 0.5).astype(np.float32) if operand
            else _rand_bits(rs, (D, solve_j.K_pad)))
    x0T = np.stack([_x0(rs) for _ in range(N)], axis=1)
    args = (x0T, (rs.randn(D, N) * 0.3).astype(np.float32), np.full(D, 0.5, np.float32),
            np.zeros(D, np.float32), np.full(D, -2.0, np.float32), np.full(D, 2.0, np.float32),
            (rs.randn(D, N) * 0.5).astype(np.float32), LAM)
    out_j = solve_j(jnp.asarray(lead), *(jnp.asarray(v) for v in args))
    out_p = solve_p(torch.from_numpy(lead), *(torch.from_numpy(np.array(v)) for v in args))
    delta_p, ms_p, ct_p = (v.numpy() for v in out_p)
    delta_j, ms_j, ct_j = (np.asarray(v) for v in out_j)
    assert ct_p.shape == ct_j.shape == (N, K) and delta_p.shape == delta_j.shape == (D, N)
    _assert_update(ct_p, ct_j, ms_p[0], ms_j[0], ms_p[1], ms_j[1], delta_p / ms_p[1],
                   delta_j / ms_j[1], LAM)


def test_swarm_rollout_plain_matches_jax_kernel():
    rs = np.random.RandomState(11)
    jdyn, jcost = swarm_jax()
    jcfg = JConfig(nx=NX, nu=NU, K=K, T=T, dtype=F32)
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
    x0_K = np.stack([_x0(rs) for _ in range(K)])
    u = np.clip(rs.randn(K, T, NU), -2, 2).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    rollout = LG.make_fused_rollout(cfg, swarm_torch())
    cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
    np.testing.assert_allclose(cost_p.numpy(), cost_j, **TOL_C)


@pytest.mark.parametrize("route", ["MPPI", "SMPPI", "KMPPI", "MPPI_Batched", "rollout"])
def test_swarm_controllers_take_the_kernels(route, caplog):
    """Every controller routes the untagged swarm to its kernel (on CPU
    tensors its plain version) with no plain-path warning (the legacy route
    warns only that it is the legacy pair), and its commands stay finite
    and within the bounds."""
    dyn, cost = swarm_torch()
    lim = 2.0 * torch.ones(NU)
    use_pallas = {"MPPI_Batched": "kernel_rng", "rollout": "rollout"}.get(route, True)
    kw = dict(num_samples=64, horizon=T, lambda_=1.0, u_min=-lim, u_max=lim, seed=1,
              use_pallas=use_pallas, device="cpu")
    if route == "SMPPI":
        kw.update(action_min=-lim, action_max=lim, delta_t=DT_SWARM, w_action_seq_cost=0.1)
    if route == "KMPPI":
        kw.update(num_support_pts=NSP, kernel=P.RBFKernel(2.0))
    if route == "MPPI_Batched":
        kw.update(num_envs=2, num_samples=256)
    cls = getattr(P, "MPPI" if route == "rollout" else route)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = cls(dyn, cost, NX, 0.25 * torch.eye(NU), **kw)
    assert ctrl._fns.fused or route == "rollout"
    assert "plain torch path" not in caplog.text, caplog.text
    x = torch.from_numpy(np.stack([_x0(np.random.RandomState(s)) for s in (3, 4)]))
    with torch.no_grad():
        for _ in range(2):
            a = ctrl.command(x if route == "MPPI_Batched" else x[0])
            assert bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 2.0
            x = dyn(x, a.expand(2, NU))


def _lq_pair(nx, nu, seed=4):
    rs = np.random.RandomState(seed)
    B = (rs.randn(nx, nu) * 0.3).astype(np.float32)
    goal = rs.uniform(-1.0, 1.0, nx).astype(np.float32)
    jB, jg = jnp.asarray(B), jnp.asarray(goal)
    return (lambda s, a: s + a @ jB.T, lambda s, a: ((jg - s) ** 2).sum(axis=-1),
            P.linear_quadratic(torch.from_numpy(B), torch.from_numpy(goal)))


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_named_linear_quadratic_beyond_32_matches_jax(variant):
    """The named ``linear_quadratic`` at nx = 40: its struct's register
    arrays hold 32, so the factory runs the trace of its own callables
    (its product u Bᵀ one dense layer beyond 32), against JAX's kernel with
    the same callables."""
    jdyn, jcost, lq = _lq_pair(40, 20)
    x0 = np.random.RandomState(2).uniform(-1.0, 1.0, 40).astype(np.float32)
    solve = _kernel_a_against_jax(variant, jdyn, jcost, lq, x0, seed=9, nx=40, nu=20)
    assert isinstance(solve.model, BL.GeneratedModel) and solve.spec.act_ld > 0
    assert lq.model_id == KM.LINEAR_QUADRATIC  # the named model itself is unchanged


def test_named_models_beyond_32_route_to_the_kernels(caplog):
    """``linear_quadratic`` and ``toy2d`` beyond 32 states take the kernels
    with no warning; the legacy rollout and the batched pair too."""
    from pytorch_mppi_tpu_torch.ops.kernel_models import toy2d_model

    _, _, lq = _lq_pair(36, 4)
    nx = 36
    B = torch.eye(nx)[:, :4] * 0.5
    goal, center, Qh = torch.ones(nx), torch.zeros(nx), torch.eye(nx) * 0.2

    def t_dyn(s, a):
        return s + a @ B.T

    def t_cost(s, a):
        dc = center - s
        return (((goal - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)
                + 2.0 * torch.exp(-(dc @ Qh * dc).sum(-1)))

    toy = toy2d_model(t_dyn, t_cost, B, goal, 0.1, Qh, center, 2.0)
    for model in (lq, toy):
        cfg = MPPIConfig(nx=model.nx, nu=model.nu, K=64, T=3)
        for make in (FS.make_transposed_fused_solve, LG.make_fused_rollout,
                     lambda c, m: FS.make_transposed_batched_solve(c, 2, m)):
            solve = make(cfg, model)
            if hasattr(solve, "spec"):
                assert solve.spec.model_id >= BL.GENERATED and solve.spec.act_ld > 0
        x, u = torch.randn(64, model.nx), torch.randn(64, model.nu)
        traced = FS.make_transposed_fused_solve(cfg, model).model
        torch.testing.assert_close(traced.dynamics(x, u), model.dynamics(x, u))
        torch.testing.assert_close(traced.running_cost(x, u), model.running_cost(x, u),
                                   rtol=2e-5, atol=2e-5)
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = P.MPPI(model.dynamics, model.running_cost, model.nx, torch.eye(model.nu),
                          num_samples=64, horizon=3, use_pallas=True, device="cpu")
        assert ctrl._fns.fused and not caplog.text, caplog.text


def _wide_fuzz_pair(seed):
    """JAX's ``TestFuzzFused`` draws (``tests/fuzz_programs.py`` and its
    torch copy, two RandomStates in lockstep) at nx drawn in 33-48."""
    from fuzz_programs import gen_program
    from test_torch_batch_last import gen_program_torch

    jr, tr = np.random.RandomState(4000 + seed), np.random.RandomState(4000 + seed)
    nx, nu = int(jr.randint(33, 49)), int(jr.randint(1, 4))
    assert (int(tr.randint(33, 49)), int(tr.randint(1, 4))) == (nx, nu)
    jcore, _, _ = gen_program(jr, force_kind="dynamics", nx=nx, nu=nu, dtype=F32)
    jcost_core, _, _ = gen_program(jr, force_kind="cost", nx=nx, nu=nu, dtype=F32)
    tcore, _, _ = gen_program_torch(tr, force_kind="dynamics", nx=nx, nu=nu, dtype=torch.float32)
    tcost_core, _, _ = gen_program_torch(tr, force_kind="cost", nx=nx, nu=nu,
                                         dtype=torch.float32)
    return jr, nx, nu, (lambda s, a: s + 0.1 * jnp.tanh(jcore(s, a)),
                        lambda s, a: jnp.abs(jcost_core(s, a)) + (s**2).sum(axis=-1),
                        lambda s, a: s + 0.1 * torch.tanh(tcore(s, a)),
                        lambda s, a: torch.abs(tcost_core(s, a)) + (s**2).sum(dim=-1))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_programs_beyond_32(seed):
    rng, nx, nu, (jdyn, jcost, tdyn, tcost) = _wide_fuzz_pair(seed)
    x0 = rng.randn(nx).astype(np.float32) * 0.5
    solve = _kernel_a_against_jax("mppi", jdyn, jcost, (tdyn, tcost), x0, seed=seed + 50,
                                  nx=nx, nu=nu, spread=0.0)
    assert solve.spec.model_id >= BL.GENERATED and solve.spec.act_ld > 0


def test_round_one_solve_of_a_program_beyond_32_matches_jax():
    """An nx = 33 program in the round-1 solve (JAX's round-1 kernel takes
    any nx), against JAX's ``make_fused_solve`` on the same bits."""
    _round_one_against_jax(*_lq_pair(33, 2, seed=6)[:2], _lq_pair(33, 2, seed=6)[2], 33, 2)


# ---------------------------------------------------------------------------
# Step 6: the round-1 solve of a block model
# ---------------------------------------------------------------------------


def _round_one_against_jax(jdyn, jcost, model, nx, nu, K_=300, T_=5, x0=None):
    rs = np.random.RandomState(5)
    jcfg = JConfig(nx=nx, nu=nu, K=K_, T=T_, dtype=F32)
    jsolve = PR.make_fused_solve(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                                 rng_in_kernel=False)
    solve = RM.make_fused_solve(MPPIConfig(nx=nx, nu=nu, K=K_, T=T_), model)
    assert solve.spec.act_ld > 0 and solve.act_rows > 0  # the block path
    sigma = np.eye(nu) * 0.5
    lam = np.float32(0.7)
    U = (rs.randn(T_, nu) * 0.1).astype(np.float32)
    chol = np.linalg.cholesky(sigma).astype(np.float32)
    mu = np.full(nu, 0.05, np.float32)
    lo, hi = np.full(nu, -1.0, np.float32), np.full(nu, 1.0, np.float32)
    a_flat = (lam * (U @ np.linalg.inv(sigma).T)).reshape(-1).astype(np.float32)
    x0 = rs.uniform(-1.0, 1.0, nx).astype(np.float32) if x0 is None else x0
    args = [_rand_bits(rs, (solve.K_pad, T_ * nu)), x0, U, chol, mu, lo, hi, a_flat, lam]
    delta_j, m_j, s_j, cost_j = (np.asarray(v) for v in jsolve(*(jnp.asarray(v) for v in args)))
    delta_p, m_p, s_p, cost_p = solve(*(torch.from_numpy(np.asarray(v)) for v in args))
    assert np.ptp(cost_j) > 0.01
    np.testing.assert_allclose(cost_p.numpy(), cost_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose((delta_p / s_p).numpy(), delta_j / s_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(m_p), float(m_j), rtol=1e-5, atol=1e-4)
    return solve


def test_round_one_solve_of_the_block_mlp_matches_jax():
    """``ResidualMLPBlock`` (a [14, 72×5, 10] residual MLP, nx = 10, nu = 4)
    in the round-1 solve, against JAX's ``make_fused_solve`` with the MLP
    closed in."""
    from test_torch_block_mlp import NU as B_NU, NX as B_NX, X0, _pair

    jdyn, jcost, model = _pair()
    assert model.model_id == KM.RESIDUAL_MLP_BLOCK
    _round_one_against_jax(jdyn, jcost, model, B_NX, B_NU, x0=X0)


def test_round_one_solve_of_a_traced_network_matches_jax():
    """A traced [16, 96, 96, 96, 12] network (dense layers) in the round-1
    solve, against JAX's kernel with the same network."""
    from test_torch_block_mlp import T_NU, T_NX, _traced_pair

    jdyn, jcost, tdyn, tcost = _traced_pair()
    solve = _round_one_against_jax(jdyn, jcost, (tdyn, tcost), T_NX, T_NU)
    assert isinstance(solve.model, BL.GeneratedModel)
    assert solve.model.program.dense_layers(solve.model.outputs)


# ---------------------------------------------------------------------------
# Step 4: JAX's remaining primitives
# ---------------------------------------------------------------------------


def _interior(s):
    out = s.new_zeros(s.shape[0], 2 * s.shape[1] - 1)
    out[:, ::2] = s
    return out


STEP4 = {
    "erfinv": lambda s, u: torch.erfinv(torch.tanh(s)).sum(-1),
    "nextafter": lambda s, u: (torch.nextafter(s, u[:, :1]) - s).sum(-1) * 1e12,
    "shifts": lambda s, u: (((torch.floor(s * 8).long() << 3) + ((s * 100).long() >> 2)).sum(-1)
                            + (torch.bitwise_left_shift((u * 4).long(), 1)
                               + torch.bitwise_right_shift((u * 50).long(), 3)).sum(-1)
                            ).double(),
    "cummax_cummin": lambda s, u: (torch.cummax(s, 1).values * torch.cummin(u, 1)[0][:, :1]
                                   ).sum(-1),
    "logcumsumexp": lambda s, u: (torch.logcumsumexp(s, 1) * u[:, :1]).sum(-1),
    "interior_pad": lambda s, u: (_interior(s) * torch.arange(5.0, dtype=s.dtype)).sum(-1),
}


@pytest.mark.parametrize("name", list(STEP4))
def test_step4_primitives_against_torch(name):
    """Each primitive traced and held against the torch function itself in
    float64 (rtol 1e-12), at probes that reach the ops' edges (erfinv near
    ±1, shifts of negative values)."""
    f = STEP4[name]
    rs = np.random.RandomState(3)
    s = torch.from_numpy(rs.randn(32, 3) * 2.0)
    u = torch.from_numpy(rs.randn(32, 2) * 2.0)
    prog, consts, (out,) = BL.trace_program(f, 3, 2, [1], torch.float64)
    got = prog.evaluate(out, consts, s, u, 0)[0]
    torch.testing.assert_close(got.expand(32), f(s, u).reshape(32).to(got.dtype), rtol=1e-12,
                               atol=1e-12)


def _step4_torch(s, u):
    """Every step-4 primitive in one running cost."""
    e = torch.erfinv(torch.tanh(0.5 * s)).sum(-1)
    n = (torch.nextafter(s, torch.zeros_like(s)) - s).sum(-1) * 1e6
    i = (torch.floor(s * 4).long() << 2) + (torch.floor(u[:, :1] * 8).long() >> 1)
    sh = i.to(s.dtype).sum(-1) * 0.01
    c = torch.cummax(s, 1).values.sum(-1) - torch.cummin(s, 1).values.sum(-1)
    lc = torch.logcumsumexp(u, 1)[:, 1]
    p = (_interior(s) ** 2).sum(-1)
    return (s ** 2).sum(-1) + 0.1 * (e + n + sh + c + lc + p)


def _step4_jax(s, u):
    e = lax.erf_inv(jnp.tanh(0.5 * s)).sum(-1)
    n = (jnp.nextafter(s, jnp.zeros_like(s)) - s).sum(-1) * 1e6
    i = jnp.left_shift(jnp.floor(s * 4).astype(jnp.int32), 2) + jnp.right_shift(
        jnp.floor(u[:, :1] * 8).astype(jnp.int32), 1)
    sh = i.astype(s.dtype).sum(-1) * 0.01
    c = lax.cummax(s, axis=1).sum(-1) - lax.cummin(s, axis=1).sum(-1)
    lc = lax.cumlogsumexp(u, axis=1)[:, 1]
    p = (lax.pad(s, jnp.zeros((), s.dtype), ((0, 0, 0), (0, 0, 1))) ** 2).sum(-1)
    return (s ** 2).sum(-1) + 0.1 * (e + n + sh + c + lc + p)


def test_step4_program_against_jax_kernel():
    """A running cost of every step-4 primitive through kernel A's plain
    version against JAX's kernel (its interpreter evaluates ``erf_inv``,
    ``nextafter``, the shifts, ``cummax``/``cummin``/``cumlogsumexp`` and
    ``pad``) with the same bits."""
    nx, nu = 3, 2
    jdyn = lambda s, a: s + 0.1 * jnp.tanh(a @ jnp.ones((nu, nx), F32))  # noqa: E731
    tdyn = lambda s, a: s + 0.1 * torch.tanh(a @ torch.ones(nu, nx))  # noqa: E731
    x0 = np.array([0.3, -0.6, 0.9], np.float32)
    solve = _kernel_a_against_jax("mppi", jdyn, _step4_jax, (tdyn, _step4_torch), x0, seed=3,
                                  nx=nx, nu=nu)
    assert isinstance(solve.model, BL.GeneratedModel)


# ---------------------------------------------------------------------------
# The emitted C++ on the host
# ---------------------------------------------------------------------------

_HOST = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
namespace fused_mppi {
struct DenseLinear {
  float operator()(int, float v) const { return v; }
};
template <class E>
void block_dense(const float*, const float*, int, int, int, const float*, float*, int, int, E) {}
#include "model.cuh"
}
using fused_mppi::Generated;
int main() {
  int h[4];  // K, nx, nu, constants
  if (fread(h, sizeof(int), 4, stdin) != 4) return 1;
  const int K = h[0], nx = h[1], nu = h[2];
  float* c = (float*)malloc(sizeof(float) * (h[3] + 1));
  float* xs = (float*)malloc(sizeof(float) * K * nx);
  float* us = (float*)malloc(sizeof(float) * K * nu);
  if (fread(c, sizeof(float), h[3], stdin) != (size_t)h[3]) return 1;
  if (fread(xs, sizeof(float), K * nx, stdin) != (size_t)(K * nx)) return 1;
  if (fread(us, sizeof(float), K * nu, stdin) != (size_t)(K * nu)) return 1;
  for (int k = 0; k < K; ++k) {
    float* x = xs + k * nx;
#if BLOCK
    Generated::Carry carry;
    Generated::begin<32>(c, x, us + k * nu, nx, nu, 0, carry, nullptr, 0);
#else
    Generated::step<Generated::kN>(c, x, us + k * nu, nx, nu, 0);
#endif
    const float cost = Generated::cost<32>(c, x, us + k * nu, nx, nu, 0);
    fwrite(x, sizeof(float), nx, stdout);
    fwrite(&cost, sizeof(float), 1, stdout);
  }
  return 0;
}
"""


@pytest.mark.parametrize("case", ["swarm", "step4"])
def test_emitted_source_on_the_host(tmp_path, case):
    """The swarm's layer-less block struct (its ``begin`` steps the state
    in place) and a program of the step-4 primitives (the helpers
    ``erfinv_f``, ``shl_i``, ``shr_i``; ``nextafterf``), compiled with the
    host ``g++`` and held against the program's evaluator in float32."""
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    if case == "swarm":
        (dyn, cost), nx, nu = swarm_torch(), NX, NU
    else:
        nx, nu = 3, 2
        dyn, cost = (lambda s, a: s + 0.1 * torch.tanh(a @ torch.ones(nu, nx))), _step4_torch
    model = BL.kernel_model(MPPIConfig(nx=nx, nu=nu, K=64, T=3), dyn, cost)
    kernel = BL.generated_kernel(model, None)
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "host.cpp").write_text(_HOST)
    exe = tmp_path / "host"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-DBLOCK={int(kernel.block)}", "-o", str(exe), str(tmp_path / "host.cpp")],
                   check=True, capture_output=True, timeout=600)
    rs = np.random.RandomState(8)
    x = torch.from_numpy(np.stack([_x0(rs) for _ in range(32)]) if case == "swarm"
                         else rs.randn(32, nx).astype(np.float32))
    u = torch.from_numpy(rs.randn(32, nu).astype(np.float32))
    blob = struct.pack("4i", 32, nx, nu, model.consts.numel())
    blob += b"".join(a.float().contiguous().numpy().tobytes() for a in (model.consts, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(32, nx + 1)
    ns, c = model.rollout_step(x, u, 0)
    np.testing.assert_allclose(res[:, :nx], ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, nx], c.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The refusals that stay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,f,what", [
    ("max_indices", lambda s, u: s.max(dim=-1).indices.double(), "indices of max"),
    ("cummax_indices", lambda s, u: torch.cummax(s, 1).indices.double().sum(-1),
     "indices of cummax"),
    ("traced_index", lambda s, u: s[torch.arange(s.shape[0]), (s[:, 0] > 0).long()],
     "index"),
    ("argsort", lambda s, u: torch.argsort(s, dim=-1).double().sum(-1), "sort"),
])
def test_refusals_that_jax_shares_name_the_op(name, f, what):
    """JAX's interpreter has no rule for ``argmax``, ``gather`` or ``sort``
    on a batched operand (``pytorch_mppi_tpu/ops/batch_last.py:327-330``),
    and the bridge refuses them too, naming the op."""
    with pytest.raises(BL.UnsupportedPrimitive, match=what):
        BL.trace_program(f, 3, 2, [1], torch.float64)


def test_a_program_beyond_shared_memory_is_refused(caplog):
    """A per-sample program whose 128 rows of state and action (nx + 2 nu
    floats each) do not fit in a block's shared memory: the factory names
    the bound, and the controller takes the plain path, warning."""
    nx = 460
    cfg = MPPIConfig(nx=nx, nu=2, K=64, T=2)
    dyn, cost = (lambda s, a: s * 0.9), (lambda s, a: (s ** 2).sum(-1))
    model = BL.kernel_model(cfg, dyn, cost)
    assert KM.activation_ld(model) == BL.ROWS_LD
    with pytest.raises(FS.FusedSolveUnavailable, match="nx \\+ 2 nu up to about"):
        FS.make_transposed_fused_solve(cfg, model)
    FS.make_transposed_fused_solve(MPPIConfig(nx=420, nu=2, K=64, T=2), (dyn, cost))
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI(dyn, cost, nx, torch.eye(2), num_samples=64, horizon=2, use_pallas=True,
                      device="cpu")
    assert not ctrl._fns.fused and "nx + 2 nu up to about" in caplog.text


def test_swarm_artifact_replays_the_live_controller(tmp_path):
    """A deploy artifact of fused MPPI on the swarm (format 7: a program
    beyond 32 states without layers travels as its nodes, and the loading
    process rebuilds its kernel under the same id) replays the live
    controller's closed loop bit for bit."""
    from pytorch_mppi_tpu_torch.utils import deploy

    dyn, cost = swarm_torch()
    lim = 2.0 * torch.ones(NU)
    ctrl = P.MPPI(dyn, cost, NX, 0.25 * torch.eye(NU), num_samples=64, horizon=T, seed=3,
                  u_min=-lim, u_max=lim, use_pallas=True, device="cpu")
    assert ctrl._fns.fused
    path = str(tmp_path / "swarm.npz")
    deploy.export_solver(ctrl, path)
    solver = deploy.load_solver(path)
    (desc,) = solver.meta["kernels"]
    assert solver.meta["version"] == 7 and desc["model"]["nx"] == NX
    x_live = x_served = torch.from_numpy(_x0(np.random.RandomState(5)))
    for _ in range(3):
        a, b = ctrl.command(x_live), solver.command(x_served)
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        x_live, x_served = dyn(x_live[None], a[None])[0], dyn(x_served[None], b[None])[0]


# ---------------------------------------------------------------------------
# Programs beyond CHUNK statements: the emitted parts
# ---------------------------------------------------------------------------

MAX_AGENTS = 38  # the swarm near MAX_OPS: nx = 152, nu = 76, 15,124 operations a step
_W6 = torch.linspace(-1.0, 1.0, 18).reshape(3, 6)


def _small_callables():
    """A per-sample program within 32 states (nx = 6, nu = 3: register
    arrays, ``step``) of about a hundred nodes in each of its dynamics and
    cost."""
    def dyn(s, a):
        z = torch.tanh(a @ _W6) + torch.sin(s * s.sum(-1, keepdim=True))
        return s + 0.1 * z * torch.cos(z).prod(-1, keepdim=True)

    def cost(s, a):
        d = s[:, :, None] - s[:, None, :]
        return (s ** 2).sum(-1) + torch.exp(-d ** 2).sum((-1, -2)) + (a ** 2).sum(-1)

    return dyn, cost


def _functions(header):
    """(name, statements) of each function of a generated header: its
    lines that end in ';' up to the line that closes it."""
    out, cur = [], None
    for line in header.splitlines():
        m = re.match(r"\s*(?:template <int N>\s*)?__device__ .*?(\w+)\(.*\{\s*$", line)
        if m:
            cur = [m.group(1), 0]
            out.append(cur)
        elif cur is not None and re.match(r"  \}\s*$", line):
            cur = None
        elif cur is not None and line.rstrip().endswith(";"):
            cur[1] += 1
    return out


def _on_the_host(tmp_path, model, kernel, x, u):
    """The emitted header compiled with the host ``g++`` (``_HOST``, with
    ``__noinline__`` a host attribute): each sample's next state and cost,
    against the program's evaluator in float32."""
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "host.cpp").write_text("#define __noinline__ __attribute__((noinline))\n" + _HOST)
    exe = tmp_path / "host"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-DBLOCK={int(kernel.block)}", "-o", str(exe), str(tmp_path / "host.cpp")],
                   check=True, capture_output=True, timeout=600)
    n, nx, nu = x.shape[0], x.shape[1], u.shape[1]
    blob = struct.pack("4i", n, nx, nu, model.consts.numel())
    blob += b"".join(a.float().contiguous().numpy().tobytes() for a in (model.consts, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(n, nx + 1)
    ns, c = model.rollout_step(x, u, 0)
    np.testing.assert_allclose(res[:, :nx], ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[:, nx], c.numpy(), rtol=1e-5, atol=1e-5)


def _max_swarm():
    g = torch.Generator().manual_seed(31)
    goal = torch.rand(MAX_AGENTS, 2, generator=g) * 4 - 2
    return swarm_torch(MAX_AGENTS, goal, torch.triu(torch.ones(MAX_AGENTS, MAX_AGENTS), 1))


def test_swarm_near_max_ops_in_parts_on_the_host(tmp_path):
    """The 38-agent swarm (15,124 operations a step, within ``MAX_OPS``;
    its cost about 16,500 statements as one function, which ``nvcc``
    did not build within an hour): its header's cost in ``__noinline__``
    parts of at most ``CHUNK`` statements, compiled with the host ``g++``
    and held against the program's evaluator."""
    nx, nu = 4 * MAX_AGENTS, 2 * MAX_AGENTS
    model = BL.kernel_model(MPPIConfig(nx=nx, nu=nu, K=64, T=3), *_max_swarm())
    assert BL._count_ops(model.program, model.outputs) == 15_124 <= BL.MAX_OPS
    kernel = BL.generated_kernel(model, None)
    funcs = _functions(kernel.header())
    parts = [f for f, _ in funcs if re.match(r"cost_part\d+$", f)]
    assert len(parts) >= len(model.program.live([model.outputs[nx]])) // BL.CHUNK
    assert max(n for _, n in funcs) <= BL.CHUNK
    rs = np.random.RandomState(8)
    x = torch.from_numpy(np.concatenate([rs.uniform(-2, 2, (16, nu)),
                                         rs.randn(16, nu) * 0.3], 1).astype(np.float32))
    u = torch.from_numpy(rs.randn(16, nu).astype(np.float32))
    _on_the_host(tmp_path, model, kernel, x, u)


def _shift_callables(nx, nu):
    """Dynamics that shift a history of the state upward and put a
    computed row of nu values in front (``torch.cat([z, s[:, :-nu]])``): the
    next state's elements from nu on are state elements moved unchanged,
    which the step reads after it has written the first nu in place."""
    def dyn(s, a):
        z = torch.tanh(0.5 * a + s[:, :nu]) + torch.sin(s[:, -nu:] * s.sum(-1, keepdim=True))
        return torch.cat([z, s[:, :-nu]], -1)

    def cost(s, a):
        return (s ** 2).sum(-1) + torch.exp(-s[:, :nu] ** 2).sum(-1) + (a ** 2).sum(-1)

    return dyn, cost


@pytest.mark.parametrize("case,chunk", [("swarm", 64), ("swarm", 200), ("small", 24),
                                        ("small", 64), ("shift", 24), ("shift_wide", 96)])
def test_parts_on_the_host(tmp_path, monkeypatch, case, chunk):
    """Programs split at a small ``CHUNK``: the layer-less block struct's
    ``begin`` and ``cost`` (10 agents, nx = 40), a per-sample program's
    ``step`` and ``cost`` on register arrays (nx = 6), and a shift of the
    state's history in both (nx = 6, and nx = 40 in ``begin``), whose
    unchanged elements the step must read before it writes the state in
    place: no emitted function holds more than ``CHUNK`` statements, values
    cross parts in the scratch rows, and the host build agrees with the
    evaluator."""
    monkeypatch.setattr(BL, "CHUNK", chunk)
    if case == "swarm":
        fns, nx, nu = swarm_torch(), NX, NU
    elif case == "small":
        fns, nx, nu = _small_callables(), 6, 3
    else:
        nx, nu = (6, 3) if case == "shift" else (40, 4)
        fns = _shift_callables(nx, nu)
    model = BL.kernel_model(MPPIConfig(nx=nx, nu=nu, K=64, T=3), *fns)
    kernel = BL.generated_kernel(model, None)
    funcs = _functions(kernel.header())
    first = "begin" if nx > BL.MAXN else "step"
    split = {f"{first}_part0"} if len(model.program.live(model.outputs[:nx])) > chunk else set()
    assert split | {"cost_part0"} <= {f for f, _ in funcs}
    assert max(n for _, n in funcs) <= chunk
    rs = np.random.RandomState(9)
    x = torch.from_numpy(np.stack([_x0(rs) for _ in range(16)]) if case == "swarm"
                         else rs.randn(16, nx).astype(np.float32))
    u = torch.from_numpy(rs.randn(16, nu).astype(np.float32))
    _on_the_host(tmp_path, model, kernel, x, u)


@pytest.mark.parametrize("chunk", [500, 1024, None])
def test_no_function_beyond_chunk(monkeypatch, chunk):
    """The 38-agent swarm's header at ``CHUNK`` (None: the default), and
    a traced terminal cost beyond it: no emitted function holds more than
    ``CHUNK`` statements, and a part writes only what a later part or the
    caller reads."""
    if chunk is not None:
        monkeypatch.setattr(BL, "CHUNK", chunk)
    nx, nu = 4 * MAX_AGENTS, 2 * MAX_AGENTS
    cfg = MPPIConfig(nx=nx, nu=nu, K=64, T=3)
    dyn, cost = _max_swarm()
    header = BL.generated_kernel(BL.kernel_model(cfg, dyn, cost),
                                 BL.trace_terminal(cfg, lambda s, a: cost(s, a))).header()
    funcs = _functions(header)
    assert {"cost_part0", "terminal_part0"} <= {f for f, _ in funcs}
    assert max(n for _, n in funcs) <= BL.CHUNK
    for name in re.findall(r"static void (\w+_part\d+)\(", header):
        body = header.split(f"static void {name}(", 1)[1].split("\n  }\n", 1)[0]
        stored = set(re.findall(r"(s[fib]\[\d+\]) = v\d+;", body))
        assert len(stored) == len(re.findall(r" = v\d+;", body))  # a slot once a part


@pytest.mark.parametrize("case", ["swarm16", "swarm10", "small", "lq_terminal"])
def test_within_one_chunk_the_header_is_one_function(monkeypatch, case):
    """A program of at most ``CHUNK`` statements emits the header it
    emitted as one function (``Program.emit``), with no part: the 16- and
    10-agent swarms, a per-sample program and the flagship LQ beside a
    traced terminal cost."""
    cfg_of = lambda nx, nu: MPPIConfig(nx=nx, nu=nu, K=64, T=3)  # noqa: E731
    if case.startswith("swarm"):
        agents = int(case[5:])
        g = torch.Generator().manual_seed(31)
        fns = swarm_torch(agents, torch.rand(agents, 2, generator=g) * 4 - 2,
                          torch.triu(torch.ones(agents, agents), 1))
        model, terminal = BL.kernel_model(cfg_of(4 * agents, 2 * agents), *fns), None
    elif case == "small":
        model, terminal = BL.kernel_model(cfg_of(6, 3), *_small_callables()), None
    else:
        B = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
        model = BL.kernel_model(cfg_of(2, 2), lambda s, a: s + a @ B.T,
                                lambda s, a: ((s - 2.0) ** 2).sum(-1))
        terminal = BL.trace_terminal(cfg_of(2, 2), lambda s, a: 10.0 * (s ** 2).sum(-1))
    live = max(len(model.program.live([o])) for o in model.outputs)
    assert len(model.program.live(model.outputs[:model.nx])) <= BL.CHUNK and live <= BL.CHUNK
    header = BL._header(model, terminal)
    assert "__noinline__" not in header
    monkeypatch.setattr(BL, "CHUNK", 10 ** 9)
    assert BL._header(model, terminal) == header
