"""The residual MLP in the fused kernels: the plain versions of kernel A, of
the batched kernel and of the legacy rollout with ``residual_mlp_model``
against the JAX kernels with the same MLP closed in, on the CPU, and the
routing.

* ``make_transposed_{fused,smppi,kmppi}_solve``'s plain versions against
  JAX's in Pallas interpret mode, fed the same int32 bits (bits mode), for
  five models: the pendulum's [3, 32, 32, 2] with the action clipped and
  the angle wrapped, the same with the angle encoded as (sin, cos) ([4, 32,
  32, 2]), a [4, 16, 2] model with nu = 2, no clip or wrap and the
  quadratic cost (``tests/test_pallas_transposed.py:31-41``'s problem), a
  learned cart-pole's [5, 32, 32, 4] (nx = 4, nu = 1, dimension 2
  wrapped) and a learned car's [10, 32, 32, 7] (nx = 7, nu = 2, dimension
  2 encoded), both with the quadratic cost (the N = 8 instantiations);
* ``make_transposed_batched_solve``'s plain version against JAX's in
  interpret mode, bits and operand mode, for the same five models;
* ``legacy.make_fused_rollout``'s plain version against JAX's
  ``make_fused_rollout`` in interpret mode;
* the constants' layout: ``plain_model`` rebuilds a quadratic cost's goal
  exactly for nx = 1 to 8;
* routing: ``dynamics_params`` takes the plain path, ``MPPI_Batched``
  the batched kernel, an MLP beyond the per-thread model's bounds (above
  64 units, four layers, or 8 states or actions) the block model's
  kernels (``tests/test_torch_block_mlp.py`` holds those against JAX),
  and one beyond the block model's (33 states or actions, activations
  wider than shared memory, a step-dependent config) raises
  ``FusedSolveUnavailable`` and plans on the plain path, each with its
  warning.

Tolerances.  Float32 on both sides, as the kernels: costs rtol 2e-5 /
atol 1e-5 (``TOL_C``), m the same, s rtol 2e-5, delta/s rtol 2e-4 / atol
2e-6 (``TOL_U``), the linear model's (``tests/test_torch_fused_solve.py:
8-15``).  Each step's state differs between the packages by the summation
order of three matrix products and by ``tanh``, ``sin`` and ``cos``
rounding (a few ulp), and the T steps of the rollout carry that error
through the network's Jacobian: the costs differ by about 1e-6 of
themselves.  A cost error e moves each softmax weight by e^(±e/λ), so
the models with nx > 2 take small residual steps (``OUT_SCALE``) from near
their goal, and the batched plants of the quadratic models start around
it: their costs stay at tens (λ = 0.8), where that stays within the
tolerances.  The CUDA kernels are held against the
plain versions on the card by ``chip_smoke.py``.
"""
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mppi_tpu import models as JM
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch import models as PM
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import kernel_models as KM
from pytorch_mppi_tpu_torch.ops import kernels as PK
from pytorch_mppi_tpu_torch.ops import legacy as LG
from pytorch_mppi_tpu_torch.utils.convert import mlp_params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
# the quadratic cost's goal: its first nx values
GOALS_NP = np.array([2.0, 2.0, 3.0, 0.5, 1.5, -0.5, 0.25, 1.0], np.float32)
GOAL_NP = GOALS_NP[:2]
# the initial state of the models with nx > 2: near the goal, dimension 2
# near the wrap at pi
X0_NP = np.array([1.8, 2.3, 2.9, 0.4, 1.2, -0.2, 0.5], np.float32)
# the scale of their last layer: a residual model's step is small, as a
# trained one's (a random network's unit-scale steps drive the costs to
# thousands, where at lambda = 0.8 one sample carries all the weight and
# the costs' float32 rounding, 1e-6 of them, moves s by more than TOL_C)
OUT_SCALE = 0.1
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
K, T, NSP = 256, 8, 4

# name -> (layer widths, nx, nu, make_residual_dynamics keywords, cost)
MODELS = {
    "pendulum_wrap": ([3, 32, 32, 2], 2, 1, dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,)),
                      "pendulum"),
    "pendulum_wrap_encode": ([4, 32, 32, 2], 2, 1,
                             dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,),
                                  angle_encode_dims=(0,)), "pendulum"),
    "quad_nu2": ([4, 16, 2], 2, 2, {}, "quadratic"),
    "cartpole_nx4": ([5, 32, 32, 4], 4, 1, dict(angle_wrap_dims=(2,)), "quadratic"),
    "car_nx7": ([10, 32, 32, 7], 7, 2, dict(angle_encode_dims=(2,)), "quadratic"),
}


def _weights(sizes, seed, out_scale=1.0):
    rs = np.random.RandomState(seed)
    w = [((rs.randn(a, b) * 0.3).astype(np.float32), (rs.randn(b) * 0.1).astype(np.float32))
         for a, b in zip(sizes[:-1], sizes[1:])]
    W, b = w[-1]
    w[-1] = ((W * out_scale).astype(np.float32), (b * out_scale).astype(np.float32))
    return w


def _pair(name, seed=0):
    """The JAX (dynamics, cost) with the weights closed in, and the port's
    kernel model on the same weights; nx, nu."""
    sizes, nx, nu, kw, cost = MODELS[name]
    w = _weights(sizes, seed, OUT_SCALE if nx > 2 else 1.0)
    jw = [(jnp.asarray(W), jnp.asarray(b)) for W, b in w]
    jdyn_p = JM.make_residual_dynamics(nx, nu, **kw)
    goal = jnp.asarray(GOALS_NP[:nx])
    jcost = (JM.pendulum_running_cost if cost == "pendulum"
             else lambda s, a: ((goal - s) ** 2).sum(axis=-1))
    model = KM.residual_mlp_model(mlp_params_from_numpy(w), nx, nu, cost=cost,
                                  goal=GOALS_NP[:nx] if cost == "quadratic" else None, **kw)
    return (lambda s, a: jdyn_p(jw, s, a)), jcost, model, nx, nu


def _x0(name):
    """The initial state of the kernel tests: the pendulum's near the top,
    the nx = 2 quadratic model's [-1, -1], the others' X0_NP."""
    _, nx, nu, _, cost = MODELS[name]
    if nx > 2:
        return X0_NP[:nx]
    return np.array([np.pi - 0.3, 1.0] if cost == "pendulum" else [-1.0, -1.0], np.float32)


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_plain_matches_jax_kernel(variant, name):
    rs = np.random.RandomState(7)
    jdyn, jcost, model, nx, nu = _pair(name)
    D = T * nu
    nsp = NSP if variant == "kmppi" else 0
    R = nsp * nu if variant == "kmppi" else D
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
    bits = _rand_bits(rs, (R, solve_j.K_pad))
    x0 = _x0(name)
    x0T = np.broadcast_to(x0[:, None], (nx, K))
    full = lambda v, n=D: np.full(n, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.3).astype(np.float32)
    a_flat, lam = U2 * 0.7, np.float32(0.8)
    if variant == "mppi":
        rest = (U2, full(1.0), full(0.05), full(-2.0), full(2.0), a_flat, lam)
    elif variant == "smppi":
        rest = (U2, (rs.randn(D) * 0.3).astype(np.float32), full(0.8), full(0.05), full(-2.0),
                full(2.0), full(-2.5), full(2.5), a_flat, lam, np.float32(2.0),
                np.float32(0.5))
    else:
        interp, _ = PK.interpolation_operators(PK.RBFKernel(2.0), T, nsp, torch.float32)
        Wt = np.kron(interp.numpy(), np.eye(nu, dtype=np.float32))
        rest = (U2, (rs.randn(R) * 0.3).astype(np.float32), full(1.0, R), full(0.05, R),
                full(-2.5, R), full(2.5, R), full(-2.0), full(2.0), a_flat, Wt, lam)
    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in rest))
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0)[:, None].expand(nx, K),
                    *(torch.from_numpy(np.array(v)) for v in rest))
    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(m_p, m_j, **TOL_C)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, **TOL_U)


@pytest.mark.parametrize("name", list(MODELS))
def test_rollout_plain_matches_jax_kernel(name):
    """K = 200 (the JAX kernel pads to its block), per-sample initial
    states with angles beyond ±π."""
    rs = np.random.RandomState(11)
    jdyn, jcost, model, nx, nu = _pair(name, seed=1)
    Kr, Tr = 200, 12
    jcfg = JConfig(nx=nx, nu=nu, K=Kr, T=Tr, dtype=F32)
    x0_K = (rs.randn(Kr, nx) * 2.5).astype(np.float32)
    u = (rs.randn(Kr, Tr, nu) * 1.5).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    rollout = LG.make_fused_rollout(MPPIConfig(nx=nx, nu=nu, K=Kr, T=Tr), model)
    cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
    assert cost_p.shape == (Kr,) and cost_p.dtype == torch.float32
    np.testing.assert_allclose(cost_p.numpy(), cost_j, **TOL_C)


@pytest.mark.parametrize("mode", ["bits", "operand"])
@pytest.mark.parametrize("name", list(MODELS))
def test_batched_plain_matches_jax_kernel(mode, name):
    """The batched kernel's plain version against JAX's
    ``make_transposed_batched_solve`` in interpret mode with the MLP closed
    in: N = 3 plants from their own states sharing one draw, in bits mode
    (the same int32 bits) and in operand mode (the same final noise)."""
    rs = np.random.RandomState(13)
    jdyn, jcost, model, nx, nu = _pair(name, seed=2)
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
    # the plants around the quadratic models' goal (costs of tens, so that
    # the softmax at lambda = 0.8 weighs many samples: see OUT_SCALE)
    x0 = _x0(name) if MODELS[name][-1] == "pendulum" else GOALS_NP[:nx]
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


def test_plain_dynamics_is_make_residual_dynamics():
    """The model's plain functions are ``make_residual_dynamics`` on a
    snapshot of the weights (later changes to the given tensors do not
    reach it) and the named running cost, and they carry the model."""
    _, _, model, _, _ = _pair("pendulum_wrap_encode")
    w = mlp_params_from_numpy(_weights(MODELS["pendulum_wrap_encode"][0], 0))
    dyn = PM.make_residual_dynamics(2, 1, u_clip=(-2.0, 2.0), angle_wrap_dims=(0,),
                                    angle_encode_dims=(0,))
    s, a = torch.randn(16, 2) * 3, torch.randn(16, 1) * 3
    assert torch.equal(model.dynamics(s, a), dyn(w, s, a))
    assert torch.equal(model.running_cost(s, a), PM.pendulum_running_cost(s, a))
    assert KM.find_kernel_model(model.dynamics, model.running_cost) is model
    assert PM.PENDULUM_MODEL.running_cost is PM.pendulum_running_cost  # untouched
    params = [(W.clone(), b.clone()) for W, b in w]
    snap = KM.residual_mlp_model(params, 2, 1, angle_encode_dims=(0,))
    before = snap.dynamics(s, a)
    params[0][0].add_(1.0)
    assert torch.equal(snap.dynamics(s, a), before)


def test_consts_layout():
    """The header and the padded rows ``ResidualMLP`` reads."""
    sizes, _, nu, kw, _ = MODELS["pendulum_wrap_encode"]
    w = _weights(sizes, 0)
    c = KM.residual_mlp_model(mlp_params_from_numpy(w), 2, nu, **kw).consts
    assert c.dtype == torch.float32
    assert c[:12].tolist() == [3, 4, 32, 32, 2, 0, 1, -2, 2, 1, 1, 0]
    pads = [32, 32, 8]
    assert c.numel() == KM.MLP_HEAD + sum(a * p + p for a, p in zip(sizes, pads))
    off = KM.MLP_HEAD
    for (W, b), n_in, p in zip(w, sizes, pads):
        Wc = c[off:off + n_in * p].reshape(n_in, p)
        assert torch.equal(Wc[:, :W.shape[1]], torch.from_numpy(W))
        assert not Wc[:, W.shape[1]:].any()
        off += n_in * p
        assert torch.equal(c[off:off + b.shape[0]], torch.from_numpy(b))
        off += p
    assert KM.mlp_header(c) == dict(widths=sizes, layers=3, clip=True, wrap=(0,), encode=(0,),
                                    cost="pendulum")
    q = KM.residual_mlp_model(mlp_params_from_numpy(_weights([4, 16, 2], 0)), 2, 2,
                              cost="quadratic", goal=[1.5, -0.5]).consts
    assert q[11:14].tolist() == [1, 1.5, -0.5]
    assert KM.mlp_header(q) == dict(widths=[4, 16, 2], layers=2, clip=False, wrap=(),
                                    encode=(), cost="quadratic")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["pendulum_wrap", "car_nx7"])
def test_untagged_network_traces_and_leaves_the_model_intact(name, dtype):
    """The model's functions passed untagged are traced by the dynamics
    bridge (``ops/batch_last.py``) into a program that computes what they
    do; a trace in another dtype than the weights' (a copy made inside the
    trace) leaves the model's per-device caches free of the trace's
    tensors, so its eager functions still give plain tensors after it."""
    from pytorch_mppi_tpu_torch.ops import batch_last as BL

    _, _, model, nx, nu = _pair(name)
    rs = np.random.RandomState(3)
    s = torch.from_numpy(rs.randn(64, nx)).to(dtype)
    u = torch.from_numpy(rs.randn(64, nu)).to(dtype)
    cfg = MPPIConfig(nx=nx, nu=nu, K=64, T=4, dtype=dtype)
    traced = BL.kernel_model(cfg, lambda s_, u_: model.dynamics(s_, u_),
                             lambda s_, u_: model.running_cost(s_, u_))
    assert isinstance(traced, BL.GeneratedModel)
    after = model.dynamics(s, u)
    assert not torch._C._functorch.is_functorch_wrapped_tensor(after)
    assert torch.equal(after, KM.residual_mlp_model(
        [(W.clone(), b.clone()) for W, b in mlp_params_from_numpy(
            _weights(MODELS[name][0], 0, OUT_SCALE if nx > 2 else 1.0))],
        nx, nu, cost=MODELS[name][4], goal=GOALS_NP[:nx] if nx > 2 else None,
        **MODELS[name][3]).dynamics(s, u))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(traced.dynamics(s, u), after, **tol)
    torch.testing.assert_close(traced.running_cost(after, u), model.running_cost(after, u),
                               **tol)


@pytest.mark.parametrize("nx", range(1, KM.MLP_MAX_N + 1))
def test_plain_model_rebuilds_the_goal(nx):
    """The goal's nx floats from ``MLP_GOAL`` on in the header, where
    ``ResidualMLP::cost`` reads them: ``plain_model`` (an operator's
    rebuild from the constants alone) gives back the goal exactly, the same
    constants and the same running cost, for every nx the kernels take."""
    rs = np.random.RandomState(nx)
    goal = (rs.randn(nx) * 3).astype(np.float32)
    model = KM.residual_mlp_model(mlp_params_from_numpy(_weights([nx + 1, 8, nx], nx)), nx, 1,
                                  cost="quadratic", goal=goal)
    c = model.consts
    assert c[KM.MLP_GOAL:KM.MLP_GOAL + nx].numpy().tobytes() == goal.tobytes()
    assert not c[KM.MLP_GOAL + nx:KM.MLP_HEAD].any()
    rebuilt = KM.plain_model(KM.RESIDUAL_MLP, c, nx, 1)
    assert torch.equal(rebuilt.consts, c)
    s, a = torch.from_numpy(rs.randn(32, nx).astype(np.float32)), torch.zeros(32, 1)
    want = ((torch.from_numpy(goal) - s) ** 2).sum(-1)
    assert torch.equal(rebuilt.running_cost(s, a), want)
    assert torch.equal(model.running_cost(s, a), want)
    assert torch.equal(rebuilt.dynamics(s, a), model.dynamics(s, a))


@pytest.mark.parametrize("bad", ["in_width", "out_width", "chain", "cost", "goal", "dims"])
def test_model_arguments_raise(bad):
    w = mlp_params_from_numpy(_weights([3, 8, 2], 0))
    kw = dict(params=w, nx=2, nu=1)
    if bad == "in_width":
        kw.update(nu=2)
    elif bad == "out_width":
        kw.update(params=mlp_params_from_numpy(_weights([3, 8, 3], 0)))
    elif bad == "chain":
        kw.update(params=[w[0], (torch.zeros(7, 2), torch.zeros(2))])
    elif bad == "cost":
        kw.update(cost="huber")
    elif bad == "goal":
        kw.update(cost="quadratic", goal=[1.0])
    else:
        kw.update(angle_wrap_dims=(2,))
    with pytest.raises(ValueError):
        KM.residual_mlp_model(**kw)


def _ctrl(model, use_pallas, nu=1, cls=None, nx=2, **kw):
    cls = cls or P.MPPI
    return cls(model.dynamics, model.running_cost, nx=nx, noise_sigma=torch.eye(nu),
               num_samples=64, horizon=6, lambda_=1.0, seed=3, use_pallas=use_pallas,
               device="cpu", **kw)


@pytest.mark.parametrize("use_pallas", [True, "rollout"])
def test_routes_to_the_kernels(use_pallas):
    """``use_pallas`` with the model takes kernel A or the legacy rollout
    (on CPU tensors their plain versions), with no warning."""
    _, _, model, _, _ = _pair("pendulum_wrap")
    ctrl = _ctrl(model, use_pallas)
    assert ctrl._fns.fused
    a = ctrl.command(torch.tensor([np.pi, 1.0]))
    assert a.shape == (1,) and bool(torch.isfinite(a).all())


def test_smppi_kmppi_route_to_kernel_a():
    _, _, model, _, _ = _pair("quad_nu2")
    for cls, kw in ((P.SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0)),
                    (P.KMPPI, dict(num_support_pts=3, kernel=P.RBFKernel(2.0)))):
        ctrl = _ctrl(model, True, nu=2, cls=cls, **kw)
        assert ctrl._fns.fused
        assert bool(torch.isfinite(ctrl.command(torch.tensor([-1.0, -1.0]))).all())


def test_dynamics_params_takes_the_plain_path(caplog):
    """Retraining through ``dynamics_params`` is ``parameterized_dynamics``:
    the plain path with the warning, as JAX's eligibility check
    (``pallas_rollout.py:280``)."""
    params = PM.mlp_init([3, 8, 2], torch.Generator().manual_seed(0), device="cpu")
    dyn = PM.make_residual_dynamics(2, 1, u_clip=(-2, 2), angle_wrap_dims=(0,))
    for use_pallas in (True, "rollout"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = P.MPPI(dyn, PM.pendulum_running_cost, nx=2, noise_sigma=torch.eye(1),
                          num_samples=32, horizon=5, dynamics_params=params, device="cpu",
                          use_pallas=use_pallas)
        assert not ctrl._fns.fused
        assert "parameterized dynamics" in caplog.text
        assert ctrl.command(torch.tensor([np.pi, 1.0])).shape == (1,)


@pytest.mark.parametrize("use_pallas", ["force", "kernel_rng"])
def test_batched_takes_the_plain_path(use_pallas, caplog):
    """The name is from before the batched kernel had its MLP instantiation:
    ``MPPI_Batched`` with the model now takes the batched kernel (on CPU
    tensors its plain version) in operand and in seed mode, with no
    warning, and the factory builds it."""
    _, _, model, _, _ = _pair("car_nx7")
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI_Batched(model.dynamics, model.running_cost, nx=7,
                              noise_sigma=torch.eye(2), num_envs=3, num_samples=256,
                              horizon=5, seed=1, use_pallas=use_pallas, device="cpu")
    assert ctrl._fns.fused
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING], caplog.text
    solve = FS.make_transposed_batched_solve(MPPIConfig(nx=7, nu=2, K=32, T=5), 3, model)
    assert solve.model is model and solve.num_envs == 3
    a = ctrl.command(torch.from_numpy(np.stack([X0_NP] * 3)))
    assert a.shape == (3, 2) and bool(torch.isfinite(a).all())


# the networks beyond the per-thread bounds of before the block model: a hidden
# width above 64, more than four layers, nu = 9, nx = 9 (beyond the N = 8 arrays)
OLD_BEYOND = {"width": ([3, 65, 2], 2, 1), "layers": ([3, 8, 8, 8, 8, 2], 2, 1),
              "nu": ([11, 8, 2], 2, 9), "nx": ([10, 8, 9], 9, 1)}


@pytest.mark.parametrize("beyond", ["nx", "nu", "width", "step_dependent"])
def test_beyond_the_bound_falls_back(beyond, caplog):
    """Beyond the block model's bounds: nx = 392 or nu = 208 (128 rows of
    state and action, nx + 2 nu floats each, beyond shared memory beside 8
    samples' activations; the block model keeps them there, not in the
    MAXN = 32 arrays), a width whose activations exceed shared memory (two
    rows of 8 samples of 3,600 floats), and a step-dependent config (a
    named model takes no timestep): the factories, the batched one too,
    raise ``FusedSolveUnavailable`` and ``use_pallas`` plans on the plain
    path with the warning."""
    nx = 392 if beyond == "nx" else 2
    nu = 208 if beyond == "nu" else 1
    sizes = {"nx": [393, 8, 392], "nu": [210, 8, 2], "width": [3, 3600, 2],
             "step_dependent": [3, 80, 2]}[beyond]
    goal = np.linspace(-1.0, 1.0, nx).astype(np.float32)
    model = KM.residual_mlp_model(mlp_params_from_numpy(_weights(sizes, 0)), nx, nu,
                                  cost="quadratic", goal=goal)
    assert model.model_id == KM.RESIDUAL_MLP_BLOCK
    step = beyond == "step_dependent"
    what = "step_dependent_dynamics" if step else "residual MLP"
    cfg = MPPIConfig(nx=nx, nu=nu, K=32, T=5, step_dependent_dynamics=step)
    for make in (FS.make_transposed_fused_solve, LG.make_fused_rollout,
                 lambda c, m: FS.make_transposed_batched_solve(c, 3, m)):
        with pytest.raises(FS.FusedSolveUnavailable, match=what):
            make(cfg, model)
    for use_pallas in (True, "rollout"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = _ctrl(model, use_pallas, nu=nu, nx=nx, step_dependent_dynamics=step)
        assert not ctrl._fns.fused
        assert what in caplog.text
        assert ctrl.command(torch.from_numpy(goal) * 0.5).shape == (nu,)


@pytest.mark.parametrize("beyond", list(OLD_BEYOND))
def test_beyond_the_per_thread_bound_takes_the_block_model(beyond, caplog):
    """The networks that took the plain path before the block model now
    take the block model's kernels (kernel A and the legacy rollout; on CPU
    tensors their plain versions), with no warning."""
    sizes, nx, nu = OLD_BEYOND[beyond]
    goal = np.linspace(-1.0, 1.0, nx).astype(np.float32)
    model = KM.residual_mlp_model(mlp_params_from_numpy(_weights(sizes, 0)), nx, nu,
                                  cost="quadratic", goal=goal)
    assert model.model_id == KM.RESIDUAL_MLP_BLOCK
    for use_pallas in (True, "rollout"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = _ctrl(model, use_pallas, nu=nu, nx=nx)
        assert ctrl._fns.fused
        assert "plain torch path" not in caplog.text and "residual MLP" not in caplog.text
        assert ctrl.command(torch.from_numpy(goal) * 0.5).shape == (nu,)
