"""The residual MLP in the fused kernels: the plain versions of kernel A and
of the legacy rollout with ``residual_mlp_model`` against the JAX kernels
with the same MLP closed in, on the CPU, and the routing.

* ``make_transposed_{fused,smppi,kmppi}_solve``'s plain versions against
  JAX's in Pallas interpret mode, fed the same int32 bits (bits mode), for
  three models: the pendulum's [3, 32, 32, 2] with the action clipped and
  the angle wrapped, the same with the angle encoded as (sin, cos) ([4, 32,
  32, 2]), and a [4, 16, 2] model with nu = 2, no clip or wrap and the
  quadratic cost (``tests/test_pallas_transposed.py:31-41``'s problem);
* ``legacy.make_fused_rollout``'s plain version against JAX's
  ``make_fused_rollout`` in interpret mode;
* routing: ``dynamics_params`` and ``MPPI_Batched`` take the plain path,
  and an MLP beyond the kernel's bounds raises ``FusedSolveUnavailable``
  and plans on the plain path, each with its warning.

Tolerances.  Float32 on both sides, as the kernels.  The MLP's own:
costs rtol 1e-4 / atol 1e-4, m the same, s rtol 1e-4, delta/s rtol 1e-3 /
atol 1e-5.  Each step's state differs between the packages by the
summation order of three matrix products and by ``tanh``, ``sin`` and
``cos`` rounding (a few ulp), and the T steps of the rollout carry that
error through the network's Jacobian, so the costs differ by more than a
linear model's (whose tolerances, ``tests/test_torch_fused_solve.py:8-15``,
are unchanged); a cost error e moves each softmax weight by e^(±e/λ).
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
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
GOAL_NP = np.array([2.0, 2.0], np.float32)
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
K, T, NSP = 256, 8, 4

# name -> (layer widths, nu, make_residual_dynamics keywords, cost)
MODELS = {
    "pendulum_wrap": ([3, 32, 32, 2], 1, dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,)),
                      "pendulum"),
    "pendulum_wrap_encode": ([4, 32, 32, 2], 1,
                             dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,),
                                  angle_encode_dims=(0,)), "pendulum"),
    "quad_nu2": ([4, 16, 2], 2, {}, "quadratic"),
}


def _weights(sizes, seed):
    rs = np.random.RandomState(seed)
    return [((rs.randn(a, b) * 0.3).astype(np.float32), (rs.randn(b) * 0.1).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _pair(name, seed=0):
    """The JAX (dynamics, cost) with the weights closed in, and the port's
    kernel model on the same weights."""
    sizes, nu, kw, cost = MODELS[name]
    w = _weights(sizes, seed)
    jw = [(jnp.asarray(W), jnp.asarray(b)) for W, b in w]
    jdyn_p = JM.make_residual_dynamics(2, nu, **kw)
    goal = jnp.asarray(GOAL_NP)
    jcost = (JM.pendulum_running_cost if cost == "pendulum"
             else lambda s, a: ((goal - s) ** 2).sum(axis=-1))
    model = KM.residual_mlp_model(mlp_params_from_numpy(w), 2, nu, cost=cost,
                                  goal=GOAL_NP if cost == "quadratic" else None, **kw)
    return (lambda s, a: jdyn_p(jw, s, a)), jcost, model, nu


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_plain_matches_jax_kernel(variant, name):
    rs = np.random.RandomState(7)
    jdyn, jcost, model, nu = _pair(name)
    D = T * nu
    nsp = NSP if variant == "kmppi" else 0
    R = nsp * nu if variant == "kmppi" else D
    flags = dict(num_support_pts=nsp, smppi=variant == "smppi",
                 sample_null_action=variant == "mppi")
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, **flags)
    jmake = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
             "kmppi": PR.make_transposed_kmppi_solve}[variant]
    pmake = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
             "kmppi": FS.make_transposed_kmppi_solve}[variant]
    solve_j = jmake(jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
                    rng_in_kernel=False)
    solve_p = pmake(cfg, model, pair_block=solve_j.block_k)
    bits = _rand_bits(rs, (R, solve_j.K_pad))
    x0 = np.array([np.pi - 0.3, 1.0] if nu == 1 else [-1.0, -1.0], np.float32)
    x0T = np.broadcast_to(x0[:, None], (2, K))
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
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0)[:, None].expand(2, K),
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
    jdyn, jcost, model, nu = _pair(name, seed=1)
    Kr, Tr = 200, 12
    jcfg = JConfig(nx=2, nu=nu, K=Kr, T=Tr, dtype=F32)
    x0_K = (rs.randn(Kr, 2) * 2.5).astype(np.float32)
    u = (rs.randn(Kr, Tr, nu) * 1.5).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    rollout = LG.make_fused_rollout(MPPIConfig(nx=2, nu=nu, K=Kr, T=Tr), model)
    cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
    assert cost_p.shape == (Kr,) and cost_p.dtype == torch.float32
    np.testing.assert_allclose(cost_p.numpy(), cost_j, **TOL_C)


def test_plain_dynamics_is_make_residual_dynamics():
    """The model's plain functions are ``make_residual_dynamics`` on a
    snapshot of the weights (later changes to the given tensors do not
    reach it) and the named running cost, and they carry the model."""
    _, _, model, _ = _pair("pendulum_wrap_encode")
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
    sizes, nu, kw, _ = MODELS["pendulum_wrap_encode"]
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


def _ctrl(model, use_pallas, nu=1, cls=None, **kw):
    cls = cls or P.MPPI
    return cls(model.dynamics, model.running_cost, nx=2, noise_sigma=torch.eye(nu),
               num_samples=64, horizon=6, lambda_=1.0, seed=3, use_pallas=use_pallas,
               device="cpu", **kw)


@pytest.mark.parametrize("use_pallas", [True, "rollout"])
def test_routes_to_the_kernels(use_pallas):
    """``use_pallas`` with the model takes kernel A or the legacy rollout
    (on CPU tensors their plain versions), with no warning."""
    _, _, model, _ = _pair("pendulum_wrap")
    ctrl = _ctrl(model, use_pallas)
    assert ctrl._fns.fused
    a = ctrl.command(torch.tensor([np.pi, 1.0]))
    assert a.shape == (1,) and bool(torch.isfinite(a).all())


def test_smppi_kmppi_route_to_kernel_a():
    _, _, model, _ = _pair("quad_nu2")
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


def test_batched_takes_the_plain_path(caplog):
    """The batched kernel has no MLP instantiation yet: the plain path, and
    the warning names the ROADMAP item."""
    _, _, model, _ = _pair("quad_nu2")
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = P.MPPI_Batched(model.dynamics, model.running_cost, nx=2,
                              noise_sigma=torch.eye(2), num_envs=3, num_samples=32,
                              horizon=5, seed=1, use_pallas="force", device="cpu")
    assert not ctrl._fns.fused
    assert "residual-MLP instantiation" in caplog.text and "ROADMAP.md" in caplog.text
    with pytest.raises(FS.FusedSolveUnavailable, match="residual-MLP"):
        FS.make_transposed_batched_solve(MPPIConfig(nx=2, nu=2, K=32, T=5), 3, model)
    assert ctrl.command(torch.zeros(3, 2)).shape == (3, 2)


@pytest.mark.parametrize("beyond", ["width", "layers", "nu"])
def test_beyond_the_bound_falls_back(beyond, caplog):
    """A hidden width above 64, more than four layers, or nu = 3 (beyond
    the N = 2 arrays): the factories raise ``FusedSolveUnavailable`` and
    ``use_pallas`` plans on the plain path with the warning."""
    nu = 3 if beyond == "nu" else 1
    sizes = {"width": [3, 65, 2], "layers": [3, 8, 8, 8, 8, 2], "nu": [5, 8, 2]}[beyond]
    model = KM.residual_mlp_model(mlp_params_from_numpy(_weights(sizes, 0)), 2, nu,
                                  cost="quadratic", goal=GOAL_NP)
    cfg = MPPIConfig(nx=2, nu=nu, K=32, T=5)
    for make in (FS.make_transposed_fused_solve, LG.make_fused_rollout):
        with pytest.raises(FS.FusedSolveUnavailable, match="residual MLP"):
            make(cfg, model)
    for use_pallas in (True, "rollout"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = _ctrl(model, use_pallas, nu=nu)
        assert not ctrl._fns.fused
        assert "residual MLP" in caplog.text
        assert ctrl.command(torch.tensor([0.5, -0.5])).shape == (nu,)
