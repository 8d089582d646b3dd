"""The legacy ``use_pallas="rollout"`` route of the port against the JAX
package on the CPU.

* ``legacy.make_fused_rollout`` and ``legacy.fused_weighted_update`` (their
  plain versions, on CPU tensors) against ``pallas_rollout.make_fused_rollout``
  and ``fused_weighted_update`` in Pallas interpret mode, with K not a
  multiple of 128 so that the JAX kernels pad;
* ``make_mppi_step(use_pallas="rollout")`` against JAX's on the same normals,
  and ``MPPI(use_pallas="rollout")`` against the port's plain ``MPPI``;
* ``use_pallas`` keeps its value, and any other string raises.

Float32 on both sides.  Costs rtol 2e-5 / atol 1e-5, the update rtol 2e-4 /
atol 2e-6 (``tests/test_pallas_transposed.py:102-107``); the controllers at
``tests/test_utils.py:288-310``'s tolerances.  The CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``.
"""
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import MPPIState as JState
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.models.toy2d import Toy2DEnvironment as JToy2D
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch import MPPI
from pytorch_mppi_tpu_torch.config import MPPIConfig, MPPIState
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import legacy as LG
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)


def _problem(name):
    """(JAX dynamics, JAX cost, port kernel model, nu)."""
    if name == "pendulum":
        return jpend.pendulum_dynamics, jpend.pendulum_running_cost, PENDULUM_MODEL, 1
    if name == "toy2d":
        jenv = JToy2D(dtype=F32)
        return jenv.dynamics, jenv.running_cost, Toy2DEnvironment(device="cpu").kernel_model, 2
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    return (lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(axis=-1),
            linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP)), 2)


@pytest.mark.parametrize("problem", ["linear", "pendulum", "toy2d"])
@pytest.mark.parametrize("shared_x0", [True, False], ids=["shared_x0", "per_sample_x0"])
def test_rollout_plain_matches_jax_kernel(problem, shared_x0):
    rs = np.random.RandomState(2)
    K, T = 200, 7
    jdyn, jcost, model, nu = _problem(problem)
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32)
    rollout_j = PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                      JS.wrap_cost(jcfg, jcost))
    x0 = rs.randn(2).astype(np.float32)
    x0_K = (np.broadcast_to(x0, (K, 2)) if shared_x0
            else rs.randn(K, 2).astype(np.float32))
    u = (rs.randn(K, T, nu) * 1.3).astype(np.float32)
    cost_j = np.asarray(rollout_j(jnp.asarray(x0_K), jnp.asarray(u)))

    rollout_p = LG.make_fused_rollout(MPPIConfig(nx=2, nu=nu, K=K, T=T), model)
    x0_p = (torch.from_numpy(x0)[None].expand(K, 2) if shared_x0
            else torch.from_numpy(x0_K))
    cost_p = rollout_p(x0_p, torch.from_numpy(u))
    assert cost_p.shape == (K,) and cost_p.dtype == torch.float32
    np.testing.assert_allclose(cost_p.numpy(), cost_j, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("problem,K,T", [("pendulum", 777, 15), ("linear", 777, 30),
                                         ("toy2d", 1000, 20)],
                         ids=["pendulum_D15_K777", "linear_D60_K777", "toy2d_D40_K1000"])
def test_rollout_tiles_match_jax_kernel(problem, K, T):
    """K not a multiple of any block size and D = 15 (rows that are not
    16-byte aligned, which the kernel copies 4 bytes at a time), through the
    wrapper with the rule's S and with each forced S, against the JAX
    kernel."""
    rs = np.random.RandomState(11)
    jdyn, jcost, model, nu = _problem(problem)
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32)
    x0_K = rs.randn(K, 2).astype(np.float32)
    u = (rs.randn(K, T, nu) * 1.1).astype(np.float32)
    cost_j = np.asarray(PR.make_fused_rollout(jcfg, JS.wrap_dynamics(jcfg, jdyn),
                                              JS.wrap_cost(jcfg, jcost))(
        jnp.asarray(x0_K), jnp.asarray(u)))
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T)
    for tile in (None,) + FS.TILES:
        rollout = LG.make_fused_rollout(cfg, model, tile_k=tile)
        assert rollout.tile_k == tile
        cost_p = rollout(torch.from_numpy(x0_K), torch.from_numpy(u))
        np.testing.assert_allclose(cost_p.numpy(), cost_j, rtol=2e-5, atol=1e-5)


def test_rollout_tile_rule_and_override():
    """The rollout's blocks take ``tile_samples`` samples (313 blocks of 32
    at the flagship) unless ``tile_k`` forces 32, 64 or 128."""
    cfg = MPPIConfig(nx=2, nu=2, K=10_000, T=30)
    assert LG.make_fused_rollout(cfg, LQ).tile_k is None
    assert FS.check_tile(None, 10_000) == 32 and FS.check_tile(128, 10_000) == 128
    assert FS.tile_samples(1000, FS.H100_SMS) == 32 and FS.tile_samples(10**6, FS.H100_SMS) == 128
    assert LG.make_fused_rollout(cfg, LQ, tile_k=64).tile_k == 64
    with pytest.raises(ValueError, match="tile_k"):
        LG.make_fused_rollout(cfg, LQ, tile_k=48)


# T, nu, S -> steps a chunk, floats a row, buffers, chunks
GEOMETRY = [
    ((30, 2, 32), (30, 60, 1, 1)),  # the flagship: 7.5 KB, one contiguous span
    ((30, 2, 128), (30, 60, 1, 1)),
    ((15, 1, 32), (15, 20, 1, 1)),  # D = 15: 4 float4s, made 5
    ((100, 3, 32), (100, 300, 1, 1)),
    ((100, 3, 128), (12, 36, 2, 9)),  # 150 KB: chunks of 12 steps, 16-byte starts
    ((100, 31, 64), (2, 68, 2, 50)),  # 4 steps of nu = 31 do not fit: 2 steps
    ((3, 31, 128), (1, 36, 2, 3)),
]


@pytest.mark.parametrize("args,expect", GEOMETRY, ids=[str(g[0]) for g in GEOMETRY])
def test_rollout_geometry(args, expect):
    """The staging rule (``fused_mppi_rollout_geometry``): the whole tile in
    one buffer when it fits 48 KB, else two buffers of the most steps that
    fit; rows of an odd number of float4s (reads free of bank conflicts)."""
    T, nu, S = args
    g = LG.rollout_geometry(T, nu, S)
    assert (g["steps"], g["ldr"], g["buffers"], g["chunks"]) == expect
    assert g["ldr"] % 8 == 4 and g["ldr"] >= g["steps"] * nu
    assert g["smem"] == g["buffers"] * S * g["ldr"] * 4 <= LG.ROLLOUT_SMEM


@pytest.mark.parametrize("K,D", [(200, 12), (1100, 60)], ids=["K200", "K1100"])
def test_weighted_update_plain_matches_jax_kernel(K, D):
    """Padded rows weigh exactly 0 in the JAX kernel; the plain version has
    none.  (pert, m, s) and the update pert / s agree."""
    rs = np.random.RandomState(4)
    cost = (rs.rand(K) * 40 + 5).astype(np.float32)
    noise = rs.randn(K, D).astype(np.float32)
    lam = np.float32(0.7)
    pert_j, m_j, s_j = (np.asarray(v) for v in PR.fused_weighted_update(
        jnp.asarray(cost), jnp.asarray(noise), jnp.asarray(lam)))
    pert_p, m_p, s_p = (v.numpy() for v in LG.fused_weighted_update(
        torch.from_numpy(cost), torch.from_numpy(noise), torch.tensor(lam)))
    np.testing.assert_allclose(m_p, m_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(pert_p / s_p, pert_j / s_j, rtol=2e-4, atol=2e-6)
    # the plain version is the reference's weighting (mppi.py:254-270)
    _, omega = PS.compute_weighting(torch.from_numpy(cost), torch.tensor(lam))
    np.testing.assert_allclose(pert_p / s_p, (omega @ torch.from_numpy(noise)).numpy(),
                               rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("K,D,pad", [(300, 12, 4), (300, 12, 3), (500, 15, 0), (130, 60, 0)],
                         ids=["strided_ld16", "strided_ld15", "D15", "K130"])
def test_weighted_update_layouts_match_jax_kernel(K, D, pad):
    """A strided noise (row stride ld > D, 16-byte rows or not) and D not a
    multiple of 4, the layouts the kernel reads with scalar loads, through
    the wrapper (its plain version on CPU tensors) and through the factory
    with each forced block size, against the JAX kernel on the contiguous
    noise."""
    rs = np.random.RandomState(9)
    cost = (rs.rand(K) * 40 + 5).astype(np.float32)
    full = rs.randn(K, D + pad).astype(np.float32)
    noise = torch.from_numpy(full)[:, :D]
    assert noise.stride(0) == D + pad
    lam = np.float32(0.9)
    pert_j, m_j, s_j = (np.asarray(v) for v in PR.fused_weighted_update(
        jnp.asarray(cost), jnp.asarray(np.ascontiguousarray(full[:, :D])), jnp.asarray(lam)))
    for update in (LG.fused_weighted_update, *(LG.make_weighted_update(S) for S in FS.TILES)):
        pert_p, m_p, s_p = update(torch.from_numpy(cost), noise, torch.tensor(lam))
        assert pert_p.shape == (D,) and m_p.shape == () and s_p.shape == ()
        np.testing.assert_allclose(m_p.numpy(), m_j, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(s_p.numpy(), s_j, rtol=2e-5)
        np.testing.assert_allclose((pert_p / s_p).numpy(), pert_j / s_j, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("K,D,S,groups", [(10_000, 60, 32, 18), (777, 15, 64, 2),
                                          (20, 60, 128, 1), (16_500, 60, 32, 23),
                                          (10_000, 300, 128, 9)])
def test_weighted_update_buffers_are_one_allocation(K, D, S, groups):
    """The wrapper's one allocation a call: the partials of the ceil(K / S)
    blocks and of their merge groups, rows of m, s, two unused floats and
    the D sums padded to four (16-byte rows), then (pert, m, s), whose
    views it returns."""
    partial, gpart, out = LG.weighted_update_buffers(K, D, S, torch.device("cpu"))
    PS = 4 + -(-D // 4) * 4
    assert LG.weighted_stride(D) == PS and PS % 4 == 0
    assert partial.shape == (-(-K // S), PS) and gpart.shape == (groups, PS)
    assert out.shape == (D + 2,)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (partial, gpart, out))
    assert partial.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
    assert gpart.data_ptr() == partial.data_ptr() + 4 * partial.numel()
    assert out.data_ptr() == gpart.data_ptr() + 4 * gpart.numel()


@pytest.mark.parametrize("nblocks,group", [(1, 8), (64, 8), (65, 9), (79, 9), (313, 18),
                                           (516, 23), (67_108_864, 8192)])
def test_weighted_group_balances_the_two_merge_levels(nblocks, group):
    """The first merge level's group: the smallest g ≥ 8 with g² ≥ nblocks,
    so that each level merges about √nblocks partials, and the groups of
    K = 2³¹ samples at 32 a block still fit the tickets."""
    assert LG.weighted_group(nblocks) == group
    groups = -(-nblocks // group)
    assert groups <= group and 1 + groups <= LG.WEIGHTED_COUNTERS


def test_weighted_update_counter_and_tile():
    """One buffer of merge tickets per device, the same int32 tensor on
    every call; the factory takes only the kernel's block sizes and keeps
    the one it was given (None: ``tile_samples`` of K at each call)."""
    cpu = torch.device("cpu")
    counter = LG.weighted_update_counter(cpu)
    assert counter is LG.weighted_update_counter(cpu)
    assert counter.dtype == torch.int32 and counter.shape == (LG.WEIGHTED_COUNTERS,)
    assert not counter.any()
    assert LG.fused_weighted_update.tile_k is None
    assert LG.make_weighted_update(64).tile_k == 64
    with pytest.raises(ValueError, match="tile_k"):
        LG.make_weighted_update(48)
    assert FS.tile_samples(10_000, FS.H100_SMS) == 32  # 313 blocks at the flagship


def _patch_normals(monkeypatch):
    """The same N(0, 1) draws on either side, in call order."""
    jbank, pbank = np.random.RandomState(0), np.random.RandomState(0)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(jbank.randn(*shape), F32))
    monkeypatch.setattr(PS, "standard_normal",
                        lambda gen, shape, dtype, device: torch.tensor(
                            pbank.randn(*shape), dtype=dtype, device=device))


@pytest.mark.parametrize("flags", [{}, {"u_scale": 1.5, "noise_abs_cost": True}],
                         ids=["linear", "u_scale_abs"])
def test_rollout_step_matches_jax(monkeypatch, flags):
    """Three chained ``use_pallas="rollout"`` steps against JAX's, which run
    its two legacy kernels in interpret mode, on the same normals."""
    K, T, nu = 200, 6, 2
    jdyn, jcost, model, _ = _problem("linear")
    fields = dict(noise_mu=np.full(nu, 0.05, np.float32), noise_sigma=np.diag([0.8, 1.2]),
                  lambda_=np.float32(0.8), u_min=np.full(nu, -1.0, np.float32),
                  u_max=np.full(nu, 1.0, np.float32), u_init=np.zeros(nu, np.float32))
    U0 = (np.random.RandomState(1).randn(T, nu) * 0.3).astype(np.float32)
    x0 = np.array([-3.0, -2.0], np.float32)
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, **flags)
    jfns = JS.make_mppi_step(jcfg, jdyn, jcost, jit=False, use_pallas="rollout")
    jparams = JParams(**{k: jnp.asarray(v, F32) for k, v in fields.items()})
    jstate = JState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0))
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, **flags)
    fns = PS.make_mppi_step(cfg, model.dynamics, model.running_cost, use_pallas="rollout")
    assert fns.fused
    params, state = params_from_numpy(**fields), MPPIState(U=torch.from_numpy(U0), seed=0)
    _patch_normals(monkeypatch)
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega),
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(art.noise.numpy(), np.asarray(jart.noise),
                                   rtol=2e-4, atol=2e-6)


LQ = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor([2.0, 2.0]))


def _mppi(use_pallas, **kw):
    return MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=256, horizon=8,
                lambda_=1.0, seed=3, device="cpu", use_pallas=use_pallas, **kw)


def test_controller_rollout_matches_plain():
    """The legacy route shares the plain path's noise stream, so each
    command's action matches it (tests/test_utils.py:288-310)."""
    c_ref, c_leg = _mppi(False), _mppi("rollout")
    assert c_leg.use_pallas == "rollout" and c_leg._fns.fused and not c_ref._fns.fused
    state = torch.tensor([-3.0, -2.0])
    for _ in range(3):
        a1, a2 = c_ref.command(state), c_leg.command(state)
        np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-4, atol=1e-5)
        state = LQ.dynamics(state[None], a1[None])[0]
    np.testing.assert_allclose(c_ref.omega.numpy(), c_leg.omega.numpy(), rtol=1e-4, atol=1e-7)
    assert c_leg.noise is not None and c_leg.noise.shape == (256, 8, 2)


def test_use_pallas_keeps_its_value():
    """``"rollout"`` is not collapsed to True: it selects another solve, and
    the step cache is keyed by the value as given."""
    c = _mppi("rollout")
    assert c.use_pallas == "rollout"
    assert _mppi(True).use_pallas is True and _mppi(0).use_pallas is False
    key = next(iter(c._fns_cache))
    assert key[1] == "rollout"
    with pytest.raises(ValueError, match="use_pallas"):
        _mppi("bogus")
    with pytest.raises(ValueError, match="use_pallas"):
        _mppi("force")  # a batched mode, not MPPI's


def test_ineligible_configs_warn_and_take_plain_path(caplog):
    """A callable the tracer refuses (JAX's ``bad_dyn``), a float64 config,
    and a step dependence with a named model (which takes no timestep) take
    the plain path with a warning saying why."""
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = PS.make_mppi_step(MPPIConfig(nx=2, nu=2, K=8, T=3),
                                lambda s, a: s - s.mean(dim=0, keepdim=True) + a,
                                lambda s, a: s.sum(-1), use_pallas="rollout")
    assert not fns.fused and "no kernel model" in caplog.text
    assert "mean over the batch axis" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = PS.make_mppi_step(MPPIConfig(nx=2, nu=2, K=8, T=3, dtype=torch.float64),
                                LQ.dynamics, LQ.running_cost, use_pallas="rollout")
    assert not fns.fused and "ineligible" in caplog.text
    assert LG.pallas_eligible(MPPIConfig(nx=2, nu=2, K=8, T=3))
    step_dependent = MPPIConfig(nx=2, nu=2, K=8, T=3, step_dependent_dynamics=True)
    assert LG.pallas_eligible(step_dependent)  # a traced model takes the timestep
    with pytest.raises(FS.FusedSolveUnavailable, match="takes no timestep"):
        LG.make_fused_rollout(step_dependent, LQ)


@pytest.mark.parametrize("step_dependent", [False, True], ids=["plain", "step_dependent"])
def test_untagged_callables_take_the_rollout_kernel(step_dependent):
    """Untagged callables within the tracer's vocabulary reach the legacy
    rollout kernel (on the CPU its plain version with the traced program),
    step-dependent ones too: its costs equal the plain rollout's."""
    B = torch.from_numpy(B_NP)
    goal = torch.from_numpy(GOAL_NP)
    if step_dependent:
        dyn = lambda s, a, t: s + a @ B.T * (1.0 + 0.01 * t)  # noqa: E731
        cost = lambda s, a, t: ((goal - s) ** 2).sum(-1) * (1.0 + 0.005 * t)  # noqa: E731
    else:
        dyn = lambda s, a: s + a @ B.T  # noqa: E731
        cost = lambda s, a: ((goal - s) ** 2).sum(-1)  # noqa: E731
    cfg = MPPIConfig(nx=2, nu=2, K=64, T=6, step_dependent_dynamics=step_dependent)
    fns = PS.make_mppi_step(cfg, dyn, cost, use_pallas="rollout")
    assert fns.fused
    rollout = LG.make_fused_rollout(cfg, BL.kernel_model(cfg, dyn, cost))
    g = torch.Generator().manual_seed(0)
    u = torch.randn(64, 6, 2, generator=g)
    x0 = torch.randn(64, 2, generator=g)
    want, _, _ = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, dyn), PS.wrap_cost(cfg, cost), x0, u)
    torch.testing.assert_close(rollout(x0, u), want, rtol=2e-5, atol=1e-5)


def test_wrappers_check_their_inputs():
    rollout = LG.make_fused_rollout(MPPIConfig(nx=2, nu=2, K=8, T=3), LQ)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rollout(torch.empty((8, 2), device="meta"), torch.empty((8, 3, 2), device="meta"))
    # beyond 32 the named model runs the trace of its callables; a
    # step-dependent config keeps the named model, whose registers hold 32
    wide = LG.make_fused_rollout(MPPIConfig(nx=33, nu=2, K=8, T=3),
                                 linear_quadratic(torch.zeros(33, 2), torch.zeros(33)))
    assert wide(torch.zeros(8, 33), torch.zeros(8, 3, 2)).shape == (8,)
    with pytest.raises(FS.FusedSolveUnavailable, match="at most 32"):
        LG.make_fused_rollout(MPPIConfig(nx=33, nu=2, K=8, T=3, step_dependent_dynamics=True),
                              linear_quadratic(torch.zeros(33, 2), torch.zeros(33)))
    assert set(FS.launches) == {"mppi", "smppi", "kmppi", "batched", "rollout",
                                "weighted_update", "sampler", "rowmajor",
                                "generated_mppi", "generated_smppi", "generated_kmppi",
                                "generated_batched", "generated_rollout",
                                "mppi_block", "smppi_block", "kmppi_block", "batched_block",
                                "rollout_block", "generated_mppi_block",
                                "generated_smppi_block", "generated_kmppi_block",
                                "generated_batched_block", "generated_rollout_block"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_legacy_work_counts_inputs_once():
    """``chip_smoke.rollout_work`` and ``weighted_update_work``, the bounds'
    counts: a shared x0 is nx values, the actions and the noise are read
    once, and the rollout's actions come scaled (no u_scale product)."""
    smoke = _chip_smoke()
    K, T, nu, D = 300, 4, 2, 8
    u = torch.zeros(K, T, nu)
    ops, nbytes = smoke.rollout_work(LQ, torch.zeros(2)[None].expand(K, 2), u)
    # x' = x + u Bᵀ: nx (2 nu + 1); |goal - x'|²: 3 nx; the sum: 1
    assert ops == K * T * (2 * (2 * nu + 1) + 3 * 2 + 1)
    assert nbytes == 4 * (2 + K * T * nu + LQ.consts.numel() + K)
    _, per_sample = smoke.rollout_work(LQ, torch.zeros(K, 2), u)
    assert per_sample - nbytes == 4 * (2 * K - 2)
    ops, nbytes = smoke.weighted_update_work(K, D)
    assert ops == K * (5 + 2 * D) + 3 * (5 + 4 * D)
    assert nbytes == 4 * (K + K * D + 1 + D + 2)
    assert smoke.bound((67e9, 0)) == (1.0, "operations")
    assert smoke.bound((0, 3.35e9)) == (1.0, "bytes")
