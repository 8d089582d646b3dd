"""The port's MPPI_Batched against the JAX package on the CPU.

* ``fused_solve.batched_solve_plain`` (what the batched CUDA kernel computes)
  against ``pallas_rollout.make_transposed_batched_solve`` in Pallas
  interpret mode, fed the same int32 bits or the same final noise operand;
* the plain ``make_batched_step`` against JAX's (``jit=False``), and the
  fused step in bits and operand mode against JAX's through its override
  hook, with the same noise injected on both sides by ``monkeypatch``;
* the fused operand-mode step against the port's own plain step on one seed;
* the routing of ``use_pallas``, and the ``TestMPPIBatched`` behaviours of
  ``tests/test_mppi.py`` on ``MPPI_Batched(device="cpu")``.

Float32 on both sides (``tests/conftest.py`` turns on x64 for JAX).
Tolerances, as ``tests/test_pallas_transposed.py:410-413``: costs rtol 2e-5 /
atol 2e-5; the update (delta/s, U, actions, omega) rtol 2e-4 / atol 2e-6.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
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
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.models.toy2d import Toy2DEnvironment as JToy2D
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch import BatchedState, MPPI_Batched
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import batched_state_from_numpy, params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
TOL_C = dict(rtol=2e-5, atol=2e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _problem(name):
    """(JAX dynamics, JAX cost, port kernel model, nu, T, bound)."""
    if name == "pendulum":
        return (jpend.pendulum_dynamics, jpend.pendulum_running_cost, PENDULUM_MODEL,
                1, 8, 2.0)
    if name == "toy2d":
        jenv = JToy2D(dtype=F32)
        model = Toy2DEnvironment(device="cpu").kernel_model
        return jenv.dynamics, jenv.running_cost, model, 2, 6, 1.0
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    return (lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(axis=-1),
            linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP)), 2, 6, 1.0)


# name, problem, config flags, noise_rho, JAX block_k (None: its own)
KERNEL_CASES = [
    ("linear_diag", "linear", {}, 0.0, None),
    ("full_op_rho", "linear", {}, 0.5, None),
    ("antithetic_block128", "linear", {"antithetic": True}, 0.0, 128),
    ("abs_cost_u_scale", "linear", {"noise_abs_cost": True, "u_scale": 1.7}, 0.0, None),
    ("pendulum", "pendulum", {}, 0.0, None),
    ("toy2d", "toy2d", {}, 0.0, None),
]


def _kernel_operands(rs, nu, T, N, rho, bound, jcfg):
    D = T * nu
    if rho:
        sigma = np.array([[1.0, 0.3], [0.3, 0.8]], np.float32)[:nu, :nu]
        _, op, _, _, _ = JS._transposed_operands(
            jnp.asarray(sigma), jnp.zeros(nu, F32), jnp.full(nu, -bound, F32),
            jnp.full(nu, bound, F32), jcfg, T, nu, F32)
        op = np.asarray(op)
    else:
        op = np.full(D, 0.8, np.float32)
    x0T = (rs.randn(2, N) * 1.5).astype(np.float32)
    U2T = (rs.randn(D, N) * 0.3).astype(np.float32)
    aT = (rs.randn(D, N) * 0.5).astype(np.float32)
    return (x0T, U2T, op, np.full(D, 0.05, np.float32), np.full(D, -bound, np.float32),
            np.full(D, bound, np.float32), aT, np.float32(0.8))


def _assert_solves_agree(out_p, out_j):
    delta_p, ms_p, ct_p = (v.numpy() for v in out_p)
    delta_j, ms_j, ct_j = (np.asarray(v) for v in out_j)
    assert ct_p.shape == ct_j.shape and delta_p.shape == delta_j.shape
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(ms_p[0], ms_j[0], **TOL_C)
    np.testing.assert_allclose(ms_p[1], ms_j[1], rtol=2e-5)
    np.testing.assert_allclose(delta_p / ms_p[1], delta_j / ms_j[1], **TOL_U)


@pytest.mark.parametrize("problem,flags,rho,block", [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
def test_plain_matches_jax_kernel_bits(problem, flags, rho, block):
    """Bits mode: the same int32 bits, shared by the plants."""
    rs = np.random.RandomState(5)
    N, K = 3, 256
    jdyn, jcost, model, nu, T, bound = _problem(problem)
    D = T * nu
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=not rho, noise_rho=rho,
                   **flags)
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), block_k=block,
        rng_in_kernel=False)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    args = _kernel_operands(rs, nu, T, N, rho, bound, jcfg)
    out_j = solve_j(jnp.asarray(bits), *(jnp.asarray(v) for v in args))

    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=not rho, noise_rho=rho, **flags)
    solve_p = FS.make_transposed_batched_solve(cfg, N, model, pair_block=solve_j.block_k)
    assert solve_p.bits_cols == cols
    out_p = solve_p(torch.from_numpy(bits), *(torch.from_numpy(np.array(v)) for v in args))
    _assert_solves_agree(out_p, out_j)


@pytest.mark.parametrize("problem", ["linear", "pendulum"])
def test_plain_matches_jax_kernel_operand(problem):
    """Operand mode: the same final (D, K_pad) noise; no sign is applied in
    the kernel even with antithetic sampling (the mirror is in the draw)."""
    rs = np.random.RandomState(9)
    N, K = 3, 200  # K not a multiple of 128: the JAX kernel pads
    jdyn, jcost, model, nu, T, bound = _problem(problem)
    D = T * nu
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, antithetic=True)
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), noise_operand=True)
    noiseT = (rs.randn(D, solve_j.K_pad) * 0.9).astype(np.float32)
    args = _kernel_operands(rs, nu, T, N, 0.0, bound, jcfg)
    out_j = solve_j(jnp.asarray(noiseT), *(jnp.asarray(v) for v in args))

    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, antithetic=True)
    solve_p = FS.make_transposed_batched_solve(cfg, N, model, noise_operand=True)
    assert solve_p.noise_operand and solve_p.K_pad == K
    out_p = solve_p(torch.from_numpy(noiseT), *(torch.from_numpy(np.array(v)) for v in args))
    _assert_solves_agree(out_p, out_j)


def test_seed_mode_shares_the_draw_across_plants():
    """Seed mode draws each sample's noise from its source column only, so
    plants with the same nominal sequence and state get the same costs, and
    the draw equals the injected Philox words."""
    N, K, T, nu = 3, 64, 4, 2
    D = T * nu
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, antithetic=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    solve = FS.make_transposed_batched_solve(cfg, N, model)
    key = (77, 88)
    x0T = torch.tensor([[-3.0, -3.0, 1.0], [-2.0, -2.0, 1.0]])
    U2T = torch.zeros(D, N)
    args = (x0T, U2T, torch.ones(D), torch.zeros(D), torch.full((D,), -torch.inf),
            torch.full((D,), torch.inf), torch.zeros(D, N), torch.tensor(1.0))
    delta, ms, cost = solve(key, *args)
    torch.testing.assert_close(cost[0], cost[1], rtol=0, atol=0)
    assert not torch.equal(cost[0], cost[2])
    bits = FS.philox_bits(key, torch.arange(solve.bits_cols), D).to(torch.int32)
    for a, b in zip((delta, ms, cost), solve(bits, *args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The step against JAX's make_batched_step
# ---------------------------------------------------------------------------

FIELDS = dict(noise_mu=np.full(2, 0.05, np.float32), noise_sigma=np.diag([0.8, 1.2]),
              lambda_=np.float32(0.8), u_min=np.full(2, -1.0, np.float32),
              u_max=np.full(2, 1.0, np.float32), u_init=np.zeros(2, np.float32))


def _noise_bank(monkeypatch, K, D):
    """The same (K, D) noise for the i-th ``sample_noise_flat`` call on
    either side."""
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        jbank.randn(K, D).astype(np.float32)))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        pbank.randn(K, D).astype(np.float32)))


def _step_pair(flags, N, K, T, jkw=None, pkw=None):
    """JAX and port batched steps, params and states on the linear problem."""
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    jcfg = JConfig(nx=2, nu=2, K=K, T=T, dtype=F32, diag_sigma=True, **flags)
    jfns = JS.make_batched_step(jcfg, N, lambda s, a: s + a @ B.T,
                                lambda s, a: ((goal - s) ** 2).sum(axis=-1), jit=False,
                                **(jkw or {}))
    cfg = MPPIConfig(nx=2, nu=2, K=K, T=T, diag_sigma=True, **flags)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    fns = PS.make_batched_step(cfg, N, model.dynamics, model.running_cost, **(pkw or {}))
    U0 = (np.random.RandomState(1).randn(N, T, 2) * 0.3).astype(np.float32)
    jparams = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    jstate = JS.BatchedState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0))
    state = batched_state_from_numpy(U0, seed=0)
    return jfns, jparams, jstate, fns, params_from_numpy(**FIELDS), state, jcfg, cfg, model


STEP_CASES = [
    ("bounds", {}),
    ("abs_cost", {"noise_abs_cost": True}),
    ("u_scale", {"u_scale": 1.6}),
    ("u_per_command", {"u_per_command": 2}),
]


@pytest.mark.parametrize("flags", [c[1] for c in STEP_CASES], ids=[c[0] for c in STEP_CASES])
def test_plain_steps_match_jax(monkeypatch, flags):
    """Three chained plain commands on the same injected noise."""
    N, K, T = 3, 64, 5
    jfns, jparams, jstate, fns, params, state, *_ = _step_pair(flags, N, K, T)
    x0 = np.array([[-3.0, -2.0], [1.0, 1.0], [0.5, -0.5]], np.float32)
    _noise_bank(monkeypatch, K, T * 2)
    assert not fns.fused
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        assert art.cost_total.shape == (N, K)
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **TOL_C)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega), **TOL_U)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **TOL_U)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **TOL_U)
        np.testing.assert_allclose(art.noise.numpy(), np.asarray(jart.noise), **TOL_U)
        x0 = x0 + 0.1
    assert state.counter == 3


@pytest.mark.parametrize("mode", ["bits", "operand"])
def test_fused_steps_match_jax(monkeypatch, mode):
    """The fused step against JAX's step with its batched kernel injected
    through ``transposed_solve_override``: the same bits (through
    ``key_to_seed`` on both sides) or the same operand draw."""
    N, K, T = 2, 256, 5
    D = T * 2
    flags = {"antithetic": True} if mode == "bits" else {}
    _, _, _, _, params, state, jcfg, cfg, model = _step_pair(flags, N, K, T)
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    jdyn = lambda s, a: s + a @ B.T  # noqa: E731
    jcost = lambda s, a: ((goal - s) ** 2).sum(axis=-1)  # noqa: E731
    solve_j = PR.make_transposed_batched_solve(
        jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), block_k=128,
        rng_in_kernel=mode != "bits", noise_operand=mode == "operand")
    solve_p = FS.make_transposed_batched_solve(cfg, N, model, pair_block=solve_j.block_k,
                                               noise_operand=mode == "operand")
    jfns, jparams, jstate, fns, params, state, *_ = _step_pair(
        flags, N, K, T, jkw=dict(transposed_solve_override=solve_j),
        pkw=dict(transposed_solve_override=solve_p))
    assert fns.fused
    if mode == "bits":
        bits = _rand_bits(np.random.RandomState(4), (D, solve_p.bits_cols))
        monkeypatch.setattr(PR, "key_to_seed", lambda k: jnp.asarray(bits))
        monkeypatch.setattr(FS, "key_to_seed", lambda s: torch.from_numpy(bits))
    else:
        _noise_bank(monkeypatch, K, D)
    x0 = np.array([[-3.0, -2.0], [1.0, 1.0]], np.float32)
    for _ in range(2):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **TOL_C)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega), **TOL_U)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **TOL_U)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **TOL_U)
        assert art.noise is None


@pytest.mark.parametrize("antithetic", [False, True])
def test_fused_operand_step_matches_plain_step(antithetic):
    """On one seed the operand-mode step draws the plain step's noise, so the
    two differ only by float32 summation order (tests/
    test_pallas_transposed.py:466-510)."""
    N, K, T = 2, 256, 6
    cfg = MPPIConfig(nx=2, nu=2, K=K, T=T, diag_sigma=True, antithetic=antithetic)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    plain = PS.make_batched_step(cfg, N, model.dynamics, model.running_cost)
    fused = PS.make_batched_step(cfg, N, model.dynamics, model.running_cost,
                                 use_pallas="force")
    assert fused.fused and not plain.fused
    params = params_from_numpy(**FIELDS)
    state = BatchedState(U=torch.randn(N, T, 2, generator=torch.Generator().manual_seed(9)) * 0.1,
                         seed=7)
    x0 = torch.tensor([[-3.0, -2.0], [1.0, 1.0]])
    s_p, a_p, art_p = plain.step(params, state, x0)
    s_f, a_f, art_f = fused.step(params, state, x0)
    torch.testing.assert_close(art_f.cost_total, art_p.cost_total, **TOL_C)
    torch.testing.assert_close(s_f.U, s_p.U, **TOL_U)
    torch.testing.assert_close(a_f, a_p, **TOL_U)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.fixture
def recorder(monkeypatch):
    """Records the batched factory's keyword arguments and refuses, so that
    only the routing is pinned (``tests/test_pallas_transposed.py:537-594``)."""
    calls = []

    def record(config, num_envs, model, **kw):
        calls.append(kw)
        raise FS.FusedSolveUnavailable("routing probe")

    monkeypatch.setattr(FS, "make_transposed_batched_solve", record)
    return calls


def _route(K, use_pallas, **flags):
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    cfg = MPPIConfig(nx=2, nu=2, K=K, T=4, diag_sigma=True, **flags)
    return PS.make_batched_step(cfg, 2, model.dynamics, model.running_cost,
                                use_pallas=use_pallas)


def test_below_crossover_true_takes_plain_path(recorder, caplog):
    K = max(1, PS._BATCHED_KERNEL_MIN_K // 2)
    with caplog.at_level(logging.INFO, logger="pytorch_mppi_tpu_torch"):
        fns = _route(K, True)
    assert not fns.fused and recorder == []
    assert any("use_pallas='force'" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("mode,operand", [("force", True), ("kernel_rng", False)])
def test_mode_strings_keep_the_kernel(recorder, mode, operand):
    for K in (max(1, PS._BATCHED_KERNEL_MIN_K // 2), PS._BATCHED_KERNEL_MIN_K):
        recorder.clear()
        _route(K, mode)
        assert recorder == [{"noise_operand": operand, "terminal_final": None}]


def test_true_at_crossover_takes_operand_mode(recorder):
    _route(PS._BATCHED_KERNEL_MIN_K, True)
    assert recorder == [{"noise_operand": True, "terminal_final": None}]


def test_mode_strings_warn_below_crossover(caplog):
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = _route(max(1, PS._BATCHED_KERNEL_MIN_K // 2), "kernel_rng")
    assert fns.fused
    assert any("likely faster" in r.getMessage() for r in caplog.records) == (
        PS._BATCHED_KERNEL_MIN_K > 1)


def test_fused_artifacts_and_null_action_warn(recorder, caplog):
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = _route(PS._BATCHED_KERNEL_MIN_K, "force", fused_artifacts=True,
                     sample_null_action=True)
    assert not fns.fused and recorder == []
    text = caplog.text
    assert "fused_artifacts" in text and "sample_null_action" in text


def test_override_guard_and_bad_mode():
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=4, diag_sigma=True, fused_artifacts=True)
    with pytest.raises(ValueError, match="transposed_solve_override"):
        PS.make_batched_step(cfg, 2, model.dynamics, model.running_cost,
                             transposed_solve_override=object())
    with pytest.raises(ValueError, match="use_pallas"):
        _route(8, "rollout")
    # the grid holds blocks of plant groups on x: no 65,535-plant limit
    solve = FS.make_transposed_batched_solve(MPPIConfig(nx=2, nu=2, K=8, T=4), 65_536, model)
    assert solve.num_envs == 65_536 and solve.blocks == -(-65_536 // solve.plant_group)
    with pytest.raises(ValueError, match="group"):
        FS.make_transposed_batched_solve(MPPIConfig(nx=2, nu=2, K=8, T=4), 3, model, group=4)


@pytest.mark.parametrize("N", [1, 16, 64, 1024, 70_000])
@pytest.mark.parametrize("K", [256, 10_240, 16_384])
def test_plant_group_fills_the_card(N, K):
    """``plant_group``: at most ``PLANT_GROUP_MAX`` plants a block; one
    plant a block where even that underfills the card; otherwise the grid
    of ``nblocks · ceil(N / P)`` blocks holds ``FILL_BLOCKS``, with the
    fewest groups that do, spread evenly."""
    nblocks = -(-K // FS._BLOCK)
    P = FS.plant_group(N, nblocks)
    groups = -(-N // P)
    assert 1 <= P <= min(N, FS.PLANT_GROUP_MAX)
    if nblocks * N < FS.FILL_BLOCKS:
        assert P == 1
    else:
        assert nblocks * groups >= FS.FILL_BLOCKS
        fewest = min(-(-N // q) for q in range(1, min(N, FS.PLANT_GROUP_MAX) + 1)
                     if nblocks * -(-N // q) >= FS.FILL_BLOCKS)
        assert groups == fewest
        assert P == -(-N // groups)  # the groups differ by at most one plant
    if (N, K) == (1024, 16_384):
        assert P == FS.PLANT_GROUP_MAX
    if (N, K) == (16, 10_240):
        assert 1 <= P <= 4


def test_more_plants_than_a_grid_row():
    """More than 65,535 plants: the factory builds, its plain version gives
    the shapes of the contract, and ``use_pallas="force"`` routes to it."""
    N, K, T = 70_000, 8, 2
    D = T * 2
    cfg = MPPIConfig(nx=2, nu=2, K=K, T=T, diag_sigma=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    solve = FS.make_transposed_batched_solve(cfg, N, model)
    assert solve.plant_group == FS.plant_group(N, 1)
    g = torch.Generator().manual_seed(3)
    args = (torch.randn(2, N, generator=g), torch.randn(N, D, generator=g).T * 0.3,
            torch.ones(D), torch.zeros(D), torch.full((D,), -1.0), torch.full((D,), 1.0),
            torch.randn(N, D, generator=g).T * 0.5, torch.tensor(1.0))
    delta, ms, cost = solve((5, 6), *args)
    assert delta.shape == (D, N) and ms.shape == (2, N) and cost.shape == (N, K)
    assert all(bool(torch.isfinite(v).all()) for v in (delta, ms, cost))
    fns = PS.make_batched_step(cfg, N, model.dynamics, model.running_cost, use_pallas="force")
    assert fns.fused


def test_toy2d_environment_means_the_card(monkeypatch):
    """``Toy2DEnvironment()`` with no device means the card, as the
    controllers do: without one it raises and asks for ``device="cpu"``."""
    env = Toy2DEnvironment(device="cpu")
    assert env.device.type == "cpu" and env.start.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Toy2DEnvironment()


# ---------------------------------------------------------------------------
# The controller: tests/test_mppi.py:622-705 on the port
# ---------------------------------------------------------------------------

LQ = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor([2.0, 2.0]))
GOAL = torch.tensor([2.0, 2.0])


def _batched(use_pallas, num_envs=4, **kw):
    args = dict(nx=2, noise_sigma=torch.eye(2), num_envs=num_envs, num_samples=100,
                horizon=10, lambda_=1.0, seed=42, device="cpu", use_pallas=use_pallas)
    args.update(kw)
    return MPPI_Batched(LQ.dynamics, LQ.running_cost, **args)


PATHS = pytest.mark.parametrize("use_pallas", [False, "force"], ids=["plain", "fused_plain"])


@PATHS
def test_batched_basic_command(use_pallas):
    ctrl = _batched(use_pallas)
    assert ctrl._fns.fused == bool(use_pallas)
    action = ctrl.command(torch.randn(4, 2, generator=torch.Generator().manual_seed(42)))
    assert action.shape == (4, 2)
    assert ctrl.cost_total.shape == (4, 100) and ctrl.omega.shape == (4, 100)
    assert ctrl.states is None


@PATHS
def test_batched_moves_toward_goal(use_pallas):
    ctrl = _batched(use_pallas, num_samples=300)
    states = torch.tensor([[-3.0, -2.0], [-1.0, -1.0], [0.0, 0.0], [1.0, -1.0]])
    initial = torch.linalg.norm(states - GOAL, dim=-1)
    for _ in range(10):
        states = LQ.dynamics(states, ctrl.command(states))
    assert (torch.linalg.norm(states - GOAL, dim=-1) < initial).any()


@PATHS
def test_batched_bounded_actions(use_pallas):
    u_max = torch.tensor([0.5, 0.5])
    ctrl = _batched(use_pallas, u_max=u_max)
    states = torch.randn(4, 2, generator=torch.Generator().manual_seed(42))
    for _ in range(5):
        actions = ctrl.command(states)
        assert (actions <= u_max + 1e-6).all() and (actions >= -u_max - 1e-6).all()
        states = LQ.dynamics(states, actions)


@PATHS
def test_batched_independent_envs(use_pallas):
    ctrl = _batched(use_pallas, num_envs=2, num_samples=200)
    actions = ctrl.command(torch.tensor([[-5.0, -5.0], [5.0, 5.0]]))
    assert not torch.allclose(actions[0], actions[1], atol=0.1), actions


@PATHS
def test_batched_reset(use_pallas):
    ctrl = _batched(use_pallas, num_envs=2)
    ctrl.command(torch.randn(2, 2, generator=torch.Generator().manual_seed(42)))
    before = ctrl.U.clone()
    ctrl.reset()
    assert ctrl.U.shape == (2, 10, 2) and not torch.allclose(ctrl.U, before)


@PATHS
def test_batched_compile(use_pallas):
    ctrl = _batched(use_pallas, num_envs=2, num_samples=50, horizon=5)
    assert ctrl.compile() is ctrl
    actions = ctrl.command(torch.randn(2, 2, generator=torch.Generator().manual_seed(42)))
    assert actions.shape == (2, 2) and torch.isfinite(actions).all()


@pytest.mark.parametrize("kw", [dict(scan_unroll=0), dict(prng_impl=None),
                                dict(prng_impl="auto"), dict(key=None)],
                         ids=["scan_unroll", "prng_none", "prng_auto", "key_none"])
def test_batched_jax_keywords_accepted(kw):
    """scan_unroll, prng_impl and key (pytorch_mppi_tpu/controller.py:1024,
    1027, 1033) at the values that mean the default: the same command as
    without them, on the same seed."""
    x = torch.zeros(2, 2)
    torch.testing.assert_close(_batched(False, num_envs=2, **kw).command(x),
                               _batched(False, num_envs=2).command(x), rtol=0, atol=0)


@pytest.mark.parametrize("kw,match", [(dict(key=object()), "seed="),
                                      (dict(prng_impl="rbg"), "Philox from seed")],
                         ids=["key", "prng_rbg"])
def test_batched_jax_rng_keywords_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _batched(False, num_envs=2, **kw)


def test_batched_controller_surface(monkeypatch):
    ctrl = _batched(False, num_envs=3, u_per_command=2, u_min=-0.7)
    actions = ctrl.command(torch.zeros(3, 2))
    assert actions.shape == (3, 2, 2)
    assert ctrl.lambda_ == 1.0 and ctrl.noise_sigma.shape == (2, 2)
    torch.testing.assert_close(ctrl.u_max, torch.tensor([0.7, 0.7]))
    ctrl.U = torch.zeros(3, 10, 2)
    assert ctrl.U.abs().sum() == 0
    with pytest.raises(ValueError, match="num_envs=3"):
        ctrl.command(torch.zeros(2, 2))
    with pytest.raises(ValueError, match="use_pallas"):
        _batched("rollout")
    for flag, value in (("mesh", object()), ("env_axis", "plants"), ("sample_axis", "k")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
            _batched(False, **{flag: value})
    # dynamics_params, ported since: taken, and passed first to the dynamics
    seen = []
    params = {"B": torch.eye(2)}

    def param_lq(p, s, a):
        seen.append(p)
        return s + a @ p["B"].T

    pc = MPPI_Batched(param_lq, LQ.running_cost, nx=2, noise_sigma=torch.eye(2), num_envs=3,
                      num_samples=16, horizon=4, device="cpu", dynamics_params=params)
    assert pc.config.parameterized_dynamics
    assert torch.isfinite(pc.command(torch.zeros(3, 2))).all()
    assert len(seen) == 4 and all(p is params for p in seen)
    # num_iterations and stochastic_dynamics, ported since: taken
    iters = _batched(False, num_envs=3, num_iterations=2)
    assert iters.config.num_iterations == 2
    iters.command(torch.zeros(3, 2))
    assert iters._state.counter == 2

    def noisy(s, a, rng):
        return LQ.dynamics(s, a) + 0.01 * torch.randn(s.shape, generator=rng)

    stoch = MPPI_Batched(noisy, LQ.running_cost, nx=2, noise_sigma=torch.eye(2), num_envs=3,
                         num_samples=16, horizon=4, device="cpu", stochastic_dynamics=True)
    assert stoch.config.stochastic_dynamics
    assert torch.isfinite(stoch.command(torch.zeros(3, 2))).all()
    # the JAX factory's ValueError for M > 1 (pytorch_mppi_tpu/ops/solve.py:1985-1991)
    with pytest.raises(ValueError, match="not supported on MPPI_Batched"):
        PS.make_batched_step(MPPIConfig(nx=2, nu=2, K=16, T=4, M=2), 3, LQ.dynamics,
                             LQ.running_cost)
    # terminal_state_cost, ported since: taken, and the rollout states kept
    term = _batched(False, num_envs=3, terminal_state_cost=lambda s, a: s[..., -1, :].sum(-1))
    term.command(torch.zeros(3, 2))
    assert term.states is not None and term.states.shape == (3, term.K, term.T, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPPI_Batched(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2), num_envs=2)


def test_batched_state_from_numpy_round_trip():
    U = np.random.RandomState(0).randn(3, 5, 2).astype(np.float32)
    state = batched_state_from_numpy(U, seed=11)
    assert isinstance(state, BatchedState) and state.seed == 11 and state.counter == 0
    np.testing.assert_array_equal(state.U.numpy(), U)
    assert batched_state_from_numpy(U, 3, dtype=torch.float64).U.dtype == torch.float64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_fused_work_counts_batched_inputs_once():
    """``chip_smoke.fused_work`` for the batched variant: N plants' columns
    of x0, U and a read once, the operand read in place of the operator and
    the draw; the draw counted once for the plants that share it, the rest
    N times the single-plant operations."""
    smoke = _chip_smoke()
    N, K, T, nu = 3, 300, 4, 2
    D = T * nu
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    x0T, op = torch.zeros(2, N), torch.ones(D)
    ops_seed, b_seed = smoke.fused_work(cfg, model, (1, 2), x0T, op, variant="batched", plants=N)
    consts = model.consts.numel()
    assert b_seed == 4 * (2 * N + 2 * D * N + 3 * D + 1 + D + consts + N * (K + D + 2))
    ops_op, b_op = smoke.fused_work(cfg, model, torch.zeros(D, K), x0T, op,
                                    variant="batched", plants=N)
    assert b_op == b_seed - 4 * D + 4 * D * K
    # operand mode draws nothing: no normal (30), no transform (2), no Philox;
    # seed mode draws each of the K source columns once for all N plants
    draw = K * (D * 32 + -(-D // 4) * 98)
    assert ops_seed - ops_op == draw
    ops_one, _ = smoke.fused_work(cfg, model, (1, 2), torch.zeros(2, 1).expand(2, K), op)
    assert ops_seed == N * ops_one - (N - 1) * draw
    # antithetic pairs: K/2 source columns
    anti = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, antithetic=True)
    ops_anti, _ = smoke.fused_work(anti, model, (1, 2), x0T, op, variant="batched", plants=N)
    assert ops_anti == ops_op + draw // 2


def test_scenario_loop_settles_like_jax():
    """``examples/scenario_batch.py``'s default loop (N = 16, K = 256, T = 10,
    30 steps, sigma = 0.5 I, bounds +-1) on both packages, two seeds each.
    Every plant comes within 0.5 of the goal during the loop and the mean
    distance over the last 10 steps stays below 1.0 (``chip_smoke.py``'s
    check); the share within 0.5 at the last step is a draw for both, and the
    example's "more than 90 %" holds for JAX at seed 0 but not at seed 1."""
    from pytorch_mppi_tpu import MPPI_Batched as JBatched

    N, K, T, steps = 16, 256, 10, 30
    B, goal = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    jdyn = lambda s, a: s + a @ B.T  # noqa: E731
    jcost = lambda s, a: ((goal - s) ** 2).sum(axis=-1)  # noqa: E731
    final_share = {}
    for seed in (0, 1):
        jc = JBatched(jdyn, jcost, nx=2, noise_sigma=jnp.eye(2, dtype=F32) * 0.5, num_envs=N,
                      num_samples=K, horizon=T, lambda_=1.0, seed=seed,
                      u_min=jnp.array([-1.0, -1.0], F32), u_max=jnp.array([1.0, 1.0], F32))
        pc = _batched(False, num_envs=N, num_samples=K, horizon=T, seed=seed,
                      noise_sigma=torch.eye(2) * 0.5, u_min=torch.tensor([-1.0, -1.0]),
                      u_max=torch.tensor([1.0, 1.0]))
        xj = jax.random.uniform(jax.random.PRNGKey(42 + seed), (N, 2), F32, -4.0, 0.0)
        xp = torch.from_numpy(np.asarray(xj))
        dj, dp = [], []
        for _ in range(steps):
            xj = jdyn(xj, jc.command(xj))
            xp = LQ.dynamics(xp, pc.command(xp))
            dj.append(np.linalg.norm(np.asarray(goal - xj), axis=-1))
            dp.append(torch.linalg.norm(GOAL - xp, dim=-1).numpy())
        for side, d in (("jax", np.stack(dj)), ("port", np.stack(dp))):
            assert (d.min(axis=0) < 0.5).all(), (side, seed, d.min(axis=0))
            assert d[-10:].mean() < 1.0, (side, seed, d[-10:].mean())
            final_share[side, seed] = (d[-1] < 0.5).mean()
    assert final_share["jax", 0] > 0.9 > final_share["jax", 1]
