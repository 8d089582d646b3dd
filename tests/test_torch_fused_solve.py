"""The fused kernel's plain version against the JAX fused kernel.

``pytorch_mppi_tpu_torch.ops.fused_solve.fused_solve_plain`` (what the CUDA
kernel ``csrc/fused_mppi.cu`` computes, run on the CPU) against
``pallas_rollout.make_transposed_fused_solve(rng_in_kernel=False)`` in Pallas
interpret mode, fed the same int32 random bits.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.

Tolerances.  Both sides map bits to normals with Giles' single-precision
erfinv, so the normals differ only by the rounding of ``log1p`` and of
fused multiply-adds: at most one ulp of |z| < 8, i.e. 4.8e-7 (atol 1e-6
below).  Costs and the update then differ by float32 summation order, as in
``tests/test_pallas_transposed.py:102-107``: costs rtol 2e-5 / atol 1e-5,
the update delta/s rtol 2e-4 / atol 2e-6, s rtol 2e-5.
"""
import dataclasses
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.models import pendulum as jpend
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import MPPIConfig, MPPIState
from pytorch_mppi_tpu_torch.models.pendulum import PENDULUM_MODEL
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic, quadratic_terminal
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)


def _linear_pair(B_np):
    B = jnp.asarray(B_np, F32)
    goal = jnp.asarray(GOAL_NP, F32)
    return (lambda s, a: s + a @ B.T,
            lambda s, a: ((goal - s) ** 2).sum(axis=-1),
            linear_quadratic(torch.from_numpy(B_np), torch.from_numpy(GOAL_NP)))


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


# name, problem, K, T, nu, config flags, full op (noise_rho), emit
CASES = [
    ("linear", "linear", 256, 6, 2, {}, 0.0, False),
    ("null_abs", "linear", 256, 6, 2,
     {"sample_null_action": True, "noise_abs_cost": True}, 0.0, False),
    ("antithetic", "linear", 256, 6, 2, {"antithetic": True}, 0.0, False),
    ("u_scale", "linear", 256, 6, 2, {"u_scale": 2.5}, 0.0, False),
    ("pendulum", "pendulum", 256, 15, 1, {"sample_null_action": True}, 0.0, False),
    ("odd_padded", "linear3", 200, 7, 3, {"u_scale": 1.3}, 0.0, False),
    ("antithetic_padded", "linear3", 200, 7, 3, {"antithetic": True}, 0.0, False),
    ("full_op_rho", "linear", 256, 6, 2, {}, 0.5, False),
    ("emit_perturbed", "linear", 256, 6, 2, {"antithetic": True}, 0.0, True),
]


@pytest.mark.parametrize(
    "problem,K,T,nu,flags,rho,emit",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel(problem, K, T, nu, flags, rho, emit):
    rs = np.random.RandomState(7)
    D = T * nu
    nx = 2
    if problem == "pendulum":
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        x0 = np.array([np.pi, 1.0], np.float32)
        lo = np.full(D, -2.0, np.float32)
        hi = np.full(D, 2.0, np.float32)
    else:
        B_np = B_NP if nu == 2 else (rs.randn(2, nu) * 0.5).astype(np.float32)
        jdyn, jcost, model = _linear_pair(B_np)
        x0 = np.array([-3.0, -2.0], np.float32)
        lo = np.full(D, -1.0, np.float32)
        hi = np.full(D, 1.0, np.float32)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=not rho,
                   noise_rho=rho, **flags)
    solve_j = PR.make_transposed_fused_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=False, emit_perturbed=emit)
    block = solve_j.block_k
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    U2 = (rs.randn(D) * 0.1).astype(np.float32)
    if rho:
        sigma = np.array([[1.0, 0.3], [0.3, 0.8]], np.float32)
        _, op, _, _, _ = JS._transposed_operands(
            jnp.asarray(sigma), jnp.zeros(nu, F32), jnp.asarray(lo[:nu]),
            jnp.asarray(hi[:nu]), jcfg, T, nu, F32)
        op = np.asarray(op)
    else:
        op = np.full(D, 0.8, np.float32)
    mu = np.full(D, 0.05, np.float32)
    a_flat = U2 * 0.7
    lam = np.float32(0.8)
    x0T = np.broadcast_to(x0[:, None], (nx, K))

    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(
        jnp.asarray(v) for v in (U2, op, mu, lo, hi, a_flat, lam)))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=not rho,
                     noise_rho=rho, **flags)
    solve_p = FS.make_transposed_fused_solve(cfg, model, pair_block=block,
                                             emit_perturbed=emit)
    t = torch.from_numpy
    out_p = solve_p(t(bits), t(x0)[:, None].expand(nx, K), *(
        t(np.array(v)) for v in (U2, op, mu, lo, hi, a_flat, lam)))

    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    delta_p, m_p, s_p, ct_p = (v.numpy() for v in out_p[:4])
    np.testing.assert_allclose(ct_p, ct_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(m_p, m_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, rtol=2e-4, atol=2e-6)
    if emit:
        np.testing.assert_allclose(out_p[4].numpy(), np.asarray(out_j[4]),
                                   rtol=1e-5, atol=1e-6)


def test_bits_to_normal_matches_jax():
    bits = _rand_bits(np.random.RandomState(0), (65536,))
    z_j = np.asarray(PR._bits_to_normal(jnp.asarray(bits)))
    z_p = FS.bits_to_normal(torch.from_numpy(bits)).numpy()
    assert z_p.dtype == np.float32
    # one ulp of |z| in [4, 8) is 4.8e-7
    np.testing.assert_allclose(z_p, z_j, rtol=0, atol=1e-6)


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints, written from the Random123 paper."""
    m = 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1], p0 & m]
    return c


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
], ids=["zeros", "ones"])
def test_philox_known_answers(ctr, key, expect):
    words = FS.philox4x32_10(tuple(torch.tensor(c) for c in ctr), key)
    assert tuple(int(w) for w in words) == expect
    assert tuple(_philox_scalar(ctr, key)) == expect


def test_philox_matches_scalar():
    rs = np.random.RandomState(3)
    ctr = rs.randint(0, 2**32, size=(4, 64), dtype=np.int64)
    key = tuple(int(k) for k in rs.randint(0, 2**32, size=2, dtype=np.int64))
    words = FS.philox4x32_10(tuple(torch.from_numpy(c) for c in ctr), key)
    got = torch.stack(words).numpy()
    for i in range(ctr.shape[1]):
        assert list(got[:, i]) == _philox_scalar(ctr[:, i].tolist(), key)


def test_seed_mode_uses_philox_words():
    """Seed mode draws row 4g + w of column c from word w of Philox counter
    (c, g, 0, 0): the same as injecting those words as bits."""
    K, T, nu = 16, 5, 2
    D = T * nu
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, antithetic=True,
                     fused_artifacts=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    solve = FS.make_transposed_fused_solve(cfg, model, emit_perturbed=True)
    key = (123, 456)
    bits = FS.philox_bits(key, torch.arange(solve.bits_cols), D)
    bits = bits.to(torch.int32)  # uint32 words as int32: the same 32 bits
    args = (torch.zeros(2)[:, None].expand(2, K), torch.zeros(D), torch.ones(D),
            torch.zeros(D), torch.full((D,), -torch.inf), torch.full((D,), torch.inf),
            torch.zeros(D), torch.tensor(1.0))
    seeded = solve(key, *args)
    injected = solve(bits, *args)
    for a, b in zip(seeded, injected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # antithetic pairs sum to exactly zero
    pert = seeded[4]
    torch.testing.assert_close(pert[:, : K // 2] + pert[:, K // 2:],
                               torch.zeros(D, K // 2), rtol=0, atol=0)


CASES_ITER = [
    ("linear_anti_null", "linear", {"antithetic": True, "sample_null_action": True}, 0.0),
    ("pendulum_full_rho", "pendulum", {"noise_abs_cost": True}, 0.5),
]


@pytest.mark.parametrize("problem,flags,rho", [c[1:] for c in CASES_ITER],
                         ids=[c[0] for c in CASES_ITER])
def test_fused_iteration_matches_jax(monkeypatch, problem, flags, rho):
    """The port's ``_one_iteration_fused`` (through ``make_mppi_step``)
    against JAX's operands + kernel + ``weighting_from_stats`` + update,
    given the same bits."""
    rs = np.random.RandomState(11)
    K = 256
    if problem == "pendulum":
        nx, nu, T = 2, 1, 15
        jdyn, jcost, model = (jpend.pendulum_dynamics, jpend.pendulum_running_cost,
                              PENDULUM_MODEL)
        sigma = np.array([[2.0]], np.float32)
        bound = 2.0
        x0 = np.array([np.pi, 1.0], np.float32)
    else:
        nx, nu, T = 2, 2, 6
        jdyn, jcost, model = _linear_pair(B_NP)
        sigma = np.diag([0.8, 1.2]).astype(np.float32)
        bound = 1.0
        x0 = np.array([-3.0, -2.0], np.float32)
    D = T * nu
    fields = dict(
        noise_mu=np.full(nu, 0.05, np.float32), noise_sigma=sigma,
        lambda_=np.float32(0.8), u_min=np.full(nu, -bound, np.float32),
        u_max=np.full(nu, bound, np.float32), u_init=np.zeros(nu, np.float32))
    U = (rs.randn(T, nu) * 0.3).astype(np.float32)
    diag = not rho

    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=F32, diag_sigma=diag,
                   noise_rho=rho, **flags)
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in fields.items()})
    solve_j = PR.make_transposed_fused_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
        rng_in_kernel=False)
    cols = solve_j.K_pad // 2 if jcfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    Uj = JS._shift_U(jnp.asarray(U), jp.u_init)
    sigma_inv, op, mu_t, lo2, hi2 = JS._transposed_operands(
        jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, T, nu, F32)
    a_flat = (jp.lambda_ * (Uj @ sigma_inv.T)).reshape(D)
    delta, m, s, cost_j = solve_j(
        jnp.asarray(bits), JS._x0_to_lanes(jnp.asarray(x0), K), Uj.reshape(D),
        op, mu_t, lo2, hi2, a_flat, jp.lambda_)
    ctnz_j, omega_j = PR.weighting_from_stats(cost_j, jp.lambda_, m, s)
    U_j = Uj + (delta / s).reshape(T, nu)

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=diag, noise_rho=rho,
                     **flags)
    fns = PS.make_mppi_step(cfg, model.dynamics, model.running_cost,
                            use_pallas=True)
    assert fns.fused
    assert solve_j.block_k == K  # the port's default pairing block is K
    monkeypatch.setattr(FS, "key_to_seed", lambda s_: torch.from_numpy(bits))
    state, action, art = fns.step(params_from_numpy(**fields),
                                  MPPIState(U=torch.from_numpy(U), seed=0),
                                  torch.from_numpy(x0))
    np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(cost_j),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(art.omega.numpy(), np.asarray(omega_j),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(art.cost_total_non_zero.numpy(),
                               np.asarray(ctnz_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(state.U.numpy(), np.asarray(U_j), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(action.numpy(), np.asarray(U_j[0]), rtol=2e-4, atol=2e-6)
    assert state.counter == 1 and art.noise is None


def test_wrapper_rejects_other_devices():
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=3, diag_sigma=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    solve = FS.make_transposed_fused_solve(cfg, model)
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        solve((1, 2), meta, *([torch.empty(6, device="meta")] * 6),
              torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        FS.make_transposed_fused_solve(
            MPPIConfig(nx=2, nu=2, K=8, T=3, dtype=torch.float64), model)
    # a large D takes the global-memory tiles; nx or nu up to 32 is taken
    big = FS.make_transposed_fused_solve(
        MPPIConfig(nx=2, nu=2, K=8, T=250, noise_rho=0.5), model, tile_k=128)
    assert big.tiles == "global"
    FS.make_transposed_fused_solve(
        MPPIConfig(nx=32, nu=2, K=8, T=3),
        linear_quadratic(torch.zeros(32, 2), torch.zeros(32)))
    # beyond 32 the named model runs the trace of its callables, its state
    # in shared memory; a step-dependent config keeps the named model, whose
    # registers hold 32
    wide = FS.make_transposed_fused_solve(
        MPPIConfig(nx=33, nu=2, K=8, T=3), linear_quadratic(torch.zeros(33, 2), torch.zeros(33)))
    assert wide.spec.model_id >= BL.GENERATED and wide.spec.act_ld > 0
    with pytest.raises(FS.FusedSolveUnavailable, match="at most 32"):
        FS.make_transposed_fused_solve(
            MPPIConfig(nx=33, nu=2, K=8, T=3, step_dependent_dynamics=True),
            linear_quadratic(torch.zeros(33, 2), torch.zeros(33)))
    with pytest.raises(ValueError, match="the config is"):
        FS.make_transposed_fused_solve(MPPIConfig(nx=3, nu=2, K=8, T=3), model)
    # the null-action gate, ported since: it builds, and its trailing
    # argument exists only with sample_null_action (JAX's TypeError both ways)
    gated = FS.make_transposed_fused_solve(
        dataclasses.replace(cfg, sample_null_action=True), model, null_dynamic_gate=True)
    assert gated.null_gate and not FS.make_transposed_fused_solve(
        cfg, model, null_dynamic_gate=True).null_gate
    args = ((1, 2), torch.zeros(2, 8), *([torch.zeros(6)] * 6), torch.tensor(1.0))
    assert gated(*args, 1)[3].shape == (8,)
    with pytest.raises(TypeError, match="null_dynamic_gate"):
        gated(*args)
    # a kernel terminal cost is taken, and any other callable the tracer
    # takes; one it refuses raises, naming the callable and the op
    term = quadratic_terminal(GOAL_NP, 2.0, 0.1)
    assert FS.make_transposed_fused_solve(cfg, model, terminal_final=term).tiles == "shared"
    assert FS.make_transposed_fused_solve(cfg, model, terminal_final=model.running_cost)
    with pytest.raises(BL.UnsupportedPrimitive, match="cannot be traced.*sort"):
        FS.make_transposed_fused_solve(
            cfg, model, terminal_final=lambda s, a: torch.sort(s, dim=-1).values[:, 0])


def test_fused_work_counts_inputs_once():
    """``chip_smoke.fused_work``, the bound's bytes: a stride-0 x0 is nx
    values, bits are read once, and the emitted perturbed actions are written
    once."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    K, T, nu, nx = 300, 4, 2, 2
    D = T * nu
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    x0_shared = torch.zeros(nx)[:, None].expand(nx, K)
    op = torch.ones(D)
    small = 5 * D + D + 1 + model.consts.numel() + K + D + 2
    ops_seed, b_seed = smoke.fused_work(cfg, model, (1, 2), x0_shared, op)
    assert b_seed == 4 * (nx + small)
    bits = torch.zeros((D, K), dtype=torch.int32)
    ops_bits, b_bits = smoke.fused_work(cfg, model, bits, torch.zeros(nx, K), op,
                                        emit_perturbed=True)
    assert b_bits == 4 * (nx * K + small + D * K + D * K)
    # seed mode adds Philox: 98 operations per 4 rows of every sample
    assert ops_seed - ops_bits == K * (D // 4) * 98


# variant, config: the two shapes that took the plain path before the kernel
# held its tiles in global memory and its device models 32 states and actions
ROUTES = [
    ("mppi_T100_nu3_rho", PS.make_mppi_step, dict(nx=2, nu=3, T=100, noise_rho=0.5)),
    ("smppi_T100_nu3_rho", PS.make_smppi_step, dict(nx=2, nu=3, T=100, noise_rho=0.5)),
    ("kmppi_T100_nu3_rho", PS.make_kmppi_step,
     dict(nx=2, nu=3, T=100, noise_rho=0.5, num_support_pts=50)),
    ("mppi_lq12", PS.make_mppi_step, dict(nx=12, nu=4, T=10, diag_sigma=True)),
    ("smppi_lq12", PS.make_smppi_step, dict(nx=12, nu=4, T=10, diag_sigma=True)),
    ("kmppi_lq12", PS.make_kmppi_step,
     dict(nx=12, nu=4, T=10, diag_sigma=True, num_support_pts=5)),
]


@pytest.mark.parametrize("factory,fields", [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_large_configs_route_fused(caplog, factory, fields):
    """T = 100, nu = 3 with ``noise_rho`` (D = 300) and a 12-state
    ``linear_quadratic`` reach the fused kernel with no warning."""
    nx, nu = fields["nx"], fields["nu"]
    rs = np.random.RandomState(0)
    model = linear_quadratic(torch.from_numpy(rs.randn(nx, nu).astype(np.float32) * 0.3),
                             torch.from_numpy(rs.randn(nx).astype(np.float32)))
    cfg = MPPIConfig(K=64, **fields)
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        fns = factory(cfg, model.dynamics, model.running_cost, use_pallas=True)
    assert fns.fused
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING], caplog.text


@pytest.mark.parametrize("variant", ["smppi", "kmppi"])
def test_fused_work_counts_variant_inputs_once(variant):
    """``chip_smoke.fused_work`` for SMPPI (as, two bound pairs, three
    scalars) and KMPPI (Dp drawn rows, the (D, Dp) interpolation operator,
    a Dp-row update)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    K, T, nu, nx, nsp = 300, 4, 2, 2, 2
    D, Dp = T * nu, nsp * nu
    R = Dp if variant == "kmppi" else D
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True,
                     num_support_pts=nsp if variant == "kmppi" else 0)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    x0 = torch.zeros(nx)[:, None].expand(nx, K)
    ops_seed, b_seed = smoke.fused_work(cfg, model, (1, 2), x0, torch.ones(R), variant=variant)
    vectors = 8 * D + 3 if variant == "smppi" else 4 * D + 4 * Dp + D * Dp + 1
    assert b_seed == 4 * (nx + vectors + R + model.consts.numel() + K + R + 2)
    bits = torch.zeros((R, K), dtype=torch.int32)
    ops_bits, b_bits = smoke.fused_work(cfg, model, bits, x0, torch.ones(R), variant=variant)
    assert b_bits - b_seed == 4 * R * K
    assert ops_seed - ops_bits == K * (-(-R // 4)) * 98


# ---------------------------------------------------------------------------
# Kernel A's samples a block: the rule, the device's SM count, the factories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,sms,S", [
    (10_000, 132, 32), (1_000, 132, 32), (500, 132, 32), (1, 132, 32),
    (16_384, 132, 32), (16_832, 132, 32), (16_833, 132, 64), (33_664, 132, 64),
    (33_665, 132, 128), (10_000, 78, 64), (10_000, 39, 128), (10_000, 40, 64),
    (100_000, 132, 128), (10_000, 160, 32),
])
def test_tile_samples_rule(K, sms, S):
    """The largest S of (32, 64, 128) whose ceil(K / S) blocks give each SM
    two blocks, else 32: a pure function of K and the SM count."""
    assert FS.tile_samples(K, sms) == S
    if S > FS.TILES[0]:
        assert -(-K // S) >= 2 * sms
    if S < FS.TILES[-1]:
        assert -(-K // (2 * S)) < 2 * sms


def test_sm_count_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FS.sm_count() == FS.H100_SMS == 132
    assert FS.FILL_BLOCKS == 2 * FS.H100_SMS


def test_sm_count_is_read_once_per_device(monkeypatch):
    reads = []

    class Props:
        multi_processor_count = 114

    def props(index):
        reads.append(index)
        return Props()

    monkeypatch.setattr(FS, "_sm_counts", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    assert FS.sm_count() == 114 and FS.sm_count() == 114
    assert reads == [1]
    # the factories take the rule on the current device's count
    cfg = MPPIConfig(nx=2, nu=2, K=10_000, T=3, diag_sigma=True)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    assert FS.make_transposed_fused_solve(cfg, model).tile_k == FS.tile_samples(10_000, 114) == 32
    assert FS.make_transposed_fused_solve(
        MPPIConfig(nx=2, nu=2, K=20_000, T=3, diag_sigma=True), model).tile_k == 64
    assert FS.make_transposed_batched_solve(cfg, 64, model).plant_group == FS.plant_group(
        64, -(-10_000 // 128), 2 * 114)


@pytest.mark.parametrize("factory", ["fused", "smppi", "kmppi"])
def test_factories_take_the_rule_or_a_forced_tile(factory):
    make = {"fused": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
            "kmppi": FS.make_transposed_kmppi_solve}[factory]
    cfg = MPPIConfig(nx=2, nu=2, K=1000, T=6, diag_sigma=True, num_support_pts=3)
    model = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
    assert make(cfg, model).tile_k == FS.tile_samples(1000, FS.sm_count())
    for S in FS.TILES:
        solve = make(cfg, model, tile_k=S)
        assert solve.tile_k == S and solve.blocks == -(-1000 // S)
    with pytest.raises(ValueError, match="tile_k"):
        make(cfg, model, tile_k=96)


def test_smem_bytes_of_kernel_a():
    """One (D, S + 1) tile for MPPI with a diagonal scale, two otherwise,
    after 32 + 2 * 128 + 512 floats, an operator panel of (128 / S) * 8
    rows of min(R, 160) floats where there is a product, and nine row vectors of D
    floats; at D = 300 with a full operator two tiles of 64 samples fit in
    the 227 KB a block may use, two of 128 do not."""
    head = 32 + 2 * 128 + 512 + 9 * 60
    assert FS.smem_bytes(FS.MPPI, 60, 60, False, 64) == (head + 60 * 65) * 4
    assert FS.smem_bytes(FS.MPPI, 60, 60, True, 32) == (head + 32 * 60 + 2 * 60 * 33) * 4
    assert FS.smem_bytes(FS.KMPPI, 60, 30, False, 32) == (head + 32 * 30 + 2 * 60 * 33) * 4
    assert FS.smem_bytes(FS.KMPPI, 60, 15, False, 64) == (head + 16 * 15 + 2 * 60 * 65) * 4
    assert FS.smem_bytes(FS.SMPPI, 300, 300, True, 64) <= FS.MAX_SMEM_BYTES
    assert FS.smem_bytes(FS.MPPI, 300, 300, True, 32) == (
        800 + 32 * 160 + 9 * 300 + 2 * 300 * 33) * 4 <= FS.MAX_SMEM_BYTES // 2
    assert FS.smem_bytes(FS.MPPI, 300, 300, True, 128) > FS.MAX_SMEM_BYTES
