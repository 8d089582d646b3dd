"""Elite reuse (``num_elites``) in the port against the JAX package on the CPU.

* the fused kernel's plain version with the elites operand
  (``fused_solve_plain(elites=)``) against JAX's
  ``make_transposed_fused_solve(emit_perturbed=True)`` with its (D, 128)
  operand in Pallas interpret mode, on the same int32 bits
  (``tests/test_pallas_transposed.py:1172-1214``): the null row on and off,
  antithetic pairs, the window's edge (127 elites after the null row) and the
  terminal cost ``quadratic_terminal``;
* the fused MPPI step with elites over three chained commands (the kernel's
  plain version on the CPU) against chained JAX interpret-mode kernel calls
  and JAX's refresh (``pytorch_mppi_tpu/ops/solve.py:1291-1292``);
* plain and legacy-route MPPI with elites against JAX over five commands on
  the same noise (``sample_noise_flat`` or the normals patched on both
  sides, the JAX side under ``jax.disable_jit``): the null row on and off,
  ``num_iterations = 3`` and adaptive covariance (the elite rows masked);
  float64 at 1e-10 and float32 at the parity tolerances;
* the tie rule of the refresh, the controller's shift, horizon change and
  reset of the elites, and the gates, the warning and the operand checks.

Float32 parity: costs rtol 2e-5 / atol 1e-5, commands and updates rtol 2e-4
/ atol 2e-6, perturbed actions rtol 1e-5 / atol 1e-6
(``tests/test_pallas_transposed.py:102-107``).
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import MPPIState as JState
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig, MPPIState
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic, quadratic_terminal
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy, state_from_numpy

torch.set_num_threads(1)

F32 = jnp.float32
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
TERM_GOAL = np.array([1.5, -0.5], np.float32)
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)
TOL_P = dict(rtol=1e-5, atol=1e-6)
TOL_64 = dict(rtol=1e-10, atol=1e-10)
LQ = linear_quadratic(torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP))
_JB, _JG, _JTG = (jnp.asarray(v, F32) for v in (B_NP, GOAL_NP, TERM_GOAL))


def jdyn(s, a):
    return s + a @ _JB.T


def jcost(s, a):
    return ((_JG - s) ** 2).sum(axis=-1)


def jfterm(s, a):
    return 10.0 * ((s - _JTG) ** 2).sum(axis=-1) + 0.1 * (a ** 2).sum(axis=-1)


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _el_operand(elites2, off):
    """JAX's (D, 128) operand: elite j at column off + j."""
    D = elites2.shape[1]
    return jnp.zeros((D, 128), F32).at[:, off:off + elites2.shape[0]].set(
        jnp.asarray(elites2).T)


# -- (a) the kernel's plain version with the elites operand -------------------

# name, E, K, config flags, terminal
KERNEL_CASES = [
    ("null_off", 3, 256, {}, False),
    ("null_on", 3, 256, {"sample_null_action": True}, False),
    ("antithetic_null", 4, 256, {"antithetic": True, "sample_null_action": True}, False),
    ("window_edge_127_null", 127, 256, {"sample_null_action": True}, False),
    ("terminal", 2, 200, {"u_scale": 1.5}, True),
]


@pytest.mark.parametrize("E,Kk,flags,terminal", [c[1:] for c in KERNEL_CASES],
                         ids=[c[0] for c in KERNEL_CASES])
def test_plain_kernel_with_elites_matches_jax_kernel(E, Kk, flags, terminal):
    """Cost, delta, m, s and the emitted set on the same bits and elites; the
    emitted elite columns are the clamped elites exactly."""
    rs = np.random.RandomState(11)
    Tk, nu = 6, 2
    D = Tk * nu
    jcfg = JConfig(nx=2, nu=nu, K=Kk, T=Tk, dtype=F32, diag_sigma=True, num_elites=E, **flags)
    cfg = MPPIConfig(nx=2, nu=nu, K=Kk, T=Tk, diag_sigma=True, num_elites=E, **flags)
    wt = JS.wrap_final_cost(jfterm) if terminal else None
    solve_j = PR.make_transposed_fused_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False,
        emit_perturbed=True, terminal_final=wt)
    solve_p = FS.make_transposed_fused_solve(
        cfg, LQ, pair_block=solve_j.block_k, emit_perturbed=True,
        terminal_final=quadratic_terminal(TERM_GOAL, 10.0, 0.1) if terminal else None)
    assert solve_p.num_elites == E and solve_p.elite_off == int(cfg.sample_null_action)
    cols = solve_j.K_pad // 2 if cfg.antithetic else solve_j.K_pad
    bits = _rand_bits(rs, (D, cols))
    full = lambda v: np.full(D, v, np.float32)  # noqa: E731
    U2 = (rs.randn(D) * 0.1).astype(np.float32)
    x0T = np.broadcast_to(np.array([-3.0, -2.0], np.float32)[:, None], (2, Kk))
    operands = (x0T, U2, full(0.8), full(0.05), full(-1.0), full(1.0), U2 * 0.7,
                np.float32(0.8))
    elites2 = (rs.randn(E, D) * 2.0).astype(np.float32)  # some beyond the bounds
    off = solve_p.elite_off
    out_j = solve_j(jnp.asarray(bits), *(jnp.asarray(v) for v in operands),
                    _el_operand(elites2, off))
    out_p = solve_p(torch.from_numpy(bits), *(torch.from_numpy(np.array(v)) for v in operands),
                    torch.from_numpy(elites2))
    delta_j, m_j, s_j, ct_j, pert_j = (np.asarray(v) for v in out_j)
    delta_p, m_p, s_p, ct_p, pert_p = (v.numpy() for v in out_p)
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(m_p, m_j, **TOL_C)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, **TOL_U)
    np.testing.assert_allclose(pert_p, pert_j, **TOL_P)
    assert np.array_equal(pert_p[:, off:off + E], np.clip(elites2, -1.0, 1.0).T)
    if cfg.sample_null_action:
        assert np.array_equal(pert_p[:, 0], np.zeros(D, np.float32))
    # the operand moved the costs of its samples and no others
    bare = FS.make_transposed_fused_solve(
        MPPIConfig(nx=2, nu=nu, K=Kk, T=Tk, diag_sigma=True, **flags), LQ,
        pair_block=solve_j.block_k,
        terminal_final=quadratic_terminal(TERM_GOAL, 10.0, 0.1) if terminal else None)
    ct_bare = bare(torch.from_numpy(bits),
                   *(torch.from_numpy(np.array(v)) for v in operands))[3].numpy()
    moved = ~np.isclose(ct_bare, ct_p, rtol=0, atol=0)
    assert not moved[:off].any() and not moved[off + E:].any()


def test_elites_operand_checks():
    """JAX's TypeErrors for a missing or misshapen operand, on either
    device; a solve built without elites takes none."""
    cfg = MPPIConfig(nx=2, nu=2, K=64, T=4, diag_sigma=True, num_elites=2)
    solve = FS.make_transposed_fused_solve(cfg, LQ)
    D = 8
    args = (torch.zeros(D, 64, dtype=torch.int32), torch.zeros(2, 64), torch.zeros(D),
            torch.ones(D), torch.zeros(D), -torch.ones(D), torch.ones(D), torch.zeros(D),
            torch.tensor(1.0))
    with pytest.raises(TypeError, match="elites operand"):
        solve(*args)
    with pytest.raises(TypeError, match=r"elites operand must be \(E, D\)"):
        solve(*args, torch.zeros(3, D))
    with pytest.raises(TypeError, match="elites operand"):
        solve.plain(*args)
    out = solve(*args, torch.zeros(2, D))
    assert out[3].shape == (64,)
    bare = FS.make_transposed_fused_solve(dataclasses_replace(cfg, num_elites=0), LQ)
    with pytest.raises(TypeError, match="without num_elites"):
        bare(*args, torch.zeros(2, D))


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("null", [False, True], ids=["null_off", "null_on"])
def test_injection_window(null):
    """JAX's window: the null row and the elites within min(K, 128)."""
    off = int(null)
    ok = MPPIConfig(nx=2, nu=2, K=256, T=4, num_elites=128 - off, sample_null_action=null)
    assert FS.make_transposed_fused_solve(ok, LQ).num_elites == 128 - off
    wide = MPPIConfig(nx=2, nu=2, K=256, T=4, num_elites=129 - off, sample_null_action=null)
    with pytest.raises(FS.FusedSolveUnavailable, match="injection window"):
        FS.make_transposed_fused_solve(wide, LQ)
    small = MPPIConfig(nx=2, nu=2, K=16, T=4, num_elites=17 - off, sample_null_action=null)
    with pytest.raises(FS.FusedSolveUnavailable, match=r"min\(K, 128\)"):
        FS.make_transposed_fused_solve(small, LQ)
    for cfg in (ok, wide):
        jcfg = JConfig(nx=2, nu=2, K=256, T=4, dtype=F32, num_elites=cfg.num_elites,
                       sample_null_action=null, fused_artifacts=True)
        assert FS.transposed_eligible(dataclasses_replace(cfg, fused_artifacts=True)) == \
            PR.transposed_eligible(jcfg, False, False, None)


# -- (b) the fused step over chained commands ---------------------------------

KF, TF, E_F = 256, 5, 3
FIELDS = dict(noise_mu=np.full(2, 0.05, np.float32), noise_sigma=np.diag([0.8, 1.2]).astype(
    np.float32), lambda_=np.float32(0.8), u_min=np.full(2, -1.0, np.float32),
    u_max=np.full(2, 1.0, np.float32), u_init=np.zeros(2, np.float32))


@pytest.mark.parametrize("null", [False, True], ids=["null_off", "null_on"])
def test_fused_elite_step_matches_chained_jax_kernels(monkeypatch, null):
    """Three commands of the fused step (one launch each, the plain version
    here) against three JAX interpret-mode kernel calls, each fed the last
    command's shifted elites as its operand and refreshed by JAX's top-k of
    the emitted set."""
    nu, D = 2, TF * 2
    flags = dict(sample_null_action=null, num_elites=E_F, fused_artifacts=True)
    jcfg = JConfig(nx=2, nu=nu, K=KF, T=TF, dtype=F32, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=2, nu=nu, K=KF, T=TF, diag_sigma=True, **flags)
    solve_j = PR.make_transposed_fused_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False,
        emit_perturbed=True)
    rs = np.random.RandomState(8)
    bits = [_rand_bits(rs, (D, solve_j.K_pad)) for _ in range(3)]
    fed = iter(bits)
    monkeypatch.setattr(FS, "key_to_seed", lambda s: torch.from_numpy(next(fed)))
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas=True)
    assert fns.fused

    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    params = params_from_numpy(**FIELDS)
    U0 = (rs.randn(TF, nu) * 0.3).astype(np.float32)
    el0 = np.broadcast_to(U0, (E_F, TF, nu)).copy()  # the cold start: E copies
    state = state_from_numpy(U0, seed=0, elites=el0)
    U, el = jnp.asarray(U0), jnp.asarray(el0)
    x0 = np.array([-3.0, -2.0], np.float32)
    off = int(null)
    for b in bits:
        U = JS._shift_U(U, jp.u_init)
        el = JS._shift_elites(el, jp.u_init)
        sigma_inv, op, mu_t, lo2, hi2 = JS._transposed_operands(
            jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, TF, nu, F32)
        a_flat = (jp.lambda_ * (U @ sigma_inv.T)).reshape(D)
        delta, m, s, ct_j, pert_j = solve_j(
            jnp.asarray(b), JS._x0_to_lanes(jnp.asarray(x0), KF), U.reshape(D), op, mu_t,
            lo2, hi2, a_flat, jp.lambda_, _el_operand(np.asarray(el).reshape(E_F, D), off))
        U = U + (delta / s).reshape(TF, nu)
        _, eidx = lax.top_k(-ct_j, E_F)
        el = pert_j[:, eidx].T.reshape(E_F, TF, nu)

        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(ct_j), **TOL_C)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(U), **TOL_U)
        # from the second command on, the perturbed rows are U + noise with
        # the U of the last command: they carry its absolute error
        tol_pert = dict(rtol=TOL_U["rtol"],
                        atol=TOL_U["atol"] + TOL_U["rtol"] * float(np.abs(U).max()))
        np.testing.assert_allclose(state.elites.numpy(), np.asarray(el), **tol_pert)
        np.testing.assert_allclose(art.perturbed_action.numpy().reshape(KF, D),
                                   np.asarray(pert_j).T, **tol_pert)
        x0 = x0 + 0.3 * action.numpy()
    assert state.counter == 3


# -- (c) plain and legacy MPPI against the JAX controller ---------------------

K, T = 32, 5
DT = {"f32": (jnp.float32, torch.float32, np.float32),
      "f64": (jnp.float64, torch.float64, np.float64)}


def _models(dt):
    jdt, tdt, _ = DT[dt]
    jB, jG = jnp.asarray(B_NP, jdt), jnp.asarray(GOAL_NP, jdt)
    pB, pG = torch.tensor(B_NP, dtype=tdt), torch.tensor(GOAL_NP, dtype=tdt)
    return ((lambda s, a: s + a @ jB.T, lambda s, a: ((jG - s) ** 2).sum(axis=-1)),
            (lambda s, a: s + a @ pB.T, lambda s, a: ((pG - s) ** 2).sum(-1)))


def _noise_bank(monkeypatch, dt):
    jdt, tdt, ndt = DT[dt]
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        (jbank.randn(K, T * 2) * 0.6).astype(ndt)))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        (pbank.randn(K, T * 2) * 0.6).astype(ndt)))


def _normal_bank(monkeypatch):
    """The same N(0, 1) draws for the i-th request on either side, before each
    side's own (adapted) sigma."""
    jbank, pbank = np.random.RandomState(4), np.random.RandomState(4)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(
        jbank.randn(*shape), dtype or F32))
    monkeypatch.setattr(PS, "standard_normal", lambda gen, shape, dtype, device: torch.tensor(
        pbank.randn(*shape), dtype=dtype, device=device))


# name, dtype, keywords, normals (adaptive covariance draws through its sigma)
PLAIN_CASES = [
    ("f64_null_off", "f64", dict(num_elites=3), False),
    ("f64_null_on", "f64", dict(num_elites=3, sample_null_action=True), False),
    ("f64_iter3", "f64", dict(num_elites=4, num_iterations=3, sample_null_action=True), False),
    ("f64_adaptive_iter3", "f64", dict(num_elites=3, num_iterations=3,
                                       adaptive_covariance=True, sample_null_action=True),
     True),
    ("f32_null_on", "f32", dict(num_elites=3, sample_null_action=True), False),
]


@pytest.mark.parametrize("dt,kw,normals", [c[1:] for c in PLAIN_CASES],
                         ids=[c[0] for c in PLAIN_CASES])
def test_plain_elites_match_jax_controller(monkeypatch, dt, kw, normals):
    """Five chained commands: costs, commands, U and the stored elites."""
    jdt, tdt, ndt = DT[dt]
    (jd, jc_), (pd, pc_) = _models(dt)
    common = dict(num_samples=K, horizon=T, lambda_=1.0, **kw)
    sigma = np.array([[0.6, 0.2], [0.2, 0.5]], ndt)
    jc = J.MPPI(jd, jc_, 2, jnp.asarray(sigma), u_min=-jnp.ones(2, jdt),
                u_max=jnp.ones(2, jdt), **common)
    pc = P.MPPI(pd, pc_, 2, torch.from_numpy(sigma), u_min=-torch.ones(2, dtype=tdt),
                u_max=torch.ones(2, dtype=tdt), device="cpu", **common)
    U0 = (np.random.RandomState(1).randn(T, 2) * 0.3).astype(ndt)
    jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    # the cold start: E copies of the nominal on both sides
    jc._state = jc._state._replace(elites=jc._initial_elites(jc.U))
    pc._state = pc._state._replace(elites=pc._initial_elites(pc.U))
    (_normal_bank if normals else _noise_bank)(monkeypatch, *(() if normals else (dt,)))
    tol_c = TOL_64 if dt == "f64" else TOL_C
    tol_u = TOL_64 if dt == "f64" else TOL_U
    x = np.array([-1.0, 0.5], ndt)
    with jax.disable_jit():
        for _ in range(5):
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total), **tol_c)
            np.testing.assert_allclose(ap, aj, **tol_u)
            np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **tol_u)
            np.testing.assert_allclose(pc._state.elites.numpy(), np.asarray(jc._state.elites),
                                       **tol_u)
            x = (x + 0.2 * ap).astype(ndt)
    assert pc._state.elites.shape == (kw["num_elites"], T, 2)


@pytest.mark.parametrize("null", [False, True], ids=["null_off", "null_on"])
def test_legacy_elites_match_jax(monkeypatch, null):
    """The legacy route (the rollout and the weighted update kernels' plain
    versions) with elites against JAX's legacy kernels in interpret mode, on
    the same normals, two iterations a command: the elites are written
    before the kernels and refreshed from the clamped rows."""
    Kl, Tl, E = 128, 5, 3
    flags = dict(num_elites=E, num_iterations=2, sample_null_action=null, diag_sigma=True)
    jcfg = JConfig(nx=2, nu=2, K=Kl, T=Tl, dtype=F32, **flags)
    jfns = JS.make_mppi_step(jcfg, jdyn, jcost, jit=False, use_pallas="rollout")
    cfg = MPPIConfig(nx=2, nu=2, K=Kl, T=Tl, **flags)
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas="rollout")
    assert fns.fused
    U0 = (np.random.RandomState(1).randn(Tl, 2) * 0.3).astype(np.float32)
    el0 = np.broadcast_to(U0, (E, Tl, 2)).copy()
    jp = JParams(**{k: jnp.asarray(v, F32) for k, v in FIELDS.items()})
    jstate = JState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0), elites=jnp.asarray(el0))
    params, state = params_from_numpy(**FIELDS), state_from_numpy(U0, 0, elites=el0)
    _normal_bank(monkeypatch)
    x0 = np.array([-3.0, -2.0], np.float32)
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jp, jstate, jnp.asarray(x0))
        state, action, art = fns.step(params, state, torch.from_numpy(x0))
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **TOL_C)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **TOL_U)
        np.testing.assert_allclose(state.elites.numpy(), np.asarray(jstate.elites), **TOL_U)
        x0 = x0 + 0.2
    assert state.counter == 6


# -- (d) the tie rule ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_elites_break_ties_as_lax_top_k(seed):
    """The lowest costs, ties lowest index first, as ``lax.top_k(-cost)``:
    costs with many ties."""
    rs = np.random.RandomState(seed)
    cost = rs.randint(0, 6, size=300).astype(np.float32)
    for E in (1, 4, 17, 60):
        _, want = lax.top_k(-jnp.asarray(cost), E)
        got = PS._top_elites(torch.from_numpy(cost), E)
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused_plain"])
def test_first_command_ties(use_pallas):
    """On the first command the cold-start elites are E identical rows with
    equal costs: with a noise so wide that they are the best rows, the
    refresh takes them in index order, as JAX's top_k on the same costs."""
    E = 4
    c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 400.0, num_samples=64,
               horizon=5, lambda_=1.0, seed=2, num_elites=E, device="cpu",
               use_pallas=use_pallas, fused_artifacts=use_pallas)
    assert c._fns.fused == use_pallas
    c.U = torch.full((5, 2), 0.3)
    c._state = c._state._replace(elites=c._initial_elites(c.U))
    c.command(torch.tensor([1.0, 1.0]), shift_nominal_trajectory=False)
    cost = c.cost_total
    assert bool((cost[:E] == cost[0]).all())
    idx = PS._top_elites(cost, E)
    _, want = lax.top_k(-jnp.asarray(cost.numpy()), E)
    assert idx.tolist() == np.asarray(want).tolist() == list(range(E))
    assert torch.equal(c._state.elites, c.perturbed_action[idx])


# -- (e) the controller's maintenance of the elites ---------------------------

def _elite_ctrl(**kw):
    return P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=16, horizon=6,
                  seed=0, num_elites=2, device="cpu", **kw)


def test_shift_nominal_trajectory_shifts_elites():
    """JAX's ``test_shift_helper_shifts_elites``, and the shift against JAX's
    ``_shift_elites``."""
    c = _elite_ctrl()
    c.command(torch.zeros(2))
    before = c._state.elites.clone()
    c.shift_nominal_trajectory()
    after = c._state.elites
    assert torch.equal(after[:, :-1], before[:, 1:])
    assert torch.equal(after[:, -1], c.u_init.expand(2, 2))
    want = JS._shift_elites(jnp.asarray(before.numpy()), jnp.asarray(c.u_init.numpy()))
    np.testing.assert_array_equal(after.numpy(), np.asarray(want))


def test_change_horizon_and_reset_restart_elites():
    """JAX's ``test_reset_and_change_horizon``."""
    c = _elite_ctrl()
    c.command(torch.zeros(2))
    c.change_horizon(9)
    assert c._state.elites.shape == (2, 9, 2)
    assert torch.equal(c._state.elites[0], c._state.U)
    c.command(torch.zeros(2))
    c.reset()
    assert torch.equal(c._state.elites[1], c._state.U)
    c.change_horizon(6)
    assert c._state.elites.shape == (2, 6, 2)


def test_elites_off_by_default():
    c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=8, horizon=5,
               device="cpu")
    assert c._state.elites is None
    c.command(torch.zeros(2))
    assert c._state.elites is None
    c.shift_nominal_trajectory()
    c.reset()
    assert c._state.elites is None


def test_elites_composes_with_iterations_and_adaptive_covariance():
    """JAX's ``test_composes_with_num_iterations_and_adaptive_cov``: the
    elite rows are masked from the estimate and the elites stay finite."""
    c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2) * 0.25, num_samples=16,
               horizon=6, seed=0, num_elites=3, num_iterations=3, adaptive_covariance=True,
               device="cpu")
    x = torch.tensor([-2.0, 2.0])
    for _ in range(4):
        x = LQ.dynamics(x[None], c.command(x)[None])[0]
    assert bool(torch.isfinite(x).all() and torch.isfinite(c._state.elites).all())
    assert c._state.counter == 12


# -- (f) gates, warnings -------------------------------------------------------

def _jax_and_port_error(fields, variant="mppi", **kw):
    """The ValueError text of each side's factory on the same config."""
    texts = []
    for make, cfg, dyn, cost in ((JS, JConfig(**fields), jdyn, jcost),
                                 (PS, MPPIConfig(**fields), LQ.dynamics, LQ.running_cost)):
        with pytest.raises(ValueError) as err:
            if variant == "batched":
                make.make_batched_step(cfg, 2, dyn, cost)
            else:
                getattr(make, f"make_{variant}_step")(cfg, dyn, cost, **kw)
        texts.append(str(err.value))
    return texts


@pytest.mark.parametrize("variant", ["smppi", "kmppi", "batched"])
def test_elites_only_on_mppi(variant):
    fields = dict(nx=2, nu=2, K=16, T=5, num_elites=2,
                  num_support_pts=3 if variant == "kmppi" else 0)
    jt, pt = _jax_and_port_error(fields, variant)
    assert pt == jt and "only supported on MPPI" in pt


@pytest.mark.parametrize("cls,kw", [(P.SMPPI, dict(w_action_seq_cost=0.1)),
                                    (P.KMPPI, dict(num_support_pts=4))],
                         ids=["smppi", "kmppi"])
def test_controllers_reject_elites(cls, kw):
    with pytest.raises(ValueError, match="only supported on MPPI"):
        cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=8, horizon=8,
            num_elites=2, device="cpu", **kw)


@pytest.mark.parametrize("fields", [dict(num_elites=-1),
                                    dict(num_elites=15, sample_null_action=True),
                                    dict(num_elites=16)],
                         ids=["negative", "fills_K_with_null", "fills_K"])
def test_elite_count_gates_match_jax(fields):
    jt, pt = _jax_and_port_error(dict(nx=2, nu=2, K=16, T=5, **fields))
    assert pt == jt


def test_unwired_sampler_count_does_not_reject():
    """JAX's ``test_unwired_specific_count_does_not_reject``."""
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=4, num_elites=2, num_specific_trajectories=6,
                     diag_sigma=True)
    PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost)
    with pytest.raises(ValueError, match="fills all K"):
        PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost,
                          sample_trajectories=lambda s, i: torch.zeros(6, 4, 2))


def test_unseeded_state_raises():
    """JAX's ``test_ops_layer_elites_state_must_be_seeded``, on both steps."""
    cfg = MPPIConfig(nx=2, nu=2, K=16, T=5, num_elites=2, diag_sigma=True)
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost)
    params = params_from_numpy(np.zeros(2), np.eye(2), 1.0, np.full(2, -np.inf),
                               np.full(2, np.inf), np.zeros(2))
    state = MPPIState(U=torch.zeros(5, 2), seed=0)
    for step in (fns.step, fns.step_no_shift):
        with pytest.raises(ValueError, match="state.elites is None"):
            step(params, state, torch.zeros(2))


def test_fused_without_artifacts_names_the_flag(caplog):
    """JAX's ``test_elites_without_artifacts_names_the_fix``: the plain path,
    with a warning that names ``fused_artifacts``."""
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=16, horizon=4,
                   num_elites=2, use_pallas=True, device="cpu")
    assert not c._fns.fused
    assert "fused_artifacts=True" in caplog.text
    c.command(torch.zeros(2))
    assert c.noise is not None


def test_fused_with_artifacts_keeps_the_kernel():
    c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=64, horizon=4,
               num_elites=2, use_pallas=True, fused_artifacts=True, device="cpu")
    assert c._fns.fused
    c.command(torch.zeros(2))
    assert c._state.elites.shape == (2, 4, 2)
    assert bool(torch.isfinite(c._state.elites).all())


def test_fused_window_overflow_takes_the_plain_path(caplog):
    """More elites than JAX's window: ineligible, the plain path."""
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        c = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=256, horizon=4,
                   num_elites=128, sample_null_action=True, use_pallas=True,
                   fused_artifacts=True, device="cpu")
    assert not c._fns.fused
    assert "ineligible" in caplog.text
