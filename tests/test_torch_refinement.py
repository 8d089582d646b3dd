"""Gradient refinement of the nominal (``gradient_refinement_steps``) in the
port against the JAX package on the CPU.

* the port's ``make_nominal_refiner`` (``torch.autograd`` through the plain
  rollout) against JAX's (``jax.grad`` through its scan) on the same U and
  x0 in float64 at 1e-9: a shared x0, a (Kx, nx) batch of starts, the two
  terminal hooks, ``u_scale``, a specific-dynamics hook, and M = 3 rollouts
  with the variance cost and CVaR (step-dependent "stochastic" dynamics that
  add a numpy table indexed by ``t`` on both sides and ignore the key or
  generator);
* the MPPI controller with five steps over chained commands against the JAX
  controller on the same noise (the JAX side under ``jax.disable_jit``):
  float64 element by element, float32 by J(U) (where g is near 0, Adam's
  first step is lr·sign(g), and summation order can flip that sign);
* refinement on the fused route (the kernel's plain version) against JAX's
  interpret-mode kernel call followed by JAX's refiner;
* the fixed refinement seed of stochastic dynamics, the gates, and JAX's
  behaviour checks (``tests/test_extensions.py:595-722``) run on the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as J
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig, MPPIState
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

F32, F64 = jnp.float32, jnp.float64
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
TERM_GOAL = np.array([1.5, -0.5])
TOL_64 = dict(rtol=1e-9, atol=1e-9)
TOL_C = dict(rtol=2e-5, atol=1e-5)
LQ = linear_quadratic(torch.tensor(B_NP, dtype=torch.float32),
                      torch.tensor(GOAL_NP, dtype=torch.float32))
DT = {"f32": (F32, torch.float32, np.float32), "f64": (F64, torch.float64, np.float64)}


def _models(dt, table=None):
    """JAX's and the port's dynamics, running cost (with an action term),
    terminal costs and hook in one dtype; with ``table`` ((T, M·K, nx)) the
    dynamics are step-dependent and stochastic and add ``table[t]``."""
    jdt, tdt, _ = DT[dt]
    jB, jG, jTG = (jnp.asarray(v, jdt) for v in (B_NP, GOAL_NP, TERM_GOAL))
    pB, pG, pTG = (torch.tensor(v, dtype=tdt) for v in (B_NP, GOAL_NP, TERM_GOAL))
    if table is None:
        jdyn = lambda s, a: s + a @ jB.T  # noqa: E731
        pdyn = lambda s, a: s + a @ pB.T  # noqa: E731
        jcost = lambda s, a: ((jG - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)  # noqa: E731
        pcost = lambda s, a: ((pG - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)  # noqa: E731
    else:
        jt, pt = jnp.asarray(table, jdt), torch.tensor(table, dtype=tdt)
        jdyn = lambda s, a, t, key: s + a @ jB.T + jt[t]  # noqa: E731
        pdyn = lambda s, a, t, rng: s + a @ pB.T + pt[t]  # noqa: E731
        jcost = lambda s, a, t: ((jG - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)  # noqa: E731
        pcost = lambda s, a, t: ((pG - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)  # noqa: E731
    return dict(
        jdyn=jdyn, pdyn=pdyn, jcost=jcost, pcost=pcost,
        jfinal=lambda s, a: 5.0 * ((s - jTG) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1),
        pfinal=lambda s, a: 5.0 * ((s - pTG) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1),
        jstate=lambda st, ac: 3.0 * ((st[..., -1, :] - jTG) ** 2).sum(-1),
        pstate=lambda st, ac: 3.0 * ((st[..., -1, :] - pTG) ** 2).sum(-1),
        jhook=lambda n, s, a, t: n - 0.1 * (n - s) + 0.01 * a[..., :1],
        phook=lambda n, s, a, t: n - 0.1 * (n - s) + 0.01 * a[..., :1])


def _params(dt, lo=-1.0, hi=1.0):
    jdt, tdt, ndt = DT[dt]
    fields = dict(noise_mu=np.zeros(2, ndt), noise_sigma=np.eye(2, dtype=ndt),
                  lambda_=ndt(1.0), u_min=np.full(2, lo, ndt), u_max=np.full(2, hi, ndt),
                  u_init=np.zeros(2, ndt))
    return (JParams(**{k: jnp.asarray(v, jdt) for k, v in fields.items()}),
            params_from_numpy(**fields, dtype=tdt))


# name, config fields, x0 rows (0: (nx,)), hooks
REFINER_CASES = [
    ("x0_shared", {}, 0, ()),
    ("x0_batch", {}, 4, ()),
    ("terminal_final", {}, 0, ("final",)),
    ("terminal_state", {"has_terminal_cost": True}, 0, ("state",)),
    ("u_scale", {"u_scale": 2.0}, 3, ()),
    ("specific_dynamics", {}, 0, ("hook",)),
    ("M3_cvar_variance", {"M": 3, "risk_alpha": 0.5, "rollout_var_cost": 0.3,
                          "stochastic_dynamics": True, "step_dependent_dynamics": True}, 2,
     ("final",)),
]


@pytest.mark.parametrize("fields,rows,hooks", [c[1:] for c in REFINER_CASES],
                         ids=[c[0] for c in REFINER_CASES])
def test_refiner_matches_jax(fields, rows, hooks):
    """Ten projected-Adam steps on the same U and x0, float64."""
    rs = np.random.RandomState(2)
    Tr = 6
    base = dict(nx=2, nu=2, K=8, T=Tr, gradient_refinement_steps=10,
                gradient_refinement_lr=0.1, **fields)
    jcfg, cfg = JConfig(dtype=F64, **base), MPPIConfig(dtype=torch.float64, **base)
    M = base.get("M", 1)
    table = (rs.randn(Tr, M * max(rows, 1), 2) * 0.1 if fields.get("stochastic_dynamics")
             else None)
    m = _models("f64", table)
    jfinal = JS.wrap_final_cost(m["jfinal"]) if "final" in hooks else None
    pfinal = PS.wrap_final_cost(m["pfinal"]) if "final" in hooks else None
    refine_j = JS.make_nominal_refiner(
        jcfg, JS.wrap_dynamics(jcfg, m["jdyn"]), JS.wrap_cost(jcfg, m["jcost"]),
        m["jstate"] if "state" in hooks else None, m["jhook"] if "hook" in hooks else None,
        terminal_final_cost=jfinal)
    refine_p = PS.make_nominal_refiner(
        cfg, PS.wrap_dynamics(cfg, m["pdyn"]), PS.wrap_cost(cfg, m["pcost"]),
        m["pstate"] if "state" in hooks else None, m["phook"] if "hook" in hooks else None,
        pfinal)
    jp, pp = _params("f64")
    U = rs.randn(Tr, 2) * 0.5
    x0 = rs.randn(rows, 2) if rows else np.array([-1.0, 0.5])
    want = refine_j(jp, jnp.asarray(U), jnp.asarray(x0), jax.random.PRNGKey(0))
    got = refine_p(pp, torch.tensor(U), torch.tensor(x0), seed=123)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_64)
    assert not got.requires_grad
    assert float(got.abs().max()) <= 1.0
    assert not np.allclose(got.numpy(), np.clip(U, -1, 1))  # it moved


def test_refiner_runs_under_no_grad():
    """The descent takes its own gradients inside ``torch.no_grad()``, on a
    detached copy: the caller's U is untouched and gets no graph."""
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=5, gradient_refinement_steps=3)
    refine = PS.make_nominal_refiner(cfg, PS.wrap_dynamics(cfg, LQ.dynamics),
                                     PS.wrap_cost(cfg, LQ.running_cost))
    _, pp = _params("f32")
    U = torch.zeros(5, 2, requires_grad=True)
    with torch.no_grad():
        out = refine(pp, U, torch.tensor([-1.0, 0.5]))
    assert U.grad is None and not out.requires_grad
    assert not torch.equal(out, U.detach())


def test_refiner_under_vmap_equals_the_eager_form():
    """Inside ``torch.func.vmap`` the descent takes ``torch.func.grad`` of J
    (the population evaluator's form), outside ``torch.autograd.grad`` on a
    detached copy (the command's and the artifact's): the same numbers,
    float64 at 1e-12."""
    cfg = MPPIConfig(nx=2, nu=2, K=8, T=5, gradient_refinement_steps=3,
                     dtype=torch.float64)
    refine = PS.make_nominal_refiner(cfg, PS.wrap_dynamics(cfg, LQ.dynamics),
                                     PS.wrap_cost(cfg, LQ.running_cost))
    _, pp = _params("f64")
    Us = torch.tensor(np.random.RandomState(5).uniform(-1, 1, (3, 5, 2)))
    x0 = torch.tensor([-1.0, 0.5], dtype=torch.float64)
    vmapped = torch.func.vmap(lambda U: refine(pp, U, x0))(Us)
    torch.testing.assert_close(vmapped, torch.stack([refine(pp, U, x0) for U in Us]),
                               rtol=1e-12, atol=1e-12)


def test_export_still_mistraces_func_grad():
    """Why the command keeps the eager form of the refiner's gradient: a
    non-strict ``torch.export`` of ``torch.func.grad`` lifts the grad's
    input as a constant, and the loaded program does not return the
    gradient at a new input.  When this test fails, ``torch.export``
    records ``torch.func.grad``, and ``make_nominal_refiner`` can take the
    functional form everywhere."""

    class Grad(torch.nn.Module):
        def forward(self, u):
            return torch.func.grad(lambda v: (v * v).sum())(u)

    program = torch.export.export(Grad(), (torch.tensor([1.0, 2.0, 3.0]),), strict=False)
    u = torch.tensor([5.0, 6.0, 7.0])
    try:
        got = program.module()(u)
    except Exception:  # noqa: BLE001 - any refusal is a mistrace too
        return
    right = (type(got) is torch.Tensor
             and torch.equal(got, 2 * u))
    assert not right


# -- the controller over chained commands --------------------------------------

K, T = 32, 5


def _noise_bank(monkeypatch, ndt):
    jbank, pbank = np.random.RandomState(3), np.random.RandomState(3)
    monkeypatch.setattr(JS, "sample_noise_flat", lambda *a, **k: jnp.asarray(
        (jbank.randn(K, T * 2) * 0.6).astype(ndt)))
    monkeypatch.setattr(PS, "sample_noise_flat", lambda *a, **k: torch.from_numpy(
        (pbank.randn(K, T * 2) * 0.6).astype(ndt)))


def _J(U, x0, action_weight=0.1):
    """The nominal's rollout cost in float64: the refiner's objective, with
    the running cost's action term of ``_models`` (0 for ``LQ``)."""
    B, G = torch.tensor(B_NP), torch.tensor(GOAL_NP)
    s, c = torch.tensor(np.asarray(x0), dtype=torch.float64), 0.0
    for u in torch.tensor(np.asarray(U), dtype=torch.float64):
        s = s + u @ B.T
        c += float(((G - s) ** 2).sum() + action_weight * (u ** 2).sum())
    return c


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_controller_refinement_matches_jax(monkeypatch, dt):
    """Three commands of MPPI with five refinement steps: float64 element by
    element at 1e-9; float32 by the nominal's cost J(U) at 1e-4 relative."""
    jdt, tdt, ndt = DT[dt]
    m = _models(dt)
    common = dict(num_samples=K, horizon=T, lambda_=1.0, gradient_refinement_steps=5,
                  gradient_refinement_lr=0.1)
    sigma = np.eye(2, dtype=ndt) * 0.5
    jc = J.MPPI(m["jdyn"], m["jcost"], 2, jnp.asarray(sigma), u_min=-jnp.ones(2, jdt),
                u_max=jnp.ones(2, jdt), **common)
    pc = P.MPPI(m["pdyn"], m["pcost"], 2, torch.from_numpy(sigma),
                u_min=-torch.ones(2, dtype=tdt), u_max=torch.ones(2, dtype=tdt),
                device="cpu", **common)
    U0 = (np.random.RandomState(1).randn(T, 2) * 0.3).astype(ndt)
    jc.U, pc.U = jnp.asarray(U0), torch.from_numpy(U0)
    _noise_bank(monkeypatch, ndt)
    x = np.array([-1.0, 0.5], ndt)
    with jax.disable_jit():
        for i in range(3):
            aj = np.asarray(jc.command(jnp.asarray(x)))
            ap = pc.command(torch.from_numpy(x)).numpy()
            if dt == "f64":
                np.testing.assert_allclose(pc.cost_total.numpy(), np.asarray(jc.cost_total),
                                           **TOL_64)
                np.testing.assert_allclose(pc.U.numpy(), np.asarray(jc.U), **TOL_64)
                np.testing.assert_allclose(ap, aj, **TOL_64)
            else:
                if i == 0:  # the sampling stage, before any refined nominal
                    np.testing.assert_allclose(pc.cost_total.numpy(),
                                               np.asarray(jc.cost_total), **TOL_C)
                np.testing.assert_allclose(_J(pc.U, x), _J(jc.U, x), rtol=1e-4)
            x = (x + 0.2 * ap).astype(ndt)
    assert pc._state.counter == 3


def test_fused_route_refinement_matches_jax(monkeypatch):
    """The fused step (the kernel's plain version) then five refinement
    steps, against a JAX interpret-mode kernel call on the same bits then
    JAX's refiner: the kernel's costs at the parity tolerance, the refined
    nominal by J(U)."""
    Kf, Tf = 256, 5
    D = Tf * 2
    fields = dict(nx=2, nu=2, K=Kf, T=Tf, diag_sigma=True, gradient_refinement_steps=5,
                  gradient_refinement_lr=0.1)
    jcfg, cfg = JConfig(dtype=F32, **fields), MPPIConfig(**fields)
    jB, jG = jnp.asarray(B_NP, F32), jnp.asarray(GOAL_NP, F32)
    jdyn = lambda s, a: s + a @ jB.T  # noqa: E731
    jcost = lambda s, a: ((jG - s) ** 2).sum(-1)  # noqa: E731
    wd, wc = JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost)
    solve_j = PR.make_transposed_fused_solve(jcfg, wd, wc, rng_in_kernel=False)
    refine_j = JS.make_nominal_refiner(jcfg, wd, wc, None, None)
    rs = np.random.RandomState(8)
    bits = rs.randint(-2**31, 2**31 - 1, size=(D, solve_j.K_pad), dtype=np.int64).astype(
        np.int32)
    monkeypatch.setattr(FS, "key_to_seed", lambda s: torch.from_numpy(bits))
    fns = PS.make_mppi_step(cfg, LQ.dynamics, LQ.running_cost, use_pallas=True)
    assert fns.fused
    jp, pp = _params("f32")
    U0 = (rs.randn(Tf, 2) * 0.3).astype(np.float32)
    x0 = np.array([-3.0, -2.0], np.float32)
    U = JS._shift_U(jnp.asarray(U0), jp.u_init)
    sigma_inv, op, mu_t, lo2, hi2 = JS._transposed_operands(
        jp.noise_sigma, jp.noise_mu, jp.u_min, jp.u_max, jcfg, Tf, 2, F32)
    a_flat = (jp.lambda_ * (U @ sigma_inv.T)).reshape(D)
    delta, m_, s_, ct_j = solve_j(jnp.asarray(bits), JS._x0_to_lanes(jnp.asarray(x0), Kf),
                                  U.reshape(D), op, mu_t, lo2, hi2, a_flat, jp.lambda_)
    U_j = refine_j(jp, U + (delta / s_).reshape(Tf, 2), jnp.asarray(x0), None)
    state, action, art = fns.step(pp, MPPIState(U=torch.from_numpy(U0), seed=0),
                                  torch.from_numpy(x0))
    np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(ct_j), **TOL_C)
    np.testing.assert_allclose(_J(state.U, x0, 0.0), _J(U_j, x0, 0.0), rtol=1e-4)
    assert float(state.U.abs().max()) <= 1.0
    assert torch.equal(action, state.U[0])


# -- the fixed seed of stochastic dynamics ---------------------------------------

def _noisy(s, a, rng):
    return LQ.dynamics(s, a) + 0.05 * torch.randn(s.shape, generator=rng, dtype=s.dtype)


def _stochastic_ctrl(steps, seed=4):
    return P.MPPI(_noisy, LQ.running_cost, 2, torch.eye(2) * 0.5, num_samples=16, horizon=6,
                  lambda_=1.0, seed=seed, u_min=-torch.ones(2), u_max=torch.ones(2),
                  stochastic_dynamics=True, rollout_samples=3, gradient_refinement_steps=steps,
                  gradient_refinement_lr=0.1, device="cpu")


def test_stochastic_refinement_takes_its_own_fixed_seed():
    """Every descent step of a command draws from ``refine_seed(seed,
    counter)``: the command's refined nominal is the refiner's on that seed;
    the sampling stage, the counter and the next command's draws are those
    of the same controller without refinement."""
    ref, bare = _stochastic_ctrl(5), _stochastic_ctrl(0)
    x = torch.tensor([-1.0, 0.5])
    state0 = ref._state
    ref.command(x, shift_nominal_trajectory=False)
    bare.command(x, shift_nominal_trajectory=False)
    assert torch.equal(ref.cost_total, bare.cost_total)
    assert ref._state.counter == bare._state.counter == state0.counter + 1
    refine = PS.make_nominal_refiner(
        ref.config, PS.wrap_dynamics(ref.config, _noisy), PS.wrap_cost(ref.config,
                                                                        LQ.running_cost))
    want = refine(ref._params, bare.U, x, PS.refine_seed(state0.seed, state0.counter))
    assert torch.equal(ref.U, want)
    other = refine(ref._params, bare.U, x, PS.refine_seed(state0.seed, state0.counter + 1))
    assert not torch.equal(ref.U, other)
    # the seed is of its own stream, not the next iteration's rollout
    assert PS.refine_seed(state0.seed, state0.counter) != PS.rollout_seed(state0.seed,
                                                                          state0.counter + 1)
    # and repeats from the controller's seed
    again = _stochastic_ctrl(5)
    again.command(x, shift_nominal_trajectory=False)
    assert torch.equal(again.U, ref.U)


def test_zero_steps_is_the_default_bit_for_bit():
    """``gradient_refinement_steps = 0`` changes nothing on any route."""
    for use_pallas in (False, True, "rollout"):
        a = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=64, horizon=5,
                   seed=3, use_pallas=use_pallas, device="cpu")
        b = P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=64, horizon=5,
                   seed=3, use_pallas=use_pallas, gradient_refinement_steps=0,
                   gradient_refinement_lr=0.3, device="cpu")
        x = torch.tensor([0.5, -0.5])
        for _ in range(3):
            assert torch.equal(a.command(x), b.command(x))
            assert torch.equal(a.U, b.U) and torch.equal(a.cost_total, b.cost_total)


# -- gates ---------------------------------------------------------------------

def _errors(fields, variant="mppi"):
    texts = []
    for make, cfg, dyn, cost in ((JS, JConfig(**fields), lambda s, a: s, lambda s, a: s[..., 0]),
                                 (PS, MPPIConfig(**fields), LQ.dynamics, LQ.running_cost)):
        with pytest.raises(ValueError) as err:
            if variant == "batched":
                make.make_batched_step(cfg, 2, dyn, cost)
            else:
                getattr(make, f"make_{variant}_step")(cfg, dyn, cost)
        texts.append(str(err.value))
    return texts


@pytest.mark.parametrize("fields", [dict(gradient_refinement_steps=-1),
                                    dict(gradient_refinement_steps=2, gradient_refinement_lr=0.0),
                                    dict(gradient_refinement_steps=2,
                                         gradient_refinement_lr=float("inf")),
                                    dict(gradient_refinement_steps=2,
                                         gradient_refinement_lr=float("nan"))],
                         ids=["negative_steps", "zero_lr", "inf_lr", "nan_lr"])
def test_refinement_gates_match_jax(fields):
    jt, pt = _errors(dict(nx=2, nu=2, K=8, T=5, **fields))
    assert pt == jt


@pytest.mark.parametrize("variant", ["smppi", "kmppi", "batched"])
def test_refinement_only_on_mppi(variant):
    fields = dict(nx=2, nu=2, K=8, T=5, gradient_refinement_steps=2,
                  num_support_pts=3 if variant == "kmppi" else 0)
    jt, pt = _errors(fields, variant)
    assert pt == jt and "only supported on MPPI" in pt


# -- JAX's TestGradientRefinement, run on the port -------------------------------

B64 = torch.tensor(B_NP)
GOAL64 = torch.tensor(GOAL_NP)
U_MAX = torch.tensor([1.0, 1.0], dtype=torch.float64)


def linear_dynamics(state, action):
    return state + action @ B64.T


def quadratic_cost(state, action):
    return ((GOAL64 - state) ** 2).sum(-1)


def _run(refine_steps, seed=0, K_=8, steps=10, lr=0.1, **kw):
    ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, 0.5 * torch.eye(2, dtype=torch.float64),
                  num_samples=K_, horizon=8, lambda_=1.0, seed=seed, u_max=U_MAX,
                  gradient_refinement_steps=refine_steps, gradient_refinement_lr=lr,
                  device="cpu", **kw)
    s = torch.tensor([-3.0, -2.0], dtype=torch.float64)
    for _ in range(steps):
        s = linear_dynamics(s, ctrl.command(s))
    return float(torch.linalg.norm(GOAL64 - s)), ctrl


def test_small_k_quality_improves():
    """``test_small_k_quality_improves``: K = 8, T = 8, 20 descent steps, 3
    seeds; the refined mean distance below half the unrefined."""
    base = np.mean([_run(0, seed=i)[0] for i in range(3)])
    ref = np.mean([_run(20, seed=i)[0] for i in range(3)])
    assert ref < 0.5 * base, (ref, base)


def test_nominal_cost_decreases_exactly():
    """``test_nominal_cost_decreases_exactly``: the sampling stage is the
    unrefined controller's, so the descent's gain shows on J(U)."""
    x0 = np.array([-3.0, -2.0])
    _, c_base = _run(0, steps=1)
    _, c_ref = _run(12, steps=1)
    assert torch.equal(c_ref.cost_total, c_base.cost_total)
    assert _task_cost(c_ref.U, x0) <= _task_cost(c_base.U, x0) + 1e-9


def _task_cost(U, x0):
    s, c = torch.tensor(x0), 0.0
    for u in U:
        s = linear_dynamics(s, u)
        c += float(quadratic_cost(s, u))
    return c


def test_bounds_projected():
    _, ctrl = _run(20, lr=0.5)
    assert float(ctrl.U.abs().max()) <= float(U_MAX[0]) + 1e-9


def test_deterministic():
    a, _ = _run(5, seed=7)
    b, _ = _run(5, seed=7)
    assert a == b


def test_terminal_cost_in_objective():
    def terminal(states, actions):
        return 50.0 * ((states[..., -1, :] - GOAL64) ** 2).sum(-1)

    d_base, _ = _run(0, terminal_state_cost=terminal)
    d_ref, _ = _run(20, terminal_state_cost=terminal)
    assert d_ref < d_base + 1e-9


def test_u_scale_respected():
    d, ctrl = _run(10, u_scale=2.0)
    assert np.isfinite(d)
    assert float(ctrl.U.abs().max()) <= float(U_MAX[0]) + 1e-9
