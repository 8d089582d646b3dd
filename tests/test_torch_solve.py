"""The port's plain MPPI path against ``pytorch_mppi_tpu.ops.solve``.

Both sides draw the same N(0, 1) numbers: the JAX side through a patched
``jax.random.normal`` (its step is built with ``jit=False``, so every step
draws anew), the port through a patched ``solve.standard_normal``.  Each side
then applies its own noise transform, so the transform is compared too.

Tolerances: float32 costs rtol 2e-5 / atol 1e-5 and the update (U, action,
omega) rtol 2e-4 / atol 2e-6, as ``tests/test_pallas_transposed.py:102-107``
allows for float32 summation order; float64 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import MPPIState as JState
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import MPPIConfig, MPPIState
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


def _normal_bank(seed=0):
    """N(0, 1) draws in call order: the i-th request of a shape gets the
    i-th block of one seeded stream, on whichever side asks."""
    rs = np.random.RandomState(seed)
    return lambda shape: rs.randn(*shape)


def _patch_normals(monkeypatch, jdt):
    jbank, pbank = _normal_bank(), _normal_bank()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(jbank(shape), jdt))
    monkeypatch.setattr(PS, "standard_normal",
                        lambda gen, shape, dtype, device: torch.tensor(
                            pbank(shape), dtype=dtype, device=device))


# name, config flags, sigma, bound
CASES = [
    ("diag_sigma", {}, np.diag([0.8, 1.2]), None),
    ("full_sigma", {}, np.array([[1.0, 0.3], [0.3, 0.8]]), None),
    ("noise_rho", {"noise_rho": 0.5}, np.diag([0.8, 1.2]), None),
    ("bounds", {}, np.diag([0.8, 1.2]), 0.6),
    ("null_abs_cost", {"sample_null_action": True, "noise_abs_cost": True},
     np.diag([0.8, 1.2]), None),
    ("u_scale", {"u_scale": 2.5}, np.diag([0.8, 1.2]), None),
    ("u_per_command", {"u_per_command": 2}, np.diag([0.8, 1.2]), None),
    ("antithetic", {"antithetic": True}, np.array([[1.0, 0.3], [0.3, 0.8]]), 1.0),
]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("flags,sigma,bound", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_three_chained_steps(monkeypatch, dt, flags, sigma, bound):
    jdt, tdt, ndt = DTYPES[dt]
    K, T, nx, nu = 64, 6, 2, 2
    diag = bool(np.all(sigma == np.diag(np.diagonal(sigma))))
    fields = dict(
        noise_mu=np.full(nu, 0.05), noise_sigma=sigma, lambda_=np.array(0.8),
        u_min=np.full(nu, -bound if bound else -np.inf),
        u_max=np.full(nu, bound if bound else np.inf), u_init=np.zeros(nu))
    U0 = np.random.RandomState(1).randn(T, nu) * 0.3
    x0 = np.array([-3.0, -2.0])

    B, goal = jnp.asarray(B_NP, jdt), jnp.asarray(GOAL_NP, jdt)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=jdt, diag_sigma=diag, **flags)
    jfns = JS.make_mppi_step(jcfg, lambda s, a: s + a @ B.T,
                             lambda s, a: ((goal - s) ** 2).sum(axis=-1), jit=False)
    jparams = JParams(**{k: jnp.asarray(v, jdt) for k, v in fields.items()})
    jstate = JState(U=jnp.asarray(U0, jdt), key=jax.random.PRNGKey(0))

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, dtype=tdt, diag_sigma=diag, **flags)
    model = linear_quadratic(torch.tensor(B_NP), torch.tensor(GOAL_NP))
    fns = PS.make_mppi_step(cfg, model.dynamics, model.running_cost)
    params = params_from_numpy(**fields, dtype=tdt)
    state = MPPIState(U=torch.tensor(U0, dtype=tdt), seed=0)

    _patch_normals(monkeypatch, jdt)
    tol_c = dict(rtol=2e-5, atol=1e-5) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    tol_u = dict(rtol=2e-4, atol=2e-6) if dt == "f32" else dict(rtol=1e-10, atol=1e-10)
    for _ in range(3):
        jstate, jaction, jart = jfns.step(jparams, jstate, jnp.asarray(x0, jdt))
        state, action, art = fns.step(params, state, torch.tensor(x0, dtype=tdt))
        assert art.cost_total.dtype == tdt
        np.testing.assert_allclose(art.cost_total.numpy(), np.asarray(jart.cost_total), **tol_c)
        np.testing.assert_allclose(art.omega.numpy(), np.asarray(jart.omega), **tol_u)
        np.testing.assert_allclose(state.U.numpy(), np.asarray(jstate.U), **tol_u)
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **tol_u)
        np.testing.assert_allclose(art.noise.numpy(), np.asarray(jart.noise), **tol_u)
    assert state.counter == 3


# name, K (odd: the antithetic mirror is cut to K rows), flags, sigma
NOISE_CASES = [
    ("antithetic_mirror", 7, {"antithetic": True, "diag_sigma": True}, np.diag([0.5, 2.0])),
    ("diag_scale", 8, {"diag_sigma": True}, np.diag([0.5, 2.0])),
    ("kron_operator", 8, {}, np.array([[1.0, 0.3], [0.3, 0.8]])),
    ("ar1_operator", 8, {"noise_rho": 0.7}, np.array([[1.0, 0.3], [0.3, 0.8]])),
]


@pytest.mark.parametrize("K,flags,sigma", [c[1:] for c in NOISE_CASES],
                         ids=[c[0] for c in NOISE_CASES])
def test_sample_noise_flat_transform(monkeypatch, K, flags, sigma):
    reps, nu = 5, 2
    jdt = jnp.float32
    _patch_normals(monkeypatch, jdt)
    mu = np.array([0.1, -0.2])
    jp = JParams(noise_mu=jnp.asarray(mu, jdt), noise_sigma=jnp.asarray(sigma, jdt),
                 lambda_=jnp.asarray(1.0, jdt), u_min=None, u_max=None, u_init=None)
    z_j = JS.sample_noise_flat(jax.random.PRNGKey(0), K, reps, jp, jdt,
                               antithetic=flags.get("antithetic", False),
                               noise_rho=flags.get("noise_rho", 0.0),
                               diag_sigma=flags.get("diag_sigma", False))
    pp = params_from_numpy(mu, sigma, 1.0, -np.inf, np.inf, 0.0)
    z_p = PS.sample_noise_flat(None, K, reps, pp, torch.float32,
                               antithetic=flags.get("antithetic", False),
                               noise_rho=flags.get("noise_rho", 0.0),
                               diag_sigma=flags.get("diag_sigma", False))
    assert z_p.shape == (K, reps * nu)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), rtol=1e-6, atol=1e-6)


def test_get_rollouts_matches_jax():
    K, T, nx, nu = 4, 6, 2, 2
    jdt = jnp.float32
    B, goal = jnp.asarray(B_NP, jdt), jnp.asarray(GOAL_NP, jdt)
    jcfg = JConfig(nx=nx, nu=nu, K=K, T=T, dtype=jdt, u_scale=1.5)
    jfns = JS.make_mppi_step(jcfg, lambda s, a: s + a @ B.T,
                             lambda s, a: ((goal - s) ** 2).sum(axis=-1))
    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, u_scale=1.5)
    model = linear_quadratic(torch.tensor(B_NP), torch.tensor(GOAL_NP))
    fns = PS.make_mppi_step(cfg, model.dynamics, model.running_cost)
    U = np.random.RandomState(2).randn(T, nu).astype(np.float32)
    x0 = np.array([[0.5, -1.0]], np.float32)
    r_j = jfns.get_rollouts(None, jnp.asarray(x0), jnp.asarray(U), num_rollouts=3)
    r_p = fns.get_rollouts(None, torch.from_numpy(x0), torch.from_numpy(U), num_rollouts=3)
    assert r_p.shape == (3, T, nx)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)
