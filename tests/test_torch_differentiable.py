"""The differentiable closed loop (``examples/differentiable_mpc.py``, JAX's
``tests/test_models.py::TestDifferentiableClosedLoop``) on the port, against
JAX on the CPU: plan with a residual MLP through ``ops/solve.make_mppi_step``
(``parameterized_dynamics``), execute on the true plant, differentiate the
summed squared distance to the goal with respect to the weights.

* The gradient of a 2-command loop: the same float64 weights
  (``utils/convert.mlp_params_from_numpy``), the same start state and the
  same N(0, 1) draws on both sides (``jax.random.normal`` and the port's
  ``solve.standard_normal`` patched), ``torch.autograd`` against
  ``jax.grad``: the loss within 1e-12 relative, each gradient element
  within 1e-10 of the largest |element| (the two differ by summation order
  only: 3e-14 measured).
* JAX's ``test_train_dynamics_through_control`` with its floor: 25 Adam
  steps at lr 3e-3 must take the task loss below half its start.  Both
  sides train from JAX's own initial weights (``mlp_init(PRNGKey(0))``) on
  one fixed set of six draws (numpy seed 0), fed to every evaluation of the
  loss, as JAX's jitted loss bakes its one draw in; float32, as JAX's test.
  The floor depends on the draw in both packages: over 5 weight seeds × 4
  noise seeds (each package's own generators, float32, 25 steps) JAX meets
  it in 9 of 20 runs and the port in 9 of 20, median l1 / l0 0.646 and
  0.642.  With the same draw the two loss trajectories agree within 1e-3
  relative (1.2e-4 measured: float32 over 25 Adam steps), so the port meets
  the floor exactly when JAX does.
"""
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.config import MPPIParams as JParams
from pytorch_mppi_tpu.config import MPPIState as JState
from pytorch_mppi_tpu.models.mlp import make_residual_dynamics as j_residual
from pytorch_mppi_tpu.models.mlp import mlp_init as j_mlp_init
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.examples import differentiable_mpc as D
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.utils.convert import mlp_params_from_numpy

torch.set_num_threads(1)

K, T = 128, 8  # JAX's test's sizes


def _jax_task_loss(loop_steps, dt):
    """JAX's ``task_loss`` (``tests/test_models.py:225-233``) in ``dt``."""
    B = jnp.array([[1.0, 0.0], [0.0, -1.0]], dt)
    goal = jnp.array([2.0, 2.0], dt)
    cost = lambda s, a: ((goal - s) ** 2).sum(axis=-1)  # noqa: E731
    config = JConfig(nx=2, nu=2, K=K, T=T, dtype=dt, diag_sigma=True,
                     parameterized_dynamics=True)
    fns = JS.make_mppi_step(config, j_residual(2, 2), cost, jit=False)
    params = JParams(noise_mu=jnp.zeros(2, dt), noise_sigma=jnp.eye(2, dtype=dt),
                     lambda_=jnp.asarray(1.0, dt), u_min=jnp.full((2,), -1.0, dt),
                     u_max=jnp.full((2,), 1.0, dt), u_init=jnp.zeros(2, dt))

    def task_loss(w):
        st = JState(U=jnp.zeros((T, 2), dt), key=jax.random.PRNGKey(7))
        x = jnp.array([-3.0, -2.0], dt)
        total = 0.0
        for _ in range(loop_steps):
            st, a, _ = fns.step(params, st, x, None, w)
            x = x + a @ B.T
            total = total + ((goal - x) ** 2).sum()
        return total

    return task_loss


def _patch_draws(monkeypatch, jdt, cycle=None):
    """The same N(0, 1) arrays for the i-th draw on either side; with
    ``cycle`` the i-th draw is the (i mod cycle)-th array."""
    def bank():
        rs, seen, calls = np.random.RandomState(0), {}, [0]

        def draw(shape):
            i = calls[0] if cycle is None else calls[0] % cycle
            calls[0] += 1
            if i not in seen:
                seen[i] = rs.randn(*shape)
            return seen[i]
        return draw

    jbank, pbank = bank(), bank()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(jbank(shape), dtype or jdt))
    monkeypatch.setattr(PS, "standard_normal", lambda gen, shape, dtype, device: torch.tensor(
        pbank(shape), dtype=dtype, device=device))


def _np_weights(seed=3):
    rs = np.random.RandomState(seed)
    return [((rs.rand(a, b) * 2 - 1) / math.sqrt(a), (rs.rand(b) * 2 - 1) / math.sqrt(a))
            for a, b in ((4, 16), (16, 2))]


def test_closed_loop_gradient_matches_jax(monkeypatch):
    """d task_loss / d weights of a 2-command loop, float64, against
    ``jax.grad`` on the same weights, start state and draws."""
    _patch_draws(monkeypatch, jnp.float64)
    npw = _np_weights()
    jl, jg = jax.value_and_grad(_jax_task_loss(2, jnp.float64))(
        [(jnp.asarray(W), jnp.asarray(b)) for W, b in npw])
    w = mlp_params_from_numpy(npw, dtype=torch.float64)
    leaves = [p.requires_grad_() for layer in w for p in layer]
    loss = D.make_task_loss(2, "cpu", torch.float64)(w)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-12)
    jflat = [np.asarray(t) for layer in jg for t in layer]
    scale = max(float(np.abs(g).max()) for g in jflat)
    assert scale > 0.0
    for g, want in zip(grads, jflat):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-10, atol=1e-10 * scale)


def test_train_dynamics_through_control(monkeypatch):
    """JAX's test with its floor, both packages on JAX's weights and one
    fixed draw (the module docstring)."""
    dt = jnp.float32
    _patch_draws(monkeypatch, dt, cycle=6)
    w = j_mlp_init(jax.random.PRNGKey(0), [4, 16, 2])
    w_np = [(np.asarray(W), np.asarray(b)) for W, b in w]
    opt = optax.adam(3e-3)
    opt_state = opt.init(w)
    vg = jax.jit(jax.value_and_grad(_jax_task_loss(6, dt)))
    j0, _ = vg(w)
    jax_losses = []
    for _ in range(25):
        jl, g = vg(w)
        jax_losses.append(float(jl))
        updates, opt_state = opt.update(g, opt_state, w)
        w = optax.apply_updates(w, updates)

    wp = mlp_params_from_numpy(w_np)
    leaves = [p.requires_grad_() for layer in wp for p in layer]
    task_loss = D.make_task_loss(6, "cpu")
    adam = torch.optim.Adam(leaves, lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
    with torch.no_grad():
        l0 = float(task_loss(wp))
    losses = []
    for _ in range(25):
        adam.zero_grad()
        loss = task_loss(wp)
        loss.backward()
        adam.step()
        losses.append(float(loss.detach()))
    assert all(bool(torch.isfinite(p.grad).all()) for p in leaves)
    np.testing.assert_allclose(l0, float(j0), rtol=1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    assert losses[-1] < 0.5 * l0, f"{losses[-1]} vs initial {l0}"
    assert jax_losses[-1] < 0.5 * float(j0)
