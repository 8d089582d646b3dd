"""A JAX controller's parameters and nominal sequence, carried into the port
by ``utils/convert.py``, give the same command on the same injected noise
(float32 tolerances of ``tests/test_pallas_transposed.py:102-107``); SMPPI's
and KMPPI's extra fields carry across unchanged."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as pm
from pytorch_mppi_tpu_torch import KMPPI, MPPI, RBFKernel, linear_quadratic
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.utils.convert import (
    kmppi_params_from_numpy,
    kmppi_state_from_numpy,
    params_from_numpy,
    smppi_params_from_numpy,
    smppi_state_from_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("sigma", [np.diag([0.5, 1.5]), np.array([[1.0, 0.4], [0.4, 0.9]])],
                         ids=["diag", "full"])
def test_command_after_convert(monkeypatch, sigma):
    K, T = 128, 8
    B = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
    goal = np.array([2.0, 2.0], np.float32)
    jB, jgoal = jnp.asarray(B), jnp.asarray(goal)
    kw = dict(nx=2, num_samples=K, horizon=T, lambda_=0.7, sample_null_action=True,
              noise_mu=np.array([0.1, 0.0], np.float32), u_min=np.float32(-1.5))
    jctrl = pm.MPPI(lambda s, a: s + a @ jB.T,
                    lambda s, a: ((jgoal - s) ** 2).sum(axis=-1),
                    noise_sigma=jnp.asarray(sigma, jnp.float32), seed=5, **kw)
    model = linear_quadratic(torch.from_numpy(B), torch.from_numpy(goal))
    ctrl = MPPI(model.dynamics, model.running_cost,
                noise_sigma=torch.tensor(sigma, dtype=torch.float32), device="cpu", **kw)

    jp = jctrl._params
    ctrl._params = params_from_numpy(*(np.asarray(f) for f in jp))
    ctrl._state = state_from_numpy(np.asarray(jctrl._state.U), seed=0)
    torch.testing.assert_close(ctrl.U, torch.from_numpy(np.array(jctrl.U)), rtol=0, atol=0)

    z = np.random.RandomState(4).randn(K, T * 2)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(z, jnp.float32))
    monkeypatch.setattr(PS, "standard_normal",
                        lambda gen, shape, dtype, device: torch.tensor(z, dtype=dtype))
    x0 = np.array([-3.0, -2.0], np.float32)
    ja = np.asarray(jctrl.command(x0))
    a = ctrl.command(x0).numpy()
    np.testing.assert_allclose(ctrl.cost_total.numpy(), np.asarray(jctrl.cost_total),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(a, ja, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(ctrl.U.numpy(), np.asarray(jctrl.U), rtol=2e-4, atol=2e-6)


def test_smppi_round_trip():
    """SMPPI's action sequence, action bounds, smoothing weight and step carry
    across from a JAX controller's numpy fields unchanged."""
    rs = np.random.RandomState(0)
    jctrl = pm.SMPPI(lambda s, a: s + a, lambda s, a: (s ** 2).sum(axis=-1), nx=2,
                     noise_sigma=jnp.eye(2, dtype=jnp.float32), num_samples=16, horizon=5,
                     w_action_seq_cost=3.5, delta_t=0.25,
                     action_min=jnp.full(2, -0.7, jnp.float32),
                     action_max=jnp.full(2, 0.9, jnp.float32),
                     U_init=jnp.asarray(rs.randn(5, 2), jnp.float32))
    jp = jctrl._full_params()
    base = params_from_numpy(*(np.asarray(f) for f in jp.base))
    params = smppi_params_from_numpy(base, np.asarray(jp.action_min), np.asarray(jp.action_max),
                                     np.asarray(jp.w_action_seq_cost), np.asarray(jp.delta_t))
    state = smppi_state_from_numpy(np.asarray(jctrl._state.U),
                                   np.asarray(jctrl._state.action_sequence), seed=4)
    for got, want in ((params.action_min, jp.action_min), (params.action_max, jp.action_max),
                      (params.w_action_seq_cost, jp.w_action_seq_cost),
                      (params.delta_t, jp.delta_t), (state.U, jctrl._state.U),
                      (state.action_sequence, jctrl._state.action_sequence)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert params.delta_t.shape == () and state.seed == 4 and state.counter == 0


def test_kmppi_round_trip():
    """KMPPI's control points and interpolation operators carry across from a
    JAX controller's numpy fields unchanged, and equal the port's own."""
    jctrl = pm.KMPPI(lambda s, a: s + a, lambda s, a: (s ** 2).sum(axis=-1), nx=2,
                     noise_sigma=jnp.eye(2, dtype=jnp.float32), num_samples=16, horizon=8,
                     num_support_pts=4, kernel=pm.RBFKernel(2.0))
    jctrl._state = jctrl._state._replace(theta=jnp.arange(8.0, dtype=jnp.float32).reshape(4, 2))
    jp = jctrl._full_params()
    base = params_from_numpy(*(np.asarray(f) for f in jp.base))
    params = kmppi_params_from_numpy(base, np.asarray(jp.interp_full), np.asarray(jp.interp_shift))
    state = kmppi_state_from_numpy(np.asarray(jctrl._state.U), np.asarray(jctrl._state.theta),
                                   seed=1)
    np.testing.assert_array_equal(params.interp_full.numpy(), np.asarray(jp.interp_full))
    np.testing.assert_array_equal(params.interp_shift.numpy(), np.asarray(jp.interp_shift))
    np.testing.assert_array_equal(state.theta.numpy(), np.asarray(jctrl._state.theta))
    ctrl = KMPPI(lambda s, a: s + a, lambda s, a: (s ** 2).sum(-1), nx=2,
                 noise_sigma=torch.eye(2), num_samples=16, horizon=8, num_support_pts=4,
                 kernel=RBFKernel(2.0), device="cpu")
    np.testing.assert_allclose(ctrl._full_params().interp_full.numpy(),
                               params.interp_full.numpy(), rtol=2e-4, atol=2e-6)
