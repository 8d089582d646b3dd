"""A JAX controller's parameters and nominal sequence, carried into the port
by ``utils/convert.py``, give the same command on the same injected noise
(float32 tolerances of ``tests/test_pallas_transposed.py:102-107``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu as pm
from pytorch_mppi_tpu_torch import MPPI, linear_quadratic
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.utils.convert import params_from_numpy, state_from_numpy

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
