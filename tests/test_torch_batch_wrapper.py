"""JAX's ``tests/test_batch_wrapper.py`` (all three tests) on the port's
``handle_batch_input`` and its dynamics and cost wrappers: the same inputs
through JAX's decorator and the port's, with JAX's assertions, and the
port's result equal to JAX's."""
import numpy as np
import torch

import jax.numpy as jnp

import pytorch_mppi_tpu as J
import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import solve as JS
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import solve as PS


def _adders(decorate, n):
    @decorate(n=n)
    def add(a, b):
        assert a.ndim == n and b.ndim == n
        return a + b

    return add


def _check(n, a, b, expected):
    """The sum of ``a`` and ``b`` through both packages' decorators."""
    got_j = _adders(J.handle_batch_input, n)(jnp.asarray(a), jnp.asarray(b))
    got_p = _adders(P.handle_batch_input, n)(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got_p.shape) == tuple(got_j.shape) == expected.shape
    assert torch.allclose(got_p, torch.from_numpy(expected))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(got_j))


def test_batch_wrapper_2d():
    a_2d = np.array([[0.1, 0.2, 0.3]], np.float32)
    b_2d = np.array([[0.5, -0.2, 0.3]], np.float32)
    a_3d, b_3d = np.tile(a_2d, (1, 1, 1)), np.tile(b_2d, (1, 1, 1))
    a_4d, b_4d = np.tile(a_3d, (2, 1, 1, 1)), np.tile(b_3d, (2, 1, 1, 1))
    s = np.array([[0.6, 0.0, 0.6]], np.float32)
    _check(2, a_2d, b_2d, s)
    _check(2, a_3d, b_3d, s[None])
    _check(2, a_4d, b_4d, np.stack([s[None], s[None]]))


def test_batch_wrapper_3d():
    a_3d = np.array([[[0.1, 0.2, 0.3]]], np.float32)
    b_3d = np.array([[[0.5, -0.2, 0.3]]], np.float32)
    a_4d, b_4d = np.tile(a_3d, (2, 1, 1, 1)), np.tile(b_3d, (2, 1, 1, 1))
    s = np.array([[[0.6, 0.0, 0.6]]], np.float32)
    _check(3, a_3d, b_3d, s)
    _check(3, a_4d, b_4d, np.stack([s, s]))


def test_controller_adapts_user_fn_batch_rank():
    """The solve's dynamics and cost wrappers take callables written for
    2-D batches and give them any leading batch dims, as JAX's do
    (``tests/test_batch_wrapper.py:52-87``)."""

    def strict_2d_dynamics(s, u):
        assert s.ndim == 2 and u.ndim == 2
        return s + torch.nn.functional.pad(u, (0, 1))

    def strict_2d_cost(s, u):
        assert s.ndim == 2 and u.ndim == 2
        return (s ** 2).sum(dim=-1)

    def j_dynamics(s, u):
        assert s.ndim == 2 and u.ndim == 2
        return s + jnp.pad(u, ((0, 0), (0, 1)))

    def j_cost(s, u):
        assert s.ndim == 2 and u.ndim == 2
        return (s ** 2).sum(axis=-1)

    config = MPPIConfig(nx=3, nu=2, K=4, T=5)
    dyn = PS.wrap_dynamics(config, strict_2d_dynamics)
    cost = PS.wrap_cost(config, strict_2d_cost)
    s2, u2 = torch.ones((6, 3)), torch.ones((6, 2))
    s4, u4 = s2.reshape(2, 3, 1, 3) * 2.0, u2.reshape(2, 3, 1, 2)
    assert dyn(s2, u2, 0).shape == (6, 3)
    out4 = dyn(s4, u4, 0)
    assert out4.shape == (2, 3, 1, 3)
    assert torch.allclose(out4.reshape(6, 3), dyn(s4.reshape(6, 3), u4.reshape(6, 2), 0))
    c4 = cost(s4, u4, 0)
    assert c4.shape == (2, 3, 1)
    assert torch.allclose(c4.reshape(-1), cost(s4.reshape(6, 3), u4.reshape(6, 2), 0))

    jcfg = JConfig(nx=3, nu=2, K=4, T=5)
    jdyn, jcost = JS.wrap_dynamics(jcfg, j_dynamics), JS.wrap_cost(jcfg, j_cost)
    np.testing.assert_array_equal(out4.numpy(),
                                  np.asarray(jdyn(None, jnp.asarray(s4.numpy()),
                                                  jnp.asarray(u4.numpy()), 0, None)))
    np.testing.assert_array_equal(c4.numpy(),
                                  np.asarray(jcost(jnp.asarray(s4.numpy()),
                                                   jnp.asarray(u4.numpy()), 0)))
