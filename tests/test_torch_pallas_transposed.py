"""The tests of JAX's ``tests/test_pallas_transposed.py`` that no other port
test holds under another name, on the port's kernel plain versions against
JAX's transposed kernels in Pallas interpret mode, fed the same injected
int32 bits (or the same noise operand), with JAX's tolerances
(``tests/test_pallas_transposed.py:102-107``): costs rtol 2e-5 / atol 1e-5,
s rtol 1e-5, the update delta/s rtol 2e-4 / atol 2e-6.

* ``TestTransposedSolve``: the batched kernel's noise-operand mode against
  its bits mode on the same draw; ``MPPI_Batched(use_pallas=True)`` on the
  CPU; a K that is not a multiple of JAX's block (phantom samples weigh
  nothing);
* ``TestTerminalFinalKernel.test_batched_parity``: the batched kernel in
  noise-operand mode with a traced final-state terminal cost, against JAX's
  and against the plain per-plant rollout.

The sharded batched operand (``:845``) runs in ``test_torch_sharding.py``'s
Gloo worlds; ``docs/PORT_TESTS.md`` maps every other test of the JAX file.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

torch.set_num_threads(1)

DT = jnp.float32
K, T, NU, NX = 256, 6, 2, 2
D = T * NU
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)

B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
JB, JG = jnp.asarray(B_NP), jnp.asarray(GOAL_NP)
TB, TG = torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP)
LQ = linear_quadratic(TB, TG)


def j_lin(s, a):
    return s + a @ JB.T


def j_quad(s, a):
    return ((JG - s) ** 2).sum(axis=-1)


def t_lin(s, a):
    return s + a @ TB.T


def t_quad(s, a):
    return ((TG - s) ** 2).sum(dim=-1)


def _bits(shape, seed=3):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, -(2**31), 2**31 - 1,
                                         jnp.int32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _batched_operands(N):
    """JAX's operands of ``test_batched_noise_operand_matches_bits_mode``
    (``tests/test_pallas_transposed.py:431-440``), as numpy arrays."""
    U = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (N, T, NU), DT) * 0.1)
    x0 = np.array([[-3.0, -2.0], [1.0, 1.0], [0.5, -0.5]], np.float32)[:N]
    full = lambda v: np.full(D, v, np.float32)  # noqa: E731
    sigma_inv = np.eye(NU, dtype=np.float32) / 0.64
    a2 = np.einsum("ntu,vu->ntv", U, sigma_inv).reshape(N, D).astype(np.float32)
    return (np.ascontiguousarray(x0.T), np.ascontiguousarray(U.reshape(N, D).T), full(0.8),
            full(0.0), full(-1.0), full(1.0), np.ascontiguousarray(a2.T), np.float32(1.0))


class TestTransposedSolve:
    def test_batched_noise_operand_matches_bits_mode(self):
        """The noise-operand mode fed the final noise of a draw equals the
        bits mode fed the draw's bits, to the last ulp (the scale and shift
        are one FMA on one side), and equals JAX's operand mode.  The port
        has no ``rng_in_kernel`` flag: the lead operand selects the mode, so
        JAX's refusal of both flags has no counterpart; an operand-mode solve
        refuses int32 bits on the CPU as its kernel's wrapper does on the
        card (``ROADMAP.md`` Queue 3, Q3-4)."""
        N = 3
        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
        solve_bits = FS.make_transposed_batched_solve(cfg, N, LQ)
        solve_op = FS.make_transposed_batched_solve(cfg, N, LQ, noise_operand=True)
        assert solve_op.noise_operand and not solve_bits.noise_operand
        bits = _bits((D, K))
        args = _batched_operands(N)
        noiseT = (FS.bits_to_normal(torch.from_numpy(bits)) * torch.from_numpy(args[2])[:, None]
                  + torch.from_numpy(args[3])[:, None])
        delta_b, ms_b, ct_b = solve_bits(torch.from_numpy(bits), *_t(*args))
        delta_o, ms_o, ct_o = solve_op(noiseT, *_t(*args))
        np.testing.assert_allclose(ct_o.numpy(), ct_b.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(delta_o.numpy(), delta_b.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ms_o.numpy(), ms_b.numpy(), rtol=1e-5, atol=0)

        jcfg = JConfig(nx=NX, nu=NU, K=K, T=T, dtype=DT, diag_sigma=True)
        solve_j = PR.make_transposed_batched_solve(
            jcfg, N, JS.wrap_dynamics(jcfg, j_lin), JS.wrap_cost(jcfg, j_quad),
            noise_operand=True)
        delta_j, ms_j, ct_j = solve_j(jnp.asarray(noiseT.numpy()), *_j(*args))
        np.testing.assert_allclose(ct_o.numpy(), np.asarray(ct_j), **TOL_C)
        np.testing.assert_allclose((delta_o / ms_o[1][None]).numpy(),
                                   np.asarray(delta_j / ms_j[1][None]), **TOL_U)
        with pytest.raises(ValueError, match="noise must be torch.float32"):
            solve_op(torch.from_numpy(bits), *_t(*args))

    def test_batched_controller_falls_back_on_cpu(self, caplog):
        """``MPPI_Batched(use_pallas=True)`` at K = 64: below the batched
        kernel's crossover both packages take the plain path (JAX on the
        CPU in any case), so the commands are equal bit for bit; the port
        says so in its log."""
        kw = dict(num_envs=2, num_samples=64, horizon=5, seed=3, device="cpu")
        c_ref = P.MPPI_Batched(t_lin, t_quad, 2, torch.eye(2), **kw)
        with caplog.at_level(logging.INFO, logger="pytorch_mppi_tpu_torch"):
            c_pal = P.MPPI_Batched(t_lin, t_quad, 2, torch.eye(2), use_pallas=True, **kw)
        assert not c_pal._fns.fused
        assert "use_pallas='force'" in caplog.text
        states = torch.tensor([[-3.0, -2.0], [1.0, 1.0]])
        np.testing.assert_array_equal(c_ref.command(states).numpy(),
                                      c_pal.command(states).numpy())

    def test_padded_k(self):
        """K = 100, not a multiple of JAX's 128-sample block: the phantom
        samples weigh nothing, on both sides, on the same bits."""
        Kp = 100
        jcfg = JConfig(nx=NX, nu=NU, K=Kp, T=T, dtype=DT, diag_sigma=True)
        solve_j = PR.make_transposed_fused_solve(
            jcfg, JS.wrap_dynamics(jcfg, j_lin), JS.wrap_cost(jcfg, j_quad), rng_in_kernel=False)
        solve_p = FS.make_transposed_fused_solve(MPPIConfig(nx=NX, nu=NU, K=Kp, T=T,
                                                            diag_sigma=True),
                                                 LQ, pair_block=solve_j.block_k)
        bits = _bits((D, solve_j.K_pad))
        assert solve_j.K_pad == 128
        ones = np.ones(D, np.float32)
        x0T = np.broadcast_to(np.array([-1.0, 0.5], np.float32)[:, None], (NX, Kp))
        args = (x0T, 0 * ones, ones, 0 * ones, -ones, ones, 0 * ones, np.float32(1.0))
        delta_p, m_p, s_p, ct_p = solve_p(torch.from_numpy(bits), *_t(*args))
        delta_j, m_j, s_j, ct_j = solve_j(jnp.asarray(bits), *_j(*args))
        assert ct_p.shape == (100,)
        assert torch.isfinite(ct_p).all()
        # s is the sum of 100 weights, each at most 1
        assert 0 < float(s_p) <= 100.0
        np.testing.assert_allclose(ct_p.numpy(), np.asarray(ct_j), **TOL_C)
        np.testing.assert_allclose(float(s_p), float(s_j), rtol=1e-5)
        np.testing.assert_allclose((delta_p / s_p).numpy(), np.asarray(delta_j / s_j), **TOL_U)


class TestTerminalFinalKernel:
    W_NP = np.array([3.0, 1.0], np.float32)

    @classmethod
    def _jterm(cls, s, a):
        return (jnp.asarray(cls.W_NP) * (s - JG) ** 2).sum(axis=-1) + 0.2 * (a ** 2).sum(axis=-1)

    @classmethod
    def _tterm(cls, s, a):
        return (torch.from_numpy(cls.W_NP) * (s - TG) ** 2).sum(dim=-1) + 0.2 * (a ** 2).sum(-1)

    def test_batched_parity(self):
        """JAX's ``tests/test_pallas_transposed.py:1120-1150``: the batched
        kernel in noise-operand mode with a traced final-state terminal
        cost; each plant's costs equal the plain rollout's with the
        terminal cost of its final state, and JAX's kernel's."""
        N = 2
        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
        model = BL.kernel_model(cfg, t_lin, t_quad)
        solve_p = FS.make_transposed_batched_solve(cfg, N, model, noise_operand=True,
                                                   terminal_final=self._tterm)
        jcfg = JConfig(nx=NX, nu=NU, K=K, T=T, dtype=DT, diag_sigma=True)
        wterm = JS.wrap_final_cost(self._jterm)
        solve_j = PR.make_transposed_batched_solve(
            jcfg, N, JS.wrap_dynamics(jcfg, j_lin), JS.wrap_cost(jcfg, j_quad),
            noise_operand=True, terminal_final=wterm)
        bits = _bits((D, K))
        U2 = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (D,), DT) * 0.1)
        full = lambda v: np.full(D, v, np.float32)  # noqa: E731
        noise_shared = (FS.bits_to_normal(torch.from_numpy(bits)).numpy().T * 0.8)  # (K, D)
        x0 = np.array([[-3.0, -2.0], [2.0, 1.0]], np.float32)
        U2N = np.stack([U2, -U2], axis=1)
        aN = np.stack([U2 * 0.7, -U2 * 0.7], axis=1)
        args = (np.ascontiguousarray(noise_shared.T), np.ascontiguousarray(x0.T), U2N, full(0.8),
                full(0.0), full(-1.0), full(1.0), aN, np.float32(1.0))
        delta_p, ms_p, ct_p = solve_p(*_t(*args))
        delta_j, ms_j, ct_j = solve_j(*_j(*args))
        np.testing.assert_allclose(ct_p.numpy(), np.asarray(ct_j), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose((delta_p / ms_p[1][None]).numpy(),
                                   np.asarray(delta_j / ms_j[1][None]), **TOL_U)
        pcfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
        wdyn, wcost = PS.wrap_dynamics(pcfg, t_lin), PS.wrap_cost(pcfg, t_quad)
        for n in range(N):
            pert = np.clip(U2N[:, n][None] + noise_shared, -1.0, 1.0)
            nse = pert - U2N[:, n][None]
            rc, _, _ = PS.rollout_costs(pcfg, wdyn, wcost, torch.from_numpy(x0[n]),
                                        torch.from_numpy(pert.reshape(K, T, NU)),
                                        terminal_final_cost=PS.wrap_final_cost(self._tterm))
            ct_m = rc.numpy() + nse @ aN[:, n]
            np.testing.assert_allclose(ct_p[n].numpy(), ct_m, rtol=2e-5, atol=2e-5)
