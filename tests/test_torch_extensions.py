"""JAX's ``tests/test_extensions.py`` classes ``TestGradientRefinement``
(:595-722), ``TestRunMppiJit`` (:1019-1148) and ``TestEliteReuse``
(:1149-1357) on the port, on the CPU: each JAX test translated to the
port's API with JAX's floors, in float64 as JAX's file.

The port's draws are its own (``torch.Generator``), so a floor that compares
two runs compares two runs of the port.  Some of these checks also stand,
in other forms, in ``test_torch_refinement.py``, ``test_torch_elites.py``
and ``test_torch_runner.py``; this file keeps JAX's classes whole.
"""
import math

import numpy as np
import pytest
import torch

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import solve as PS

torch.set_num_threads(1)

DTYPE = torch.float64
SEED = 42
B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=DTYPE)
GOAL = torch.tensor([2.0, 2.0], dtype=DTYPE)


def linear_dynamics(state, action):
    return state + action @ B.T


def quadratic_cost(state, action):
    return ((GOAL - state) ** 2).sum(-1)


def eye(scale=1.0):
    return scale * torch.eye(2, dtype=DTYPE)


class TestGradientRefinement:
    """``gradient_refinement_steps``: projected Adam on the nominal sequence
    after the sampling stage, ``torch.autograd`` through the rollout."""

    U_MAX = torch.tensor([1.0, 1.0], dtype=DTYPE)

    def _run(self, refine_steps, seed=0, K=8, steps=10, lr=0.1, **kw):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(0.5), num_samples=K, horizon=8,
                      lambda_=1.0, seed=seed, u_max=self.U_MAX,
                      gradient_refinement_steps=refine_steps, gradient_refinement_lr=lr,
                      device="cpu", **kw)
        s = torch.tensor([-3.0, -2.0], dtype=DTYPE)
        for _ in range(steps):
            s = linear_dynamics(s, ctrl.command(s))
        return float(torch.linalg.norm(GOAL - s)), ctrl

    def test_small_k_quality_improves(self):
        """K = 8: 20 descent steps halve the seed-averaged distance."""
        base = np.mean([self._run(0, seed=i)[0] for i in range(3)])
        ref = np.mean([self._run(20, seed=i)[0] for i in range(3)])
        assert ref < 0.5 * base, (ref, base)

    def test_nominal_cost_decreases_exactly(self):
        """The sampling stage is the unrefined controller's, so the descent's
        gain shows on the nominal rollout's task cost."""
        def J(ctrl, x0):
            s, c = x0, 0.0
            for t in range(ctrl.T):
                s = linear_dynamics(s, ctrl.U[t])
                c = c + float(quadratic_cost(s, ctrl.U[t]))
            return c

        x0 = torch.tensor([-3.0, -2.0], dtype=DTYPE)
        _, c_base = self._run(0, steps=1)
        _, c_ref = self._run(12, steps=1)
        assert J(c_ref, x0) <= J(c_base, x0) + 1e-9

    def test_bounds_projected(self):
        _, ctrl = self._run(20, lr=0.5)
        assert float(ctrl.U.abs().max()) <= float(self.U_MAX[0]) + 1e-9

    def test_deterministic(self):
        a, _ = self._run(5, seed=7)
        b, _ = self._run(5, seed=7)
        assert a == b

    def test_stochastic_m_risk_composes(self):
        """Stochastic dynamics, M = 4 and CVaR with refinement: finite."""
        def stoch_dyn(s, u, rng):
            eps = torch.randn(s.shape, generator=rng, dtype=s.dtype, device=s.device)
            return linear_dynamics(s, u) + 0.01 * eps

        ctrl = P.MPPI(stoch_dyn, quadratic_cost, 2, eye(0.5), num_samples=8, horizon=8,
                      lambda_=1.0, seed=0, u_max=self.U_MAX, stochastic_dynamics=True,
                      rollout_samples=4, risk_alpha=0.5, gradient_refinement_steps=5,
                      gradient_refinement_lr=0.1, device="cpu")
        s = torch.tensor([-3.0, -2.0], dtype=DTYPE)
        for _ in range(8):
            s = linear_dynamics(s, ctrl.command(s))
        assert torch.isfinite(s).all()
        assert torch.isfinite(ctrl.U).all()

    def test_terminal_cost_in_objective(self):
        def terminal(states, actions):
            return 50.0 * ((states[..., -1, :] - GOAL) ** 2).sum(-1)

        d_base, _ = self._run(0, terminal_state_cost=terminal)
        d_ref, _ = self._run(20, terminal_state_cost=terminal)
        assert d_ref < d_base + 1e-9

    def test_variant_gates(self):
        for cls, kw in ((P.SMPPI, dict(w_action_seq_cost=0.1)),
                        (P.KMPPI, dict(num_support_pts=4))):
            with pytest.raises(ValueError, match="only supported on MPPI"):
                cls(linear_dynamics, quadratic_cost, 2, eye(), num_samples=8, horizon=8,
                    gradient_refinement_steps=2, device="cpu", **kw)
        with pytest.raises(ValueError, match="only supported on MPPI"):
            PS.make_batched_step(MPPIConfig(nx=2, nu=2, K=8, T=5, dtype=DTYPE,
                                            gradient_refinement_steps=2),
                                 2, linear_dynamics, quadratic_cost)

    def test_validation(self):
        with pytest.raises(ValueError, match="gradient_refinement_steps"):
            PS.make_mppi_step(MPPIConfig(nx=2, nu=2, K=8, T=5, dtype=DTYPE,
                                         gradient_refinement_steps=-1),
                              linear_dynamics, quadratic_cost)
        for bad_lr in (0.0, -0.1, float("inf"), float("nan")):
            with pytest.raises(ValueError, match="gradient_refinement_lr"):
                P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=8, horizon=5,
                       gradient_refinement_steps=2, gradient_refinement_lr=bad_lr,
                       device="cpu")

    def test_u_scale_respected(self):
        d, ctrl = self._run(10, u_scale=2.0)
        assert np.isfinite(d)
        assert float(ctrl.U.abs().max()) <= float(self.U_MAX[0]) + 1e-9


class TestRunMppiJit:
    """``run_mppi_jit``'s contracts: ``u_per_command`` blocks, the batched
    loop, a ``dynamics_params`` swap, the step-dependent default cost."""

    def test_u_per_command_block_matches_eager(self):
        def build():
            return P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=32, horizon=8,
                          lambda_=1.0, seed=SEED, u_per_command=2, device="cpu")

        x0 = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        states, actions, total = P.run_mppi_jit(build(), linear_dynamics, x0, steps=6)
        assert states.shape == (7, 2) and actions.shape == (6, 2)
        ctrl2, x = build(), x0
        eager_actions, eager_total = [], 0.0
        for _ in range(3):
            block = ctrl2.command(x)  # (2, 2)
            for j in range(2):
                x = linear_dynamics(x, block[j])
                eager_total += float(quadratic_cost(x[None], block[j][None])[0])
                eager_actions.append(block[j].numpy())
        np.testing.assert_allclose(actions.numpy(), np.stack(eager_actions), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(states[-1].numpy(), x.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(total), eager_total, rtol=1e-9)

    def test_batched_controller_whole_loop(self):
        N = 3

        def build():
            return P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_envs=N,
                                  num_samples=32, horizon=8, lambda_=1.0, seed=SEED,
                                  u_per_command=2, device="cpu")

        x0 = torch.tensor([[-2.0, 1.0], [0.5, -0.5], [1.0, 1.0]], dtype=DTYPE)
        states, actions, total = P.run_mppi_jit(build(), linear_dynamics, x0, steps=4)
        assert states.shape == (5, N, 2)
        assert actions.shape == (4, N, 2)
        assert total.shape == (N,)
        ctrl2, x = build(), x0
        eager_total, eager_actions = np.zeros(N), []
        for _ in range(2):
            block = ctrl2.command(x)  # (N, upc, nu)
            for j in range(2):
                a_j = block[:, j]
                x = linear_dynamics(x, a_j)
                eager_total += quadratic_cost(x, a_j).numpy()
                eager_actions.append(a_j.numpy())
        np.testing.assert_allclose(actions.numpy(), np.stack(eager_actions), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(states[-1].numpy(), x.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(total.numpy(), eager_total, rtol=1e-9)

    def test_dynamics_params_swap_takes_effect(self):
        def pdyn(p, state, action):
            return state + action @ (p * B).T

        def build(p0):
            return P.MPPI(pdyn, quadratic_cost, 2, eye(), num_samples=32, horizon=6,
                          lambda_=1.0, seed=SEED, dynamics_params=torch.tensor(p0, dtype=DTYPE),
                          device="cpu")

        ctrl = build(1.0)
        x0 = torch.tensor([-1.0, 0.5], dtype=DTYPE)
        P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
        ctrl.dynamics_params = torch.tensor(0.5, dtype=DTYPE)  # "retrained" model
        ctrl._state = build(1.0)._state  # back to a known state
        _, acts_swapped, _ = P.run_mppi_jit(ctrl, linear_dynamics, x0, steps=3)
        _, acts_fresh, _ = P.run_mppi_jit(build(0.5), linear_dynamics, x0, steps=3)
        np.testing.assert_allclose(acts_swapped.numpy(), acts_fresh.numpy(), rtol=1e-12,
                                   atol=1e-12)

    def test_step_dependent_default_cost(self):
        def dyn_t(state, action, t):
            return state + action @ B.T

        def cost_t(state, action, t):
            return quadratic_cost(state, action) + 0.0 * t

        ctrl = P.MPPI(dyn_t, cost_t, 2, eye(), num_samples=16, horizon=4, seed=0,
                      step_dependent_dynamics=True, device="cpu")
        _, _, total = P.run_mppi_jit(ctrl, lambda x, a: linear_dynamics(x, a),
                                     torch.zeros(2, dtype=DTYPE), steps=2)
        assert torch.isfinite(total)


def _trajectory_rowset(a):
    """A stack of trajectories as a set of whole rows: each (T, nu)
    trajectory flattened, the rows sorted lexicographically."""
    f = np.asarray(a).reshape(np.shape(a)[0], -1)
    return f[np.lexsort(f.T[::-1])]


class TestEliteReuse:
    """``num_elites``: the lowest-cost perturbed trajectories of each cycle,
    shifted, sampled again in the next (iCEM, arXiv:2008.06389 §3)."""

    U_LIM = 2.0

    @staticmethod
    def _pendulum():
        dt, g, m, l = 0.05, 10.0, 1.0, 1.0

        def dyn(s, u):
            th, thd = s[..., 0], s[..., 1]
            u0 = torch.clamp(u[..., 0], -2.0, 2.0)
            thd2 = torch.clamp(
                thd + (3 * g / (2 * l) * torch.sin(th) + 3.0 / (m * l**2) * u0) * dt, -8.0, 8.0)
            return torch.stack([th + thd2 * dt, thd2], -1)

        def cost(s, u):
            th = torch.remainder(s[..., 0] + math.pi, 2 * math.pi) - math.pi
            return th**2 + 0.1 * s[..., 1]**2 + 0.001 * u[..., 0]**2

        return dyn, cost

    def _swingup_cost(self, num_elites, seed, K=16, T=25, steps=100):
        dyn, cost = self._pendulum()
        ctrl = P.MPPI(dyn, cost, 2, torch.tensor([[4.0]], dtype=DTYPE), num_samples=K,
                      horizon=T, lambda_=1.0, seed=seed,
                      u_min=torch.tensor([-self.U_LIM], dtype=DTYPE),
                      u_max=torch.tensor([self.U_LIM], dtype=DTYPE), num_elites=num_elites,
                      device="cpu")
        x = torch.tensor([math.pi, 0.0], dtype=DTYPE)
        total = 0.0
        for _ in range(steps):
            a = ctrl.command(x)
            total += float(cost(x, a.reshape(1)))
            x = dyn(x, a.reshape(1))
        return total

    def test_starved_k_quality_improves(self):
        """K = 16: keeping the 4 best trajectories wins on most seeds (same
        seed, same noise stream) and on the mean by at least 5 %."""
        seeds = range(4)
        base = [self._swingup_cost(0, s) for s in seeds]
        elite = [self._swingup_cost(4, s) for s in seeds]
        wins = sum(e < b for e, b in zip(elite, base))
        assert wins >= 3, (base, elite)
        assert np.mean(elite) < 0.95 * np.mean(base), (base, elite)

    def test_injection_rows_and_refresh(self):
        """With the null row, a sampler and elites the leading rows are
        [null, sampler, elites]; the elite rows are the last cycle's top-E
        shifted and clamped; the stored elites are this cycle's top-E."""
        class Ramp(P.SpecificActionSampler):
            num_trajectories = 1

            def sample_trajectories(self, state, info):
                return 0.25 * torch.ones((1, 8, 2), dtype=DTYPE)

        E = 3
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=24, horizon=8,
                      lambda_=1.0, seed=3, u_min=-torch.ones(2, dtype=DTYPE),
                      u_max=torch.ones(2, dtype=DTYPE), sample_null_action=True,
                      specific_action_sampler=Ramp(), num_elites=E, device="cpu")
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        ctrl.command(x)
        prev_elites = ctrl._state.elites
        idx = np.argsort(ctrl.cost_total.numpy(), kind="stable")[:E]
        np.testing.assert_array_equal(_trajectory_rowset(ctrl.perturbed_action[idx].numpy()),
                                      _trajectory_rowset(prev_elites.numpy()))

        ctrl.command(linear_dynamics(x, ctrl.U[0]))
        np.testing.assert_array_equal(ctrl.perturbed_action[0].numpy(), 0.0)
        np.testing.assert_allclose(ctrl.perturbed_action[1].numpy(), 0.25)
        expected = torch.clamp(PS._shift_elites(prev_elites, ctrl._params.u_init), -1.0, 1.0)
        np.testing.assert_array_equal(ctrl.perturbed_action[2:2 + E].numpy(), expected.numpy())

    def test_action_cost_accounts_for_elite_rows(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=6,
                      seed=0, num_elites=4, device="cpu")
        ctrl.command(torch.tensor([-1.0, 2.0], dtype=DTYPE))
        assert torch.isfinite(ctrl.cost_total).all()
        np.testing.assert_allclose(float(ctrl.omega.sum()), 1.0, rtol=1e-9)

    def test_off_by_default(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=8, horizon=5,
                      seed=0, device="cpu")
        assert ctrl._state.elites is None
        ctrl.command(torch.zeros(2, dtype=DTYPE))
        assert ctrl._state.elites is None

    def test_reset_and_change_horizon(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=6,
                      seed=0, num_elites=2, device="cpu")
        ctrl.command(torch.zeros(2, dtype=DTYPE))
        ctrl.change_horizon(9)
        assert ctrl._state.elites.shape == (2, 9, 2)
        np.testing.assert_array_equal(ctrl._state.elites[0].numpy(), ctrl._state.U.numpy())
        ctrl.command(torch.zeros(2, dtype=DTYPE))
        ctrl.reset()
        np.testing.assert_array_equal(ctrl._state.elites[1].numpy(), ctrl._state.U.numpy())

    def test_shift_helper_shifts_elites(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=6,
                      seed=0, num_elites=2, device="cpu")
        ctrl.command(torch.zeros(2, dtype=DTYPE))
        before = ctrl._state.elites.numpy().copy()
        ctrl.shift_nominal_trajectory()
        after = ctrl._state.elites.numpy()
        np.testing.assert_array_equal(after[:, :-1], before[:, 1:])
        np.testing.assert_array_equal(after[:, -1], np.broadcast_to(
            ctrl._params.u_init.numpy(), after[:, -1].shape))

    def test_checkpoint_roundtrip(self, tmp_path):
        from pytorch_mppi_tpu_torch.utils import checkpoint as CK

        def build():
            return P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16,
                          horizon=6, seed=11, num_elites=3, device="cpu")

        a = build()
        x = torch.tensor([1.0, -1.0], dtype=DTYPE)
        a.command(x)
        path = str(tmp_path / "elites.npz")
        CK.save_controller(path, a)
        b = build()
        CK.load_controller(path, b)
        np.testing.assert_array_equal(a._state.elites.numpy(), b._state.elites.numpy())
        np.testing.assert_array_equal(a.command(x).numpy(), b.command(x).numpy())

    def test_composes_with_num_iterations_and_adaptive_cov(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(0.25), num_samples=16, horizon=6,
                      seed=0, num_elites=3, num_iterations=3, adaptive_covariance=True,
                      device="cpu")
        x = torch.tensor([-2.0, 2.0], dtype=DTYPE)
        for _ in range(4):
            x = linear_dynamics(x, ctrl.command(x))
        assert torch.isfinite(x).all()
        assert torch.isfinite(ctrl._state.elites).all()

    def test_run_mppi_jit_threads_elites(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=6,
                      seed=0, num_elites=2, device="cpu")
        _, _, total = P.run_mppi_jit(ctrl, linear_dynamics,
                                     torch.tensor([-1.0, 1.0], dtype=DTYPE), steps=4)
        assert torch.isfinite(total)
        assert ctrl._state.elites.shape == (2, 6, 2)
        assert torch.isfinite(ctrl._state.elites).all()

    def test_gates(self):
        for cls, kw in ((P.SMPPI, dict(w_action_seq_cost=0.1)),
                        (P.KMPPI, dict(num_support_pts=4))):
            with pytest.raises(ValueError, match="only supported on MPPI"):
                cls(linear_dynamics, quadratic_cost, 2, eye(), num_samples=8, horizon=8,
                    num_elites=2, device="cpu", **kw)
        with pytest.raises(ValueError, match="only supported on MPPI"):
            PS.make_batched_step(MPPIConfig(nx=2, nu=2, K=8, T=5, dtype=DTYPE, num_elites=2),
                                 2, linear_dynamics, quadratic_cost)
        with pytest.raises(ValueError, match="num_elites"):
            PS.make_mppi_step(MPPIConfig(nx=2, nu=2, K=8, T=5, dtype=DTYPE, num_elites=-1),
                              linear_dynamics, quadratic_cost)
        # capacity: the injected rows must leave room for fresh noise
        with pytest.raises(ValueError, match="fills all K"):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=4, horizon=5,
                   num_elites=4, device="cpu")
