"""JAX's ``tests/test_extensions.py`` classes ``TestStochasticDynamics``
(:27-73), ``TestDynamicsParams`` (:141-158), ``TestRiskSensitiveCVaR``
(:311-428), ``TestGradientRefinement`` (:595-722), ``TestPrngAutoDefault``
(:724-741), ``TestRunMppiJit`` (:1019-1148), ``TestEliteReuse``
(:1149-1357) and ``TestTerminalFinalCost`` (:1358-1494, but its mesh test)
on the port, on the CPU: each JAX test translated to the port's API with
JAX's floors, in float64 as JAX's file.  Stochastic dynamics take a
trailing ``torch.Generator`` where JAX's take a key.

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


class TestStochasticDynamics:
    def test_m_gt_1_with_keys(self):
        """stochastic_dynamics=True passes a per-step generator; with M > 1
        the M rollouts see different noise draws."""

        def noisy_dynamics(state, action, rng):
            noise = 0.05 * torch.randn(state.shape, generator=rng, dtype=DTYPE)
            return state + action @ B.T + noise

        ctrl = P.MPPI(noisy_dynamics, quadratic_cost, 2, eye(), num_samples=64, horizon=8,
                      lambda_=1.0, seed=SEED, stochastic_dynamics=True, rollout_samples=4,
                      rollout_var_cost=0.1, terminal_state_cost=None, device="cpu")
        a = ctrl.command(torch.tensor([-1.0, -1.0], dtype=DTYPE))
        assert a.shape == (2,)
        assert torch.isfinite(a).all()
        # M > 1 stores rollouts; the M axis must differ (different draws)
        assert ctrl.states.shape[0] == 4
        assert not torch.allclose(ctrl.states[0], ctrl.states[1])

    def test_stochastic_step_dependent(self):
        def noisy_step_dynamics(state, action, t, rng):
            noise = 0.01 * torch.randn(state.shape, generator=rng, dtype=DTYPE)
            return state + action @ B.T + noise

        def cost_step(state, action, t):
            return quadratic_cost(state, action)

        ctrl = P.MPPI(noisy_step_dynamics, cost_step, 2, eye(), num_samples=32, horizon=5,
                      lambda_=1.0, seed=SEED, stochastic_dynamics=True,
                      step_dependent_dynamics=True, device="cpu")
        a = ctrl.command(torch.tensor([0.0, 0.0], dtype=DTYPE))
        assert torch.isfinite(a).all()

    def test_get_rollouts_stochastic(self):
        def noisy_dynamics(state, action, rng):
            return state + action @ B.T + 0.01 * torch.randn(state.shape, generator=rng,
                                                              dtype=DTYPE)

        ctrl = P.MPPI(noisy_dynamics, quadratic_cost, 2, eye(), num_samples=32, horizon=5,
                      lambda_=1.0, seed=SEED, stochastic_dynamics=True, device="cpu")
        ctrl.command(torch.tensor([0.0, 0.0], dtype=DTYPE))
        r = ctrl.get_rollouts(torch.tensor([0.0, 0.0], dtype=DTYPE), num_rollouts=3)
        assert r.shape == (3, 5, 2)


class TestDynamicsParams:
    def test_params_are_traced_not_baked(self):
        """Swapping dynamics_params must change the result WITHOUT
        rebuilding (the weights are arguments, not constants of the
        bundle)."""

        def dyn(p, state, action):
            return state + action @ B.T * p["gain"]

        ctrl = P.MPPI(dyn, quadratic_cost, 2, eye(), num_samples=64, horizon=5, lambda_=1.0,
                      seed=SEED, dynamics_params={"gain": torch.tensor(1.0, dtype=DTYPE)},
                      device="cpu")
        state = torch.tensor([-2.0, -2.0], dtype=DTYPE)
        a1 = ctrl.command(state, shift_nominal_trajectory=False)
        fns_before = ctrl._fns
        ctrl.dynamics_params = {"gain": torch.tensor(-1.0, dtype=DTYPE)}
        a2 = ctrl.command(state, shift_nominal_trajectory=False)
        assert ctrl._fns is fns_before  # no rebuild
        assert not torch.allclose(a1, a2)


class TestRiskSensitiveCVaR:
    """risk_alpha: CVaR aggregation over the M stochastic rollouts: the
    cost is the mean of the worst ceil(alpha·M) rollout costs a sample
    instead of the mean over all M."""

    @staticmethod
    def _stoch_dyn(state, action, rng):
        # multiplicative noise: bigger actions are riskier
        eps = torch.randn(state.shape, generator=rng, dtype=state.dtype)
        return state + action @ B.T * (1.0 + 0.5 * eps)

    def _rollout(self, risk_alpha, M=4, K=16, T=5):
        config = MPPIConfig(nx=2, nu=2, K=K, T=T, M=M, dtype=DTYPE, stochastic_dynamics=True,
                            risk_alpha=risk_alpha)
        dyn_w = PS.wrap_dynamics(config, self._stoch_dyn)
        cost_w = PS.wrap_cost(config, quadratic_cost)
        acts = torch.randn(K, T, 2, generator=torch.Generator().manual_seed(1), dtype=DTYPE)
        x0 = torch.tensor([-3.0, -2.0], dtype=DTYPE)
        return PS.rollout_costs(config, dyn_w, cost_w, x0, acts, seed=2)

    def test_exact_worst_case_aggregation(self):
        """CVaR_0.5 with M = 4 equals the mean of each trajectory's two
        worst rollout costs, recomputed from the stored per-rollout states
        and actions (which M > 1 always keeps)."""
        cost_cvar, states, actions = self._rollout(0.5)
        per_m = quadratic_cost(states, actions).sum(-1)  # (M, K)
        worst2 = torch.sort(per_m, dim=0, descending=True).values[:2]
        np.testing.assert_allclose(cost_cvar.numpy(), worst2.mean(0).numpy(), rtol=1e-12)

    def test_alpha_one_recovers_mean(self):
        c_mean, _, _ = self._rollout(0.0)
        c_all, _, _ = self._rollout(1.0)
        np.testing.assert_allclose(c_mean.numpy(), c_all.numpy(), rtol=1e-12)

    def test_cvar_upper_bounds_mean(self):
        c_mean, _, _ = self._rollout(0.0)
        c_cvar, _, _ = self._rollout(0.25)
        assert (c_cvar.numpy() >= c_mean.numpy() - 1e-12).all()

    def test_risk_averse_controller_backs_off_the_cliff(self):
        """A cliff: reward for moving right, a large penalty past x = 2, and
        multiplicative dynamics noise (the risk grows with the commanded
        speed).  The CVaR planner, optimising the worst quarter of its
        stochastic rollouts, picks a markedly smaller action than the
        risk-neutral planner (JAX's floor, 0.75)."""
        def cliff_dyn(s, u, rng):
            eps = torch.randn(s.shape, generator=rng, dtype=s.dtype)
            return s + u * (1.0 + 0.7 * eps)

        def cliff_cost(s, u):
            x = s[..., 0]
            return -x + 100.0 * torch.clamp(x - 2.0, min=0.0)

        def first_action(risk_alpha):
            ctrl = P.MPPI(cliff_dyn, cliff_cost, 1, torch.eye(1, dtype=DTYPE), num_samples=512,
                          horizon=1, lambda_=0.3, seed=SEED, stochastic_dynamics=True,
                          rollout_samples=16, risk_alpha=risk_alpha,
                          u_min=torch.tensor([0.0], dtype=DTYPE),
                          u_max=torch.tensor([3.0], dtype=DTYPE), device="cpu")
            return float(ctrl.command(torch.zeros(1, dtype=DTYPE)).reshape(-1)[0])

        neutral = first_action(0.0)
        averse = first_action(0.25)
        assert averse < 0.75 * neutral, (averse, neutral)

    def test_validation(self):
        with pytest.raises(ValueError, match="risk_alpha"):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4, seed=0,
                   risk_alpha=1.5, device="cpu")
        with pytest.raises(ValueError, match="rollout_samples"):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4, seed=0,
                   risk_alpha=0.5, device="cpu")

    def test_ops_layer_validation(self):
        """A hand-built MPPIConfig gets the controller's errors from the
        step factories: risk_alpha > 0 at M = 1 would otherwise be ignored."""
        import dataclasses

        factories = (
            lambda c: PS.make_mppi_step(c, linear_dynamics, quadratic_cost),
            lambda c: PS.make_smppi_step(c, linear_dynamics, quadratic_cost),
            lambda c: PS.make_kmppi_step(dataclasses.replace(c, num_support_pts=3),
                                         linear_dynamics, quadratic_cost),
        )
        for make in factories:
            with pytest.raises(ValueError, match="rollout_samples"):
                make(MPPIConfig(nx=2, nu=2, K=16, T=5, dtype=DTYPE, risk_alpha=0.5))
            with pytest.raises(ValueError, match="risk_alpha"):
                make(MPPIConfig(nx=2, nu=2, K=16, T=5, M=4, dtype=DTYPE,
                                stochastic_dynamics=True, risk_alpha=1.5))
        # the batched rollout has no M axis at all: loud, not silent
        with pytest.raises(ValueError, match="MPPI_Batched"):
            PS.make_batched_step(
                MPPIConfig(nx=2, nu=2, K=16, T=5, M=4, dtype=DTYPE, stochastic_dynamics=True,
                           risk_alpha=0.5),
                2, linear_dynamics, quadratic_cost)


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


class TestPrngAutoDefault:
    """``prng_impl="auto"``, the default, resolves to None off a TPU (JAX's
    ``_resolve_prng_impl``); the port draws with Philox from ``seed`` and
    refuses a JAX generator such as ``"rbg"``."""

    def test_auto_resolves_to_threefry_on_cpu(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4,
                      seed=0, device="cpu")
        assert ctrl.prng_impl is None
        with pytest.raises(ValueError, match="prng_impl='rbg' selects a JAX generator"):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4, seed=0,
                   prng_impl="rbg", device="cpu")

    def test_batched_auto_default(self):
        ctrl = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_envs=2,
                              num_samples=16, horizon=4, seed=0, device="cpu")
        assert ctrl.prng_impl is None


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


class TestTerminalFinalCost:
    """Final-state terminal cost (``terminal_final_cost``): a terminal cost
    declared as a function of the LAST state/action evaluates on the final
    state of the rollout, keeping the rollout storage off (no (M, K, T, nx)
    tensor) and the fused kernels eligible.  JAX's ``tests/test_extensions.py``
    class of that name (:1358-1494) on the port, its mesh test aside (the
    port's sharding is held by ``test_torch_sharding.py``)."""

    GOAL = torch.tensor([1.5, -0.5], dtype=DTYPE)

    @classmethod
    def _fterm(cls, s, a):
        return 10.0 * ((s - cls.GOAL) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)

    @classmethod
    def _full_term(cls, states, actions):
        return cls._fterm(states[..., -1, :], actions[..., -1, :])

    def _pair(self, **extra):
        kw = dict(num_samples=64, horizon=8, lambda_=1.0, seed=11,
                  u_min=-torch.ones(2, dtype=DTYPE), u_max=torch.ones(2, dtype=DTYPE),
                  u_scale=0.7, device="cpu")
        kw.update(extra)
        full = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                      terminal_state_cost=self._full_term, **kw)
        fin = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                     terminal_final_cost=self._fterm, **kw)
        return full, fin

    def test_bit_identical_to_full_terminal(self):
        """Same seed => same noise stream; the identical cost through the
        final-state hook reproduces the full-trajectory hook bit for bit,
        while the final-state variant keeps rollout storage off."""
        full, fin = self._pair()
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        for _ in range(3):
            a1, a2 = full.command(x), fin.command(x)
            torch.testing.assert_close(a1, a2, rtol=0, atol=0)
            torch.testing.assert_close(full.cost_total, fin.cost_total, rtol=0, atol=0)
            x = linear_dynamics(x, a1)
        assert full.states is not None  # the full hook forces storage
        assert fin.states is None  # the final hook keeps the lazy contract

    def test_multi_rollout_m(self):
        """M > 1: the final hook sees the (M·K,)-flat final states and its
        (M, K) cost broadcasts exactly like the full hook's."""
        full, fin = self._pair(rollout_samples=3, rollout_var_cost=0.5)
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        torch.testing.assert_close(full.command(x), fin.command(x), rtol=0, atol=0)

    def test_mutually_exclusive(self):
        with pytest.raises(ValueError, match="mutually exclusive"):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=8, horizon=4,
                   terminal_state_cost=self._full_term, terminal_final_cost=self._fterm,
                   device="cpu").command(torch.zeros(2, dtype=DTYPE))

    def test_smppi_kmppi(self):
        kw = dict(num_samples=64, horizon=8, lambda_=1.0, seed=11,
                  u_min=-torch.ones(2, dtype=DTYPE), u_max=torch.ones(2, dtype=DTYPE),
                  device="cpu")
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        bounds = dict(action_min=-torch.ones(2, dtype=DTYPE), action_max=torch.ones(2, dtype=DTYPE))
        s_full = P.SMPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                         terminal_state_cost=self._full_term, **bounds, **kw)
        s_fin = P.SMPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                        terminal_final_cost=self._fterm, **bounds, **kw)
        torch.testing.assert_close(s_full.command(x), s_fin.command(x), rtol=0, atol=0)
        k_full = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                         terminal_state_cost=self._full_term, num_support_pts=4, **kw)
        k_fin = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(0.5),
                        terminal_final_cost=self._fterm, num_support_pts=4, **kw)
        torch.testing.assert_close(k_full.command(x), k_fin.command(x), rtol=0, atol=0)

    def test_batched(self):
        def dyn_n(s, a):
            return s + a

        def cost_n(s, a):
            return (s ** 2).sum(-1)

        full = P.MPPI_Batched(dyn_n, cost_n, 2, eye(0.4), num_envs=3,
                              terminal_state_cost=self._full_term, num_samples=32, horizon=6,
                              seed=5, device="cpu")
        fin = P.MPPI_Batched(dyn_n, cost_n, 2, eye(0.4), num_envs=3,
                             terminal_final_cost=self._fterm, num_samples=32, horizon=6, seed=5,
                             device="cpu")
        X = torch.tensor([[-2.0, 1.0], [2.0, -1.0], [-1.0, 0.5]], dtype=DTYPE)
        torch.testing.assert_close(full.command(X), fin.command(X), rtol=0, atol=0)
        with pytest.raises(ValueError, match="mutually exclusive"):
            P.MPPI_Batched(dyn_n, cost_n, 2, eye(), num_envs=2,
                           terminal_state_cost=self._full_term, terminal_final_cost=self._fterm,
                           num_samples=8, horizon=4, device="cpu")

    def test_gradient_refinement_descends_terminal(self):
        """The refiner's objective includes the final-state terminal cost:
        with a pure-terminal task (zero running cost) the refined nominal
        reaches a lower terminal cost than the unrefined one."""
        def zero_cost(s, a):
            return torch.zeros(s.shape[:-1], dtype=DTYPE)

        kw = dict(num_samples=16, horizon=8, lambda_=1.0, seed=2,
                  u_min=-torch.ones(2, dtype=DTYPE), u_max=torch.ones(2, dtype=DTYPE),
                  device="cpu")
        base = P.MPPI(linear_dynamics, zero_cost, 2, eye(), terminal_final_cost=self._fterm,
                      **kw)
        ref = P.MPPI(linear_dynamics, zero_cost, 2, eye(), terminal_final_cost=self._fterm,
                     gradient_refinement_steps=8, gradient_refinement_lr=0.2, **kw)
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)

        def final_cost_of(ctrl):
            ctrl.command(x)
            s = x
            for t in range(ctrl.T):
                s = linear_dynamics(s, ctrl.U[t])
            return float(self._fterm(s, ctrl.U[-1]))

        assert final_cost_of(ref) < final_cost_of(base)


class TestSpecificDynamicsHook:
    def test_specific_dynamics_applied_each_step(self):
        """JAX's ``tests/test_extensions.py:98-119``: the sampler's per-step
        ``specific_dynamics`` hook post-processes each rollout state, so
        every stored state respects the hook's clamp."""

        class ClampSampler(P.SpecificActionSampler):
            num_trajectories = 1

            def sample_trajectories(self, state, info):
                return torch.zeros((1, 8, 2), dtype=DTYPE)

            def specific_dynamics(self, next_state, state, action, t):
                return torch.clamp(next_state, -1.5, 1.5)

        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=64, horizon=8,
                      lambda_=1.0, seed=SEED, specific_action_sampler=ClampSampler(),
                      terminal_state_cost=lambda s, a: torch.zeros(s.shape[1], dtype=DTYPE),
                      device="cpu")
        ctrl.command(torch.tensor([0.0, 0.0], dtype=DTYPE))
        assert float(torch.max(torch.abs(ctrl.states))) <= 1.5 + 1e-9


class TestAntitheticSampling:
    """``antithetic_sampling=True``: K/2 mirrored Gaussian draws
    (``tests/test_extensions.py:161-206``)."""

    def test_noise_pairs_mirror(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=64, horizon=5,
                      lambda_=1.0, seed=SEED, antithetic_sampling=True, device="cpu")
        ctrl.command(torch.tensor([0.0, 0.0], dtype=DTYPE))
        noise = ctrl.noise.numpy()  # (K, T, nu); unbounded, mu = 0: the raw draw
        np.testing.assert_allclose(noise[:32], -noise[32:], atol=1e-12)

    def test_mirrored_mean_is_mu(self):
        mu = torch.tensor([0.3, -0.1], dtype=DTYPE)
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), noise_mu=mu, num_samples=128,
                      horizon=4, lambda_=1.0, seed=SEED, antithetic_sampling=True, device="cpu")
        ctrl.command(torch.tensor([0.0, 0.0], dtype=DTYPE))
        # the pairs cancel about mu: the sample mean over K is mu
        mean = ctrl.noise.numpy().mean(axis=0)
        np.testing.assert_allclose(mean, np.broadcast_to(mu.numpy(), mean.shape), atol=1e-12)

    def test_reaches_goal_and_deterministic(self):
        def run():
            ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=200,
                          horizon=10, lambda_=1.0, seed=SEED, antithetic_sampling=True,
                          device="cpu")
            state = torch.tensor([-2.0, -2.0], dtype=DTYPE)
            for _ in range(15):
                state = linear_dynamics(state, ctrl.command(state))
            return state.numpy()

        s1, s2 = run(), run()
        np.testing.assert_array_equal(s1, s2)
        assert np.linalg.norm(s1 - GOAL.numpy()) < 1.0

    def test_odd_k(self):
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=33, horizon=4,
                      lambda_=1.0, seed=SEED, antithetic_sampling=True, device="cpu")
        a = ctrl.command(torch.tensor([0.5, 0.5], dtype=DTYPE))
        assert a.shape == (2,)
        assert torch.isfinite(ctrl.cost_total).all()


class TestScanUnroll:
    def test_unroll_batched_and_variants(self):
        """JAX's ``tests/test_extensions.py:758-775``: ``scan_unroll`` is a
        scheduling knob, so KMPPI and MPPI_Batched give the same command bit
        for bit at any factor (0 = the whole loop)."""
        x = torch.tensor([0.5, -0.5], dtype=DTYPE)
        a1 = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=32, horizon=8,
                     seed=SEED, device="cpu").command(x)
        a2 = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=32, horizon=8,
                     seed=SEED, scan_unroll=0, device="cpu").command(x)
        np.testing.assert_array_equal(a1.numpy(), a2.numpy())
        xb = torch.stack([x, -x])
        kw = dict(num_envs=2, num_samples=32, horizon=6, seed=SEED, device="cpu")
        b1 = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), **kw).command(xb)
        b2 = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), scan_unroll=0,
                            **kw).command(xb)
        np.testing.assert_array_equal(b1.numpy(), b2.numpy())


class TestKMPPIHorizonGuard:
    """``change_horizon`` below ``num_support_pts`` is clamped, so a horizon
    sweep never ill-conditions the kernel's Gram solve
    (``tests/test_extensions.py:778-810``)."""

    def test_horizon_sweep_stays_finite(self):
        ctrl = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=32, horizon=15,
                       num_support_pts=5, seed=SEED, device="cpu")
        s = torch.tensor([-1.0, 1.0], dtype=DTYPE)
        for T in list(range(1, 51, 7)) + [1, 50, 3]:
            ctrl.change_horizon(T)
            assert ctrl.T >= ctrl.num_support_pts
            assert torch.isfinite(ctrl._interp_full).all()
            assert torch.isfinite(ctrl._interp_shift).all()
            assert torch.isfinite(ctrl.command(s)).all()

    def test_tiny_horizon_default_nsp(self):
        ctrl = P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=1,
                       seed=SEED, device="cpu")
        assert ctrl.num_support_pts == 1
        assert torch.isfinite(ctrl.command(torch.zeros(2, dtype=DTYPE))).all()

    def test_nsp_above_horizon_rejected(self):
        with pytest.raises(ValueError):
            P.KMPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4,
                    num_support_pts=8, seed=SEED, device="cpu")


def _white_params():
    from pytorch_mppi_tpu_torch.config import MPPIParams

    return MPPIParams(noise_mu=torch.zeros(2, dtype=DTYPE), noise_sigma=eye(),
                      lambda_=torch.tensor(1.0, dtype=DTYPE),
                      u_min=torch.full((2,), -math.inf, dtype=DTYPE),
                      u_max=torch.full((2,), math.inf, dtype=DTYPE),
                      u_init=torch.zeros(2, dtype=DTYPE))


class TestTimeCorrelatedNoise:
    """``noise_rho``: AR(1) correlation of the exploration noise along the
    horizon, with N(mu, Sigma) marginals (``tests/test_extensions.py:813-885``).
    The port's draws take a ``torch.Generator`` where JAX's take a key."""

    def test_marginals_and_lag1_correlation(self):
        rho = 0.8
        n = PS.sample_noise_flat(torch.Generator().manual_seed(0), 4096, 20, _white_params(), DTYPE,
                                 noise_rho=rho).numpy().reshape(4096, 20, 2)
        # unit marginal variance at every step
        assert abs(n.std(axis=0) - 1.0).max() < 0.08
        x, y = n[:, :-1, :], n[:, 1:, :]
        corr = (x * y).mean() / (x.std() * y.std())
        assert abs(corr - rho) < 0.05

    def test_rho_zero_is_white_and_bitwise_default(self):
        a = PS.sample_noise_flat(torch.Generator().manual_seed(1), 64, 8, _white_params(), DTYPE)
        b = PS.sample_noise_flat(torch.Generator().manual_seed(1), 64, 8, _white_params(), DTYPE,
                                 noise_rho=0.0)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_smoother_candidate_trajectories(self):
        """The correlation smooths the candidates along the horizon
        (E|n_t - n_{t-1}| scales with sqrt(2(1 - rho))), and the loop still
        reaches the goal."""

        def run(rho):
            ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=256,
                          horizon=10, lambda_=1.0, seed=SEED, noise_rho=rho, device="cpu")
            s = torch.tensor([-3.0, -2.0], dtype=DTYPE)
            ctrl.command(s)
            rough = float(torch.abs(torch.diff(ctrl.noise, dim=1)).mean())
            for _ in range(14):
                s = linear_dynamics(s, ctrl.command(s))
            return rough, float(torch.linalg.norm(s - GOAL))

        rough_w, _ = run(0.0)
        rough_c, d_c = run(0.7)
        assert d_c < 2.5
        assert rough_c < 0.7 * rough_w

    def test_invalid_rho_rejected(self):
        with pytest.raises(ValueError):
            P.MPPI(linear_dynamics, quadratic_cost, 2, eye(), num_samples=16, horizon=4, seed=0,
                   noise_rho=1.0, device="cpu")


class TestValidationGuards:
    """Loud errors instead of silent wrong results
    (``tests/test_extensions.py:888-1016``; its ``num_iterations`` and
    ``run_mppi_jit`` checks stand in ``test_torch_iterations.py`` and
    ``test_torch_runner.py``)."""

    def test_batched_noise_rho_validated(self):
        with pytest.raises(ValueError):
            P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_envs=2,
                           num_samples=16, horizon=4, seed=0, noise_rho=1.5, device="cpu")

    def test_batched_terminal_cost(self):
        """MPPI_Batched takes a terminal cost, with the single-plant solve's
        lazy rollout storage."""

        def terminal(states, actions):
            # (N, K, T, nx) -> (N, K): the last state weighed heavily
            return 10.0 * ((GOAL - states[..., -1, :]) ** 2).sum(-1)

        x0 = torch.tensor([[-3.0, -2.0], [3.0, 2.0]], dtype=DTYPE)
        kw = dict(num_envs=2, horizon=8, seed=SEED, device="cpu")
        plain = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_samples=64, **kw)
        plain.command(x0)
        assert plain.states is None  # lazy storage
        term = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_samples=64,
                              terminal_state_cost=terminal, **kw)
        a = term.command(x0)
        assert a.shape == (2, 2)
        assert term.states.shape == (2, 64, 8, 2)
        assert not np.allclose(a.numpy(), plain.command(x0).numpy())  # the cost matters
        s = x0
        ctrl = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_samples=128,
                              terminal_state_cost=terminal, **kw)
        for _ in range(15):
            s = linear_dynamics(s, ctrl.command(s))
        assert (torch.linalg.norm(GOAL - s, dim=-1).numpy() < 1.5).all()

    def test_batched_terminal_cost_sees_scaled_actions(self):
        """The batched terminal cost gets the ``u_scale``-scaled actions, as
        the single-plant solve stores them."""

        def identity_dyn(state, action):
            return state

        def zero_cost(state, action):
            return torch.zeros(state.shape[:-1], dtype=DTYPE)

        def action_energy(states, actions):
            return (actions ** 2).sum(dim=(-1, -2))

        def build(u_scale):
            return P.MPPI_Batched(identity_dyn, zero_cost, 2, eye(), num_envs=2, num_samples=16,
                                  horizon=4, seed=7, u_scale=u_scale,
                                  terminal_state_cost=action_energy, device="cpu")

        c1, c2 = build(1.0), build(2.0)
        # a zero nominal makes the action cost zero: cost_total is the energy
        c1.U = torch.zeros_like(c1.U)
        c2.U = torch.zeros_like(c2.U)
        x0 = torch.zeros((2, 2), dtype=DTYPE)
        c1.command(x0, shift_nominal_trajectory=False)
        c2.command(x0, shift_nominal_trajectory=False)
        np.testing.assert_allclose(c2.cost_total.numpy(), 4.0 * c1.cost_total.numpy(),
                                   rtol=1e-6)

    def test_batched_num_iterations(self):
        """MPPI_Batched takes ``num_iterations``: bit for bit the default at
        1, a different command at 3, and 0 refused."""

        def build(**kw):
            return P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, eye(), num_envs=3,
                                  num_samples=32, horizon=6, seed=SEED, device="cpu", **kw)

        x0 = torch.tensor([[-3.0, -2.0], [1.0, 1.0], [0.0, 0.0]], dtype=DTYPE)
        a_default = build().command(x0)
        a_one = build(num_iterations=1).command(x0)
        np.testing.assert_array_equal(a_default.numpy(), a_one.numpy())
        a_three = build(num_iterations=3).command(x0)
        assert a_three.shape == (3, 2) and torch.isfinite(a_three).all()
        assert not np.allclose(a_three.numpy(), a_one.numpy())
        with pytest.raises(ValueError):
            build(num_iterations=0)


class TestReviewGates:
    def test_batched_rejects_out_of_range_risk_alpha(self):
        """JAX's ``tests/test_extensions.py:1544-1552``: ``make_batched_step``
        checks the range of ``risk_alpha`` as the other factories do."""
        config = MPPIConfig(nx=2, nu=2, K=8, T=5, dtype=DTYPE, risk_alpha=-0.5)
        with pytest.raises(ValueError, match=r"risk_alpha must be in \[0, 1\]"):
            PS.make_batched_step(config, 2, linear_dynamics, quadratic_cost)


class TestEliteTerminalComposition:
    def test_elites_with_terminal_final(self):
        """JAX's ``tests/test_extensions.py:1556-1573``: the elites are the
        lowest total costs, the final-state terminal cost included, and the
        rollout storage stays lazy."""
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, eye(0.5), num_samples=32, horizon=6,
                      seed=4, num_elites=3,
                      terminal_final_cost=lambda s, a: 5.0 * (s ** 2).sum(-1),
                      u_min=-torch.ones(2, dtype=DTYPE), u_max=torch.ones(2, dtype=DTYPE),
                      device="cpu")
        x = torch.tensor([-2.0, 1.0], dtype=DTYPE)
        for _ in range(3):
            x = linear_dynamics(x, ctrl.command(x))
        assert ctrl.states is None
        idx = np.argsort(ctrl.cost_total.numpy())[:3]
        np.testing.assert_array_equal(_trajectory_rowset(ctrl.perturbed_action[idx]),
                                      _trajectory_rowset(ctrl._state.elites))
