"""The port's controllers on the CPU: the pendulum swing-up on both paths,
the device rule, the unported flags, routing and the step cache of ``MPPI``;
the quality checks, API surface and step cache of ``SMPPI`` and ``KMPPI``."""
import logging

import numpy as np
import pytest
import torch

from pytorch_mppi_tpu_torch import (
    KMPPI,
    MPPI,
    SMPPI,
    RBFKernel,
    SpecificActionSampler,
    linear_quadratic,
    run_mppi,
)
from pytorch_mppi_tpu_torch.models import (
    PendulumEnv,
    Toy2DEnvironment,
    angle_normalize,
    pendulum_dynamics,
    pendulum_running_cost,
)

torch.set_num_threads(1)


def _pendulum(**kw):
    return MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor([[10.0]]), num_samples=256, horizon=15,
                lambda_=1.0, u_min=torch.tensor([-2.0]), u_max=torch.tensor([2.0]),
                device="cpu", **kw)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused_plain"])
def test_pendulum_swing_up(use_pallas):
    """Acceptance problem: from hanging [pi, 1], upright within 150 steps.
    ``use_pallas=True`` on the CPU runs the fused kernel's plain version."""
    ctrl = _pendulum(use_pallas=use_pallas)
    assert ctrl._fns.fused == use_pallas
    env = PendulumEnv(downward_start=True)
    run_mppi(ctrl, env, lambda dataset: None, iter=150, render=False)
    assert abs(angle_normalize(env.state[0])) < 0.25
    assert ctrl.cost_total.shape == (256,)
    assert (ctrl.noise is None) == use_pallas


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPPI(pendulum_dynamics, pendulum_running_cost, nx=2, noise_sigma=[[1.0]])


class _HangingSampler(SpecificActionSampler):
    """One row of the pendulum's horizon: no torque."""

    def sample_trajectories(self, state, info):
        return torch.zeros(1, 15, 1)


UNPORTED = [
    ("rollout_samples", 2),
    ("rollout_var_cost", 0.5),
    ("risk_alpha", 0.5),
    ("stochastic_dynamics", True),
    ("specific_action_sampler", _HangingSampler()),
    ("num_iterations", 2),
    ("adaptive_covariance", True),
    ("gradient_refinement_steps", 3),
    ("num_elites", 4),
    ("dynamics_params", {"w": 1.0}),
    ("mesh", "a 1-rank mesh"),  # made in the test (gloo_mesh)
]


# the terminal hooks, ported since: each is taken alone (the full-trajectory
# one keeps the rollout states), and the two together raise the JAX
# controller's ValueError (pytorch_mppi_tpu/ops/solve.py:313-323)
PORTED = {"terminal_state_cost": lambda s, a: s[..., -1, :].sum(-1),
          "terminal_final_cost": lambda s, a: s.sum(-1)}


@pytest.fixture
def gloo_mesh(tmp_path):
    """A Gloo world of this one process and its mesh (a "k" axis of one
    rank), taken down after the test."""
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost(f"file://{tmp_path / 'group'}", 1, 0, device="cpu")
    try:
        yield make_mesh((1,), ("k",), device="cpu")
    finally:
        dist.destroy_process_group()


def _noisy_pendulum(s, a, rng):
    return pendulum_dynamics(s, a) + 0.01 * torch.randn(s.shape, generator=rng, dtype=s.dtype)


def _weighted_pendulum(p, s, a):
    """The pendulum with its action scaled by ``p["w"]`` (dynamics_params)."""
    return pendulum_dynamics(s, a * p["w"])


# the stochastic rollouts, the iterations, the specific-action sampler, elite
# reuse, gradient refinement and dynamics_params, ported since: each flag is
# taken (with what it needs: risk_alpha the M > 1 rollouts, stochastic
# dynamics a generator argument, dynamics_params dynamics that take them),
# reaches the config and runs a command
TAKEN = {"rollout_samples": {}, "rollout_var_cost": {}, "risk_alpha": {"rollout_samples": 4},
         "stochastic_dynamics": {}, "num_iterations": {},
         "adaptive_covariance": {"num_iterations": 2}, "specific_action_sampler": {},
         "gradient_refinement_steps": {}, "num_elites": {}, "dynamics_params": {}}
CONFIG_FIELD = {"rollout_samples": "M", "specific_action_sampler": "num_specific_trajectories",
                "dynamics_params": "parameterized_dynamics"}
OWN_DYNAMICS = {"stochastic_dynamics": _noisy_pendulum, "dynamics_params": _weighted_pendulum}


@pytest.mark.parametrize("flag,value", UNPORTED + list(PORTED.items()),
                         ids=[u[0] for u in UNPORTED] + list(PORTED))
def test_unported_flag_raises(request, flag, value):
    if flag == "mesh":
        # the sharding, ported since: a mesh of one rank splits the samples
        # over one rank, and the command is the unsharded one
        mesh = request.getfixturevalue("gloo_mesh")
        ctrl = _pendulum(mesh=mesh)
        assert ctrl.mesh is mesh
        a = ctrl.command(np.array([np.pi, 1.0]))
        torch.testing.assert_close(a, _pendulum().command(np.array([np.pi, 1.0])),
                                   rtol=0, atol=0)
        assert ctrl.cost_total.shape == (ctrl.K,) and torch.isfinite(ctrl.cost_total).all()
        return
    if flag in TAKEN:
        kw = dict(TAKEN[flag], **{flag: value})
        ctrl = (MPPI(OWN_DYNAMICS[flag], pendulum_running_cost, nx=2,
                     noise_sigma=torch.tensor([[10.0]]), num_samples=64, horizon=15,
                     device="cpu", **kw) if flag in OWN_DYNAMICS else _pendulum(**kw))
        want = {"specific_action_sampler": getattr(value, "num_trajectories", None),
                "dynamics_params": True}.get(flag, value)
        assert getattr(ctrl.config, CONFIG_FIELD.get(flag, flag)) == want
        ctrl.command(np.array([np.pi, 1.0]))
        assert torch.isfinite(ctrl.cost_total).all()
        if flag == "specific_action_sampler":
            assert not ctrl.perturbed_action[0].any()
        if flag == "num_elites":
            assert ctrl._state.elites.shape == (value, ctrl.T, 1)
        M = ctrl.config.M
        assert (ctrl.states is None) == (M == 1)
        if M > 1:
            assert ctrl.states.shape == (M, ctrl.K, ctrl.T, 2)
        assert ctrl._state.counter == ctrl.config.num_iterations
        return
    if flag in PORTED:
        ctrl = _pendulum(**{flag: value})
        ctrl.command(np.array([np.pi, 1.0]))
        assert torch.isfinite(ctrl.cost_total).all()
        assert (ctrl.states is not None) == (flag == "terminal_state_cost")
        with pytest.raises(ValueError, match="mutually exclusive"):
            _pendulum(**PORTED)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        _pendulum(**{flag: value})


def test_plain_callable_routes_to_plain_path(caplog):
    model = linear_quadratic(torch.eye(2), torch.tensor([2.0, 2.0]))
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl = MPPI(lambda s, a: model.dynamics(s, a), model.running_cost, nx=2,
                    noise_sigma=torch.eye(2), num_samples=32, horizon=5,
                    device="cpu", use_pallas=True)
    assert "no kernel model" in caplog.text
    assert not ctrl._fns.fused
    ctrl.command(np.array([0.0, 0.0]))
    assert ctrl.noise.shape == (32, 5, 2)


def test_fused_artifacts_on_fused_path():
    model = linear_quadratic(torch.eye(2), torch.tensor([2.0, 2.0]))
    ctrl = MPPI(model.dynamics, model.running_cost, nx=2, noise_sigma=torch.eye(2),
                num_samples=32, horizon=5, device="cpu", use_pallas=True,
                fused_artifacts=True, u_max=torch.tensor([0.5, 0.5]))
    assert ctrl._fns.fused
    ctrl.command(np.array([0.0, 0.0]))
    assert ctrl.perturbed_action.shape == (32, 5, 2)
    assert float(ctrl.perturbed_action.abs().max()) <= 0.5
    torch.testing.assert_close(ctrl.omega.sum(), torch.tensor(1.0))


def test_change_horizon_reuses_step_fns():
    ctrl = _pendulum()
    fns15 = ctrl._fns
    ctrl.change_horizon(10)
    assert ctrl.U.shape == (10, 1) and ctrl._fns is not fns15
    fns10 = ctrl._fns
    ctrl.change_horizon(15)
    assert ctrl.U.shape == (15, 1) and ctrl._fns is fns15
    ctrl.change_horizon(10)
    assert ctrl._fns is fns10
    assert ctrl.command(np.array([np.pi, 1.0])).shape == (1,)


def test_controller_api_surface():
    ctrl = _pendulum(u_per_command=2)
    assert ctrl.command(np.array([np.pi, 1.0])).shape == (2, 1)
    U = ctrl.U.clone()
    ctrl.shift_nominal_trajectory()
    torch.testing.assert_close(ctrl.U[:-1], U[1:])
    assert ctrl.get_rollouts(np.array([np.pi, 1.0]), num_rollouts=3).shape == (3, 15, 2)
    ctrl.lambda_ = 2.0
    assert ctrl.lambda_ == 2.0
    ctrl.noise_sigma = torch.tensor([[4.0]])
    torch.testing.assert_close(ctrl.noise_sigma_inv, torch.tensor([[0.25]]))
    ctrl.reset()
    assert ctrl.U.shape == (15, 1)
    with pytest.raises(ValueError, match="trailing dimension"):
        ctrl.command(np.zeros(3))
    with pytest.raises(ValueError, match="positive definite"):
        ctrl.noise_sigma = torch.tensor([[-1.0]])


def test_seeded_runs_repeat():
    a = [_pendulum(seed=3).command(np.array([np.pi, 1.0])) for _ in range(2)]
    torch.testing.assert_close(a[0], a[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SMPPI and KMPPI: the quality checks of tests/test_mppi.py:744-771, 820-836
# on the port, on the plain path and (use_pallas=True) the kernel's plain
# version; the API surface; the step cache; KMPPI's horizon clamp.
# ---------------------------------------------------------------------------

LQ = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor([2.0, 2.0]))
GOAL = torch.tensor([2.0, 2.0])
PATHS = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused_plain"])


def _lq_ctrl(cls, use_pallas, **kw):
    ctrl = cls(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
               num_samples=500, horizon=15, lambda_=1.0, device="cpu",
               use_pallas=use_pallas, **kw)
    assert ctrl._fns.fused == use_pallas
    return ctrl


def _final_dist(ctrl, state, steps=20):
    for _ in range(steps):
        state = LQ.dynamics(state[None], ctrl.command(state)[None])[0]
    return float(torch.linalg.norm(state - GOAL))


@PATHS
def test_smppi_stable_trajectory(use_pallas):
    ctrl = _lq_ctrl(SMPPI, use_pallas, w_action_seq_cost=5.0, seed=42)
    state = torch.tensor([-1.0, -1.0])
    for _ in range(10):
        action = ctrl.command(state)
        assert bool(torch.isfinite(action).all())
        state = LQ.dynamics(state[None], action[None])[0]
        assert bool(torch.isfinite(state).all())
    assert bool(torch.isfinite(ctrl.cost_total).all())
    assert bool((ctrl.cost_total >= 0).all())


@PATHS
def test_kmppi_reaches_goal(use_pallas):
    dists = [_final_dist(_lq_ctrl(KMPPI, use_pallas, num_support_pts=5,
                                  kernel=RBFKernel(sigma=2.0), seed=seed),
                         torch.tensor([-3.0, -2.0]))
             for seed in (42, 43, 44)]
    assert sum(dists) / 3 < 2.0, dists


@PATHS
def test_smppi_planned_trajectory_smoother(use_pallas):
    state = torch.tensor([-3.0, -2.0])
    mppi = _lq_ctrl(MPPI, use_pallas, seed=42)
    mppi.command(state)
    smppi = _lq_ctrl(SMPPI, use_pallas, w_action_seq_cost=10.0, seed=42)
    smppi.command(state)
    mppi_smooth = float(torch.diff(mppi.U, dim=0).abs().sum())
    smppi_smooth = float(torch.diff(smppi.get_action_sequence(), dim=0).abs().sum())
    assert smppi_smooth < mppi_smooth * 2.0, (mppi_smooth, smppi_smooth)


def test_smppi_api_surface():
    ctrl = SMPPI(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
                 num_samples=64, horizon=6, device="cpu", w_action_seq_cost=2.0,
                 delta_t=0.5, action_min=-0.5, action_max=0.5, U_init=torch.full((6, 2), 0.1))
    torch.testing.assert_close(ctrl.U, torch.zeros(6, 2))
    torch.testing.assert_close(ctrl.get_action_sequence(), torch.full((6, 2), 0.1))
    torch.testing.assert_close(ctrl.action_min, torch.full((2,), -0.5))
    assert ctrl.w_action_seq_cost == 2.0 and ctrl.delta_t == 0.5
    fns = ctrl._fns
    ctrl.w_action_seq_cost = 7.0
    ctrl.delta_t = 0.25
    assert ctrl._fns is fns and ctrl.delta_t == 0.25
    assert "w=7.0 t=0.25" in ctrl.get_params()
    action = ctrl.command(np.array([0.0, 0.0]))
    assert action.shape == (2,) and bool((action.abs() <= 0.5).all())
    torch.testing.assert_close(action, ctrl.action_sequence[0])
    seq = ctrl.action_sequence.clone()
    ctrl.shift_nominal_trajectory()
    torch.testing.assert_close(ctrl.action_sequence[:-1], seq[1:])
    torch.testing.assert_close(ctrl.action_sequence[-1], seq[-1])
    ctrl.change_horizon(8)
    assert ctrl.U.shape == (8, 2) and ctrl.action_sequence.shape == (8, 2)
    torch.testing.assert_close(ctrl.action_sequence[-1], seq[-1])
    ctrl.change_horizon(4)
    assert ctrl.action_sequence.shape == (4, 2)
    ctrl.action_sequence = torch.ones(4, 2)
    ctrl.reset()
    torch.testing.assert_close(ctrl.action_sequence, torch.zeros(4, 2))
    torch.testing.assert_close(ctrl.U, torch.zeros(4, 2))


def test_kmppi_api_surface():
    ctrl = KMPPI(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
                 num_samples=64, horizon=9, device="cpu")
    assert ctrl.num_support_pts == 4 and ctrl.config.num_support_pts == 4
    assert isinstance(ctrl.interpolation_kernel, RBFKernel)
    torch.testing.assert_close(ctrl.theta, torch.zeros(4, 2))
    assert ctrl.command(np.array([0.0, 0.0])).shape == (2,)
    traj, full = ctrl.deparameterize_to_trajectory_single(ctrl.theta)
    torch.testing.assert_close(traj, ctrl.U)
    assert full.shape == (9, 4)
    batch, _ = ctrl.deparameterize_to_trajectory_batch(torch.ones(3, 4, 2))
    assert batch.shape == (3, 9, 2)
    theta = ctrl.theta.clone()
    ctrl.shift_nominal_trajectory()
    torch.testing.assert_close(ctrl.theta, ctrl._interp_shift @ theta)
    fns = ctrl._fns
    old_full = ctrl._interp_full
    ctrl.kernel_sigma = 3.0
    assert ctrl.kernel_sigma == 3.0 and ctrl._fns is fns
    assert not torch.equal(ctrl._interp_full, old_full)
    ctrl.reset()
    torch.testing.assert_close(ctrl.theta, torch.zeros(4, 2))
    assert "num_support_pts=4" in ctrl.get_params()
    with pytest.raises(ValueError, match="exceeds horizon"):
        KMPPI(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
              num_samples=8, horizon=3, num_support_pts=5, device="cpu")


@pytest.mark.parametrize("cls", [SMPPI, KMPPI], ids=["smppi", "kmppi"])
def test_variant_change_horizon_reuses_step_fns(cls):
    ctrl = cls(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
               num_samples=32, horizon=10, device="cpu", use_pallas=True)
    fns10 = ctrl._fns
    ctrl.change_horizon(12)
    assert ctrl.U.shape == (12, 2) and ctrl._fns is not fns10
    fns12 = ctrl._fns
    ctrl.change_horizon(10)
    assert ctrl._fns is fns10
    ctrl.change_horizon(12)
    assert ctrl._fns is fns12
    assert ctrl.command(np.array([0.0, 0.0])).shape == (2,)


def test_kmppi_clamps_horizon_to_support_points(caplog):
    ctrl = KMPPI(LQ.dynamics, LQ.running_cost, nx=2, noise_sigma=torch.eye(2),
                 num_samples=32, horizon=10, num_support_pts=5, device="cpu")
    with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
        ctrl.change_horizon(3)
    assert "clamped to num_support_pts=5" in caplog.text
    assert ctrl.T == 5 and ctrl.U.shape == (5, 2) and ctrl.theta.shape == (5, 2)
    assert ctrl._interp_full.shape == (5, 5)
    assert bool(torch.isfinite(ctrl._interp_full).all())
    assert ctrl.command(np.array([0.0, 0.0])).shape == (2,)


@pytest.mark.parametrize("cls", [MPPI, SMPPI, KMPPI], ids=["mppi", "smppi", "kmppi"])
def test_toy2d_runs_the_kernel_model(cls):
    """The 2-D navigation task carries the kernel's toy2d model, so
    ``use_pallas=True`` routes to the fused solve (its plain version here)."""
    env = Toy2DEnvironment(device="cpu")
    ctrl = cls(env.dynamics, env.running_cost, nx=2, noise_sigma=torch.eye(2) * 0.2,
               num_samples=64, horizon=8, u_min=torch.tensor([-1.0, -1.0]),
               u_max=torch.tensor([1.0, 1.0]), device="cpu", use_pallas=True)
    assert ctrl._fns.fused
    state = env.start
    for _ in range(3):
        action = ctrl.command(state)
        assert bool((action.abs() <= 1.0).all())
        state = env.dynamics(state[None], action[None])[0]
    assert bool(torch.isfinite(state).all())


# ---------------------------------------------------------------------------
# The JAX constructor surface (pytorch_mppi_tpu/controller.py:254-262,
# :284, :391, :560-563): compile(), scan_unroll, prng_impl, key,
# sample_axis, M and info, on MPPI and the two variants that inherit it.
# ---------------------------------------------------------------------------

CONTROLLERS = pytest.mark.parametrize("cls", [MPPI, SMPPI, KMPPI], ids=["mppi", "smppi", "kmppi"])


def _small(cls, **kw):
    return cls(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_samples=50, horizon=5,
               device="cpu", seed=7, **kw)


@CONTROLLERS
def test_compile_returns_the_controller(cls):
    ctrl = _small(cls)
    assert ctrl.compile() is ctrl and ctrl.compile(mode="max-autotune") is ctrl
    assert ctrl.command(np.array([0.0, 0.0])).shape == (2,)


@CONTROLLERS
@pytest.mark.parametrize("unroll", [0, 4])
def test_scan_unroll_does_not_change_the_command(cls, unroll):
    """As tests/test_extensions.py:755-774 holds for JAX: the unroll of the
    rollout loop changes nothing of the result."""
    state = np.array([-1.0, 0.5])
    a = _small(cls).command(state)
    b = _small(cls, scan_unroll=unroll).command(state)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@CONTROLLERS
@pytest.mark.parametrize("impl", ["auto", None])
def test_prng_impl_default_stream_is_accepted(cls, impl):
    ctrl = _small(cls, prng_impl=impl)
    assert ctrl.prng_impl == impl
    torch.testing.assert_close(ctrl.command(np.array([0.0, 0.0])),
                               _small(cls).command(np.array([0.0, 0.0])), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg", "threefry2x32"])
def test_prng_impl_tpu_kinds_raise(impl):
    with pytest.raises(ValueError, match="Philox from seed"):
        _small(MPPI, prng_impl=impl)


@CONTROLLERS
def test_key_is_rejected_for_seed(cls):
    with pytest.raises(ValueError, match="seed="):
        _small(cls, key=object())
    assert _small(cls, key=None).command(np.array([0.0, 0.0])).shape == (2,)


@pytest.mark.parametrize("axis", ["k", "data", None])
def test_sample_axis(axis):
    """Without a mesh ``sample_axis`` is kept and ignored, as JAX's (its
    sharding constraint is the identity there): the same command as the
    default's."""
    ctrl = _small(MPPI, sample_axis=axis)
    assert ctrl.sample_axis == axis and ctrl.mesh is None
    x = np.array([0.5, -0.5])
    torch.testing.assert_close(ctrl.command(x), _small(MPPI).command(x), rtol=0, atol=0)


@CONTROLLERS
def test_rollout_samples_and_info(cls):
    ctrl = _small(cls)
    assert ctrl.M == 1 and ctrl.info is None
    assert "M=1" in ctrl.get_params()
    ctrl.command(np.array([0.0, 0.0]), info={"step": 3})
    assert ctrl.info == {"step": 3}
    ctrl.command(np.array([0.0, 0.0]))
    assert ctrl.info is None
