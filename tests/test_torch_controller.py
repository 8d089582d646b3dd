"""The port's ``MPPI`` controller on the CPU: the pendulum swing-up on both
paths, the device rule, the unported flags, routing and the step cache."""
import logging

import numpy as np
import pytest
import torch

from pytorch_mppi_tpu_torch import MPPI, linear_quadratic, run_mppi
from pytorch_mppi_tpu_torch.models import (
    PendulumEnv,
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


UNPORTED = [
    ("terminal_state_cost", lambda s, a: s.sum(-1)),
    ("terminal_final_cost", lambda s, a: s.sum(-1)),
    ("rollout_samples", 2),
    ("rollout_var_cost", 0.5),
    ("risk_alpha", 0.5),
    ("stochastic_dynamics", True),
    ("specific_action_sampler", object()),
    ("num_iterations", 2),
    ("adaptive_covariance", True),
    ("gradient_refinement_steps", 3),
    ("num_elites", 4),
    ("dynamics_params", {"w": 1.0}),
    ("mesh", object()),
]


@pytest.mark.parametrize("flag,value", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_flag_raises(flag, value):
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
