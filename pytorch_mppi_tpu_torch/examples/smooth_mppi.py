"""MPPI against SMPPI against KMPPI on the 2-D navigation task (the
counterpart of ``examples/smooth_mppi.py``, the reference's comparison
script ``tests/smooth_mppi.py``): an LQR cost with a hill, linear-delta
dynamics, a scaled terminal cost, compared on accumulated cost, final
distance and control smoothness.  In float64, so every controller takes
the plain path.

With ``record_gif`` (``--gif``) each controller also records a frame a
step of its rollouts, the candidates coloured by cost beside the path so
far, to ``<name>_evolution.gif`` (``utils/viz.GifRecorder``, headless PIL),
and the three paths are drawn to ``smooth_mppi_trajectories.png``.

Run: python -m pytorch_mppi_tpu_torch.examples.smooth_mppi [--gif]
"""
from __future__ import annotations

import logging
import sys

import torch

from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, RBFKernel
from pytorch_mppi_tpu_torch.models import Toy2DEnvironment
from pytorch_mppi_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

COLORS = {"MPPI": "tab:orange", "SMPPI": "tab:purple", "KMPPI": "tab:cyan"}


def controllers(env, device):
    """The three controllers of the comparison, in float64."""
    dtype = env.dtype
    one = torch.tensor([1.0, 1.0], dtype=dtype)
    common = dict(nx=2, noise_sigma=torch.eye(2, dtype=dtype) * 0.2, num_samples=500,
                  horizon=20, lambda_=1.0, u_min=-one, u_max=one,
                  terminal_state_cost=env.terminal_cost, seed=42, device=device)
    return {
        "MPPI": MPPI(env.dynamics, env.running_cost, **common),
        "SMPPI": SMPPI(env.dynamics, env.running_cost, w_action_seq_cost=50.0, delta_t=1.0,
                       action_min=-one, action_max=one, **common),
        "KMPPI": KMPPI(env.dynamics, env.running_cost, num_support_pts=5,
                       kernel=RBFKernel(sigma=2.0), **common),
    }


def _record(env, ctrl, state, states, recorder, color):
    """One frame: the 8 lowest-cost candidate rollouts coloured by cost and
    the path so far."""
    from pytorch_mppi_tpu_torch.utils.viz import draw_rollouts_colored

    cost = ctrl.cost_total.cpu()
    order = torch.argsort(cost)[:8]
    rollouts = torch.stack([ctrl.get_rollouts(state, U=ctrl.perturbed_action[i])[0]
                            for i in order.tolist()])
    artists = draw_rollouts_colored(env.ax, state, rollouts, cost[order])
    path = torch.stack(states).cpu().numpy()
    (ln,) = env.ax.plot(path[:, 0], path[:, 1], color=color, linewidth=2)
    recorder.capture()
    for art in artists + [ln]:
        art.remove()


def main(steps: int = 40, record_gif: bool = False, device=None):
    """Run each controller ``steps`` steps from the start; returns the rows
    ``(method, accumulated cost, final distance, smoothness)``, the last
    the summed |Δaction| over the run.  The gifs and the figure go to the
    working directory."""
    device = resolve_device(device, "smooth_mppi")
    env = Toy2DEnvironment(dtype=torch.float64, device=device)
    fig = None
    if record_gif:
        try:
            fig = env.start_visualization()
        except ImportError:
            logger.warning("matplotlib is missing: no gif")

    print(f"{'method':<8s} {'accum cost':>12s} {'final dist':>12s} {'smoothness':>12s}")
    rows = []
    for name, ctrl in controllers(env, device).items():
        recorder = None
        if fig is not None:
            from pytorch_mppi_tpu_torch.utils.viz import GifRecorder

            recorder = GifRecorder(fig)
        state = env.start
        total_cost, actions, states = 0.0, [], [state]
        for _ in range(steps):
            a = ctrl.command(state)
            if recorder is not None:
                _record(env, ctrl, state, states, recorder, COLORS[name])
            actions.append(a)
            total_cost += float(env.running_cost(state[None], a[None])[0])
            state = env.dynamics(state[None], a[None])[0]
            states.append(state)
        final_dist = float(torch.linalg.norm(state - env.goal))
        smooth = float(torch.diff(torch.stack(actions), dim=0).abs().sum())
        rows.append((name, total_cost, final_dist, smooth))
        print(f"{name:<8s} {total_cost:>12.2f} {final_dist:>12.4f} {smooth:>12.3f}")
        if recorder is not None:
            print("saved:", recorder.save(f"{name.lower()}_evolution.gif", fps=8))
        if fig is not None:
            env.draw_trajectory(torch.stack(states), color=COLORS[name], label=name)

    if fig is not None:
        env.ax.legend()
        print("saved:", env.save_figure("smooth_mppi_trajectories.png"))
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(record_gif="--gif" in sys.argv)
