"""Ahead-of-time deployment: build a solver artifact in one process, serve it
in another (the counterpart of ``examples/deploy_serving.py``).

The build host defines the problem, builds the controller and exports its
command with ``utils/deploy.export_solver``: one ``.npz`` holding the
``torch.export`` programs, the hyperparameters and the solver state.  The
serving host, a fresh subprocess here, imports only
``pytorch_mppi_tpu_torch.utils.deploy``, numpy and torch, never defines the
dynamics or the cost, loads the artifact and closes the control loop
against a numpy plant.  It serves on the device the artifact was built for
(an artifact exported on the card runs on the card).

The hyperparameters are runtime inputs of the exported programs: the build
host applies another lambda to the loaded solver without exporting again.

Run:  python -m pytorch_mppi_tpu_torch.examples.deploy_serving
      python -m pytorch_mppi_tpu_torch.examples.deploy_serving --steps 150   (full swing-up)
      python -m pytorch_mppi_tpu_torch.examples.deploy_serving --device cpu
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import tempfile

import torch

from pytorch_mppi_tpu_torch import MPPI
from pytorch_mppi_tpu_torch.utils import deploy
from pytorch_mppi_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# the serving process: loads the artifact, closes the loop against a
# numpy-only plant, reports the final angle; no dynamics or cost code
_SERVING_HOST = r"""
import json, sys, time
import numpy as np
import torch
from pytorch_mppi_tpu_torch.utils import deploy

path, steps = sys.argv[1], int(sys.argv[2])
solver = deploy.load_solver(path)
g, m, l, dt = 10.0, 1.0, 1.0, 0.05
s = np.array([np.pi, 1.0], np.float32)
t0 = time.perf_counter()
for _ in range(steps):
    a = float(solver.command(torch.from_numpy(s)))
    u = np.clip(a, -2.0, 2.0)
    thdot = np.clip(s[1] + (3*g/(2*l)*np.sin(s[0]) + 3.0/(m*l**2)*u)*dt, -8, 8)
    s = np.array([s[0] + thdot*dt, thdot], np.float32)
wall = time.perf_counter() - t0
ang = abs(float(((s[0] + np.pi) % (2*np.pi)) - np.pi))
print(json.dumps({"final_angle": ang, "steps": steps, "wall_s": wall,
                  "device": str(solver.device)}))
"""


def build_artifact(path, horizon=15, num_samples=500, device=None):
    """The build host: define the problem, build the controller (the plain
    path), export it to ``path``; returns the in-memory solver with its
    lambda doubled."""
    device = resolve_device(device, "deploy_serving")

    def angle_normalize(x):
        return torch.remainder(x + math.pi, 2 * math.pi) - math.pi

    g, m, l, dt = 10.0, 1.0, 1.0, 0.05

    def dynamics(state, u):
        th, thdot = state[..., 0], state[..., 1]
        u0 = torch.clamp(u[..., 0], -2.0, 2.0)
        newthdot = torch.clamp(
            thdot + (3 * g / (2 * l) * torch.sin(th) + 3.0 / (m * l**2) * u0) * dt, -8, 8)
        return torch.stack([th + newthdot * dt, newthdot], dim=-1)

    def cost(state, u):
        th, thdot = state[..., 0], state[..., 1]
        return angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u[..., 0] ** 2)

    ctrl = MPPI(dynamics, cost, 2, torch.tensor([[10.0]]), num_samples=num_samples,
                horizon=horizon, lambda_=1.0, seed=0, u_min=torch.tensor([-2.0]),
                u_max=torch.tensor([2.0]), device=device)
    solver = deploy.export_solver(ctrl, path)
    logger.info("exported the %s artifact (%s route, %s) to %s", solver.meta["class"],
                solver.meta["route"], solver.meta["device"], path)

    # the tunables stay live on the in-memory solver too: another lambda
    # without exporting again (the serving host could do the same)
    solver.params = solver.params._replace(lambda_=solver.params.lambda_ * 2)
    return solver


def _serving_env():
    """The serving process's environment: this checkout's package first on
    its path, so that it runs without an installed copy."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def main(argv=None, device=None):
    """Export, then serve ``--steps`` commands in a fresh process; returns
    the serving host's ``{"final_angle", "steps", "wall_s", "device"}``.

    :param device: the build device (and so the serving one); default
        ``--device``, else the card.
    """
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--keep", action="store_true", help="keep the artifact file")
    p.add_argument("--device", default=None, help="'cpu', or the card by default")
    args = p.parse_args(argv)
    device = resolve_device(device if device is not None else args.device, "deploy_serving")

    # mkstemp: the name is created and owned at once; export_solver
    # overwrites the empty placeholder
    fd, path = tempfile.mkstemp(suffix=".mppi.npz")
    os.close(fd)
    try:
        build_artifact(path, num_samples=args.samples, device=device)
        logger.info("artifact size: %.0f KiB", os.path.getsize(path) / 1024)
        out = subprocess.run([sys.executable, "-c", _SERVING_HOST, path, str(args.steps)],
                             env=_serving_env(), capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"serving host failed:\n{out.stderr[-3000:]}")
        result = json.loads(out.stdout.strip().splitlines()[-1])
        logger.info("serving host (no user code) on %s: %d steps in %.1f s, final |angle| = "
                    "%.4f", result["device"], result["steps"], result["wall_s"],
                    result["final_angle"])
        return result
    finally:
        if not args.keep and os.path.exists(path):
            os.remove(path)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")
    r = main()
    # with enough steps the served artifact must complete the swing-up
    if r["steps"] >= 150:
        assert r["final_angle"] < 0.25, r
