#!/usr/bin/env python3
"""Command latency of the plain path with stochastic dynamics, for two
checkouts of the repo, in alternating processes on one CUDA card.

    python3 pytorch_mppi_tpu_torch/tools/stochastic_host_ab.py A_DIR B_DIR \
        [--pairs 3] [--commands 60] [--out FILE]

Each process imports ``pytorch_mppi_tpu_torch`` from its checkout and runs,
at ``bench.py``'s flagship (``linear_quadratic``, K = 10,000, T = 30, from
[-3, -2] towards the goal [2, 2]) with dynamics that draw from their step's
generator (``stochastic_dynamics=True``, so every command takes the plain
path and launches no kernel of the port):

* ``mppi_m4_cvar``: MPPI with M = 4 rollouts of ``torch.randn`` noise, the
  variance cost and CVaR (``PERF.md`` §5's stochastic MPPI row);
* ``mppi_m4``: the same without CVaR, asked for the kernel (phase 8's
  artifact ``mppi plain, stochastic M=4``);
* ``smppi_step``: SMPPI with step-dependent ``Tensor.normal_`` noise
  (phase 8's ``smppi plain, stochastic, step-dependent``);
* ``batched_n16``: ``MPPI_Batched`` at N = 16, K = 10,240 with the
  ``torch.randn`` noise (§5's stochastic batched row);
* ``gated``: MPPI whose dynamics draw ``torch.bernoulli(p)`` and
  ``torch.normal(0, std)`` with tensors, ``Tensor.exponential_`` and
  ``torch.randperm`` (phase 8's newest artifact).

For each, ``--warmup`` commands, then ``--commands`` commands on the plant
between CUDA events: ``{case}.ms`` is their median, and ``{case}.host_ms``
the median host time of ``command()`` followed by a synchronise.  The
processes run A, B, B, A, ... (``--pairs`` pairs; ``ab_turns.py``); the
summary gives each metric's median per checkout, B / A, and in how many
pairs B read higher.  ``--device cpu --samples 256 --batch-samples 256``
rehearses it on the CPU.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import ab_turns  # this folder's: the turns and the summary

T, NX, NU, SCALE = 30, 2, 2, 0.05


def child(root, device, samples, batch_samples, warmup, commands):
    sys.path.insert(0, root)  # this checkout's package, never an installed one
    import torch

    from pytorch_mppi_tpu_torch import MPPI, SMPPI, MPPI_Batched
    from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

    dev = torch.device(device)
    lq = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev),
                          torch.tensor([2.0, 2.0], device=dev))

    def noisy(s, a, rng):
        return lq.dynamics(s, a) + SCALE * torch.randn(s.shape, generator=rng, device=s.device,
                                                       dtype=s.dtype)

    def noisy_step(s, a, t, rng):
        return lq.dynamics(s, a) + SCALE * (1.0 + 0.02 * t) * torch.empty_like(s).normal_(
            generator=rng)

    def gated(s, a, rng):
        gate = torch.bernoulli(torch.sigmoid(s).clamp(0.1, 0.9), generator=rng)
        std = SCALE * (1.0 + 0.1 * s.abs())
        e = torch.empty_like(s).exponential_(4.0, generator=rng)
        perm = torch.randperm(s.shape[-1], generator=rng, device=s.device)
        return (lq.dynamics(s, a) + SCALE * gate + torch.normal(0.0, std, generator=rng)
                + SCALE * torch.index_select(e, -1, perm))

    def cost_step(s, a, t):
        return lq.running_cost(s, a)

    def single(cls=MPPI, fns=(noisy, lq.running_cost), **kw):
        return cls(*fns, nx=NX, noise_sigma=torch.eye(NU, device=dev), num_samples=samples,
                   horizon=T, lambda_=1.0, seed=42, device=dev, stochastic_dynamics=True, **kw)

    bound = torch.tensor([1.0, 1.0])
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    starts = torch.rand(16, NX, generator=g, device=dev) * 4 - 4
    cases = {
        "mppi_m4_cvar": (lambda: single(rollout_samples=4, rollout_var_cost=0.1,
                                        risk_alpha=0.5), None),
        "mppi_m4": (lambda: single(use_pallas=True, rollout_samples=4, rollout_var_cost=0.1),
                    None),
        "smppi_step": (lambda: single(SMPPI, fns=(noisy_step, cost_step),
                                      step_dependent_dynamics=True, w_action_seq_cost=1.0,
                                      delta_t=1.0, action_min=torch.tensor([-3.0, -3.0]),
                                      action_max=torch.tensor([3.0, 3.0])), None),
        "batched_n16": (lambda: MPPI_Batched(
            noisy, lq.running_cost, nx=NX, noise_sigma=torch.eye(NU, device=dev) * 0.5,
            num_envs=16, num_samples=batch_samples, horizon=T, lambda_=1.0,
            u_min=-bound, u_max=bound, seed=0, device=dev, stochastic_dynamics=True), starts),
        "gated": (lambda: single(fns=(gated, lq.running_cost)), None),
    }
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"torch": torch.__version__}
    for name, (make, x0) in cases.items():
        ctrl = make()
        x = torch.tensor([-3.0, -2.0], device=dev) if x0 is None else x0.clone()
        for _ in range(warmup):
            x = lq.dynamics(x, ctrl.command(x))
        sync()
        host, events = [], []
        for _ in range(commands):
            wall = time.perf_counter()
            if dev.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            a = ctrl.command(x)
            if dev.type == "cuda":
                end.record()
                events.append((start, end))
            sync()
            host.append((time.perf_counter() - wall) * 1e3)
            x = lq.dynamics(x, a)
        sync()
        if events:
            out[f"{name}.ms"] = statistics.median(s.elapsed_time(e) for s, e in events)
        out[f"{name}.host_ms"] = statistics.median(host)
        if not bool(torch.isfinite(x).all()):
            raise SystemExit(f"{name}: non-finite states")
        del ctrl
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (for example the parent commit)")
    ap.add_argument("b", help="checkout B (for example this commit)")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--samples", type=int, default=10_000)
    ap.add_argument("--batch-samples", type=int, default=10_240)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--commands", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write every process's result here (JSON lines)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.device, args.samples, args.batch_samples, args.warmup,
                     args.commands)
    roots = [str(Path(args.a).resolve()), str(Path(args.b).resolve())]

    def show(i, r):
        print(f"[{'AB'[i]}] " + " | ".join(f"{k} {v:.4f}" for k, v in r.items()
                                            if isinstance(v, float)))

    results = ab_turns.run_turns(
        roots, lambda root: [sys.executable, __file__, args.a, args.b, "--child", root,
                             "--device", args.device, "--samples", str(args.samples),
                             "--batch-samples", str(args.batch_samples),
                             "--warmup", str(args.warmup), "--commands", str(args.commands)],
        args.pairs, show, args.out)
    ab_turns.summarize(results, [k for k, v in results[0][0].items() if isinstance(v, float)],
                       "AB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
