#!/usr/bin/env python3
"""Host time of the kernel wrappers and of the controllers' commands, for two
checkouts of the repo, in alternating processes on one CUDA card.

    python3 pytorch_mppi_tpu_torch/tools/batched_host_ab.py A_DIR B_DIR \
        [--pairs 6] [--out FILE]

Each process imports ``pytorch_mppi_tpu_torch`` from its checkout (whose
kernels are built there first) and measures,
on the host clock, at ``examples/scenario_batch.py``'s N = 16, K = 10,240,
T = 30 problem:

* ``issue_us``: the host time of one wrapper call
  (``make_transposed_batched_solve``, operand and seed mode; the
  single-plant MPPI wrapper at K = 10,000, T = 30 as a control; the legacy
  route's weighted update and the sampler at that flagship), from loops of
  ``--calls`` calls that issue work without waiting for the card, the
  median over ``--repeats`` loops;
* ``ctypes_us``: for the first three, the part of it spent in the library's
  entry point (``fused_mppi_launch`` through ctypes: argument conversion,
  the kernel launches and the error checks), timed around that call alone;
  the rest of ``issue_us`` is the wrapper's Python (checks and allocations);
* ``null_ctypes_us``: a ctypes call that does nothing (``fused_mppi_block``);
* ``profile``: the wrapper's most expensive functions under ``cProfile``
  (its overhead inflates them alike in both checkouts);
* ``command_us``: the median host time of ``MPPI_Batched.command`` followed
  by a synchronise (what a control loop waits for), operand and seed mode,
  and of the fused ``MPPI``, ``SMPPI`` and ``KMPPI`` commands, the legacy
  route's command (``MPPI(use_pallas="rollout")``) and the sampler loop
  (the sampler, the legacy rollout and the weighted update written out, as
  ``chip_smoke.py``'s ``FrontEndLoop``) at ``bench.py``'s flagship
  (K = 10,000, T = 30; from [-3, -2] towards the goal [2, 2]);
* ``graph_us``: the device time of one call replayed from a CUDA graph of
  20 calls: the batched pair at N = 16 (operand and seed mode), each
  single-plant solve (the flagship, seed mode), the MPPI
  solve with a full operator at D = 300 (T = 100, nu = 3, ``noise_rho`` =
  0.5), the legacy rollout and the weighted update, the sampler in seed and
  bits mode at the flagship, and the sampler with a full operator at D = 300.

Both checkouts' kernels are built at once; the processes run A, B, B, A, A,
B, ... (``--pairs`` pairs; ``ab_turns.py``); the summary gives each
metric's median per checkout, B / A, and in how many pairs B read higher.
``--device cpu`` rehearses the script on the CPU (the plain versions, no
ctypes metrics) at a small ``--calls``.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import ab_turns  # this folder's: the build, the turns and the summary

N, K, T, NU = 16, 10_240, 30, 2
FLAG_K = 10_000
NSP = T // 2  # KMPPI's support points at the flagship


def _graph_us(fn, iters=20):
    """Device microseconds per call of ``fn`` replayed from a CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def _loop_us(fn, calls, repeats, sync):
    """Median host microseconds per call over ``repeats`` loops of
    ``calls`` calls, each loop started and ended on an idle card."""
    samples = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e6)
        sync()
    return statistics.median(samples)


def child(root, device, calls, repeats, commands):
    sys.path.insert(0, root)  # this checkout's package, never an installed one
    import cProfile
    import pstats

    import torch

    import pytorch_mppi_tpu_torch as port
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel, linear_quadratic
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import rowmajor as RM
    from pytorch_mppi_tpu_torch.ops import solve as PS

    if not Path(port.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {port.__file__}, not the package under {root}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    lq = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev),
                          torch.tensor([2.0, 2.0], device=dev))
    D = T * NU
    vec = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
    lam = torch.tensor(1.0, device=dev)
    x0T = torch.rand(2, N, generator=gen, device=dev) * 4 - 4
    U2T = (torch.randn(N, D, generator=gen, device=dev) * 0.3).T
    aT = (torch.randn(N, D, generator=gen, device=dev) * 0.5).T
    rest = (x0T, U2T, vec(0.5 ** 0.5), vec(0.0), vec(-1.0), vec(1.0), aT, lam)
    cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True)
    op_solve = FS.make_transposed_batched_solve(cfg, N, lq, noise_operand=True)
    noise = torch.randn(D, op_solve.K_pad, generator=gen, device=dev) * 0.5 ** 0.5
    seed_solve = FS.make_transposed_batched_solve(cfg, N, lq)
    flag = MPPIConfig(nx=2, nu=NU, K=FLAG_K, T=T, diag_sigma=True)
    mppi_solve = FS.make_transposed_fused_solve(flag, lq)
    x0 = torch.tensor([-3.0, -2.0], device=dev)[:, None].expand(2, FLAG_K)
    mppi_args = ((5, 6), x0, torch.zeros(D, device=dev), vec(1.0), vec(0.0),
                 vec(-1e9), vec(1e9), vec(0.0), lam)
    # the legacy route's weighted update and the sampler at the flagship
    wu_cost = torch.rand(FLAG_K, generator=gen, device=dev) * 2 + 1
    wu_noise = torch.randn(FLAG_K, D, generator=gen, device=dev)
    sample = RM.make_fused_sampler(flag)
    s_args = (torch.zeros(D, device=dev), vec(1.0), vec(0.0), vec(-1e9), vec(1e9), vec(0.0))
    wrappers = {
        "batched_operand": lambda: op_solve(noise, *rest),
        "batched_seed": lambda: seed_solve((5, 6), *rest),
        "mppi_control": lambda: mppi_solve(*mppi_args),
        "weighted_update": lambda: LG.fused_weighted_update(wu_cost, wu_noise, lam),
        "sampler": lambda: sample((5, 6), *s_args),
    }
    through_launch = ("batched_operand", "batched_seed", "mppi_control")
    out = {"root": root, "package": port.__file__,
           "plant_group": getattr(op_solve, "plant_group", None)}
    for name, fn in wrappers.items():
        for _ in range(20):
            fn()
        out[f"{name}.issue_us"] = _loop_us(fn, calls, repeats, sync)
    if cuda:
        lib = FS._lib()
        out["null_ctypes_us"] = _loop_us(lib.fused_mppi_block, 10 * calls, repeats, sync)
        real = lib.fused_mppi_launch
        inner = []

        def timed(*args):
            t0 = time.perf_counter()
            rc = real(*args)
            inner.append(time.perf_counter() - t0)
            return rc

        lib.fused_mppi_launch = timed
        try:
            for name in through_launch:
                fn = wrappers[name]
                inner.clear()
                _loop_us(fn, calls, repeats, sync)
                out[f"{name}.ctypes_us"] = statistics.median(inner) * 1e6
        finally:
            lib.fused_mppi_launch = real
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        wrappers["batched_operand"]()
    prof.disable()
    sync()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    out["profile"] = [f"{Path(f).name}:{line}({fn}) {v[2] / calls * 1e6:.2f} us"
                      for (f, line, fn), v in top]

    def starts():
        g = torch.Generator(device=dev)
        g.manual_seed(42)
        return torch.rand(N, 2, generator=g, device=dev) * 4 - 4

    for mode, use_pallas in (("operand", True), ("seed", "kernel_rng")):
        ctrl = MPPI_Batched(lq.dynamics, lq.running_cost, nx=2,
                            noise_sigma=torch.eye(NU, device=dev) * 0.5, num_envs=N,
                            num_samples=K, horizon=T, lambda_=1.0,
                            u_min=-torch.ones(NU), u_max=torch.ones(NU), seed=0,
                            use_pallas=use_pallas, device=dev)
        x = starts()
        for _ in range(10):
            x = lq.dynamics(x, ctrl.command(x))
        sync()
        lat = []
        for _ in range(commands):
            t0 = time.perf_counter()
            action = ctrl.command(x)
            sync()
            lat.append((time.perf_counter() - t0) * 1e6)
            x = lq.dynamics(x, action)
        out[f"command_{mode}.command_us"] = statistics.median(lat)

    # the single-plant fused commands at the flagship, and their solves alone
    goal = torch.tensor([2.0, 2.0], device=dev)
    flagship = {
        "mppi": (MPPI, {}),
        "smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                              action_min=torch.tensor([-3.0, -3.0]),
                              action_max=torch.tensor([3.0, 3.0]))),
        "kmppi": (KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0))),
    }
    for variant, (cls, extra) in flagship.items():
        ctrl = cls(lq.dynamics, lq.running_cost, nx=2, noise_sigma=torch.eye(NU, device=dev),
                   num_samples=FLAG_K, horizon=T, lambda_=1.0, seed=42, use_pallas=True,
                   device=dev, **extra)
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(10):
            x = lq.dynamics(x[None], ctrl.command(x)[None])[0]
        sync()
        lat = []
        for _ in range(commands):
            t0 = time.perf_counter()
            action = ctrl.command(x)
            sync()
            lat.append((time.perf_counter() - t0) * 1e6)
            x = lq.dynamics(x[None], action[None])[0]
        if not bool(torch.linalg.norm(x - goal) < 10.0):
            raise SystemExit(f"{variant} flagship loop diverged: {x.tolist()}")
        out[f"command_{variant}.command_us"] = statistics.median(lat)

    # the legacy route's command and the sampler loop at the flagship
    def run_loop(command, name):
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(10):
            x = lq.dynamics(x[None], command(x)[None])[0]
        sync()
        lat = []
        for _ in range(commands):
            t0 = time.perf_counter()
            action = command(x)
            sync()
            lat.append((time.perf_counter() - t0) * 1e6)
            x = lq.dynamics(x[None], action[None])[0]
        if not bool(torch.linalg.norm(x - goal) < 10.0):
            raise SystemExit(f"{name} flagship loop diverged: {x.tolist()}")
        out[f"command_{name}.command_us"] = statistics.median(lat)

    legacy = MPPI(lq.dynamics, lq.running_cost, nx=2, noise_sigma=torch.eye(NU, device=dev),
                  num_samples=FLAG_K, horizon=T, lambda_=1.0, seed=42, use_pallas="rollout",
                  device=dev)
    run_loop(legacy.command, "legacy")
    rollout = LG.make_fused_rollout(flag, lq)
    loop = {"U": torch.zeros(T, NU, device=dev), "count": 0}
    unbounded = (torch.full((D,), -float("inf"), device=dev),
                 torch.full((D,), float("inf"), device=dev))

    def sampler_command(x):
        U2 = loop["U"].reshape(-1)
        key = FS.key_to_seed((7 << 32) | loop["count"])
        loop["count"] += 1
        pert, pc = sample(key, U2, vec(1.0), vec(0.0), *unbounded, lam * U2)
        cost = rollout(x[None].expand(FLAG_K, 2), pert.reshape(FLAG_K, T, NU)) + pc
        upd, _, s = LG.fused_weighted_update(cost, pert - U2, lam)
        U = loop["U"] + (upd / s).reshape(T, NU)
        loop["U"] = torch.cat([U[1:], torch.zeros(1, NU, device=dev)])
        return U[0]

    run_loop(sampler_command, "sampler_loop")
    if cuda:
        D, R = T * NU, NSP * NU
        x0T = torch.tensor([-3.0, -2.0], device=dev)[:, None].expand(2, FLAG_K)
        U2 = torch.randn(D, generator=gen, device=dev) * 0.3
        cfgs = {v: MPPIConfig(nx=2, nu=NU, K=FLAG_K, T=T, diag_sigma=True,
                              num_support_pts=NSP if v == "kmppi" else 0, smppi=v == "smppi")
                for v in flagship}
        wide = (vec(-1e9), vec(1e9))
        solves = {
            "mppi": (FS.make_transposed_fused_solve(cfgs["mppi"], lq),
                     (x0T, U2, vec(1.0), vec(0.0), *wide, vec(0.0), lam)),
            "smppi": (FS.make_transposed_smppi_solve(cfgs["smppi"], lq),
                      (x0T, U2, U2 * 0.5, vec(1.0), vec(0.0), *wide, vec(-3.0), vec(3.0),
                       vec(0.0), lam, lam, lam)),
            "kmppi": (FS.make_transposed_kmppi_solve(cfgs["kmppi"], lq),
                      (x0T, U2, torch.zeros(R, device=dev), torch.ones(R, device=dev),
                       torch.zeros(R, device=dev), torch.full((R,), -1e9, device=dev),
                       torch.full((R,), 1e9, device=dev), *wide, vec(0.0),
                       torch.ones(D, R, device=dev) / R, lam)),
        }
        out["batched_operand.graph_us"] = _graph_us(lambda: op_solve(noise, *rest))
        out["batched_seed.graph_us"] = _graph_us(lambda: seed_solve((1, 2), *rest))
        for variant, (solve, args) in solves.items():
            out[f"solve_{variant}.graph_us"] = _graph_us(lambda s=solve, a=args: s((1, 2), *a))
        bits = torch.randint(-2**31, 2**31 - 1, (sample.bits_rows, D), dtype=torch.int32,
                             generator=gen, device=dev)
        out["weighted_update.graph_us"] = _graph_us(wrappers["weighted_update"])
        out["sampler.graph_us"] = _graph_us(wrappers["sampler"])
        out["sampler_bits.graph_us"] = _graph_us(lambda: sample(bits, *s_args))
        wide = MPPIConfig(nx=2, nu=3, K=FLAG_K, T=100, noise_rho=0.5)
        D3 = wide.T * wide.nu
        op3 = torch.eye(D3, device=dev) + 0.1 * torch.rand(D3, D3, generator=gen, device=dev)
        sample3 = RM.make_fused_sampler(wide)
        args3 = (torch.zeros(D3, device=dev), op3, torch.zeros(D3, device=dev),
                 torch.full((D3,), -1e9, device=dev), torch.full((D3,), 1e9, device=dev),
                 torch.zeros(D3, device=dev))
        out["sampler_D300_full_op.graph_us"] = _graph_us(lambda: sample3((5, 6), *args3))
        lq3 = linear_quadratic(torch.randn(2, 3, generator=gen, device=dev) * 0.5,
                               torch.tensor([2.0, 2.0], device=dev))
        sig3 = torch.eye(3, device=dev) + 0.3 * (torch.ones(3, 3, device=dev)
                                                 - torch.eye(3, device=dev))
        z3 = torch.zeros(3, device=dev)
        op300 = PS._transposed_operands(sig3, z3, z3, z3, wide, 100, 3, torch.float32)[1]
        x3 = torch.tensor([-3.0, -2.0], device=dev)[:, None].expand(2, FLAG_K)
        solve300 = FS.make_transposed_fused_solve(wide, lq3)
        args300 = (x3, torch.zeros(D3, device=dev), op300.contiguous(), torch.zeros(D3, device=dev),
                   torch.full((D3,), -1e9, device=dev), torch.full((D3,), 1e9, device=dev),
                   torch.zeros(D3, device=dev), lam)
        out["solve_mppi_D300.graph_us"] = _graph_us(lambda: solve300((5, 6), *args300))
        u_flag = torch.randn(FLAG_K, T, NU, generator=gen, device=dev)
        x0_K = torch.tensor([-3.0, -2.0], device=dev)[None].expand(FLAG_K, 2)
        out["rollout.graph_us"] = _graph_us(lambda: rollout(x0_K, u_flag))
    print(json.dumps(out))
    return 0


def build_child(root):
    """Build a checkout's kernels; prints the seconds it took."""
    sys.path.insert(0, root)  # this checkout's package, never an installed one
    from pytorch_mppi_tpu_torch.ops import _build

    r = _build.build()
    print(0.0 if r is None else r[0])
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (for example the parent commit)")
    ap.add_argument("b", help="checkout B (for example this commit)")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--commands", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write every process's result here (JSON lines)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        if args.build:
            return build_child(args.child)
        return child(args.child, args.device, args.calls, args.repeats, args.commands)
    roots = [str(Path(args.a).resolve()), str(Path(args.b).resolve())]
    if args.device == "cuda":
        ab_turns.build(dict.fromkeys(roots), lambda root: [
            sys.executable, __file__, args.a, args.b, "--child", root, "--build"])

    def show(i, r):
        print(f"[{'AB'[i]}] " + " | ".join(f"{k} {v:.2f}" for k, v in r.items()
                                            if isinstance(v, float)))
        print(f"[{'AB'[i]}] profile: " + "; ".join(r["profile"]))

    results = ab_turns.run_turns(
        roots, lambda root: [sys.executable, __file__, args.a, args.b, "--child", root,
                             "--device", args.device, "--calls", str(args.calls),
                             "--repeats", str(args.repeats), "--commands", str(args.commands)],
        args.pairs, show, args.out)
    ab_turns.summarize(results, [k for k, v in results[0][0].items() if isinstance(v, float)],
                       "AB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
