#!/usr/bin/env python3
"""On-card smoke test of pytorch_mppi_tpu_torch: builds the CUDA kernel, holds
it against its plain PyTorch version, and drives the port's main path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It exits non-zero, printing no result, when no card is available or when
the package is not beside it.  Phases, each fatal when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for ``csrc/fused_mppi.cu``;
3. kernel against plain: the fused kernel and ``fused_solve_plain`` on the
   same device inputs and bits, at the shapes of phases 4 and 5 (K = 10,000,
   T = 30 and the swing-up's K = 1,000, T = 15) and more, in bits mode and
   in seed mode (Philox in both), then the statistics of the seed-mode
   noise;
4. main path: 1,000 closed-loop commands of ``MPPI(linear_quadratic, K=10_000,
   T=30, use_pallas=True)`` (``bench.py``'s flagship problem), with the
   launch count and the goal checked, then the same on the plain torch path;
5. swing-up: the pendulum with ``use_pallas=True``, 150 steps;
6. the ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

K, T, NX, NU = 10_000, 30, 2, 2
COMMANDS = 1000
WARMUP = 20
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM data sheet


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def fused_work(config, model, seed_or_bits, x0T, op, emit_perturbed=False):
    """``(operations, bytes)`` one fused iteration needs on these inputs,
    for the least time the card could take (the ``bound_ms`` below).

    Operations are counted from ``csrc/fused_mppi.cu`` for the K live
    samples: every arithmetic instruction on the data, integer or float,
    once (a fused multiply-add twice, a library function such as ``log1pf``,
    ``expf``, ``sinf`` or ``fmodf`` once), erfinv on its common branch
    (|z| < 2.9).  Bytes count each input read once (a stride-0 ``x0T`` is
    its nx values) and each output written once; the (nblocks, D + 2)
    partials between the two kernels are not the function's."""
    from pytorch_mppi_tpu_torch.ops.fused_solve import _BLOCK

    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    D = T * nu
    seed_mode = not isinstance(seed_or_bits, torch.Tensor)
    full_op = op.ndim == 2
    # per (sample, row): the normal (bits -> u: 6; Giles' erfinv: 22;
    # sqrt(2) and the antithetic sign: 2), the transform, U + n, the clamp,
    # the rectified noise and its action cost, the weighted update (3)
    per_row = 30 + (2 * D + 1 if full_op else 2) + 6 + int(config.noise_abs_cost) + 3
    # Philox4x32-10: 10 rounds of 2 mulhi, 2 mullo, 4 xor; 9 key bumps of 2
    philox = -(-D // 4) * 98 if seed_mode else 0
    if model.name == "pendulum":  # scale 1, step 12, cost 9, sum 1
        per_step = nu + 12 + 9 + 1
    else:  # linear_quadratic: scale, u Bᵀ + x, |goal - x|², sum
        per_step = nu + nx * (2 * nu + 1) + 3 * nx + 1
    # per sample: the total, the logit, the block max, exp, the block sum
    per_sample = D * per_row + philox + T * per_step + 7
    nblocks = -(-K // _BLOCK)
    operations = K * per_sample + nblocks * (5 + 4 * D)
    x0_elems = nx if x0T.stride(1) == 0 else nx * K
    in_elems = (x0_elems + 5 * D + op.numel() + 1 + model.consts.numel()
                + (0 if seed_mode else seed_or_bits.numel()))
    out_elems = K + D + 2 + (D * K if emit_perturbed else 0)
    return operations, 4 * (in_elems + out_elems)


def events_ms(fn, iters):
    """Mean time per call on the card's timeline, between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters, names):
    """Device time per call of the kernels whose names contain ``names``,
    from the profiler's trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(n in e.key for n in names))
    return total / iters / 1e3 if total > 0 else None


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pytorch_mppi_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no pytorch_mppi_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))  # the checkout's package, never an installed one
    from pytorch_mppi_tpu_torch import MPPI, linear_quadratic, run_mppi
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import (
        PENDULUM_MODEL,
        PendulumEnv,
        angle_normalize,
        pendulum_dynamics,
        pendulum_running_cost,
    )
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import solve as PS

    # float32 products stay float32: no TF32 anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    built = _build.build()
    if built is None:
        print(f"# build: {_build.library_path().name} already built")
    else:
        secs, log = built
        print(f"# build {_build.SOURCE.name}: {secs:.1f} s\n" + "\n".join(
            "#   " + line for line in log.strip().splitlines()))

    # -- 3. kernel against its plain version ----------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev)
    goal = torch.tensor([2.0, 2.0], device=dev)
    lq = linear_quadratic(B, goal)

    def operands(model, K_, T_, nu, rho, op_diag, mu, bound, lam):
        D = T_ * nu
        cfg_sigma = torch.tensor([[1.0, 0.3], [0.3, 0.8]], device=dev)[:nu, :nu]
        if rho:
            cfg = MPPIConfig(nx=2, nu=nu, K=K_, T=T_, noise_rho=rho)
            op = PS._transposed_operands(cfg_sigma, torch.zeros(nu, device=dev),
                                         torch.zeros(nu, device=dev),
                                         torch.zeros(nu, device=dev), cfg, T_, nu,
                                         torch.float32)[1]
        else:
            op = torch.full((D,), op_diag, device=dev)
        U2 = torch.randn(D, generator=gen, device=dev) * 0.3
        x0 = (torch.tensor([math.pi, 1.0]) if model is PENDULUM_MODEL
              else torch.tensor([-3.0, -2.0])).to(dev)
        return (x0[:, None].expand(2, K_), U2, op.contiguous(),
                torch.full((D,), mu, device=dev),
                torch.full((D,), -bound, device=dev), torch.full((D,), bound, device=dev),
                (U2 * 0.7).contiguous(), torch.tensor(lam, device=dev))

    # name, model, K, T, nu, flags, noise_rho, emit, pairing block; the diagonal
    # op, mu and the bound follow in OPERANDS.  "swing_up" is the operands of
    # phase 5: sigma = 10 (op sqrt(10)), mu = 0, bounds +-2, no null row.
    cases = [
        ("lq_diag", lq, K, T, NU, {}, 0.0, False, None),
        ("lq_full_rho", lq, K, T, NU, {}, 0.5, False, None),
        ("lq_antithetic_5120", lq, K, T, NU, {"antithetic": True}, 0.0, False, 5120),
        ("lq_null_abs", lq, K, T, NU, {"sample_null_action": True, "noise_abs_cost": True},
         0.0, False, None),
        ("lq_u_scale", lq, K, T, NU, {"u_scale": 2.5}, 0.0, False, None),
        ("lq_emit_antithetic", lq, K, T, NU, {"antithetic": True}, 0.0, True, None),
        ("pendulum_null", PENDULUM_MODEL, K, 15, 1, {"sample_null_action": True}, 0.0,
         False, None),
        ("pendulum_full_rho", PENDULUM_MODEL, K, 15, 1, {}, 0.5, True, None),
        ("swing_up", PENDULUM_MODEL, 1000, 15, 1, {}, 0.0, False, None),
    ]
    OPERANDS = {"swing_up": (math.sqrt(10.0), 0.0, 2.0)}  # op, mu, bound
    # A cost error e moves each softmax weight by a factor e^(+-e/lam), so m,
    # s and the update may move by that much; the update is compared on the
    # scale of its largest element (its terms cancel, K = 10,000 of them).
    print("# kernel vs plain: cost rtol 2e-5 atol 1e-5; with e the largest cost "
          "error: |dm| <= e/lam + 1e-6, s rtol w = 2e-4 + 2e/lam, delta/s atol "
          "w * max|delta/s|; perturbed rtol 1e-5 atol 1e-6")
    max_update_err = 0.0
    for mode in ("bits", "seed"):
        for name, model, K_, T_, nu, flags, rho, emit, pb in cases:
            lam = 1.0
            op_diag, mu, bound = OPERANDS.get(
                name, (0.8, 0.05, 2.0 if model is PENDULUM_MODEL else 1.0))
            cfg = MPPIConfig(nx=2, nu=nu, K=K_, T=T_, diag_sigma=not rho,
                             noise_rho=rho, **flags)
            solve = FS.make_transposed_fused_solve(cfg, model, pair_block=pb,
                                                   emit_perturbed=emit)
            args = operands(model, K_, T_, nu, rho, op_diag, mu, bound, lam)
            if mode == "bits":
                lead = torch.randint(-2**31, 2**31 - 1, (T_ * nu, solve.bits_cols),
                                     dtype=torch.int32, generator=gen, device=dev)
            else:
                lead = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                           device=dev))
            out_k = solve(lead, *args)
            torch.cuda.synchronize()
            out_p = FS.fused_solve_plain(
                lead, *args, model=model, K=K_, T=T_, nu=nu,
                antithetic=cfg.antithetic, null_action=cfg.sample_null_action,
                abs_cost=cfg.noise_abs_cost, u_scale=cfg.u_scale,
                emit_perturbed=emit, pair_block=solve.pair_block)
            for v in out_k:
                check(bool(torch.isfinite(v).all()), f"{mode}/{name}: non-finite kernel output")
            dk, mk, sk, ck = out_k[:4]
            dp, mp, sp, cp = out_p[:4]
            c_err = float((ck - cp).abs().max())
            c_ok = bool(((ck - cp).abs() <= 1e-5 + 2e-5 * cp.abs()).all())
            w_tol = 2e-4 + 2 * c_err / lam
            m_err = abs(float(mk - mp))
            s_rel = abs(float(sk / sp - 1))
            uk, up = dk / sk, dp / sp
            u_err = float((uk - up).abs().max())
            u_ok = bool(((uk - up).abs() <= w_tol * float(up.abs().max())).all())
            ok = (c_ok and m_err <= c_err / lam + 1e-6 and s_rel <= w_tol and u_ok)
            line = (f"# {mode:4s} {name:20s} K={K_:5d} cost err {c_err:.3e} | m err {m_err:.3e} "
                    f"| s rel {s_rel:.3e} (tol {w_tol:.3e}) | delta/s err {u_err:.3e}")
            if emit:
                p_err = float((out_k[4] - out_p[4]).abs().max())
                ok = ok and bool(((out_k[4] - out_p[4]).abs()
                                  <= 1e-6 + 1e-5 * out_p[4].abs()).all())
                line += f" | perturbed err {p_err:.3e}"
            print(line + ("" if ok else "  <-- FAIL"))
            check(ok, f"kernel disagrees with its plain version: {mode}/{name}")
            max_update_err = max(max_update_err, u_err)

    # statistics of the seed-mode noise: U = 0, sigma = I, mu = 0, no bounds
    D = T * NU
    zeros, ones = torch.zeros(D, device=dev), torch.ones(D, device=dev)
    free = (torch.zeros(2, device=dev)[:, None].expand(2, K), zeros, ones, zeros,
            torch.full((D,), -torch.inf, device=dev), torch.full((D,), torch.inf, device=dev),
            zeros, torch.tensor(1.0, device=dev))
    for anti in (False, True):
        cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True, antithetic=anti)
        solve = FS.make_transposed_fused_solve(cfg, lq, emit_perturbed=True)
        z = solve((0x12345678, 0x9ABCDEF0), *free)[4].double()
        if anti:
            pair_sum = float((z[:, : K // 2] + z[:, K // 2:]).abs().max())
            var = float(z[:, : K // 2].var())
            n = z[:, : K // 2].numel()
            print(f"# seed-mode noise, antithetic: max |z_k + z_(k+K/2)| = {pair_sum} "
                  f"| var {var:.5f} over {n} (5 sigma: {5 * (2 / n) ** 0.5:.5f})")
            check(pair_sum == 0.0, "antithetic pairs do not sum to zero")
        else:
            mean, var, n = float(z.mean()), float(z.var()), z.numel()
            print(f"# seed-mode noise: mean {mean:.5f} (5 sigma: {5 / n ** 0.5:.5f}) "
                  f"| var {var:.5f} (5 sigma: {5 * (2 / n) ** 0.5:.5f}) over {n}")
            check(abs(mean) <= 5 / n ** 0.5, "seed-mode noise mean is not 0")
        check(abs(var - 1) <= 5 * (2 / n) ** 0.5, "seed-mode noise variance is not 1")

    # -- 4. the main path at full width ----------------------------------------
    def closed_loop(use_pallas):
        ctrl = MPPI(lq.dynamics, lq.running_cost, nx=NX,
                    noise_sigma=torch.eye(NU, device=dev), num_samples=K, horizon=T,
                    lambda_=1.0, seed=42, use_pallas=use_pallas)
        check(ctrl._fns.fused == use_pallas, f"use_pallas={use_pallas} took the wrong route")
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(WARMUP):
            x = lq.dynamics(x[None], ctrl.command(x)[None])[0]
        torch.cuda.synchronize()
        FS.launches = 0  # count the main path's launches only
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        min_d = torch.tensor(float("inf"), device=dev)
        wall = time.perf_counter()
        for i in range(COMMANDS):
            starts[i].record()
            action = ctrl.command(x)
            ends[i].record()
            x = lq.dynamics(x[None], action[None])[0]
            min_d = torch.minimum(min_d, torch.linalg.norm(x - goal))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        launched = FS.launches
        lat = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        final_d = float(torch.linalg.norm(x - goal))
        check(action.shape == (NU,) and bool(torch.isfinite(ctrl.U).all()),
              "main path gave a non-finite or misshapen action")
        return dict(median_ms=statistics.median(lat), p90_ms=lat[int(0.9 * len(lat))],
                    solves_per_s=COMMANDS / wall, min_dist=float(min_d),
                    final_dist=final_d, launches=launched, ctrl=ctrl, x=x)

    def breakdown(name, ctrl, x, n=50):
        """Where a command's time goes: device kernels per command from the
        profiler, and the device's idle share of the host-clock window."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = time.perf_counter()
            for _ in range(n):
                x = lq.dynamics(x[None], ctrl.command(x)[None])[0]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - wall) * 1e6
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        count = sum(e.count for e in kern)
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        print(f"# breakdown [{name}] over {n} commands (profiler on): host "
              f"{wall / n:.1f} us/command | device busy {busy / n:.1f} us/command in "
              f"{count / n:.1f} kernels | device idle {1 - busy / wall:.3f} | top: " + "; ".join(
                  f"{e.key[:40]} {e.self_device_time_total / n:.1f} us x{e.count / n:.1f}"
                  for e in top))

    fused = closed_loop(True)
    plain = closed_loop(False)
    for name, r in (("fused", fused), ("plain", plain)):
        print(f"# main path [{name}] K={K} T={T}: command median {r['median_ms']:.4f} ms "
              f"p90 {r['p90_ms']:.4f} ms (CUDA events) | {r['solves_per_s']:.1f} solves/s "
              f"(host clock) | min dist {r['min_dist']:.3f} final dist "
              f"{r['final_dist']:.3f} | launches {r['launches']}")
        # bench.py:184's sanity check: reached the goal region and did not diverge
        check(r["min_dist"] < 1.0 and r["final_dist"] < 10.0,
              f"{name} closed loop failed bench.py's sanity check")
    check(fused["launches"] == 2 * COMMANDS,
          f"fused path launched {fused['launches']} kernels for {COMMANDS} commands, "
          f"expected {2 * COMMANDS}")
    check(plain["launches"] == 0, "the plain path launched the fused kernel")
    main_launches = fused["launches"]
    breakdown("fused", fused["ctrl"], fused["x"])
    breakdown("plain", plain["ctrl"], plain["x"])

    # the kernel alone at the main path's shapes and operands
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
    solve = FS.make_transposed_fused_solve(cfg, lq)
    x0 = torch.tensor([-3.0, -2.0], device=dev)
    U = torch.randn(T, NU, generator=gen, device=dev) * 0.3
    op = torch.ones(T * NU, device=dev)
    lam = torch.tensor(1.0, device=dev)
    lo = torch.full((T * NU,), -torch.inf, device=dev)
    args = (PS._x0_to_lanes(x0, K), U.reshape(-1), op, torch.zeros(T * NU, device=dev),
            lo, -lo, U.reshape(-1) * 0.7, lam)
    bits = torch.randint(-2**31, 2**31 - 1, (T * NU, K), dtype=torch.int32,
                         generator=gen, device=dev)
    seed = (1234, 5678)
    plain_args = dict(model=lq, K=K, T=T, nu=NU)
    times = {}
    for mode, lead in (("seed", seed), ("bits", bits)):
        dev_ms = device_ms(lambda: solve(lead, *args), 200,
                           ("mppi_fused_partial", "flash_merge"))
        call_ms = events_ms(lambda: solve(lead, *args), 500)
        plain_ms = events_ms(lambda: FS.fused_solve_plain(lead, *args, **plain_args), 50)
        # the least time the card could take for the same work
        ops, nbytes = fused_work(cfg, lq, lead, args[0], args[2])
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_F32_PER_S * 1e3
        bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        times[mode] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by)
        print(f"# kernel alone [{mode}] K={K} T={T}: device {dev_ms} ms (profiler) | "
              f"per call {call_ms:.5f} ms (CUDA events, host wrapper included) | "
              f"plain version {plain_ms:.5f} ms (CUDA events)")
        print(f"# bound [{mode}]: {nbytes} B -> {t_bytes:.3e} ms at 3.35 TB/s; "
              f"{ops} operations -> {t_ops:.3e} ms at 67 TFLOP/s; bound by {bound_by}")

    # -- 5. swing-up -------------------------------------------------------------
    FS.launches = 0
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor([[10.0]], device=dev), num_samples=1000,
                horizon=15, lambda_=1.0, u_min=torch.tensor([-2.0]),
                u_max=torch.tensor([2.0]), use_pallas=True)
    check(ctrl._fns.fused, "the pendulum did not route to the fused kernel")
    env = PendulumEnv(downward_start=True)
    run_mppi(ctrl, env, lambda dataset: None, iter=150, render=False)
    angle = abs(float(angle_normalize(env.state[0])))
    print(f"# swing-up: final |angle| {angle:.4f} after 150 steps, K=1000, T=15 | "
          f"launches {FS.launches}")
    check(angle < 0.25, f"pendulum swing-up failed: final |angle| {angle}")
    check(FS.launches == 300, f"swing-up launched {FS.launches} kernels, expected 300")

    # -- 6. the kernels line and the last line ---------------------------------
    dev_ms, call_ms, plain_ms, bound_ms, bound_by = times["seed"]
    print(json.dumps({"kernels": [{
        "name": "fused_mppi (mppi_fused_partial + flash_merge)",
        "route": "cuda",
        "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
        "replaces": "pytorch_mppi_tpu/ops/pallas_rollout.py:512",
        "launches": main_launches,
        "max_abs_err": max_update_err,
        "ms": dev_ms if dev_ms is not None else call_ms,
        # the profiler's device time of both kernels, or, when its trace
        # holds none, CUDA-event time per call with the host wrapper included
        "ms_source": "profiler" if dev_ms is not None else "cuda_events_with_host",
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
