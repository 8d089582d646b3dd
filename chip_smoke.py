#!/usr/bin/env python3
"""On-card smoke test of pytorch_mppi_tpu_torch: builds the CUDA kernel, holds
its three variants (MPPI, SMPPI, KMPPI) against their plain PyTorch versions,
and drives the port's main paths.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It exits non-zero, printing no result, when no card is available or when
the package is not beside it.  Phases, each fatal when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for ``csrc/fused_mppi.cu``;
3. kernel against plain: each variant of the fused kernel and its plain
   version on the same device inputs and bits, at the shapes of phases 4-6
   (K = 10,000, T = 30; the swing-up's K = 1,000, T = 15; the closed loops'
   K = 500) and more (D = 300 with a full operator, on the global-memory
   tiles; a 12-state, 4-action ``linear_quadratic``), in bits mode and in
   seed mode (Philox in both), then the statistics of the seed-mode noise;
4. main paths: 1,000 closed-loop commands of ``MPPI``, ``SMPPI`` and
   ``KMPPI`` on ``linear_quadratic`` at K = 10,000, T = 30 (``bench.py``'s
   flagship problem), fused (``use_pallas=True``) with the launch count and
   the goal checked, then the same on the plain torch path; the kernels
   alone at the same shapes;
5. swing-up: the pendulum with ``use_pallas=True``, 150 steps;
6. closed loops through the kernels: the ``tests/test_mppi.py`` LQ problem
   (KMPPI reaches the goal, SMPPI stays finite) and the toy2d comparison of
   ``examples/smooth_mppi.py`` (MPPI, SMPPI, KMPPI);
7. the ``kernels`` line, the card line, then the last line
   ``{"ok": true, "device": ...}``.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

DEVICE = "cuda"
K, T, NX, NU = 10_000, 30, 2, 2
NSP = T // 2  # KMPPI's default support points at the flagship
COMMANDS = 1000
WARMUP = 20
LOOP_K = 500  # the closed loops of phase 6
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
PR1_MPPI_SEED_MS = 0.04754  # the MPPI pair, seed mode, flagship (PERF.md, PR 1)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def _per_step(model, nx, nu):
    """Operations of one device-model step plus its running cost."""
    if model.name == "pendulum":  # scale 1, step 12, cost 9, sum 1
        return nu + 12 + 9 + 1
    # scale, u Bᵀ + x, |goal - x|², sum
    ops = nu + nx * (2 * nu + 1) + 3 * nx + 1
    if model.name == "toy2d":  # hill (c - x)ᵀ Q (c - x), r|u|², exp and sums
        ops += nx * (3 + 3 * nx) + 2 * nu + 6
    return ops


def fused_work(config, model, seed_or_bits, x0T, op, emit_perturbed=False,
               variant="mppi"):
    """``(operations, bytes)`` one fused iteration needs on these inputs,
    for the least time the card could take (the ``bound_ms`` below).

    Operations are counted from ``csrc/fused_mppi.cu`` for the K live
    samples: every arithmetic instruction on the data, integer or float,
    once (a fused multiply-add twice, a library function such as ``log1pf``,
    ``expf``, ``sinf`` or ``fmodf`` once), erfinv on its common branch
    (|z| < 2.9).  Bytes count each input read once (a stride-0 ``x0T`` is
    its nx values) and each output written once; the (nblocks, R + 2)
    partials between the two kernels are not the function's.  R is the
    rows drawn and updated: D = T·nu, or Dp = nsp·nu for KMPPI."""
    from pytorch_mppi_tpu_torch.ops.fused_solve import _BLOCK

    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    D = T * nu
    R = config.num_support_pts * nu if variant == "kmppi" else D
    seed_mode = not isinstance(seed_or_bits, torch.Tensor)
    full_op = op.ndim == 2
    absc = int(config.noise_abs_cost)
    # per drawn row: the normal (bits -> u: 6; Giles' erfinv: 22; sqrt(2)
    # and the antithetic sign: 2), the transform
    draw = 30 + (2 * R + 1 if full_op else 2)
    if variant == "mppi":
        # U + n, the clamp, the rectified noise and its action cost, the
        # weighted update (3)
        per_sample = D * (draw + 6 + absc + 3)
    elif variant == "smppi":
        # U + n, rate clamp, integrate, action clamp, (pa - as)/dt - U, the
        # action cost, the smoothness term (sub, fma, u_scale), the update
        # (sub, div, sub, fma)
        per_sample = D * (draw + 1 + 2 + 2 + 2 + 3 + 2 + absc
                          + 2 + int(config.u_scale != 1.0) + 5) + 2
    else:
        # theta + n, the clamp, the update (3); per horizon row the
        # interpolation (Dp fmas), the clamp, the rectified noise and its cost
        per_sample = R * (draw + 1 + 2 + 3) + D * (2 * R + 2 + 1 + 2 + absc)
    # Philox4x32-10: 10 rounds of 2 mulhi, 2 mullo, 4 xor; 9 key bumps of 2
    philox = -(-R // 4) * 98 if seed_mode else 0
    # per sample: the total, the logit, the block max, exp, the block sum
    per_sample += philox + T * _per_step(model, nx, nu) + 7
    nblocks = -(-K // _BLOCK)
    operations = K * per_sample + nblocks * (5 + 4 * R)
    x0_elems = nx if x0T.stride(1) == 0 else nx * K
    vectors = {"mppi": 5 * D + 1, "smppi": 8 * D + 3,
               "kmppi": 4 * D + 4 * R + D * R + 1}[variant]
    in_elems = (x0_elems + vectors + op.numel() + model.consts.numel()
                + (0 if seed_mode else seed_or_bits.numel()))
    out_elems = K + R + 2 + (D * K if emit_perturbed else 0)
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


def breakdown(name, ctrl, step, x, n=50):
    """Where a command's time goes: device kernels per command from the
    profiler, and the device's idle share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for _ in range(n):
            x = step(x, ctrl.command(x))
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


def card_line():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi failed"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


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
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, RBFKernel, linear_quadratic, run_mppi
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import (
        PENDULUM_MODEL,
        PendulumEnv,
        Toy2DEnvironment,
        angle_normalize,
        pendulum_dynamics,
        pendulum_running_cost,
    )
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import solve as PS
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    # float32 products stay float32: no TF32 anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    def reset_launches():
        for v in FS.VARIANTS:
            FS.launches[v] = 0

    # -- 1. device -----------------------------------------------------------
    card = card_line()
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    built = _build.build()
    if built is None:
        print(f"# build: {_build.library_path().name} already built")
    else:
        secs, log = built
        print(f"# build {_build.SOURCE.name} ({_build.PARTS} parts in parallel): "
              f"{secs:.1f} s\n" + "\n".join(
                  "#   " + line for line in log.strip().splitlines()))

    # -- 3. kernel against its plain version ----------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev)
    goal = torch.tensor([2.0, 2.0], device=dev)
    lq = linear_quadratic(B, goal)
    g_cpu = torch.Generator().manual_seed(12)
    lq3 = linear_quadratic(torch.randn(2, 3, generator=g_cpu) * 0.5, torch.tensor([2.0, 2.0]))
    lq12 = linear_quadratic(torch.randn(12, 4, generator=g_cpu) * 0.3,
                            torch.randn(12, generator=g_cpu))
    toy = Toy2DEnvironment(device=dev)
    X0 = {"pendulum": [math.pi, 1.0], "linear_quadratic": [-3.0, -2.0],
          "toy2d": [-3.0, -2.0]}
    factories = {"mppi": FS.make_transposed_fused_solve,
                 "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}

    def operands(variant, cfg, model, rho, op_diag, mu, bound, abound, lam, w, dt):
        """The device operands of one kernel case, in call order after the
        noise source."""
        K_, T_, nu, nx = cfg.K, cfg.T, cfg.nu, cfg.nx
        D = T_ * nu
        reps = cfg.num_support_pts if variant == "kmppi" else T_
        R = reps * nu
        if rho:
            sig = torch.eye(nu, device=dev) + 0.3 * (torch.ones(nu, nu, device=dev)
                                                     - torch.eye(nu, device=dev))
            z = torch.zeros(nu, device=dev)
            op = PS._transposed_operands(sig, z, z, z, cfg, reps, nu, torch.float32)[1]
        else:
            op = torch.full((R,), op_diag, device=dev)
        x0 = torch.tensor(X0.get(model.name, [0.5] * nx), device=dev)[:nx]
        if x0.numel() < nx:
            x0 = torch.randn(nx, generator=gen, device=dev)
        x0T = x0[:, None].expand(nx, K_)
        U2 = torch.randn(D, generator=gen, device=dev) * 0.3
        a_flat = (U2 * 0.7).contiguous()
        full = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
        lam_t = torch.tensor(lam, device=dev)
        if variant == "mppi":
            return (x0T, U2, op.contiguous(), full(mu), full(-bound), full(bound), a_flat, lam_t)
        if variant == "smppi":
            as2 = torch.randn(D, generator=gen, device=dev) * 0.2
            return (x0T, U2, as2, op.contiguous(), full(mu), full(-bound), full(bound),
                    full(-abound), full(abound), a_flat, lam_t, torch.tensor(w, device=dev),
                    torch.tensor(dt, device=dev))
        th = torch.randn(R, generator=gen, device=dev) * 0.2
        interp, _ = interpolation_operators(RBFKernel(2.0), T_, cfg.num_support_pts,
                                            torch.float32, device=dev)
        Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
        pfull = lambda v: torch.full((R,), v, device=dev)  # noqa: E731
        return (x0T, U2, th, op.contiguous(), pfull(mu), pfull(-bound), pfull(bound),
                full(-abound), full(abound), a_flat, Wt, lam_t)

    # (name, model, K, T, nu, nsp, config flags, noise_rho, emit, pairing
    # block, operand overrides).  The overrides give the diagonal op, mu, the
    # drawn rows' bound, the action/trajectory bound, lambda, w and delta_t
    # of the main paths' and closed loops' own operands.
    inf = math.inf
    base_cases = [
        ("lq_diag", lq, K, T, NU, NSP, {}, 0.0, False, None, {}),
        ("lq_full_rho", lq, K, T, NU, NSP, {}, 0.5, False, None, {}),
        ("lq_antithetic_5120", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, False, 5120, {}),
        ("lq_null_abs", lq, K, T, NU, NSP,
         {"sample_null_action": True, "noise_abs_cost": True}, 0.0, False, None, {}),
        ("lq_u_scale", lq, K, T, NU, NSP, {"u_scale": 2.5}, 0.0, False, None, {}),
        ("lq_emit_antithetic", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, True, None, {}),
        ("pendulum_null", PENDULUM_MODEL, K, 15, 1, 7, {"sample_null_action": True}, 0.0,
         False, None, {}),
        ("pendulum_full_rho", PENDULUM_MODEL, K, 15, 1, 7, {}, 0.5, True, None, {}),
        ("D300_full_rho_global", lq3, K, 100, 3, 50, {}, 0.5, False, None, {}),
        ("lq12_nx12_nu4", lq12, K, T, 4, NSP, {}, 0.0, True, None, {}),
    ]
    cases = [("mppi",) + c for c in base_cases] + [
        # phase 5's operands: sigma = 10 (op sqrt(10)), mu = 0, bounds +-2
        ("mppi", "swing_up", PENDULUM_MODEL, 1000, 15, 1, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(10.0), mu=0.0, bound=2.0)),
        # phase 4's: the flagship main paths
        ("smppi", "main_path", lq, K, T, NU, 0, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=3.0, w=1.0, dt=1.0)),
        ("kmppi", "main_path", lq, K, T, NU, NSP, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf)),
        # phase 6's: the LQ loops and the toy2d comparison
        ("smppi", "lq_loop", lq, LOOP_K, 15, NU, 0, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf, w=5.0, dt=1.0)),
        ("kmppi", "lq_loop", lq, LOOP_K, 15, NU, 5, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf)),
        ("mppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0)),
        ("smppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0, abound=1.0, w=50.0, dt=1.0)),
        ("kmppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 5, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0, abound=1.0)),
    ]
    cases += [("smppi",) + c for c in base_cases] + [("kmppi",) + c for c in base_cases]
    # A cost error e moves each softmax weight by a factor e^(+-e/lam), so m,
    # s and the update may move by that much; the update is compared on the
    # scale of its largest element (its terms cancel, K = 10,000 of them).
    print("# kernel vs plain: cost rtol 2e-5 atol 1e-5; with e the largest cost "
          "error: |dm| <= e/lam + 1e-6, s rtol w = 2e-4 + 2e/lam, delta/s atol "
          "w * max|delta/s|; perturbed rtol 1e-5 atol 1e-6")
    max_update_err = dict.fromkeys(FS.VARIANTS, 0.0)
    n_cases = dict.fromkeys(FS.VARIANTS, 0)
    for mode in ("bits", "seed"):
        for variant, name, model, K_, T_, nu, nsp, flags, rho, emit, pb, over in cases:
            lam = 1.0
            pend = model is PENDULUM_MODEL
            cfg = MPPIConfig(nx=model.nx, nu=nu, K=K_, T=T_, diag_sigma=not rho,
                             noise_rho=rho, num_support_pts=nsp if variant == "kmppi" else 0,
                             smppi=variant == "smppi", **flags)
            solve = factories[variant](cfg, model, pair_block=pb, emit_perturbed=emit)
            if name.endswith("_global"):
                check(solve.tiles == "global", f"{variant}/{name} did not take global tiles")
            args = operands(variant, cfg, model, rho, over.get("op", 0.8), over.get("mu", 0.05),
                            over.get("bound", 2.0 if pend else 1.5),
                            over.get("abound", 2.0 if pend else 1.0), lam,
                            over.get("w", 3.0), over.get("dt", 0.5))
            R = (nsp if variant == "kmppi" else T_) * nu
            if mode == "bits":
                lead = torch.randint(-2**31, 2**31 - 1, (R, solve.bits_cols),
                                     dtype=torch.int32, generator=gen, device=dev)
            else:
                lead = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                           device=dev))
            out_k = solve(lead, *args)
            torch.cuda.synchronize()
            out_p = solve.plain(lead, *args)
            for v in out_k:
                check(bool(torch.isfinite(v).all()),
                      f"{mode}/{variant}/{name}: non-finite kernel output")
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
            line = (f"# {mode:4s} {variant:5s} {name:20s} K={K_:5d} D={T_ * nu:3d} "
                    f"tiles={solve.tiles:6s} cost err {c_err:.3e} | m err {m_err:.3e} "
                    f"| s rel {s_rel:.3e} (tol {w_tol:.3e}) | delta/s err {u_err:.3e}")
            if emit:
                p_err = float((out_k[4] - out_p[4]).abs().max())
                ok = ok and bool(((out_k[4] - out_p[4]).abs()
                                  <= 1e-6 + 1e-5 * out_p[4].abs()).all())
                line += f" | perturbed err {p_err:.3e}"
            print(line + ("" if ok else "  <-- FAIL"))
            check(ok, f"kernel disagrees with its plain version: {mode}/{variant}/{name}")
            max_update_err[variant] = max(max_update_err[variant], u_err)
            n_cases[variant] += 1
    print(f"# kernel vs plain: {sum(n_cases.values())} cases agreed "
          f"({', '.join(f'{v} {n}' for v, n in n_cases.items())})")

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

    # -- 4. the main paths at full width ---------------------------------------
    def lq_step(x, action):
        return lq.dynamics(x[None], action[None])[0]

    MAIN = {  # the flagship problem of each controller
        "mppi": (MPPI, {}),
        "smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                              action_min=torch.tensor([-3.0, -3.0]),
                              action_max=torch.tensor([3.0, 3.0]))),
        "kmppi": (KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0))),
    }

    def closed_loop(variant, use_pallas):
        cls, extra = MAIN[variant]
        ctrl = cls(lq.dynamics, lq.running_cost, nx=NX,
                   noise_sigma=torch.eye(NU, device=dev), num_samples=K, horizon=T,
                   lambda_=1.0, seed=42, use_pallas=use_pallas, device=dev, **extra)
        check(ctrl._fns.fused == use_pallas,
              f"{variant} use_pallas={use_pallas} took the wrong route")
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(WARMUP):
            x = lq_step(x, ctrl.command(x))
        torch.cuda.synchronize()
        reset_launches()  # count the main path's launches only
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        min_d = torch.tensor(float("inf"), device=dev)
        wall = time.perf_counter()
        for i in range(COMMANDS):
            starts[i].record()
            action = ctrl.command(x)
            ends[i].record()
            x = lq_step(x, action)
            min_d = torch.minimum(min_d, torch.linalg.norm(x - goal))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        launched = dict(FS.launches)
        lat = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        final_d = float(torch.linalg.norm(x - goal))
        check(action.shape == (NU,) and bool(torch.isfinite(ctrl.U).all()),
              f"{variant} main path gave a non-finite or misshapen action")
        return dict(median_ms=statistics.median(lat), p90_ms=lat[int(0.9 * len(lat))],
                    solves_per_s=COMMANDS / wall, min_dist=float(min_d),
                    final_dist=final_d, launches=launched, ctrl=ctrl, x=x)

    main = {}
    for variant in FS.VARIANTS:
        for path, use_pallas in (("fused", True), ("plain", False)):
            r = closed_loop(variant, use_pallas)
            main[variant, path] = r
            print(f"# main path [{variant} {path}] K={K} T={T}: command median "
                  f"{r['median_ms']:.4f} ms p90 {r['p90_ms']:.4f} ms (CUDA events) | "
                  f"{r['solves_per_s']:.1f} solves/s (host clock) | min dist "
                  f"{r['min_dist']:.3f} final dist {r['final_dist']:.3f} | launches "
                  f"{r['launches']}")
            # bench.py:184's sanity check: reached the goal region and did not diverge
            check(r["min_dist"] < 1.0 and r["final_dist"] < 10.0,
                  f"{variant} {path} closed loop failed bench.py's sanity check")
            expect = {v: 0 for v in FS.VARIANTS}
            if use_pallas:
                expect[variant] = 2 * COMMANDS
            check(r["launches"] == expect,
                  f"{variant} {path} path launched {r['launches']} for {COMMANDS} "
                  f"commands, expected {expect}")
    for (variant, path), r in main.items():
        breakdown(f"{variant} {path}", r["ctrl"], lq_step, r["x"])

    # the kernels alone at the main paths' shapes and operands; the global
    # tiles at D = 300 (T = 100, nu = 3, full op) beside them
    timed = {}
    for variant in FS.VARIANTS:
        for shape in ("flagship", "D300_global"):
            if shape == "flagship":
                model, T_, nu, nsp, rho = lq, T, NU, NSP, 0.0
            else:
                model, T_, nu, nsp, rho = lq3, 100, 3, 50, 0.5
            cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T_, diag_sigma=not rho, noise_rho=rho,
                             num_support_pts=nsp if variant == "kmppi" else 0,
                             smppi=variant == "smppi")
            solve = factories[variant](cfg, model)
            args = operands(variant, cfg, model, rho, 1.0, 0.0, inf,
                            3.0 if variant == "smppi" else inf, 1.0, 1.0, 1.0)
            R = (nsp if variant == "kmppi" else T_) * nu
            bits = torch.randint(-2**31, 2**31 - 1, (R, solve.bits_cols), dtype=torch.int32,
                                 generator=gen, device=dev)
            modes = (("seed", (1234, 5678)), ("bits", bits)) if shape == "flagship" else (
                ("seed", (1234, 5678)),)
            for mode, lead in modes:
                dev_ms = device_ms(lambda: solve(lead, *args), 200,
                                   ("mppi_fused_partial", "flash_merge"))
                call_ms = events_ms(lambda: solve(lead, *args), 500)
                plain_ms = events_ms(lambda: solve.plain(lead, *args), 50)
                ops, nbytes = fused_work(cfg, model, lead, args[0], args[3 if variant != "mppi"
                                                                         else 2],
                                         variant=variant)
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                t_ops = ops / H100_F32_PER_S * 1e3
                bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
                timed[variant, shape, mode] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by)
                print(f"# kernel alone [{variant} {shape} {mode}] K={K} T={T_} tiles="
                      f"{solve.tiles}: device {dev_ms} ms (profiler) | per call "
                      f"{call_ms:.5f} ms (CUDA events, host wrapper included) | plain "
                      f"version {plain_ms:.5f} ms (CUDA events)")
                print(f"# bound [{variant} {shape} {mode}]: {nbytes} B -> {t_bytes:.3e} ms "
                      f"at 3.35 TB/s; {ops} operations -> {t_ops:.3e} ms at 67 TFLOP/s; "
                      f"bound by {bound_by}")
    mppi_seed = timed["mppi", "flagship", "seed"][0]
    if mppi_seed is not None:
        print(f"# MPPI pair, seed mode, flagship: {mppi_seed:.5f} ms against PR 1's "
              f"{PR1_MPPI_SEED_MS} ms: ratio {mppi_seed / PR1_MPPI_SEED_MS:.4f} "
              f"(limit 1.1)")

    # -- 5. swing-up -------------------------------------------------------------
    reset_launches()
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor([[10.0]], device=dev), num_samples=1000,
                horizon=15, lambda_=1.0, u_min=torch.tensor([-2.0]),
                u_max=torch.tensor([2.0]), use_pallas=True, device=dev)
    check(ctrl._fns.fused, "the pendulum did not route to the fused kernel")
    env = PendulumEnv(downward_start=True)
    run_mppi(ctrl, env, lambda dataset: None, iter=150, render=False)
    angle = abs(float(angle_normalize(env.state[0])))
    print(f"# swing-up: final |angle| {angle:.4f} after 150 steps, K=1000, T=15 | "
          f"launches {FS.launches['mppi']}")
    check(angle < 0.25, f"pendulum swing-up failed: final |angle| {angle}")
    check(FS.launches["mppi"] == 300, f"swing-up launched {FS.launches}, expected 300")

    # -- 6. closed loops through the kernels -------------------------------------
    # tests/test_mppi.py:744-771: K = 500, T = 15, sigma = I, 20 steps
    def lq_ctrl(cls, seed, **kw):
        c = cls(lq.dynamics, lq.running_cost, nx=2, noise_sigma=torch.eye(2, device=dev),
                num_samples=LOOP_K, horizon=15, lambda_=1.0, seed=seed, use_pallas=True,
                device=dev, **kw)
        check(c._fns.fused, f"{cls.__name__} LQ loop did not route to the fused kernel")
        return c

    reset_launches()
    dists = []
    for seed in (42, 43, 44):
        c = lq_ctrl(KMPPI, seed, num_support_pts=5, kernel=RBFKernel(2.0))
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(20):
            x = lq_step(x, c.command(x))
        dists.append(float(torch.linalg.norm(x - goal)))
    c = lq_ctrl(SMPPI, 42, w_action_seq_cost=5.0)
    x = torch.tensor([-3.0, -2.0], device=dev)
    finite = True
    for _ in range(20):
        action = c.command(x)
        x = lq_step(x, action)
        finite = finite and bool(torch.isfinite(action).all() and torch.isfinite(x).all())
    finite = finite and bool(torch.isfinite(c.cost_total).all() and (c.cost_total >= 0).all())
    print(f"# LQ loops (K={LOOP_K}, T=15, 20 steps): KMPPI final dist {dists} mean "
          f"{sum(dists) / 3:.4f} | SMPPI finite {finite}, final dist "
          f"{float(torch.linalg.norm(x - goal)):.4f} | launches {FS.launches}")
    check(sum(dists) / 3 < 2.0, f"KMPPI LQ loop missed the goal: {dists}")
    check(finite, "SMPPI LQ loop went non-finite or gave a negative cost")
    check(FS.launches == {"mppi": 0, "smppi": 40, "kmppi": 120},
          f"LQ loops launched {FS.launches}")

    # examples/smooth_mppi.py's comparison, without the terminal cost
    toy_common = dict(nx=2, noise_sigma=torch.eye(2, device=dev) * 0.2,
                      num_samples=LOOP_K, horizon=20, lambda_=1.0,
                      u_min=torch.tensor([-1.0, -1.0]), u_max=torch.tensor([1.0, 1.0]),
                      seed=42, use_pallas=True, device=dev)
    toy_ctrls = {
        "mppi": MPPI(toy.dynamics, toy.running_cost, **toy_common),
        "smppi": SMPPI(toy.dynamics, toy.running_cost, w_action_seq_cost=50.0, delta_t=1.0,
                       action_min=torch.tensor([-1.0, -1.0]),
                       action_max=torch.tensor([1.0, 1.0]), **toy_common),
        "kmppi": KMPPI(toy.dynamics, toy.running_cost, num_support_pts=5,
                       kernel=RBFKernel(2.0), **toy_common),
    }
    for name, c in toy_ctrls.items():
        check(c._fns.fused, f"toy2d {name} did not route to the fused kernel")
        reset_launches()
        x = toy.start.clone()
        total, actions = 0.0, []
        for _ in range(40):
            a = c.command(x)
            actions.append(a)
            total += float(toy.running_cost(x[None], a[None])[0])
            x = toy.dynamics(x[None], a[None])[0]
        acts = torch.stack(actions)
        smooth = float(torch.diff(acts, dim=0).abs().sum())
        in_bounds = bool(torch.isfinite(acts).all() and (acts.abs() <= 1.0).all())
        print(f"# toy2d [{name}] K={LOOP_K} T=20, 40 steps: accumulated cost {total:.2f} | "
              f"final dist {float(torch.linalg.norm(x - toy.goal)):.4f} | smoothness "
              f"{smooth:.3f} | actions finite and within +-1: {in_bounds} | launches "
              f"{FS.launches[name]}")
        check(in_bounds, f"toy2d {name}: actions non-finite or out of bounds")
        check(FS.launches[name] == 80, f"toy2d {name} launched {FS.launches}")

    # -- 7. the kernels line and the last line ---------------------------------
    sources = {"mppi": ("fused_mppi MPPI (mppi_fused_partial<..., kMPPI> + flash_merge)",
                        "pytorch_mppi_tpu/ops/pallas_rollout.py:512"),
               "smppi": ("fused_mppi SMPPI (mppi_fused_partial<..., kSMPPI> + flash_merge)",
                         "pytorch_mppi_tpu/ops/pallas_rollout.py:755"),
               "kmppi": ("fused_mppi KMPPI (mppi_fused_partial<..., kKMPPI> + flash_merge)",
                         "pytorch_mppi_tpu/ops/pallas_rollout.py:940")}
    kernels = []
    for variant in FS.VARIANTS:
        dev_ms, call_ms, plain_ms, bound_ms, bound_by = timed[variant, "flagship", "seed"]
        g_ms = timed[variant, "D300_global", "seed"]
        b_ms = timed[variant, "flagship", "bits"]
        kernels.append({
            "name": sources[variant][0],
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": sources[variant][1],
            "launches": main[variant, "fused"]["launches"][variant],
            "max_abs_err": max_update_err[variant],
            "ms": dev_ms if dev_ms is not None else call_ms,
            # the profiler's device time of both kernels, or, when its trace
            # holds none, CUDA-event time per call with the host wrapper included
            "ms_source": "profiler" if dev_ms is not None else "cuda_events_with_host",
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "ms_bits_mode": b_ms[0] if b_ms[0] is not None else b_ms[1],
            "ms_D300_global_tiles": g_ms[0] if g_ms[0] is not None else g_ms[1],
            "bound_ms_D300_global_tiles": g_ms[3],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
