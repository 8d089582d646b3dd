#!/usr/bin/env python3
"""Device time of the block models' kernels for several checkouts of the
repo, in alternating processes on one CUDA card.

    python3 pytorch_mppi_tpu_torch/tools/block_ab.py DIR [DIR ...] [--turns 2] [--out FILE]

The shapes are ``chip_smoke.py`` phase 4e's (read from each checkout's own
``chip_smoke.py``): a learned quadrotor's [16, 256, 256, 12] residual MLP on
``ResidualMLPBlock`` (``QUAD_SIZES``, seeded weights) in kernel A's three
variants and the legacy rollout at K = 10,000, T = 30 and in the batched pair
at N = 16, K = 10,240; and an untagged ``nn.Sequential`` of MBPO's shape
(``MBPO_SIZES``, SiLU) traced into dense layers, in kernel A (MPPI) and the
batched pair.  Each checkout's named library and the MBPO network's two
generated libraries are built first, every checkout at once (one process
each).  Then the checkouts' processes run one after another, in turns
(A, B, ..., then backwards, ``--turns`` times; ``ab_turns.py``), each
timing every kernel on seed-mode operands as the device time of one call
replayed from a CUDA graph (20 calls; the batched pairs 3), beside the
card's name and power limit.  The summary gives each kernel's median per
checkout, its ratio to the first checkout's, and in how many turns it
read higher.  Compare checkouts only within one call: a card's power
limit and its host move the times between calls.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import ab_turns  # this folder's: the build, the turns and the summary

KERNELS = ("quad mppi", "quad smppi", "quad kmppi", "quad rollout", "quad batched",
           "mbpo mppi", "mbpo batched")


def _setup(root):
    """The checkout's chip_smoke module, package and traced MBPO model."""
    sys.path.insert(0, root)  # this checkout's package, never an installed one
    import torch

    import chip_smoke as cs
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import batch_last as BL

    fns = cs.mbpo_callables(torch.device("cuda"))
    model = BL.kernel_model(MPPIConfig(nx=cs.QUAD_NX, nu=cs.QUAD_NU, K=cs.MLP_K, T=cs.MLP_T),
                            *fns)
    return cs, model


def build_child(root):
    _, model = _setup(root)
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    t0 = time.perf_counter()
    built = _build.build()
    if built is not None:
        _build.library_path().with_suffix(".log").write_text(built[1])
    kernel = BL.generated_kernel(model, None)
    for variant in (FS.MPPI, FS.BATCHED):
        kernel.library(variant)
    print(time.perf_counter() - t0)  # the build's seconds, read by ab_turns.build
    return 0


def time_child(root):
    cs, mbpo = _setup(root)
    import torch

    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import mlp_init
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops.kernel_models import residual_mlp_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    qp = mlp_init(cs.QUAD_SIZES, torch.Generator().manual_seed(29), torch.float32, dev)
    Wq, bq = qp[-1]
    qp[-1] = (Wq * cs.QUAD_STEP, bq * cs.QUAD_STEP)
    quad = residual_mlp_model(qp, cs.QUAD_NX, cs.QUAD_NU, cost="quadratic", goal=cs.QUAD_GOAL)
    K, T, nsp = cs.MLP_K, cs.MLP_T, cs.MLP_T // 2
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}
    key = (1234, 5678)
    _, ops = cs.mlp_operands(dev, gen, cs.QUAD_NX, cs.QUAD_NU, list(cs.QUAD_X0), 1.0)
    calls = {}
    for which, model in (("quad", quad), ("mbpo", mbpo)):
        for variant in ("mppi", "smppi", "kmppi") if which == "quad" else ("mppi",):
            cfg = MPPIConfig(nx=cs.QUAD_NX, nu=cs.QUAD_NU, K=K, T=T, diag_sigma=True,
                             num_support_pts=nsp if variant == "kmppi" else 0,
                             smppi=variant == "smppi")
            solve = factories[variant](cfg, model)
            calls[f"{which} {variant}"] = (lambda s=solve, a=ops[variant]: s(key, *a), 20)
        b_cfg = MPPIConfig(nx=cs.QUAD_NX, nu=cs.QUAD_NU, K=cs.MLP_BATCH_K, T=T, diag_sigma=True)
        bsolve = FS.make_transposed_batched_solve(b_cfg, cs.MLP_BATCH_N, model)
        rest = cs.mlp_batched_rest(dev, gen, cs.QUAD_NX, cs.QUAD_NU, cs.MLP_BATCH_N,
                                   list(cs.QUAD_X0), 0.2, 1.0)
        calls[f"{which} batched"] = (lambda s=bsolve, r=rest: s(key, *r), 3)
    rollout = LG.make_fused_rollout(MPPIConfig(nx=cs.QUAD_NX, nu=cs.QUAD_NU, K=K, T=T), quad)
    x0_K = torch.tensor(cs.QUAD_X0, device=dev)[None].expand(K, cs.QUAD_NX)
    u = torch.clamp(torch.randn(K, T, cs.QUAD_NU, generator=gen, device=dev), -2, 2)
    calls["quad rollout"] = (lambda: rollout(x0_K, u), 20)
    out = {"card": cs.card_line()}
    for name in KERNELS:
        fn, iters = calls[name]
        fn()
        torch.cuda.synchronize()
        out[name] = cs.graph_ms(fn, iters)
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkouts, the first the reference")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", help="also write every process's result here (JSON lines)")
    ap.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root = str(Path(args.dirs[0]).resolve())
        return build_child(root) if args.child == "build" else time_child(root)
    roots = [str(Path(d).resolve()) for d in args.dirs]
    ab_turns.build(dict.fromkeys(roots),
                   lambda root: [sys.executable, __file__, root, "--child", "build"])
    results = ab_turns.run_turns(
        roots, lambda root: [sys.executable, __file__, root, "--child", "time"], args.turns,
        lambda i, r: print(f"[{roots[i]}] " + " | ".join(f"{k} {r[k]:.6f} ms" for k in KERNELS)
                           + f" | {r['card']}"),
        args.out)
    ab_turns.summarize(results, KERNELS, [f"{i}:{Path(root).name}" for i, root in enumerate(roots)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
