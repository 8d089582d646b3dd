#!/usr/bin/env python3
"""The dynamics bridge's program near ``MAX_OPS`` on one CUDA card: the
planar swarm of ``chip_smoke.swarm_callables`` at 38 agents (nx = 152, nu
= 76, 15,124 scalar operations a step of the bound's 16,384; 40 agents'
16,720 are refused), its kernel A library built alone (one ``nvcc``, timed,
a line a minute while it runs), then kernel A's MPPI against its plain
version and a float64 rollout at K = 10,000, T = 10
(``chip_smoke.wide_kernel_a``, phase 4g's check), timed from a CUDA graph
of 20 calls beside its bound, with its registers and spill stores from the
build log.  Its ``nvcc`` has run for more than an hour on an H100 host's 8
cores, past ``chip_smoke.py``'s time limit, so that script leaves this case
to here.  Prints its ``kernels`` row as one JSON line.

    python3 pytorch_mppi_tpu_torch/tools/max_ops_alone.py

Run from the root of a checkout; exits non-zero where a check fails.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
AGENTS, STEPS = 38, 10


def plan(CS, dev):
    """The swarm at AGENTS agents traced, and its kernel A library:
    (callables, {label: (kernel, variant)})."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    start = time.perf_counter()
    fns = CS.swarm_callables(dev, AGENTS)
    model = BL.kernel_model(MPPIConfig(nx=4 * AGENTS, nu=2 * AGENTS, K=CS.K, T=STEPS), *fns)
    ops = BL._count_ops(model.program, model.outputs)
    CS.check(15_000 <= ops <= BL.MAX_OPS, f"the program near MAX_OPS has {ops} operations a step")
    kernel = BL.generated_kernel(model, None)
    print(f"# traced swarm [{AGENTS} agents] nx={4 * AGENTS} nu={2 * AGENTS}: "
          f"{time.perf_counter() - start:.1f} s to trace; {ops} scalar operations a step (the "
          f"bound MAX_OPS {BL.MAX_OPS}); header {len(kernel.header())} characters", flush=True)
    return fns, {"swarm max mppi": (kernel, FS.MPPI)}


def main():
    sys.path.insert(0, str(ROOT))  # the checkout's chip_smoke.py and package
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("max_ops_alone: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(CS.card_line(), flush=True)
    fns, libraries = plan(CS, dev)
    label = "swarm max mppi"
    built = dict(builds=CS.start_builds(libraries))
    thread = built["builds"][label][0]
    start = time.perf_counter()
    while thread.is_alive():
        thread.join(60)
        print(f"# nvcc of [{label}]: {time.perf_counter() - start:.0f} s so far", flush=True)
    CS.join_generated_builds(built)
    ptxas = CS.block_ptxas(built, [label], named=False)
    for e in ptxas:
        print(f"# ptxas [{label}: {e['name']}]: {e.get('registers')} registers, "
              f"{e.get('spills')} bytes spill stores, {e.get('stack')} bytes stack frame, "
              f"ptxas {e.get('compile_ms')} ms", flush=True)
    CS.check(ptxas, f"no generated kernel of [{label}] in its build log")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    report = {"timed": {}, "err": {}, "launches": {}}
    nx, nu = 4 * AGENTS, 2 * AGENTS
    CS.wide_kernel_a(dev, gen, report, label, "mppi", fns, nx, nu,
                     x0=CS.swarm_x0(gen, dev, agents=AGENTS),
                     expect={"generated_mppi_block": 1}, T=STEPS)
    d_ms, p_ms, b_ms, b_by = report["timed"][label]
    row = {
        "name": f"fused_mppi {label}, the swarm near MAX_OPS, {AGENTS} agents, nx={nx} "
                f"nu={nu}, K={CS.K} T={STEPS} (mppi_fused_partial<Generated, 32, ..., "
                f"kMPPI>, Generated::kPerSample)",
        "route": "cuda",
        "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
        "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
        "replaces": "pytorch_mppi_tpu/ops/pallas_rollout.py:512",
        "launches": report["launches"][label].get("generated_mppi_block", 0),
        "launches_on": "check",
        "max_abs_err": report["err"][label]["kernel_plain"],
        "max_abs_err_f64": report["err"][label]["kernel_f64"],
        "max_abs_err_plain_f64": report["err"][label]["plain_f64"],
        "ms": d_ms, "ms_source": "cuda_graph", "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "build_s": built["build_s"][label],
        "registers": max(e.get("registers", 0) for e in ptxas),
        "spills": max(e.get("spills", 0) for e in ptxas),
        "ptxas_ms": sum(e.get("compile_ms", 0.0) for e in ptxas),
    }
    print(json.dumps({"kernels": [row]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
