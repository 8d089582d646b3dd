#!/usr/bin/env python3
"""``chip_smoke.py`` phase 4g alone on one CUDA card: the named library and
phase 4g's generated libraries built together (the named one in a thread,
each generated one in a thread of its own, as phase 2 starts them), then
``chip_smoke.wide_programs`` (the swarm's five kernels, the step-4 program,
the named LQ at nx = 64, the dense terminal beside the flagship's named
model, the quadrotor's round-1 solve and the named toy2d at nx = 64
against their plain versions,
timed, and 10 swarm commands fused against plain), and its ``kernels``
rows as one JSON line.

    python3 pytorch_mppi_tpu_torch/tools/wide_programs_alone.py

Run from the root of a checkout; exits non-zero where a check fails.
"""
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main():
    sys.path.insert(0, str(ROOT))  # the checkout's chip_smoke.py and package
    import torch

    import chip_smoke as CS
    from pytorch_mppi_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("wide_programs_alone: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(CS.card_line(), flush=True)
    start = time.perf_counter()
    named = {}
    thread = threading.Thread(target=lambda: named.update(built=_build.build()))
    thread.start()
    fns, models, plan = CS.wide_plan(dev)
    built = dict(wide_fns=fns, wide_models=models, builds=CS.start_builds(plan))
    CS.join_generated_builds(built)
    print(f"# generated builds joined at {time.perf_counter() - start:.1f} s", flush=True)
    thread.join()
    if named.get("built"):
        print("# named build parts (nvcc seconds): " + " | ".join(
            f"{k}: {v:.1f}" for k, v in enumerate(named["built"][2])))
    print(f"# build phase {time.perf_counter() - start:.1f} s", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    report = CS.wide_programs(dev, gen, built)
    print(json.dumps({"kernels": CS.wide_program_rows(report)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
