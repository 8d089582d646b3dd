#!/usr/bin/env python3
"""The machine code of ``csrc/fused_mppi.cu``'s build parts in two checkouts,
compared: whether a change to the source changed what the card runs.

    python3 pytorch_mppi_tpu_torch/tools/sass_ab.py A_DIR B_DIR [--parts 4 6 11]

Each part (``-DFUSED_MPPI_PART``, ``ops/_build.py``) of each checkout is
compiled to a cubin with ``ops/_build.NVCC_FLAGS``, every ``nvcc`` started
together, and disassembled with ``cuobjdump -sass``; for each part it
prints the SASS lines of each checkout, how many lines differ, and each
kernel's registers (``-Xptxas -v``).  Needs ``nvcc`` and ``cuobjdump``
(the CUDA toolkit), not a card.  The files go to ``--out``.
"""
import argparse
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("a", help="checkout A (for example the parent commit)")
    ap.add_argument("b", help="checkout B (for example this commit)")
    ap.add_argument("--parts", type=int, nargs="+", default=[4, 6, 11])
    ap.add_argument("--out", default="build/sass_ab")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.b).resolve()))
    from pytorch_mppi_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for side, root in (("a", args.a), ("b", args.b)):
        source = Path(root) / "pytorch_mppi_tpu_torch" / "csrc" / "fused_mppi.cu"
        for part in args.parts:
            cubin = out / f"{side}_{part}.cubin"
            procs[side, part] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, f"-DFUSED_MPPI_PART={part}", "-cubin", "-o",
                 str(cubin), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {key: p.communicate()[0] for key, p in procs.items()}
    for key, p in procs.items():
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{logs[key]}")
    for part in args.parts:
        sass = {}
        for side in ("a", "b"):
            sass[side] = subprocess.run([cuobjdump, "-sass", str(out / f"{side}_{part}.cubin")],
                                        capture_output=True, text=True, check=True).stdout
            (out / f"{side}_{part}.sass").write_text(sass[side])
        a, b = sass["a"].splitlines(), sass["b"].splitlines()
        differ = sum(1 for line in difflib.unified_diff(a, b, lineterm="", n=0)
                     if line[:1] in "+-" and not line.startswith(("+++", "---")))
        regs = {side: re.findall(r"Used (\d+) registers", logs[side, part]) for side in ("a", "b")}
        print(f"part {part}: SASS lines A {len(a)} B {len(b)}, differing lines {differ} | "
              f"registers A {regs['a']} B {regs['b']}")


if __name__ == "__main__":
    main()
