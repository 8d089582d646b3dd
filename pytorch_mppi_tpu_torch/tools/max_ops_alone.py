#!/usr/bin/env python3
"""The build curve of the dynamics bridge's programs near ``MAX_OPS`` on one
CUDA card's host: the planar swarm of ``chip_smoke.swarm_callables`` at a
number of agents (38 agents: nx = 152, nu = 76, 15,124 scalar operations a
step of the bound's 16,384), its kernel A library (the ``kMPPI`` variant
alone) built with ``nvcc --time`` (``_build.generated_command``, the
command ``build_generated`` runs), one function a program (``CHUNK`` 0:
the program as one run of statements, as before the split) or split into
parts of at most ``CHUNK`` statements (``batch_last.Program.emit_parts``).
All builds start together, one ``nvcc`` each, and a build still running at
``--limit`` seconds is killed with its processes (the stage it was in, and
for how long, is printed).  Each build prints its operations, the largest
function's statements, the header's size, the seconds of each ``nvcc``
stage, and the kernel's registers, spill stores and stack frame from
``-Xptxas -v`` (``chip_smoke.ptxas_entries``, with its parts' largest).
A finished library goes into the kernel cache (``_build.install_generated``,
as ``build_generated`` puts its own).  Then each build of ``--check`` that
finished runs ``chip_smoke.wide_kernel_a`` (phase 4g's check, which
``chip_smoke.py`` runs as case ``swarm max mppi`` at 38 agents and the
default ``CHUNK``: kernel A against its plain version and a float64
rollout at K = 10,000, T = 10), timed from a CUDA graph of 20 calls beside
its bound.  One JSON line a build and a check; the whole table in
``max_ops_curve.json``, with each build's log and ``--time`` table, under
``--out`` (``build/max_ops``).

    python3 pytorch_mppi_tpu_torch/tools/max_ops_alone.py \\
        --builds 16:0,24:0,30:0,38:0,38:2048 --check 38:2048 --limit 600

A build is ``AGENTS:CHUNK``; ``AGENTS`` alone takes the default ``CHUNK``.
Run from the root of a checkout; exits non-zero where a build or a check
fails.
"""
import argparse
import csv
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STEPS = 10
ONE_FUNCTION = 10 ** 9  # CHUNK for a program emitted as one run of statements


def parse(spec, default_chunk):
    out = []
    for item in filter(None, spec.split(",")):
        agents, _, chunk = item.partition(":")
        out.append((int(agents), int(chunk) if chunk else default_chunk))
    return out


def label(agents, chunk):
    return f"{agents}:{chunk}"


def traced(CS, BL, dev, agents, chunk):
    """The swarm's callables, model and kernel with ``BL.CHUNK`` set to
    ``chunk`` (0: one function)."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig

    BL.CHUNK = chunk or ONE_FUNCTION
    fns = CS.swarm_callables(dev, agents)
    model = BL.kernel_model(MPPIConfig(nx=4 * agents, nu=2 * agents, K=CS.K, T=STEPS), *fns)
    return fns, model, BL.generated_kernel(model, None)


def largest_function(header):
    """The most statements of one function of a generated header (a line
    that ends in ';' counts one)."""
    best = cur = 0
    for line in header.splitlines():
        if re.match(r"\s*(__device__|template|struct|};|\s*}\s*$)", line):
            best, cur = max(best, cur), 0
        elif line.rstrip().endswith(";"):
            cur += 1
    return max(best, cur)


def stages(csv_text):
    """Seconds by ``nvcc`` stage from a ``--time`` table (its rows name the
    phase and its time in ms)."""
    rows = list(csv.reader(io.StringIO(csv_text)))
    if not rows:
        return {}
    head = [h.strip().lower() for h in rows[0]]
    phase = next((i for i, h in enumerate(head) if "phase name" in h), None)
    metric = next((i for i, h in enumerate(head) if h.startswith("metric")), None)
    out = {}
    for r in rows[1:]:
        if phase is None or metric is None or len(r) <= max(phase, metric):
            continue
        try:
            ms = float(r[metric])
        except ValueError:
            continue
        name = r[phase].strip()
        out[name] = round(out.get(name, 0.0) + ms / 1000.0, 3)
    return out


def running(pgid):
    """The processes of a build's group: (command, seconds alive)."""
    try:
        ps = subprocess.run(["ps", "-o", "etimes=,comm=", "-g", str(pgid)],
                            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [(c, int(e)) for e, c in (line.split(None, 1) for line in ps.splitlines() if line)]


def start_build(_build, kernel, mask, work):
    """One ``nvcc`` of ``kernel``'s library with ``--time`` into ``work``,
    in a process group of its own: a dict the waiting thread fills."""
    work.mkdir(parents=True, exist_ok=True)
    model = work / "generated_model.cuh"
    model.write_text(kernel.header())
    timing = work / "time.csv"
    cmd = _build.generated_command(_build._nvcc(), model, mask, work / "generated.so",
                                   ["--time", str(timing)])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    build = dict(proc=proc, timing=timing, start=time.perf_counter(), header=kernel.header(),
                 mask=mask, library=work / "generated.so")

    def drain():
        build["log"] = proc.communicate()[0]
        build["wall_s"] = time.perf_counter() - build["start"]

    build["thread"] = threading.Thread(target=drain, daemon=True)
    build["thread"].start()
    return build


def finish(CS, _build, build, out_dir, name, killed):
    """The build's numbers, its log and ``--time`` table kept in
    ``out_dir``; a finished library installed in the kernel cache."""
    proc, log = build["proc"], build.get("log", "")
    res = dict(killed=killed, rc=proc.returncode, wall_s=round(build["wall_s"], 1))
    res["stages_s"] = stages(build["timing"].read_text()) if build["timing"].is_file() else {}
    tag = name.replace(":", "_")
    (out_dir / f"max_ops_{tag}.log").write_text(log)
    if build["timing"].is_file():
        (out_dir / f"max_ops_{tag}.time.csv").write_text(build["timing"].read_text())
    if not killed and proc.returncode == 0:
        _build.install_generated(build["header"], build["mask"], build["library"], log)
        entries = [e for e in CS.ptxas_entries(log) if "Generated" in e["name"]]
        for key in ("registers", "spills", "stack", "part_stack", "part_spills"):
            res[key] = max((e[key] for e in entries if key in e), default=None)
    return res


def main():
    sys.path.insert(0, str(ROOT))  # the checkout's chip_smoke.py and package
    import torch

    import chip_smoke as CS
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--builds", default="16:0,24:0,30:0,38:0,16,38")
    ap.add_argument("--check", default="38")
    ap.add_argument("--limit", type=float, default=600.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "max_ops"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("max_ops_alone: no CUDA card", file=sys.stderr)
        return 1
    default_chunk = BL.CHUNK
    builds, checks = parse(args.builds, default_chunk), parse(args.check, default_chunk)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    print(CS.card_line(), flush=True)
    print(f"# {os.cpu_count()} host cores; {len(builds)} builds together; killed at "
          f"{args.limit:.0f} s", flush=True)
    mask = 1 << FS.MPPI
    table, running_builds = {}, {}
    for agents, chunk in builds:
        name = label(agents, chunk)
        start = time.perf_counter()
        _, model, kernel = traced(CS, BL, dev, agents, chunk)
        header = kernel.header()
        table[name] = dict(agents=agents, chunk=chunk, nx=4 * agents, nu=2 * agents,
                           ops=BL._count_ops(model.program, model.outputs),
                           header_chars=len(header), largest_function=largest_function(header),
                           trace_s=round(time.perf_counter() - start, 1))
        running_builds[name] = start_build(_build, kernel, mask,
                                           out_dir / f"lib_{name.replace(':', '_')}")
        print(f"# build [{name}] started: {table[name]}", flush=True)
    while any(b["thread"].is_alive() for b in running_builds.values()):
        time.sleep(10)
        for name, b in running_builds.items():
            if b["thread"].is_alive() and time.perf_counter() - b["start"] > args.limit:
                table[name]["at_kill"] = running(b["proc"].pid)
                os.killpg(b["proc"].pid, signal.SIGKILL)
                b["thread"].join()
                b["killed"] = True
        alive = [n for n, b in running_builds.items() if b["thread"].is_alive()]
        if alive and int(time.perf_counter()) % 60 < 10:
            print(f"# still building: {alive}", flush=True)
    for name, b in running_builds.items():
        table[name].update(finish(CS, _build, b, out_dir, name, b.get("killed", False)))
        print(json.dumps({"build": name, **table[name]}), flush=True)
    ok = all(r["killed"] or r["rc"] == 0 for r in table.values())
    for agents, chunk in checks:
        name = label(agents, chunk)
        row = table.get(name)
        if row is None or row.get("killed") or row.get("rc") != 0:
            print(f"# check [{name}]: not built, skipped", flush=True)
            ok = False
            continue
        fns, _, kernel = traced(CS, BL, dev, agents, chunk)
        if not _build.generated_path(kernel.header(), mask).is_file():
            print(f"# check [{name}]: the traced header differs from the built one", flush=True)
            ok = False
            continue
        gen = torch.Generator(device=dev)
        gen.manual_seed(2026)
        report = {"timed": {}, "err": {}, "launches": {}}
        try:
            CS.wide_kernel_a(dev, gen, report, name, "mppi", fns, 4 * agents, 2 * agents,
                             x0=CS.swarm_x0(gen, dev, agents=agents),
                             expect={"generated_mppi_block": 1}, T=STEPS)
        except SystemExit as e:  # chip_smoke.check's failure, printed; the next check runs
            print(f"# check [{name}]: {e}", flush=True)
            ok = False
        d_ms, p_ms, b_ms, b_by = report["timed"].get(name, (None,) * 4)
        row.update(ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                   x_bound=None if d_ms is None else round(d_ms / b_ms, 1),
                   err=report["err"].get(name), launches=report["launches"].get(name))
        print(json.dumps({"check": name, **row}), flush=True)
    BL.CHUNK = default_chunk
    (out_dir / "max_ops_curve.json").write_text(json.dumps(table, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
