"""The harness the A/B tools share (``batched_host_ab.py``, ``block_ab.py``):
build every checkout at once, each in a process of its own; run each
checkout's timing process in turns (the checkouts in order, then backwards);
summarise each metric as its median per checkout beside the first
checkout's.  A tool gives the command line of a checkout's build process
(which prints its build seconds as its last line) and of its timing process
(which prints one JSON object as its last line)."""
import json
import statistics
import subprocess
import sys
from pathlib import Path


def build(roots, argv_of):
    """Run ``argv_of(root)`` for every checkout of ``roots`` (each once) at
    once; ``{root: seconds}``, the seconds each process printed last."""
    procs = {root: subprocess.Popen(argv_of(root), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for root in roots}
    seconds = {}
    for root, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"build of {root} failed:\n{log}")
        seconds[root] = float(log.strip().splitlines()[-1])
        print(f"# built {root}: {seconds[root]:.1f} s (all checkouts at once)", flush=True)
    return seconds


def run_turns(roots, argv_of, turns, show, out=None):
    """``turns`` passes over the checkouts, even passes in order and odd ones
    backwards, each running ``argv_of(root)`` and reading the JSON object it
    printed last; ``show(i, result)`` prints checkout i's.  One list of
    results a checkout, in the order of ``roots`` (a folder may be given
    twice); every result also goes to ``out`` (JSON lines) where given."""
    results = [[] for _ in roots]
    lines = []
    order = list(range(len(roots)))
    for turn in range(turns):
        for i in order if turn % 2 == 0 else order[::-1]:
            done = subprocess.run(argv_of(roots[i]), capture_output=True, text=True)
            if done.returncode != 0:
                raise SystemExit(f"process for {roots[i]} failed:\n{done.stdout}\n{done.stderr}")
            r = json.loads(done.stdout.strip().splitlines()[-1])
            results[i].append(r)
            lines.append(json.dumps(dict(r, root=roots[i], checkout=i)))
            show(i, r)
            sys.stdout.flush()
    if out:
        Path(out).write_text("\n".join(lines) + "\n")
    return results


def summarize(results, keys, names):
    """For each metric of ``keys``: every checkout's median, its ratio to the
    first checkout's, and in how many turns it read higher than the first
    checkout's in the same turn, under ``names`` (one a checkout); printed,
    then returned."""
    ref = results[0]
    summary = {}
    for key in keys:
        med = [statistics.median(r[key] for r in rs) for rs in results]
        summary[key] = {
            name: dict(median=m, ratio=m / med[0],
                       higher_in=f"{sum(r[key] > a[key] for r, a in zip(rs, ref))}/{len(ref)}")
            for name, m, rs in zip(names, med, results)}
        print(f"# {key}: " + " | ".join(
            f"{name} {v['median']:.6g} ({v['ratio']:.3f}, higher in {v['higher_in']})"
            for name, v in summary[key].items()))
    print(json.dumps({"summary": summary}))
    return summary
