"""Profiling and timing utilities (counterpart of ``pytorch_mppi_tpu/utils/timer.py``).

The reference only logs per-command wall-clock at debug level (mppi.py:882-887)
and hand-rolls warmup+trimmed-mean timing in its benchmark harness
(tests/benchmark_mppi.py:84-145).  Here a timed region ends with
``torch.cuda.synchronize`` on a CUDA device, device times come from CUDA
events on the card (the host clock on the CPU), and :func:`trace` captures a
``torch.profiler`` trace.  The functions and their dict keys are the JAX
package's.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from .device import resolve_device


def _devices(tree) -> set:
    """The CUDA devices of the tensors in a tree of results."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, (tuple, list)):
        return set().union(*map(_devices, tree)) if tree else set()
    if isinstance(tree, dict):
        return _devices(list(tree.values()))
    return set()


def _sync(out, device=None):
    """Wait for the work that made ``out`` (and for ``device``, when it is
    a CUDA device) to finish."""
    devices = _devices(out)
    if device is not None and torch.device(device).type == "cuda":
        devices.add(torch.device(device))
    for d in devices:
        torch.cuda.synchronize(d)
    return out


def benchmark_command(ctrl, state, num_warmup: int = 3, num_iters: int = 20):
    """Benchmark ``ctrl.command(state)``, returning stats in seconds: the
    reference harness protocol (benchmark_mppi.py:84-113), each command
    ended by a synchronise of the controller's device."""
    for _ in range(num_warmup):
        _sync(ctrl.command(state, shift_nominal_trajectory=False), ctrl.d)

    times = []
    for _ in range(num_iters):
        ctrl.reset()
        _sync(None, ctrl.d)
        t0 = time.perf_counter()
        _sync(ctrl.command(state), ctrl.d)
        times.append(time.perf_counter() - t0)

    times.sort()
    trim = max(1, len(times) // 10)
    trimmed = times[trim:-trim] if len(times) > 2 * trim else times
    return {
        "mean_s": sum(trimmed) / len(trimmed),
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "p99_s": times[min(len(times) - 1, int(len(times) * 0.99))],
        "num_iters": num_iters,
    }


def benchmark_fn(fn: Callable, *args, num_warmup: int = 3, num_iters: int = 20):
    """Benchmark ``fn(*args)``, each call ended by a synchronise of the CUDA
    devices of its results."""
    for _ in range(num_warmup):
        _sync(fn(*args))
    times = []
    for _ in range(num_iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "num_iters": num_iters,
    }


def _elapsed_s(run: Callable, device) -> float:
    """Seconds ``run()`` takes: between two CUDA events on ``device``'s
    current stream, or on the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def median_host_rtt(samples: int = 5, device=None):
    """Median time of a tiny op on ``device`` (default: the card; with no
    card it raises, and the caller passes ``device='cpu'``): the fixed
    overhead of one call, which :func:`chained_median_time` subtracts."""
    device = resolve_device(device, "median_host_rtt")
    x = torch.zeros((), dtype=torch.float32, device=device)
    tiny = lambda: x + 1
    _sync(tiny())  # warm
    ts = sorted(_elapsed_s(tiny, device) for _ in range(samples))
    return ts[len(ts) // 2]


def chained_median_time(fn: Callable, *args, iters_per_dispatch: int = 1,
                        repeats: int = 3, rtt=None, device=None):
    """Median per-iteration time of ``fn(*args)``, whose body already chains
    ``iters_per_dispatch`` iterations, less the median time of a tiny op
    (``rtt``, default :func:`median_host_rtt`).  On a CUDA device (default:
    that of the first result's tensors) the time is between CUDA events,
    on the CPU the host clock's."""
    out = fn(*args)
    if device is None:
        devices = _devices(out)
        device = next(iter(devices)) if devices else "cpu"
    _sync(out, device)
    if rtt is None:
        rtt = median_host_rtt(device=device)
    times = sorted(_elapsed_s(lambda: fn(*args), device) for _ in range(repeats))
    return max(times[len(times) // 2] - rtt, 1e-9) / iters_per_dispatch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a ``torch.profiler`` trace of the enclosed block, with CPU
    activity and, where a card is present, CUDA activity, and write it as
    a Chrome trace (``trace.json`` in ``log_dir``; view it in Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def probe_device_reachable(timeout_s: float = 600, logger=None) -> bool:
    """Bounded liveness check of the card: a subprocess runs one small
    kernel on it under a hard timeout, so that a caller that must stay
    bounded (a benchmark, a test lane) learns of a hung or missing device
    without hanging itself.  It reports (via ``logger`` or stderr) a
    timeout apart from a fast failure (no card, a CUDA error), with the
    tail of the subprocess's stderr for the latter.  The JAX package's
    ``MPPI_SKIP_RELAY_PROBE`` is not carried over: it skips the probe of a
    relay-attached TPU, and a card here is local."""
    import subprocess
    import sys

    def _report(msg):
        if logger is not None:
            logger.warning(msg)
        else:
            print(f"# WARNING: {msg}", file=sys.stderr)

    code = (
        "import torch; "
        "print(float(torch.ones((8, 128), device='cuda').sum().cpu()))"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout_s,
            capture_output=True,
            text=True,
        )
    except subprocess.TimeoutExpired:
        _report(f"device probe timed out after {timeout_s:.0f}s (the card did not answer)")
        return False
    if proc.returncode != 0:
        tail = "\n".join((proc.stderr or "").strip().splitlines()[-3:])
        _report(f"device probe failed fast (rc={proc.returncode}): {tail}")
        return False
    return True
