"""Multi-process runs of the port (``tests/test_distributed.py`` on
``pytorch_mppi_tpu_torch``): the collectives of a sharded solve and of a
data-parallel train step cross an OS-process boundary (Gloo on the CPU).

The solve: two processes run ``pytorch_mppi_tpu_torch/tools/
multiprocess_smoke.py``, joining one group through
``parallel.initialize_multihost`` over TCP.  The worker checks that two
identical sharded runs agree bit for bit and that the sharded run equals
the single-process solve bit for bit (the port's sharded plain path gathers
the costs and updates identically on every rank), and that the summed
costs agree within 1e-9 relative.  As JAX's test, one retry with a fresh
port, only for an infrastructure failure (``_INFRA_SIGNATURES``).

The train step: this file run as a script is a worker of a 2-rank Gloo
world (``python tests/test_torch_distributed.py RANK INIT_FILE OUT_DIR``)
that takes three ``make_train_step(mesh=...)`` steps in float64; each
equals the single-process step on the whole batch within rtol 1e-12 (the
mean of the ranks' mean gradients sums in another order).
"""
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return env


def _spawn(pid, nprocs, port):
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_mppi_tpu_torch.tools.multiprocess_smoke", str(pid),
         str(nprocs), f"localhost:{port}", "cpu"],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# Failure text of an environmental flake: the _free_port race (the store
# loses the port between probe and bind) or a rendezvous that timed out.
# Only these earn a retry: a worker that formed its group and then failed
# its checks is a real regression and fails at once.
_INFRA_SIGNATURES = (
    "Address already in use",
    "Failed to bind",
    "Connection refused",
    "DistNetworkError",
    "Socket Timeout",
    "timed out",
    "<worker hang: communicate() timeout>",
)


def _infra_flake(out):
    return any(sig in out for sig in _INFRA_SIGNATURES)


def _run_world(spawn, n, timeout):
    """Start ``n`` workers, wait for all; returns (procs, outputs, timed_out)."""
    procs = [spawn(i) for i in range(n)]
    outs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                if q.poll() is None:
                    q.kill()
            out, _ = p.communicate()
            out = (out or "") + "\n<worker hang: communicate() timeout>"
        outs.append(out or "")
    return procs, outs, timed_out


def test_two_process_sharded_solve_bit_identical():
    """2 processes form one "k" mesh; the K-sharded solve is bit for bit
    across identical runs and against the single-process solve."""
    last_failure = None
    for attempt in range(2):
        port = _free_port()
        procs, outs, timed_out = _run_world(lambda i: _spawn(i, 2, port), 2, 180)
        failed = [(i, p, out) for i, (p, out) in enumerate(zip(procs, outs))
                  if p.returncode != 0 or "multiprocess smoke OK" not in out]
        if not failed:
            return
        last_failure = [f"attempt {attempt}, worker {i} (rc={p.returncode}):\n{out[-4000:]}"
                        for i, p, out in failed]
        if not (timed_out or all(_infra_flake(out) for _, _, out in failed)):
            raise AssertionError("worker ran but its smoke/determinism assertions failed "
                                 "(not retried):\n" + "\n".join(last_failure))
    raise AssertionError("\n".join(last_failure))


def _train_problem():
    from pytorch_mppi_tpu_torch import models as PM

    params = PM.mlp_init((4, 16, 2), torch.Generator().manual_seed(3), dtype=torch.float64,
                         device="cpu")
    rs = np.random.RandomState(4)
    batch = tuple(torch.tensor(rs.randn(12, 2)) for _ in range(3))
    return params, batch


def _train_steps(step, init, params, batch, n=3):
    opt, out = init(params), []
    for _ in range(n):
        params, opt, loss = step(params, opt, batch)
        out.append(np.concatenate([loss.reshape(1).numpy()] + [
            t.reshape(-1).numpy() for layer in params for t in layer]))
    return np.stack(out)


def _train_worker(rank, init_file, out_dir):
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch import models as PM
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    initialize_multihost(f"file://{init_file}", 2, rank, device="cpu")
    step, init = PM.make_train_step(mesh=make_mesh((2,), ("data",), device="cpu"))
    np.save(os.path.join(out_dir, f"train{rank}.npy"), _train_steps(step, init, *_train_problem()))
    dist.destroy_process_group()


def test_data_parallel_train_step_matches_single_process(tmp_path):
    """make_train_step(mesh=...) over 2 ranks, float64: three Adam steps,
    each within rtol 1e-12 of the single-process step on the whole batch,
    and the ranks' parameters equal."""
    from pytorch_mppi_tpu_torch import models as PM

    init_file = str(tmp_path / "group")
    procs, outs, _ = _run_world(lambda r: subprocess.Popen(
        [sys.executable, HERE, str(r), init_file, str(tmp_path)], env=_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), 2, 180)
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    r0, r1 = (np.load(tmp_path / f"train{r}.npy") for r in range(2))
    np.testing.assert_array_equal(r0, r1)
    want = _train_steps(*PM.make_train_step(), *_train_problem())
    np.testing.assert_allclose(r0, want, rtol=1e-12, atol=1e-15)


if __name__ == "__main__":
    try:
        _train_worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
