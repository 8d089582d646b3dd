#!/usr/bin/env python3
"""A K-sharded MPPI solve across processes: the port's multi-process smoke
worker (the counterpart of ``tools/multiprocess_smoke.py``).

Run one instance per process:

    python -m pytorch_mppi_tpu_torch.tools.multiprocess_smoke \
        PROCESS_ID NUM_PROCESSES ADDRESS [DEVICE]

Each process joins one process group through
``parallel.initialize_multihost`` (``ADDRESS`` is ``host:port`` or an
``init_method`` URL), builds the mesh of every rank on a "k" axis and runs
three commands of two identical K-sharded ``MPPI`` controllers beside an
unsharded one of the same seed, then a cross-process sum of the sharded
controller's gathered costs, then times ``TIMED`` commands of each.  On the
card (no ``DEVICE``, or ``cuda``; it raises when there is none) the fused
kernel in float32 at ``bench.py``'s flagship (K = 10,000, T = 30), each
rank launching kernel A over its share of the samples, one card a rank
(NCCL); on the CPU (``DEVICE`` cpu) the plain path in float64 at K = 64 a
process, T = 8, as JAX's worker (Gloo).

Checks: the two sharded runs agree bit for bit (the determinism contract);
the sharded run agrees with the unsharded one bit for bit on the CPU, and
within float32 rounding of the merge (rtol 1e-5, atol 1e-6) on the card;
the summed costs agree within 1e-9 relative (1e-5 in float32).  Exit code 0
and the line ``multiprocess smoke OK`` mean all held; the line gives the
median host time of a sharded and of an unsharded command (after a
synchronise on the card).
"""
import statistics
import sys
import time

TIMED = 50


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pid, nprocs, address = int(argv[0]), int(argv[1]), argv[2]

    import torch
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch import MPPI
    from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh
    from pytorch_mppi_tpu_torch.utils.device import resolve_device

    device = resolve_device(argv[3] if len(argv) > 3 else None, "multiprocess_smoke")

    torch.set_num_threads(1)
    initialize_multihost(address, nprocs, pid, device=device)
    assert dist.get_world_size() == nprocs, (
        f"process group did not form: {dist.get_world_size()} != {nprocs}")
    mesh = make_mesh((nprocs,), ("k",), device=device)
    card = device.type == "cuda"
    dtype = torch.float32 if card else torch.float64
    model = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor([2.0, 2.0]))
    kw = dict(num_samples=10_000 if card else 64 * nprocs, horizon=30 if card else 8,
              lambda_=1.0, seed=42, device=device,
              u_max=torch.tensor([1.0, 1.0], dtype=dtype), sample_null_action=True,
              use_pallas=card)

    def make(mesh):
        return MPPI(model.dynamics, model.running_cost, 2, torch.eye(2, dtype=dtype),
                    mesh=mesh, **kw)

    sharded, sharded2, golden = make(mesh), make(mesh), make(None)
    assert sharded._fns.fused == card
    tol = dict(rtol=1e-5, atol=1e-6) if card else dict(rtol=0, atol=0)
    s = torch.tensor([-3.0, -2.0], dtype=dtype, device=device)
    for _ in range(3):
        a1, a2, a0 = sharded.command(s), sharded2.command(s), golden.command(s)
        # identical distributed runs are bit-identical
        assert torch.equal(a1, a2), (a1, a2)
        torch.testing.assert_close(a1, a0, **tol)
        s = model.dynamics(s[None], a0[None])[0]

    # the K-sharded costs, gathered from every process (a collective read)
    tot, ref = float(sharded.cost_total.sum()), float(golden.cost_total.sum())
    assert abs(tot - ref) <= (1e-5 if card else 1e-9) * max(1.0, abs(ref)), (tot, ref)

    def median_ms(ctrl):
        lat = []
        for _ in range(TIMED):
            if card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctrl.command(s)
            if card:
                torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(lat)

    sharded_ms, golden_ms = median_ms(sharded), median_ms(golden)
    used = dist.get_backend()
    dist.destroy_process_group()
    print(f"[process {pid}] multiprocess smoke OK: {nprocs} processes on {device} ({used}), "
          f"deterministic cross-process sharded solve; command median {sharded_ms:.4f} ms "
          f"sharded, {golden_ms:.4f} ms unsharded (host clock)", flush=True)


if __name__ == "__main__":
    main()
