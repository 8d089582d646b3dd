"""A seed sweep of the quality floors of JAX's real-chip lane
(``tpu_tests/test_tpu_quality.py``) in both packages on the CPU, float32.

Each floor holds a 20-step closed loop at K = 500, T = 15 from [-3, -2] on
the lane's plant: the mean final distance over three seeds below 2.0 (and,
for MPPI and KMPPI, every seed below 3.0 and the mean accumulated cost below
200).  A seed is a draw of the package's own generator, so whether a floor
holds on one triple of seeds is a draw too.  This script runs each loop of
MPPI, KMPPI, antithetic sampling and ``noise_rho = 0.3`` over seeds 0-19 in
the JAX package and in the port, and prints, for each package, the share of
the 1,140 triples of those seeds on which the floor holds, the seeds within
2.0 and the mean distance, so that a floor the port misses on the card can
be told from a fault: a criterion both packages meet at the same rate.

    JAX_PLATFORMS=cpu python tests/lane_floor_sweep.py [SEEDS]

About three minutes for 20 seeds.  Not collected by pytest.
"""
import itertools
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CASES = {"mppi": {}, "kmppi": {"kmppi": True}, "antithetic": {"antithetic_sampling": True},
         "noise_rho": {"noise_rho": 0.3}}
START, GOAL, K, T, STEPS = (-3.0, -2.0), (2.0, 2.0), 500, 15, 20


def jax_loop(case, seed):
    import jax.numpy as jnp

    from pytorch_mppi_tpu import KMPPI, MPPI

    B, G = jnp.array([[1.0, 0.0], [0.0, -1.0]], jnp.float32), jnp.array(GOAL, jnp.float32)
    dyn = lambda s, a: s + a @ B.T  # noqa: E731
    cost = lambda s, a: ((G - s) ** 2).sum(axis=-1)  # noqa: E731
    kw = dict(CASES[case])
    cls = KMPPI if kw.pop("kmppi", False) else MPPI
    c = cls(dyn, cost, 2, jnp.eye(2, dtype=jnp.float32), num_samples=K, horizon=T, lambda_=1.0,
            seed=seed, **kw)
    s, acc = jnp.array(START, jnp.float32), 0.0
    for _ in range(STEPS):
        a = c.command(s)
        s = dyn(s, a)
        acc += float(cost(s[None], a[None])[0])
    return float(jnp.linalg.norm(G - s)), acc


def port_loop(case, seed):
    import torch

    from pytorch_mppi_tpu_torch import KMPPI, MPPI

    B, G = torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.tensor(GOAL)
    dyn = lambda s, a: s + a @ B.T  # noqa: E731
    cost = lambda s, a: ((G - s) ** 2).sum(-1)  # noqa: E731
    kw = dict(CASES[case])
    cls = KMPPI if kw.pop("kmppi", False) else MPPI
    c = cls(dyn, cost, 2, torch.eye(2), num_samples=K, horizon=T, lambda_=1.0, seed=seed,
            device="cpu", **kw)
    s, acc = torch.tensor(START), 0.0
    for _ in range(STEPS):
        a = c.command(s)
        s = dyn(s, a)
        acc += float(cost(s[None], a[None])[0])
    return float(torch.linalg.norm(G - s)), acc


def holds(case, runs):
    dists = [d for d, _ in runs]
    ok = statistics.mean(dists) < 2.0
    if case in ("mppi", "kmppi"):
        ok = ok and max(dists) < 3.0 and statistics.mean(c for _, c in runs) < 200.0
    return ok


def main():
    seeds = range(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
    report = {}
    for pkg, run in (("jax", jax_loop), ("port", port_loop)):
        for case in CASES:
            runs = [run(case, s) for s in seeds]
            triples = list(itertools.combinations(runs, 3))
            rate = sum(holds(case, t) for t in triples) / len(triples)
            report[pkg, case] = dict(rate=rate, within_2=sum(d < 2.0 for d, _ in runs),
                                     mean=statistics.mean(d for d, _ in runs),
                                     distances=[round(d, 4) for d, _ in runs])
            print(f"{pkg} {case}: the floor holds on {rate:.3f} of {len(triples)} triples | "
                  f"{report[pkg, case]['within_2']}/{len(runs)} seeds within 2.0 | mean "
                  f"distance {report[pkg, case]['mean']:.4f}", flush=True)
    print(json.dumps({f"{p} {c}": v for (p, c), v in report.items()}))


if __name__ == "__main__":
    main()
