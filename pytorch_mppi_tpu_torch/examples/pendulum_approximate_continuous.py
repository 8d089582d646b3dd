"""Pendulum swing-up with a learned model that sees the angle as (sin θ,
cos θ), which removes the wrap's discontinuity from the learned function
(the counterpart of ``examples/pendulum_approximate_continuous.py``,
reference ``tests/pendulum_approximate_continuous.py``): the loop of
``pendulum_approximate`` with ``continuous=True``, 1,000 steps.

Run: python -m pytorch_mppi_tpu_torch.examples.pendulum_approximate_continuous
"""
from __future__ import annotations

import logging

from pytorch_mppi_tpu_torch.examples import pendulum_approximate


def main(iters: int = 1000, **kw) -> dict:
    """``pendulum_approximate.main`` with the (sin, cos) encoding; the other
    keywords are its own."""
    return pendulum_approximate.main(iters=iters, continuous=True, **kw)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
