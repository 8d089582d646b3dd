"""Runnable examples, the counterparts of the JAX package's ``examples/``.

Each module has a ``main(...)`` whose defaults are the JAX example's sizes
and which returns its results, so that a test can run it small; run one as
``python -m pytorch_mppi_tpu_torch.examples.<name>`` (on the card; pass
``device="cpu"`` to ``main`` for the CPU).
"""
