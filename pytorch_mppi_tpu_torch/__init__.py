"""pytorch_mppi_tpu_torch — the MPPI engine of ``pytorch_mppi_tpu`` in PyTorch and CUDA.

A port of the JAX package to PyTorch on an NVIDIA H100.  It runs
``MPPI.command()``, ``SMPPI.command()`` and ``KMPPI.command()`` for one plant
and ``MPPI_Batched.command()`` for N plants: the plain torch path, and with
``use_pallas`` the fused iteration of each as a hand-written CUDA kernel
(``csrc/fused_mppi.cu``); ``MPPI(use_pallas="rollout")`` runs the legacy
rollout and weighted-update kernels.  ``run_mppi_jit`` runs a closed loop
against a torch plant, on the card as a CUDA graph of the loop step.
``parallel`` splits the samples or the plants of a command over the ranks
of a ``torch.distributed`` process group (``mesh=``).  Entry points run on the card unless
the caller passes ``device="cpu"``.  The package imports neither JAX nor
``pytorch_mppi_tpu``.
"""

from .config import (
    Artifacts,
    BatchedState,
    KMPPIParams,
    KMPPIState,
    MPPIConfig,
    MPPIParams,
    MPPIState,
    SMPPIParams,
    SMPPIState,
)
from .controller import KMPPI, MPPI, SMPPI, MPPI_Batched, SpecificActionSampler
from .ops import library  # noqa: F401  (registers the kernels' operators)
from .ops.kernels import BSplineKernel, RBFKernel, TimeKernel
from .ops.kernel_models import KernelModel, linear_quadratic, quadratic_terminal
from .runner import run_mppi, run_mppi_jit
from .utils.batch import batch_quadratic_product, ensure_tensor, handle_batch_input

__version__ = "0.1.0"

__all__ = [
    "MPPI",
    "SMPPI",
    "KMPPI",
    "MPPI_Batched",
    "SpecificActionSampler",
    "TimeKernel",
    "RBFKernel",
    "BSplineKernel",
    "run_mppi",
    "run_mppi_jit",
    "KernelModel",
    "linear_quadratic",
    "quadratic_terminal",
    "handle_batch_input",
    "ensure_tensor",
    "batch_quadratic_product",
    "MPPIConfig",
    "MPPIParams",
    "MPPIState",
    "SMPPIParams",
    "SMPPIState",
    "KMPPIParams",
    "KMPPIState",
    "BatchedState",
    "Artifacts",
]
