"""Trajectory-time kernels and the precomputed interpolation operators of KMPPI.

The counterpart of ``pytorch_mppi_tpu/ops/kernels.py`` (reference
``mppi.py:573-591`` for the kernels, ``mppi.py:621-655`` for the
interpolation).  Both operators are constant for a fixed horizon, so they are
solved once, in float64 on the CPU, and cast to the working type:
deparameterization is then one product.
"""
from __future__ import annotations

import numpy as np
import torch


class TimeKernel:
    """Kernel acting on the time dimension of trajectories (mppi.py:573-577).

    ``__call__(t, tk)`` takes (n, d) and (m, d) time coordinates and returns
    the (n, m) Gram matrix.
    """

    def __call__(self, t, tk):
        raise NotImplementedError


class RBFKernel(TimeKernel):
    """exp(-sum (t - tk)^2 / (1e-8 + 2 sigma^2))  (mppi.py:580-590)."""

    def __init__(self, sigma=1):
        self.sigma = sigma

    def __repr__(self):
        return f"RBFKernel(sigma={self.sigma})"

    def __call__(self, t, tk):
        d = torch.sum((t[:, None] - tk) ** 2, dim=-1)
        return torch.exp(-d / (1e-8 + 2 * self.sigma**2))


class BSplineKernel(TimeKernel):
    """Uniform cubic B-spline basis b3(|t - tk| / scale) over trajectory time
    (the smoothing the reference README names, README.md:102-104)."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def __repr__(self):
        return f"BSplineKernel(scale={self.scale})"

    def __call__(self, t, tk):
        d = torch.sqrt(torch.sum((t[:, None] - tk) ** 2, dim=-1)) / self.scale
        inner = (2.0 / 3.0) - d**2 + 0.5 * d**3
        outer = ((2.0 - d) ** 3) / 6.0
        return torch.where(d < 1.0, inner, torch.where(d < 2.0, outer, torch.zeros_like(d)))


def support_times(T: int, num_support_pts: int, dtype):
    """Support-point and horizon time grids (mppi.py:636-640)."""
    tk = torch.linspace(0.0, T - 1, int(num_support_pts), dtype=dtype)
    hs = torch.linspace(0.0, T - 1, int(T), dtype=dtype)
    return tk, hs


def interpolation_operators(kernel: TimeKernel, T: int, num_support_pts: int, dtype,
                            device=None):
    """The (T, nsp) full-horizon and (nsp, nsp) shift operators:

    full:  U(t)  = K(Hs, Tk) @ Ktktk^-1 @ theta      (mppi.py:621-627, 650-655)
    shift: theta <- K(Tk+1, Tk) @ Ktktk^-1 @ theta   (mppi.py:617-619)

    The Gram matrices are taken in ``dtype``, the solves in float64 on the
    CPU, and the operators cast back to ``dtype`` on ``device``.
    """
    tk, hs = support_times(T, num_support_pts, dtype)
    tk_c, hs_c = tk[:, None], hs[:, None]
    Ktktk = kernel(tk_c, tk_c)  # (nsp, nsp)
    Khs = kernel(hs_c, tk_c)  # (T, nsp)
    Kshift = kernel(tk_c + 1.0, tk_c)  # (nsp, nsp)
    # right-division: X @ Ktktk^-1 == solve(Ktktk^T, X^T)^T
    # through float64 tensors: numpy takes no bfloat16
    K64 = Ktktk.to(torch.float64).numpy()
    interp_full = np.linalg.solve(K64.T, Khs.to(torch.float64).numpy().T).T
    interp_shift = np.linalg.solve(K64.T, Kshift.to(torch.float64).numpy().T).T
    return (torch.as_tensor(np.ascontiguousarray(interp_full), dtype=dtype, device=device),
            torch.as_tensor(np.ascontiguousarray(interp_shift), dtype=dtype, device=device))
