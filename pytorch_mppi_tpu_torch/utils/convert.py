"""Carry a JAX controller's parameters and nominal sequence into the port.

Both functions take numpy arrays (``np.asarray`` of the JAX package's
fields), so this module needs no JAX.  The PRNG key is not carried: the two
packages draw from different generators, and the port's stream is set by its
own ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MPPIParams, MPPIState


def params_from_numpy(noise_mu, noise_sigma, lambda_, u_min, u_max, u_init,
                      dtype=torch.float32, device="cpu") -> MPPIParams:
    """The port's :class:`MPPIParams` from the JAX ``MPPIParams`` fields."""

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return MPPIParams(noise_mu=t(noise_mu), noise_sigma=t(noise_sigma),
                      lambda_=t(lambda_).reshape(()), u_min=t(u_min),
                      u_max=t(u_max), u_init=t(u_init))


def state_from_numpy(U, seed: int, dtype=torch.float32, device="cpu") -> MPPIState:
    """The port's :class:`MPPIState` with the JAX nominal sequence ``U``
    (T, nu) and a fresh stream ``seed``."""
    return MPPIState(U=torch.tensor(np.asarray(U), dtype=dtype, device=device),
                     seed=int(seed))
