"""Carry a JAX controller's parameters and nominal sequences, and a JAX
MLP's weights, into the port.

Every function takes numpy arrays (``np.asarray`` of the JAX package's
fields), so this module needs no JAX.  The PRNG key is not carried: the two
packages draw from different generators, and the port's stream is set by its
own ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import (
    BatchedState,
    KMPPIParams,
    KMPPIState,
    MPPIParams,
    MPPIState,
    SMPPIParams,
    SMPPIState,
)


def _tensor(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(noise_mu, noise_sigma, lambda_, u_min, u_max, u_init,
                      dtype=torch.float32, device="cpu") -> MPPIParams:
    """The port's :class:`MPPIParams` from the JAX ``MPPIParams`` fields."""

    def t(x):
        return _tensor(x, dtype, device)

    return MPPIParams(noise_mu=t(noise_mu), noise_sigma=t(noise_sigma),
                      lambda_=t(lambda_).reshape(()), u_min=t(u_min),
                      u_max=t(u_max), u_init=t(u_init))


def state_from_numpy(U, seed: int, dtype=torch.float32, device="cpu",
                     elites=None) -> MPPIState:
    """The port's :class:`MPPIState` with the JAX nominal sequence ``U``
    (T, nu), a fresh stream ``seed`` and, where given, the JAX state's
    ``elites`` (num_elites, T, nu)."""
    return MPPIState(U=_tensor(U, dtype, device), seed=int(seed),
                     elites=None if elites is None else _tensor(elites, dtype, device))


def smppi_params_from_numpy(base: MPPIParams, action_min, action_max,
                            w_action_seq_cost, delta_t) -> SMPPIParams:
    """The port's :class:`SMPPIParams` from the JAX ``SMPPIParams`` fields
    beside ``base``; dtype and device follow ``base``."""
    dtype, device = base.noise_mu.dtype, base.noise_mu.device
    return SMPPIParams(
        base=base, action_min=_tensor(action_min, dtype, device),
        action_max=_tensor(action_max, dtype, device),
        w_action_seq_cost=_tensor(w_action_seq_cost, dtype, device).reshape(()),
        delta_t=_tensor(delta_t, dtype, device).reshape(()))


def smppi_state_from_numpy(U, action_sequence, seed: int, dtype=torch.float32,
                           device="cpu") -> SMPPIState:
    """The port's :class:`SMPPIState`: the JAX rate sequence ``U`` and the
    commanded ``action_sequence`` (both (T, nu)), with a fresh ``seed``."""
    return SMPPIState(U=_tensor(U, dtype, device),
                      action_sequence=_tensor(action_sequence, dtype, device),
                      seed=int(seed))


def kmppi_params_from_numpy(base: MPPIParams, interp_full, interp_shift) -> KMPPIParams:
    """The port's :class:`KMPPIParams` from the JAX interpolation operators
    beside ``base``; dtype and device follow ``base``."""
    dtype, device = base.noise_mu.dtype, base.noise_mu.device
    return KMPPIParams(base=base, interp_full=_tensor(interp_full, dtype, device),
                       interp_shift=_tensor(interp_shift, dtype, device))


def kmppi_state_from_numpy(U, theta, seed: int, dtype=torch.float32,
                           device="cpu") -> KMPPIState:
    """The port's :class:`KMPPIState`: the JAX nominal ``U`` (T, nu) and
    control points ``theta`` (nsp, nu), with a fresh ``seed``."""
    return KMPPIState(U=_tensor(U, dtype, device), theta=_tensor(theta, dtype, device),
                      seed=int(seed))


def batched_state_from_numpy(U, seed: int, dtype=torch.float32, device="cpu") -> BatchedState:
    """The port's :class:`BatchedState` with the JAX plants' nominal
    sequences ``U`` (N, T, nu) and a fresh stream ``seed``."""
    return BatchedState(U=_tensor(U, dtype, device), seed=int(seed))


def mlp_params_from_numpy(params, dtype=None, device="cpu") -> list:
    """The port's MLP parameters (``models/mlp.py``) from the JAX ``[(W,
    b), ...]`` given as numpy arrays: the same layout, each array's own
    dtype unless ``dtype`` is given."""
    return [(torch.tensor(np.asarray(W), dtype=dtype, device=device),
             torch.tensor(np.asarray(b), dtype=dtype, device=device)) for W, b in params]
