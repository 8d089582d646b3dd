"""The kernels of the legacy ``use_pallas="rollout"`` route, and their plain
versions.

The counterparts of two TPU kernels of ``pytorch_mppi_tpu/ops/
pallas_rollout.py`` that ``make_mppi_step`` runs around its plain noise,
clamp and action cost when ``use_pallas="rollout"`` (``solve.py:1133-1157,
1366-1391``):

* :func:`make_fused_rollout` (``:75``) returns ``rollout(x0_K (K, nx),
  u_scaled (K, T, nu)) -> cost (K,)``: the T-step rollout of a device model
  over actions already scaled by ``u_scale``, the running cost taken after
  each step;
* :func:`fused_weighted_update` (``:172``) maps ``(cost (K,), noise (K, D),
  lambda_)`` to ``(pert (D,), m, s)``: the softmax-weighted sum of the noise
  against the largest logit ``m = max(-cost / lambda_)``, with ``s`` the sum
  of the weights, so that the update is ``pert / s``.

On CUDA tensors each launches its kernel in ``csrc/fused_mppi.cu``
(``fused_rollout``; ``weighted_partial`` then ``flash_merge``) and raises if
the launch fails; on CPU tensors it runs its plain version
(:func:`fused_rollout_plain`, :func:`weighted_update_plain`).  Float32 only;
the update's sums are fp32 FMAs, as the JAX dot's ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch

from ..config import MPPIConfig
from . import fused_solve as FS
from .kernel_models import KernelModel


def pallas_eligible(config: MPPIConfig) -> bool:
    """Static eligibility for the legacy kernels (``pallas_rollout.py:61``):
    float32, and no step dependence (the device models take no timestep).
    The JAX check's other conditions (M = 1, no terminal cost, no specific
    dynamics, deterministic and unparameterized dynamics) are flags the
    port's controllers reject before a step is built."""
    return config.dtype == torch.float32 and not config.step_dependent_dynamics


def fused_rollout_plain(x0_K, u_scaled, *, model: KernelModel):
    """What the rollout kernel computes, in torch ops on any device: the
    fused iteration's rollout, on actions that come scaled."""
    K, T, nu = u_scaled.shape
    return FS._rollout_total(model, u_scaled.reshape(K, T * nu).T, x0_K.T, T, nu, 1.0)


def make_fused_rollout(config: MPPIConfig, model: KernelModel):
    """The K×T rollout of ``model`` as one kernel call: ``rollout(x0_K
    (K, nx) of any strides, u_scaled (K, T, nu) contiguous) -> cost (K,)``.
    Raises as :func:`~.fused_solve.make_transposed_fused_solve` for the
    config and model."""
    FS.check_kernel_model(config, model)
    K, T, nx, nu = config.K, config.T, config.nx, config.nu

    def rollout(x0_K, u_scaled):
        device = u_scaled.device
        FS._check("x0_K", x0_K, device, shape=(K, nx), contiguous=False)
        FS._check("u_scaled", u_scaled, device, shape=(K, T, nu))
        cost = torch.empty(K, dtype=torch.float32, device=device)
        lib = FS._lib()
        rc = lib.fused_mppi_rollout(
            FS.device_index(device), FS.stream_of(device), model.model_id,
            model.consts_on(device).data_ptr(), K, T, nx, nu, x0_K.data_ptr(),
            x0_K.stride(1), x0_K.stride(0), u_scaled.data_ptr(), cost.data_ptr())
        FS.raise_on_error(lib, rc, "fused_rollout")
        FS.launches["rollout"] += 1
        return cost

    return FS.finish(rollout, fused_rollout_plain, dict(model=model), {}, device_arg=1)


def weighted_update_plain(cost, noise, lambda_):
    """What the weighted-update kernels compute, in torch ops on any device:
    ``(pert (D,), m, s)`` of the (K, D) noise."""
    return FS._softmax_update(cost, lambda_, noise.T)


def _weighted_update_kernel(cost, noise, lambda_):
    device = cost.device
    K, D = noise.shape
    FS._check("cost", cost, device, shape=(K,))
    FS._check("noise", noise, device, contiguous=False)
    if noise.stride(1) != 1:
        raise ValueError(f"noise must have unit column stride, got strides {noise.stride()}")
    lam = FS._check("lambda_", torch.as_tensor(lambda_, dtype=torch.float32, device=device)
                    .reshape(1), device, shape=(1,))
    f32 = dict(dtype=torch.float32, device=device)
    partial = torch.empty((-(-K // FS._BLOCK), D + 2), **f32)
    pert = torch.empty(D, **f32)
    ms = torch.empty(2, **f32)
    lib = FS._lib()
    rc = lib.fused_mppi_weighted_update(
        FS.device_index(device), FS.stream_of(device), K, D, cost.data_ptr(),
        noise.data_ptr(), noise.stride(0), lam.data_ptr(), partial.data_ptr(),
        pert.data_ptr(), ms.data_ptr())
    FS.raise_on_error(lib, rc, "weighted_update")
    FS.launches["weighted_update"] += 2
    return pert, ms[0], ms[1]


# the JAX function's signature: (cost_total, noise_flat, lambda_) -> (pert, m, s)
fused_weighted_update = FS.finish(_weighted_update_kernel, weighted_update_plain, {}, {},
                                  device_arg=0)
