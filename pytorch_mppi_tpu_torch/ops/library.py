"""The kernels of ``csrc/fused_mppi.cu`` as ``torch.library`` operators.

The port's counterpart of the Pallas custom call inside an exported JAX
program: the wrappers launch their kernels through ``ctypes``, which
``torch.export`` cannot see, so each launch is also an operator of the
``mppi_torch`` namespace, which an exported command records as a node and a
process that loads it calls (``utils/deploy.py``).  Importing the package
registers them.

* ``mppi_torch::kernel_a``: kernel A, one iteration of MPPI, SMPPI or KMPPI
  (``LaunchSpec.variant``), or the round-1 solve (``LaunchSpec.rowmajor``);
  returns ``(delta, ms (2,), cost (K,), perturbed (D, K) or empty)``;
* ``mppi_torch::batched``: the batched pair, ``batched_partial`` and
  ``flash_merge``; returns ``(delta (D, N), ms (2, N), cost (N, K))``;
* ``mppi_torch::rollout`` and ``mppi_torch::weighted_update``: the legacy
  route's pair; the rollout returns the (K,) costs, the update the (D + 2,)
  ``(pert, m, s)``.

The static configuration of a launch travels as integers (kernel A's and
the batched pair's :class:`~.fused_solve.LaunchSpec`, ``u_scale`` as a
float), the device model and terminal cost as their constants.  Each
operator has two implementations: on CUDA tensors the wrapper's launch
function (``fused_solve.launch_kernel_a``, ``legacy.launch_rollout``,
``legacy.launch_weighted_update``), which raises when a launch fails and
counts it in ``fused_solve.launches``; on CPU tensors the kernel's plain
version with the device model rebuilt from its constants
(``kernel_models.plain_model``).  A tensor on any other device has no
implementation, and the call raises.  Kernel A's merge counter and its
scratch are allocated inside the CUDA implementation, as on the direct
route; the counter is back at 0 after every launch.
"""
import contextlib
from typing import Optional, Sequence

import torch
from torch import Tensor

from . import fused_solve as FS
from . import legacy as LG
from .kernel_models import plain_model

NAMESPACE = "mppi_torch"
OPERATORS = ("kernel_a", "batched", "rollout", "weighted_update")


@contextlib.contextmanager
def exporting():
    """Route every wrapper through its operator, on any device, while a
    command is traced for ``torch.export`` (``fused_solve.via_ops``)."""
    FS._exporting += 1
    try:
        yield
    finally:
        FS._exporting -= 1


def _empty(like: Tensor, shape=0) -> Tensor:
    return like.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op("mppi_torch::kernel_a", mutates_args=(), device_types="cuda")
def kernel_a(lead: Optional[Tensor], key: Sequence[int], x0T: Tensor, U2: Tensor,
             base: Optional[Tensor], op: Optional[Tensor], mu: Optional[Tensor], lo: Tensor,
             hi: Tensor, alo: Optional[Tensor], ahi: Optional[Tensor], a_flat: Tensor,
             W: Optional[Tensor], lam: Tensor, w_seq: Optional[Tensor], dt: Optional[Tensor],
             elites: Optional[Tensor], consts: Tensor, term: Optional[Tensor],
             gate: Optional[Tensor], spec: Sequence[int],
             u_scale: float) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    delta, ms, cost, pert = FS.launch_kernel_a(
        FS.LaunchSpec(*spec), u_scale, lead, tuple(key), x0T, U2, base, op, mu, lo, hi, alo,
        ahi, a_flat, W, lam, w_seq, dt, elites, consts, term, gate)
    return delta, ms, cost, _empty(cost) if pert is None else pert


@kernel_a.register_kernel("cpu")
def _kernel_a_plain(lead, key, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W, lam,
                    w_seq, dt, elites, consts, term, gate, spec, u_scale):
    delta, ms, cost, pert = FS.plain_kernel_a(
        FS.LaunchSpec(*spec), u_scale, lead, tuple(key), x0T, U2, base, op, mu, lo, hi, alo,
        ahi, a_flat, W, lam, w_seq, dt, elites, consts, term, gate)
    return delta, ms, cost, _empty(cost) if pert is None else pert


@kernel_a.register_fake
def _kernel_a_shapes(lead, key, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W, lam,
                     w_seq, dt, elites, consts, term, gate, spec, u_scale):
    s = FS.LaunchSpec(*spec)
    return (_empty(x0T, s.R), _empty(x0T, 2), _empty(x0T, s.K),
            _empty(x0T, (s.T * s.nu, s.K) if s.emit_perturbed else 0))


@torch.library.custom_op("mppi_torch::batched", mutates_args=(), device_types="cuda")
def batched(lead: Optional[Tensor], key: Sequence[int], x0T: Tensor, U2T: Tensor,
            op: Optional[Tensor], mu: Optional[Tensor], lo: Tensor, hi: Tensor, aT: Tensor,
            lam: Tensor, consts: Tensor, term: Optional[Tensor], spec: Sequence[int],
            u_scale: float) -> tuple[Tensor, Tensor, Tensor]:
    return FS.launch_kernel_a(FS.LaunchSpec(*spec), u_scale, lead, tuple(key), x0T, U2T, None,
                              op, mu, lo, hi, None, None, aT, None, lam, None, None, None,
                              consts, term)[:3]


@batched.register_kernel("cpu")
def _batched_plain(lead, key, x0T, U2T, op, mu, lo, hi, aT, lam, consts, term, spec, u_scale):
    return FS.plain_kernel_a(FS.LaunchSpec(*spec), u_scale, lead, tuple(key), x0T, U2T, None,
                             op, mu, lo, hi, None, None, aT, None, lam, None, None, None,
                             consts, term)[:3]


@batched.register_fake
def _batched_shapes(lead, key, x0T, U2T, op, mu, lo, hi, aT, lam, consts, term, spec, u_scale):
    s = FS.LaunchSpec(*spec)
    return (_empty(x0T, (s.R, s.plants)), _empty(x0T, (2, s.plants)),
            _empty(x0T, (s.plants, s.K)))


@torch.library.custom_op("mppi_torch::rollout", mutates_args=(), device_types="cuda")
def rollout(x0_K: Tensor, u_scaled: Tensor, consts: Tensor, model_id: int,
            tile_k: int) -> Tensor:
    return LG.launch_rollout(x0_K, u_scaled, consts, model_id, tile_k or None)


@rollout.register_kernel("cpu")
def _rollout_plain(x0_K, u_scaled, consts, model_id, tile_k):
    model = plain_model(model_id, consts, x0_K.shape[1], u_scaled.shape[2])
    return LG.fused_rollout_plain(x0_K, u_scaled, model=model)


@rollout.register_fake
def _rollout_shapes(x0_K, u_scaled, consts, model_id, tile_k):
    return _empty(u_scaled, u_scaled.shape[0])


@torch.library.custom_op("mppi_torch::weighted_update", mutates_args=(), device_types="cuda")
def weighted_update(cost: Tensor, noise: Tensor, lam: Tensor, tile_k: int) -> Tensor:
    return LG.launch_weighted_update(cost, noise, lam, tile_k or None)


@weighted_update.register_kernel("cpu")
def _weighted_update_plain(cost, noise, lam, tile_k):
    pert, m, s = LG.weighted_update_plain(cost, noise, lam)
    return torch.cat([pert, m.reshape(1), s.reshape(1)])


@weighted_update.register_fake
def _weighted_update_shapes(cost, noise, lam, tile_k):
    return _empty(cost, noise.shape[1] + 2)
