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
(``fused_rollout``, whose blocks of :func:`~.fused_solve.tile_samples`
samples stage their rows in shared memory before the rollout
(:func:`rollout_geometry`); ``weighted_partial``, which merges its
per-block softmax partials itself in two levels of tickets: one launch a
call) and raises if the launch fails; on CPU tensors it runs its plain version
(:func:`fused_rollout_plain`, :func:`weighted_update_plain`).  Float32
only; the update's sums are fp32 FMAs, as the JAX dot's
``Precision.HIGHEST``.  The update's merge counts the finished blocks in
one int32 counter buffer per device (:func:`weighted_update_counter`): two
calls must not run at once on two streams of one device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..config import MPPIConfig
from . import batch_last as BL
from . import fused_solve as FS
from . import kernel_models as KM
from .kernel_models import KernelModel


def pallas_eligible(config: MPPIConfig) -> bool:
    """Static eligibility for the legacy kernels (``pallas_rollout.py:61-72``):
    M = 1, deterministic and unparameterized dynamics, and float32.  A step
    dependence needs a traced model (``ops/batch_last.py``; a named model
    takes no timestep: :func:`~.fused_solve.check_kernel_model`).  A terminal
    cost and a ``specific_dynamics`` hook send the route to the plain path
    (``solve._route_legacy_rollout``)."""
    return (config.M == 1 and not config.stochastic_dynamics
            and not config.parameterized_dynamics and config.dtype == torch.float32)


def fused_rollout_plain(x0_K, u_scaled, *, model: KernelModel):
    """What the rollout kernel computes, in torch ops on any device: the
    fused iteration's rollout, on actions that come scaled."""
    K, T, nu = u_scaled.shape
    return FS._rollout_total(model, u_scaled.reshape(K, T * nu).T, x0_K.T, T, nu, 1.0)


ROLLOUT_SMEM = 48 * 1024  # the rollout's staged bytes a block at most (fused_mppi.cu)


def rollout_ldr(cols: int) -> int:
    """Floats of a staged row of ``cols`` actions: ceil(cols / 4) float4s
    made odd, so that the 16-byte reads of one step are free of bank
    conflicts (``rollout_ldr`` in fused_mppi.cu)."""
    return (-(-cols // 4) | 1) * 4


def rollout_geometry(T: int, nu: int, S: int) -> dict:
    """How the rollout kernel stages a block's S rows of T·nu actions
    (``fused_mppi_rollout_geometry``): all T steps in one buffer when the
    tile fits ``ROLLOUT_SMEM``, else chunks of ``steps`` steps in two
    buffers (the next chunk lands while the block rolls out the current
    one), a multiple of 4 / gcd(nu, 4) steps so that every chunk starts on
    16 bytes (else one step, copied 4 bytes at a time)."""
    steps, bufs = T, 1
    if S * rollout_ldr(T * nu) * 4 > ROLLOUT_SMEM:
        m = 1 if nu % 4 == 0 else 2 if nu % 2 == 0 else 4
        if m >= T or 2 * S * rollout_ldr(m * nu) * 4 > ROLLOUT_SMEM:
            m = 1
        bufs, steps = 2, m
        while steps + m < T and 2 * S * rollout_ldr((steps + m) * nu) * 4 <= ROLLOUT_SMEM:
            steps += m
    ldr = rollout_ldr(steps * nu)
    return dict(steps=steps, ldr=ldr, buffers=bufs, smem=bufs * S * ldr * 4,
                chunks=-(-T // steps))


def _rollout_lib(model_id: int):
    """The library of ``model_id``'s rollout kernel (the named one or a
    generated model's), its staging geometry checked once against
    :func:`rollout_geometry`."""
    lib = FS.library_of(model_id, FS.ROLLOUT)
    if not getattr(lib, "_rollout_checked", False):
        geo = (ctypes.c_longlong * 4)()
        for T, nu, S in ((30, 2, 32), (15, 1, 32), (100, 3, 128), (300, 1, 128),
                         (100, 31, 64), (3, 31, 128), (250, 32, 128)):
            g = rollout_geometry(T, nu, S)
            if (lib.fused_mppi_rollout_geometry(T, nu, S, geo) != 0
                    or list(geo) != [g["steps"], g["ldr"], g["buffers"], g["smem"]]):
                raise RuntimeError("fused_mppi.cu's rollout geometry differs from "
                                   "ops/legacy.py's")
        lib._rollout_checked = True
    return lib


def rollout_act_rows(T: int, nu: int, S: int, act_ld: int, nx: int) -> int:
    """A block model's group of samples in the rollout kernel, of S halved,
    whose activations (rows of ``act_ld`` floats) and rows of per-sample
    values fit beside the staged rows (:func:`~.fused_solve.activation_rows`,
    by occupancy); 0 for a per-sample model (``act_ld`` 0).  Raises
    FusedSolveUnavailable where none fits."""
    if not act_ld:
        return 0
    rows, _ = FS.activation_rows(S, act_ld, [rollout_geometry(T, nu, S)["smem"]], nx, nu)
    if not rows:
        raise FS.FusedSolveUnavailable(
            f"a block model's activations (two rows of {act_ld} floats a sample) do not fit "
            f"in shared memory beside the rollout's staged rows")
    return rows


def launch_rollout(x0_K, u_scaled, consts, model_id: int, tile_k: int = None, act_ld: int = 0):
    """Launch the rollout kernel on checked CUDA tensors (the model's
    ``consts`` on the device; a block model's activation row of ``act_ld``
    floats): the (K,) costs.  Counts the launch."""
    device = u_scaled.device
    K, T, nu = u_scaled.shape
    S = FS.check_tile(tile_k, K)
    cost = torch.empty(K, dtype=torch.float32, device=device)
    lib = _rollout_lib(model_id)
    rc = lib.fused_mppi_rollout(
        FS.device_index(device), FS.stream_of(device), model_id, consts.data_ptr(), K, T,
        x0_K.shape[1], nu, x0_K.data_ptr(), x0_K.stride(1), x0_K.stride(0),
        u_scaled.data_ptr(), cost.data_ptr(), S,
        rollout_act_rows(T, nu, S, act_ld, x0_K.shape[1]), act_ld)
    FS.raise_on_error(lib, rc, "fused_rollout")
    FS.launches[FS.launch_name(model_id, "rollout")] += 1
    return cost


def make_fused_rollout(config: MPPIConfig, model: KernelModel, tile_k: int = None):
    """The K×T rollout of ``model`` as one kernel call: ``rollout(x0_K
    (K, nx) of any strides, u_scaled (K, T, nu) contiguous) -> cost (K,)``.
    The kernel's blocks take ``tile_k`` samples (32, 64 or 128; ``.tile_k``
    holds it); None takes :func:`~.fused_solve.tile_samples` of K and the
    card's SM count at each call.  Raises as
    :func:`~.fused_solve.make_transposed_fused_solve` for the config and
    model (:func:`~.fused_solve.check_kernel_model`; a block model's
    activations must fit beside the staged rows, :func:`rollout_act_rows`);
    a traced model (:func:`~.batch_last.kernel_model`) runs in its own
    library, with the timestep.  The call reaches :func:`launch_rollout`
    directly or through its operator (:func:`~.fused_solve.via_ops`)."""
    model = FS.as_kernel_model(config, model)
    FS.check_kernel_model(config, model)
    model_id = BL.launch_id(model)
    if tile_k is not None and tile_k not in FS.TILES:
        raise ValueError(f"tile_k must be one of {FS.TILES}, got {tile_k}")
    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    act_ld = KM.activation_ld(model)
    for S in (tile_k,) if tile_k else FS.TILES:  # the rule's S is the card's, at the call
        rollout_act_rows(T, nu, S, act_ld, config.nx)

    def rollout(x0_K, u_scaled):
        device = u_scaled.device
        FS._check("x0_K", x0_K, device, shape=(K, nx), contiguous=False)
        FS._check("u_scaled", u_scaled, device, shape=(K, T, nu))
        consts = model.consts_on(device)
        if FS.via_ops():
            return torch.ops.mppi_torch.rollout.default(x0_K, u_scaled, consts, model_id,
                                                        tile_k or 0, act_ld)
        return launch_rollout(x0_K, u_scaled, consts, model_id, tile_k, act_ld)

    return FS.finish(rollout, fused_rollout_plain, dict(model=model), dict(tile_k=tile_k),
                     device_arg=1)


def weighted_update_plain(cost, noise, lambda_):
    """What the weighted-update kernels compute, in torch ops on any device:
    ``(pert (D,), m, s)`` of the (K, D) noise."""
    return FS._softmax_update(cost, lambda_, noise.T)


_counters = {}  # the weighted update's merge counters of each device
WEIGHTED_COUNTERS = 8193  # one ticket for the groups, one for each of up to 8,192 groups


def weighted_update_counter(device) -> torch.Tensor:
    """The int32 tickets of the weighted update's in-kernel merge on
    ``device`` (``WEIGHTED_COUNTERS`` of them), the same tensor for every
    call there."""
    return FS.merge_counter(_counters, device, WEIGHTED_COUNTERS)


def weighted_stride(D: int) -> int:
    """Floats of one block's partial: m_b, s_b, two unused, then the D sums
    padded to four, so that every row starts on 16 bytes."""
    return 4 + -(-D // 4) * 4


def weighted_group(nblocks: int) -> int:
    """The blocks whose partials the first merge level takes together: the
    smallest g ≥ 8 with g² ≥ nblocks, so that both levels merge about
    √nblocks partials (``fused_mppi_weighted_group``)."""
    return max(8, math.isqrt(nblocks - 1) + 1)


def weighted_update_buffers(K: int, D: int, S: int, device):
    """One float32 allocation a call: the partials of the kernel's
    ceil(K / S) blocks of S samples and those of their groups (rows of
    :func:`weighted_stride` floats), then the (D + 2,) result (pert, m, s)
    that the wrapper returns as views."""
    nblocks = -(-K // S)
    groups = -(-nblocks // weighted_group(nblocks))
    PS = weighted_stride(D)
    buf = torch.empty((nblocks + groups) * PS + D + 2, dtype=torch.float32, device=device)
    partial = buf[:nblocks * PS].view(nblocks, PS)
    gpart = buf[nblocks * PS:(nblocks + groups) * PS].view(groups, PS)
    return partial, gpart, buf[(nblocks + groups) * PS:]


def _weighted_lib():
    """The library, its merge groups and counter count checked once against
    :func:`weighted_group` and ``WEIGHTED_COUNTERS``."""
    lib = FS._lib()
    if not getattr(lib, "_weighted_checked", False):
        if lib.fused_mppi_weighted_counters() != WEIGHTED_COUNTERS or any(
                lib.fused_mppi_weighted_group(n) != weighted_group(n)
                for n in (1, 63, 64, 65, 313, 516, 10_000, 1 << 20)):
            raise RuntimeError("fused_mppi.cu's weighted-update merge groups differ from "
                               "ops/legacy.py's")
        lib._weighted_checked = True
    return lib


def launch_weighted_update(cost, noise, lam, tile_k: int = None):
    """Launch the weighted update on checked CUDA tensors (``lam`` a float32
    tensor of one value): the (D + 2,) result ``(pert, m, s)`` at the end
    of the call's one allocation.  Counts the launch."""
    device = cost.device
    K, D = noise.shape
    S = FS.check_tile(tile_k, K)
    partial, gpart, out = weighted_update_buffers(K, D, S, device)
    lib = _weighted_lib()
    rc = lib.fused_mppi_weighted_update(
        FS.device_index(device), FS.stream_of(device), K, D, S, cost.data_ptr(),
        noise.data_ptr(), noise.stride(0), lam.data_ptr(), partial.data_ptr(),
        gpart.data_ptr(), weighted_update_counter(device).data_ptr(), out.data_ptr())
    FS.raise_on_error(lib, rc, "weighted_update")
    FS.launches["weighted_update"] += 1
    return out


def _weighted_update_kernel(cost, noise, lambda_, tile_k=None):
    device = cost.device
    K, D = noise.shape
    FS._check("cost", cost, device, shape=(K,))
    FS._check("noise", noise, device, contiguous=False)
    if noise.stride(1) != 1:
        raise ValueError(f"noise must have unit column stride, got strides {noise.stride()}")
    lam = lambda_
    if not (isinstance(lam, torch.Tensor) and lam.dtype == torch.float32
            and lam.device == device and lam.numel() == 1):
        lam = FS._check("lambda_", torch.as_tensor(lambda_, dtype=torch.float32, device=device)
                        .reshape(1), device, shape=(1,))
    if FS.via_ops():
        out = torch.ops.mppi_torch.weighted_update.default(cost, noise, lam, tile_k or 0)
    else:
        out = launch_weighted_update(cost, noise, lam, tile_k)
    return out[:D], out[D], out[D + 1]


def make_weighted_update(tile_k: int = None):
    """:func:`fused_weighted_update` with the kernel's samples a block forced
    to ``tile_k`` (32, 64 or 128; ``.tile_k`` holds it); None takes
    :func:`~.fused_solve.tile_samples` of K and the card's SM count at each
    call.  The call reaches :func:`launch_weighted_update` directly or
    through its operator (:func:`~.fused_solve.via_ops`)."""
    if tile_k is not None and tile_k not in FS.TILES:
        raise ValueError(f"tile_k must be one of {FS.TILES}, got {tile_k}")

    def update(cost, noise, lambda_):
        return _weighted_update_kernel(cost, noise, lambda_, tile_k)

    return FS.finish(update, weighted_update_plain, {}, dict(tile_k=tile_k), device_arg=0)


# the JAX function's signature: (cost_total, noise_flat, lambda_) -> (pert, m, s)
fused_weighted_update = make_weighted_update()
