"""The fused MPPI iteration: the CUDA kernel's wrapper and its plain version.

The counterpart of ``make_transposed_fused_solve`` (``pytorch_mppi_tpu/ops/
pallas_rollout.py:512``) and its helpers.  :func:`make_transposed_fused_solve`
returns ``solve(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
lambda_) -> (delta (D,), m, s, cost (K,)[, perturbed (D, K)])`` with
``U_new = U + delta / s``, for a :class:`~.kernel_models.KernelModel`:

* on CUDA tensors it launches ``csrc/fused_mppi.cu`` (kernel A, one thread
  per sample, then kernel B, the merge of the per-block softmax statistics)
  and raises if the launch fails;
* on CPU tensors it runs :func:`fused_solve_plain`, the same function in
  plain torch ops on (D, K) tensors.

``seed_or_bits`` selects the noise source.  A (D, K_pad) int32 tensor —
(D, K_pad/2) with antithetic sampling — injects the random bits, as the JAX
kernel's ``rng_in_kernel=False``; a pair of 32-bit ints is a Philox4x32-10
key, and the kernel draws its own bits.  Word w of Philox counter (c, g, 0, 0)
is the bits of row 4g + w of source column c.

Antithetic pairs sit inside pairing blocks of ``pair_block`` samples: sample
j of block b takes source column b·pair_block/2 + j for j < pair_block/2,
and the negated draw of column b·pair_block/2 + j − pair_block/2 otherwise.
This is the JAX kernel's pairing with its ``block_k``; the default block is
all of K (rounded up to even), which pairs rows k and K/2 + k as
``solve.sample_noise_flat`` does.  The pairing is independent of the CUDA
block size.

Float32 only.  Normals come from Giles' single-precision erfinv, the
polynomial XLA uses for ``erf_inv``, in both the kernel and the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import MPPIConfig
from .kernel_models import KernelModel

# kernel launches (A and B each count one); chip_smoke.py reads it
launches = 0

MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_BLOCK = 128  # samples per block of kernel A (BLOCK in fused_mppi.cu)
_MAXN = 8  # largest nx or nu of a device model (MAXN in fused_mppi.cu)


class FusedSolveUnavailable(ValueError):
    """A configuration the fused kernel cannot take; routing falls back to
    the plain path."""


def transposed_eligible(config: MPPIConfig) -> bool:
    """Static eligibility for the fused kernel: float32 and no step
    dependence (the kernel's device models take no timestep)."""
    return config.dtype == torch.float32 and not config.step_dependent_dynamics


def smem_bytes(D: int, full_op: bool) -> int:
    """Dynamic shared memory of kernel A (``fused_mppi_smem_bytes``)."""
    return ((2 if full_op else 1) * D * (_BLOCK + 1) + 2 * _BLOCK) * 4


def padded_k(K: int, pair_block: int) -> int:
    return -(-K // pair_block) * pair_block


# ---------------------------------------------------------------------------
# Random numbers, in plain torch
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_M32 = 0xFFFFFFFF


def _mulhilo32(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors holding uint32
    values, in 16-bit pieces so that no int64 product overflows."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    q = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (q >> 32), q & _M32


def philox4x32_10(counter, key):
    """Philox4x32-10 over int64 tensors: ``counter`` is four broadcastable
    tensors of uint32 values, ``key`` two ints; returns the four output
    words (Random123's ``philox4x32``)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _M32, key[1] & _M32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_to_seed(s: int) -> tuple:
    """The kernel's Philox key (two 32-bit words) from a 64-bit iteration
    seed (counterpart of ``pallas_rollout.key_to_seed``)."""
    return (s & _M32, (s >> 32) & _M32)


def philox_bits(key, cols: torch.Tensor, D: int) -> torch.Tensor:
    """(D, len(cols)) uint32 bits (in int64) of the source columns ``cols``:
    row 4g + w is word w of counter (col, g, 0, 0)."""
    G = -(-D // 4)
    c0 = cols.to(torch.int64)[None, :]
    c1 = torch.arange(G, dtype=torch.int64, device=cols.device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=cols.device)
    words = philox4x32_10((c0, c1, zero, zero), key)
    return torch.stack(torch.broadcast_tensors(*words), dim=1).reshape(4 * G, -1)[:D]


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erfinv (the kernel's and XLA's polynomial)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return p * x


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """int32 (or uint32-in-int64) random bits -> float32 standard normals
    (``_bits_to_normal``, pallas_rollout.py:1501).  The JAX map shifts
    logically; torch's ``>>`` is arithmetic, so the mask keeps the 23 bits."""
    mant = (bits.to(torch.int64) >> 9) & 0x7FFFFF
    f = (mant | 0x3F800000).to(torch.int32).view(torch.float32)
    u = f - 1.0 + 2.0**-24
    return erfinv_f32(2.0 * u - 1.0) * 1.4142135623730951


def source_columns(K: int, pair_block: int, antithetic: bool, device):
    """Source column of every sample and its antithetic sign (None without
    antithetic sampling)."""
    k = torch.arange(K, device=device)
    if not antithetic:
        return k, None
    bh = pair_block // 2
    j = k % pair_block
    src = (k // pair_block) * bh + torch.where(j < bh, j, j - bh)
    sign = torch.where(j < bh, 1.0, -1.0).to(torch.float32)
    return src, sign


def weighting_from_stats(cost_total, lambda_, m, s):
    """The reference's weights from the streaming statistics:
    cost_total_non_zero = exp(-c/lambda - m), omega = that / s."""
    ctnz = torch.exp(-cost_total / lambda_ - m)
    return ctnz, ctnz / s


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def fused_solve_plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
                      lambda_, *, model: KernelModel, K: int, T: int, nu: int,
                      antithetic: bool = False, null_action: bool = False,
                      abs_cost: bool = False, u_scale: float = 1.0,
                      emit_perturbed: bool = False, pair_block: int = None):
    """What the fused kernel computes, in torch ops on (D, K) tensors of any
    device.  Same arguments and results as the kernel's wrapper."""
    D = T * nu
    device = x0T.device
    pair_block = pair_block or K + K % 2
    src, sign = source_columns(K, pair_block, antithetic, device)
    if isinstance(seed_or_bits, torch.Tensor):
        bits = seed_or_bits.to(device)[:, src]
    else:
        bits = philox_bits(seed_or_bits, src, D)
    z = bits_to_normal(bits)
    if sign is not None:
        z = z * sign
    U_col = U2.reshape(D, 1)
    if op.ndim == 1:
        noise = z * op[:, None] + mu_t[:, None]
    else:
        noise = op @ z + mu_t[:, None]
    perturbed = U_col + noise
    if null_action:
        perturbed[:, 0] = 0.0  # a fresh tensor of this function
    perturbed = torch.clamp(perturbed, lo_t[:, None], hi_t[:, None])
    n = perturbed - U_col
    pert_cost = ((torch.abs(n) if abs_cost else n) * a_flat[:, None]).sum(dim=0)
    state = x0T.T
    total = torch.zeros(K, dtype=torch.float32, device=device)
    for t in range(T):
        u_t = perturbed[t * nu:(t + 1) * nu].T
        if u_scale != 1.0:
            u_t = u_t * u_scale
        state = model.dynamics(state, u_t)
        total = total + model.running_cost(state, u_t)
    cost = pert_cost + total
    logits = -cost / lambda_
    m = torch.amax(logits)
    w = torch.exp(logits - m)
    out = (n @ w, m, torch.sum(w), cost)
    return out + (perturbed,) if emit_perturbed else out


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from . import _build

    lib = _build.load()
    if not getattr(lib, "_argtypes_set", False):
        lib.fused_mppi_launch.argtypes = [
            _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, ctypes.c_uint32,
            ctypes.c_uint32, _I, _I, _I, _I, _P, ctypes.c_longlong,
            ctypes.c_longlong, _P, _P, _I, _P, _P, _P, _P, _P, ctypes.c_float,
            _P, _P, _P, _P, _P,
        ]
        lib.fused_mppi_launch.restype = _I
        lib.fused_mppi_error_string.argtypes = [_I]
        lib.fused_mppi_error_string.restype = ctypes.c_char_p
        lib.fused_mppi_block.restype = _I
        if lib.fused_mppi_block() != _BLOCK:
            raise RuntimeError("fused_mppi.cu BLOCK differs from fused_solve._BLOCK")
        lib._argtypes_set = True
    return lib


def _check(name, t, device, dtype=torch.float32, shape=None, contiguous=True):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def make_transposed_fused_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None):
    """The whole MPPI iteration as one fused-kernel call (see the module
    docstring for the call contract).  Raises ValueError for a non-float32
    config or a model whose sizes differ from the config's, and
    :class:`FusedSolveUnavailable` when nx or nu exceeds the device models'
    registers, when kernel A's tile does not fit in shared memory, or for the JAX
    kernel's options this port does not run yet: ``null_dynamic_gate`` and
    ``terminal_final`` (the elites operand has no config field here; the
    controller rejects ``num_elites``)."""
    if null_dynamic_gate:
        raise FusedSolveUnavailable(
            "null_dynamic_gate is not ported yet (ROADMAP.md Queue 1 item 12, sharding)")
    if terminal_final is not None:
        raise FusedSolveUnavailable(
            "terminal_final is not ported yet (ROADMAP.md Queue 1 item 5, terminal costs)")
    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    D = T * nu
    if config.dtype != torch.float32:
        raise ValueError("the fused solve requires float32")
    if (model.nx, model.nu) != (nx, nu):
        raise ValueError(
            f"kernel model {model.name!r} is (nx={model.nx}, nu={model.nu}); "
            f"the config is (nx={nx}, nu={nu})")
    if max(nx, nu) > _MAXN:
        raise FusedSolveUnavailable(
            f"nx={nx}, nu={nu}: the kernel's device models hold at most {_MAXN} of each")
    pair_block = pair_block or K + K % 2
    if config.antithetic and pair_block % 2:
        raise ValueError(f"antithetic pairing needs an even pair_block, got {pair_block}")
    full_op = not (config.diag_sigma and not config.noise_rho)
    if smem_bytes(D, full_op) > MAX_SMEM_BYTES:
        raise FusedSolveUnavailable(
            f"D={D} rows need {smem_bytes(D, full_op)} B of shared memory "
            f"per block (Hopper allows {MAX_SMEM_BYTES})")
    K_pad = padded_k(K, pair_block)
    bits_cols = K_pad // 2 if config.antithetic else K_pad
    flags = dict(model=model, K=K, T=T, nu=nu, antithetic=config.antithetic,
                 null_action=config.sample_null_action,
                 abs_cost=config.noise_abs_cost, u_scale=float(config.u_scale),
                 emit_perturbed=emit_perturbed, pair_block=pair_block)

    def launch(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_):
        global launches
        device = x0T.device
        _check("x0T", x0T, device, shape=(nx, K), contiguous=False)
        for name, t in (("U2", U2), ("mu_t", mu_t), ("lo_t", lo_t),
                        ("hi_t", hi_t), ("a_flat", a_flat)):
            _check(name, t, device, shape=(D,))
        _check("op", op, device, shape=(D, D) if full_op else (D,))
        _check("lambda_", lambda_.reshape(1), device, shape=(1,))
        if isinstance(seed_or_bits, torch.Tensor):
            bits = _check("bits", seed_or_bits, device, dtype=torch.int32,
                          shape=(D, bits_cols))
            key = (0, 0)
        else:
            bits = None
            key = tuple(int(w) & 0xFFFFFFFF for w in seed_or_bits)
        consts = model.consts_on(device)
        cost = torch.empty(K, dtype=torch.float32, device=device)
        partial = torch.empty((-(-K // _BLOCK), D + 2), dtype=torch.float32, device=device)
        delta = torch.empty(D, dtype=torch.float32, device=device)
        ms = torch.empty(2, dtype=torch.float32, device=device)
        pert = (torch.empty((D, K), dtype=torch.float32, device=device)
                if emit_perturbed else None)
        lib = _lib()
        rc = lib.fused_mppi_launch(
            device.index if device.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(device).cuda_stream,
            model.model_id, consts.data_ptr(), K, T, nx, nu,
            bits.data_ptr() if bits is not None else None, bits_cols,
            key[0], key[1], pair_block, int(config.antithetic),
            int(config.sample_null_action), int(config.noise_abs_cost),
            x0T.data_ptr(), x0T.stride(0), x0T.stride(1),
            U2.data_ptr(), op.data_ptr(), int(full_op), mu_t.data_ptr(),
            lo_t.data_ptr(), hi_t.data_ptr(), a_flat.data_ptr(),
            lambda_.data_ptr(), float(config.u_scale), cost.data_ptr(),
            partial.data_ptr(), delta.data_ptr(), ms.data_ptr(),
            pert.data_ptr() if pert is not None else None,
        )
        if rc != 0:
            raise RuntimeError(
                f"fused_mppi launch failed: CUDA error {rc} "
                f"({lib.fused_mppi_error_string(rc).decode()})")
        launches += 2
        out = (delta, ms[0], ms[1], cost)
        return out + (pert,) if emit_perturbed else out

    def solve(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_):
        if x0T.device.type == "cuda":
            return launch(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
                          lambda_)
        if x0T.device.type != "cpu":
            raise ValueError(f"the fused solve runs on cuda or cpu tensors, not {x0T.device}")
        return fused_solve_plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t,
                                 a_flat, lambda_, **flags)

    solve.K_pad = K_pad
    solve.pair_block = pair_block
    solve.bits_cols = bits_cols
    return solve

