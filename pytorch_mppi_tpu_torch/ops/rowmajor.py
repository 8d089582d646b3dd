"""The two ops-level kernels with K on rows: the fused sampling front-end and
the round-1 one-kernel solve, their wrappers and their plain versions.

The counterparts of ``pytorch_mppi_tpu/ops/pallas_rollout.py:45-58,
1331-1482, 1527-1746``.  No controller routes to them, in JAX as here; they
are utilities of the ops layer, in the (K, D) layout that
:mod:`.legacy`'s rollout and weighted update take:

* :func:`make_fused_sampler` (``:1350``) returns ``sample(seed_or_bits,
  U2 (D,), op, mu_t, lo_t, hi_t, a_flat (D,)) -> (perturbed (K, D),
  pert_cost (K,))``: the normals, the antithetic mirror, the noise transform
  (``z * op + mu_t`` for a diagonal ``op`` of D values when
  ``config.diag_sigma and not config.noise_rho``, else ``z @ op + mu_t``
  for the (D, D) operator ``kron(A_rhoᵀ, cholᵀ)``), the null-action row, the
  clamp, and the action cost ``Σ_d n_d a_d`` of the rectified noise
  ``n = perturbed − U2`` (``|n|`` under ``noise_abs_cost``);
* :func:`make_fused_solve` (``:1527``) returns ``solve(seed_or_bits, x0
  (nx,), U (T, nu), chol (nu, nu), mu (nu,), lo, hi (nu,) or scalars,
  a_flat (D,), lambda_) -> (delta (T, nu), m, s, cost (K,))`` with
  ``U_new = U + delta / s``: the noise ``chol @ z_t + mu`` of each timestep
  (JAX's ``z @ kron(I_T, cholᵀ)``), the null row, the clamp, the action
  cost, the T-step rollout of ``u_t · u_scale`` with the running cost after
  each step, and the softmax-weighted sum of the rectified noise.
  ``a_flat = λ·(U @ Σ⁻¹ᵀ)`` flattened is the caller's.

``seed_or_bits`` selects the noise source, as the JAX kernels'
``rng_in_kernel``: an int32 tensor injects the random bits, (K_pad, D) —
(K_pad/2, D) for the sampler with antithetic sampling — and a pair of
32-bit ints (:func:`.fused_solve.key_to_seed`) is a Philox4x32-10 key.  The
TPU's hardware stream cannot be reproduced, so seed mode takes the port's
counter scheme with rows and columns swapped: element d of source row r is
word d mod 4 of counter (r, d div 4, 0, 0), i.e. ``philox_bits(key, src,
D).T``.  So for one key the sampler draws the transpose of
:func:`.fused_solve.make_transposed_fused_solve`'s normals with
``pair_block = block_k``, and the round-1 solve draws that solve's normals
without antithetic sampling.

On CUDA tensors each factory's function launches its kernel in
``csrc/fused_mppi.cu`` (``fused_sampler`` for a diagonal op,
``fused_sampler_op`` for a full one, in the blocks of
:func:`sampler_geometry`; kernel A's row-major round-1 path, which merges
its own partials) and raises if the launch fails; on CPU tensors it runs
its plain version (:func:`fused_sampler_plain`,
:func:`rowmajor_solve_plain`).  ``.plain`` is that version with the
factory's flags bound, on any device.  Float32 only; the products are fp32
FMAs, as the JAX dots' ``Precision.HIGHEST``.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import MPPIConfig
from . import fused_solve as FS
from .kernel_models import KernelModel


def fused_solve_block_and_pad(K: int) -> tuple:
    """The round-1 solve's K block and padded K (``pallas_rollout.py:54``):
    block 512 from K = 512 on, else 128.  K_pad fixes the shape of the
    bits."""
    block = 512 if K >= 512 else 128
    return block, -(-K // block) * block


def sampler_eligible(config: MPPIConfig, has_specific_sampler: bool, mesh) -> bool:
    """The sampling front-end composes with every rollout option; only a
    specific-action sampler, sharding and non-float32 dtypes are out
    (``pallas_rollout.py:1336``)."""
    return not has_specific_sampler and mesh is None and config.dtype == torch.float32


def _vec(name, v, n: int, device, scalar_ok: bool = False) -> torch.Tensor:
    """A contiguous float32 (n,) tensor on ``device`` from a tensor of n
    values of any shape, or, where ``scalar_ok``, from one value."""
    if not isinstance(v, torch.Tensor):
        if not scalar_ok:
            raise TypeError(f"{name} must be a tensor, got {type(v).__name__}")
        return torch.full((n,), float(v), dtype=torch.float32, device=device)
    FS._check(name, v, device, contiguous=False)
    if v.numel() == n:
        return v.reshape(n).contiguous()
    if scalar_ok and v.numel() == 1:
        return v.reshape(1).expand(n).contiguous()
    raise ValueError(f"{name} must hold {n} values{' or one' if scalar_ok else ''}, "
                     f"got shape {tuple(v.shape)}")


def _lead(seed_or_bits, shape, device):
    """(bits, key) of the noise source: the checked int32 bits and a zero
    key, or no bits and the Philox key's two words."""
    if isinstance(seed_or_bits, torch.Tensor):
        return FS._check("bits", seed_or_bits, device, dtype=torch.int32, shape=shape), (0, 0)
    return None, tuple(int(w) & 0xFFFFFFFF for w in seed_or_bits)


def _normals(seed_or_bits, src: torch.Tensor, D: int, shape) -> torch.Tensor:
    """(len(src), D) normals of the source rows ``src``; the bits are
    ``shape``."""
    if isinstance(seed_or_bits, torch.Tensor):
        bits = FS._check("bits", seed_or_bits, seed_or_bits.device, dtype=torch.int32,
                         shape=shape).to(src.device)[src]
    else:
        bits = FS.philox_bits(seed_or_bits, src, D).T
    return FS.bits_to_normal(bits)


def _sampler_op(op, D: int, diag_fast: bool, device) -> torch.Tensor:
    """The op as the config's mode takes it: D diagonal values ((D,) or
    (1, D)), or the (D, D) operator."""
    FS._check("op", op, device)
    if diag_fast:
        if op.numel() != D or op.ndim > 2 or (op.ndim == 2 and op.shape[0] != 1):
            raise ValueError(f"a diagonal sampler (diag_sigma, no noise_rho) takes op (D,) "
                             f"or (1, D) with D={D}, got {tuple(op.shape)}")
        return op.reshape(D)
    if tuple(op.shape) != (D, D):
        raise ValueError(f"a full-op sampler takes op ({D}, {D}) = kron(A_rho^T, chol^T), "
                         f"got {tuple(op.shape)}")
    return op


_SAMPLER_VECTORS = ("U2", "mu_t", "lo_t", "hi_t", "a_flat")
SAMPLER_THREADS = 256  # threads of a block of the sampler's kernels (SAMPLER_THREADS)
_SAMPLER_PANEL = 16  # op rows of a panel of the full-op kernel, at most


def sampler_geometry(D: int, full_op: bool) -> dict:
    """The blocks of the sampler's kernels (``fused_mppi_sampler_geometry``
    computes the same).  With g = ceil(D / 4) groups of four elements a row:

    * a diagonal op (``fused_sampler``): a thread per (source row, group);
      ``lanes``, the threads of a row, are g padded to a power of two up to
      32 (16 at D = 60: two rows a warp), else to a multiple of 32; a block
      takes ``rows`` = 256 / lanes rows (1 where a row is wider), so
      ``threads`` = rows · lanes; ``smem`` holds the warps' cost sums where
      a row spans warps;
    * a full op (``fused_sampler_op``): Q = 256 // g threads share a column
      group, each with ``tile`` register rows (1, 2, 4 or 12: the fewest
      that give Q · tile ≥ 32), so a block takes ``rows`` = Q · tile source
      rows; ``smem`` holds their normals, a ``panel`` of op rows (16, or
      fewer where that does not fit) and the rows' cost shares.

    Raises :class:`~.fused_solve.FusedSolveUnavailable` when the full op's
    tiles do not fit in the shared memory a block may use."""
    nt, groups = SAMPLER_THREADS, -(-D // 4)
    if not full_op:
        lanes = 1 << (groups - 1).bit_length() if groups <= 32 else -(-groups // 32) * 32
        rows = nt // lanes if lanes <= nt else 1
        return dict(rows=rows, lanes=lanes, tile=0, panel=0,
                    threads=rows * lanes if lanes <= nt else nt,
                    smem=2 * rows * (lanes // 32) * 4 if lanes > 32 else 0)
    q = nt // groups if groups < nt else 1
    tile = 1 if q >= 32 else 2 if q >= 16 else 4 if q >= 8 else 12
    rows, dp = q * tile, 4 * groups
    for panel in (16, 8, 4, 2, 1):
        smem = (rows * dp + panel * dp + 2 * rows * groups) * 4
        if smem <= FS.MAX_SMEM_BYTES:
            return dict(rows=rows, lanes=0, tile=tile, panel=panel, threads=nt, smem=smem)
    raise FS.FusedSolveUnavailable(
        f"D={D}: a full-op sampler block's tiles ({rows} rows of normals and one op row) "
        f"exceed the {FS.MAX_SMEM_BYTES} bytes of shared memory a block may use")


def sampler_source_rows(K: int, block_k: int, antithetic: bool) -> int:
    """The source rows the sampler draws: K, or under antithetic sampling
    those whose first row lies below K (block_k / 2 in each full K block)."""
    if not antithetic:
        return K
    full, rem = divmod(K, block_k)
    return full * (block_k // 2) + min(rem, block_k // 2)


def _sampler_lib():
    """The library, its sampler geometry checked once against
    :func:`sampler_geometry`."""
    lib = FS._lib()
    if not getattr(lib, "_sampler_geometry_checked", False):
        geo = (ctypes.c_longlong * 5)()
        for D in (1, 4, 15, 60, 130, 300, 1100, 3000):
            for full in (False, True):
                try:
                    mine = sampler_geometry(D, full)
                except FS.FusedSolveUnavailable:
                    mine = None
                rc = lib.fused_mppi_sampler_geometry(D, int(full), geo)
                theirs = None if rc else dict(rows=geo[0], lanes=0 if full else geo[1],
                                              tile=geo[1] if full else 0, panel=geo[2],
                                              threads=geo[3], smem=geo[4])
                if mine != theirs:
                    raise RuntimeError(f"fused_mppi_sampler_geometry(D={D}, full_op={full}) "
                                       f"gives {theirs}, sampler_geometry {mine}")
        lib._sampler_geometry_checked = True
    return lib


def fused_sampler_plain(seed_or_bits, U2, op, mu_t, lo_t, hi_t, a_flat, *, K: int, D: int,
                        block_k: int, antithetic: bool, diag_fast: bool,
                        null_action: bool, abs_cost: bool):
    """What the sampler kernel computes, in torch ops on any device.  Same
    arguments and results as the kernel's wrapper."""
    device = U2.device
    rows = -(-K // block_k) * block_k // (2 if antithetic else 1)
    src, sign = FS.source_columns(K, block_k, antithetic, device)
    z = _normals(seed_or_bits, src, D, (rows, D))
    if sign is not None:
        z = z * sign[:, None]
    op = _sampler_op(op, D, diag_fast, device)
    U2, mu_t, lo_t, hi_t, a_flat = (_vec(name, v, D, device) for name, v in
                                    zip(_SAMPLER_VECTORS, (U2, mu_t, lo_t, hi_t, a_flat)))
    perturbed = U2 + ((z * op if diag_fast else z @ op) + mu_t)
    if null_action:
        perturbed[0] = 0.0
    perturbed = torch.clamp(perturbed, lo_t, hi_t)
    n = perturbed - U2
    return perturbed, ((torch.abs(n) if abs_cost else n) * a_flat).sum(dim=1)


def make_fused_sampler(config: MPPIConfig, block_k: int = None):
    """The sampling front-end as one kernel call (see the module docstring
    for the call contract).  ``block_k`` is the antithetic pairing block and
    fixes the bits' shape: 1024 from K = 1024 on, else 128 (``K_pad`` rounds
    K up to it).  Raises ValueError for a non-float32 config, an odd
    ``block_k`` with antithetic sampling, or an ``op`` whose shape disagrees
    with the config's mode, and
    :class:`~.fused_solve.FusedSolveUnavailable` when a full op's tiles do
    not fit in a block's shared memory (:func:`sampler_geometry`).  The
    function's ``.geometry`` and ``.blocks`` are its kernel's launch."""
    K, D = config.K, config.T * config.nu
    if config.dtype != torch.float32:
        raise ValueError("the fused sampler requires float32")
    if block_k is None:
        block_k = 1024 if K >= 1024 else 128
    antithetic = bool(config.antithetic)
    if antithetic and block_k % 2:
        raise ValueError(f"antithetic sampling needs an even K block, got {block_k}")
    diag_fast = config.diag_sigma and not config.noise_rho
    geometry = sampler_geometry(D, not diag_fast)
    K_pad = -(-K // block_k) * block_k
    rows = K_pad // 2 if antithetic else K_pad
    flags = dict(K=K, D=D, block_k=block_k, antithetic=antithetic, diag_fast=diag_fast,
                 null_action=config.sample_null_action, abs_cost=config.noise_abs_cost)

    def sample(seed_or_bits, U2, op, mu_t, lo_t, hi_t, a_flat):
        device = U2.device
        op = _sampler_op(op, D, diag_fast, device)
        U2, mu_t, lo_t, hi_t, a_flat = (_vec(name, v, D, device) for name, v in
                                        zip(_SAMPLER_VECTORS, (U2, mu_t, lo_t, hi_t, a_flat)))
        bits, key = _lead(seed_or_bits, (rows, D), device)
        f32 = dict(dtype=torch.float32, device=device)
        perturbed = torch.empty((K, D), **f32)
        cost = torch.empty(K, **f32)
        lib = _sampler_lib()
        rc = lib.fused_mppi_sampler(
            FS.device_index(device), FS.stream_of(device), K, D, FS._ptr(bits), key[0],
            key[1], block_k, int(antithetic), int(config.sample_null_action),
            int(config.noise_abs_cost), int(not diag_fast), U2.data_ptr(), op.data_ptr(),
            mu_t.data_ptr(), lo_t.data_ptr(), hi_t.data_ptr(), a_flat.data_ptr(),
            perturbed.data_ptr(), cost.data_ptr())
        FS.raise_on_error(lib, rc, "fused_sampler")
        FS.launches["sampler"] += 1
        return perturbed, cost

    blocks = -(-sampler_source_rows(K, block_k, antithetic) // geometry["rows"])
    return FS.finish(sample, fused_sampler_plain, flags,
                     dict(K_pad=K_pad, block_k=block_k, bits_rows=rows, geometry=geometry,
                          blocks=blocks))


def rowmajor_solve_plain(seed_or_bits, x0, U, chol, mu, lo, hi, a_flat, lambda_, *,
                         model: KernelModel, K: int, T: int, nu: int, null_action: bool,
                         abs_cost: bool, u_scale: float):
    """What the round-1 solve's kernels compute, in torch ops on any device.
    Same arguments and results as the kernel's wrapper."""
    device = x0.device
    D = T * nu
    K_pad = fused_solve_block_and_pad(K)[1]
    z = _normals(seed_or_bits, torch.arange(K, device=device), D, (K_pad, D))
    mu = _vec("mu", mu, nu, device)
    lo, hi = (_vec(name, v, nu, device, scalar_ok=True) for name, v in (("lo", lo), ("hi", hi)))
    U2 = U.reshape(D)
    perturbed = U2 + (z.reshape(K, T, nu) @ chol.T + mu).reshape(K, D)
    if null_action:
        perturbed[0] = 0.0
    perturbed = torch.clamp(perturbed, lo.repeat(T), hi.repeat(T))
    n = perturbed - U2
    x0T = x0.reshape(-1, 1).expand(-1, K)
    cost = FS._action_cost(n.T, a_flat.reshape(D), abs_cost) + FS._rollout_total(
        model, perturbed.T, x0T, T, nu, u_scale)
    delta, m, s = FS._softmax_update(cost, lambda_, n.T)
    return delta.reshape(T, nu), m, s, cost


def make_fused_solve(config: MPPIConfig, model: KernelModel, tile_k: int = None):
    """The round-1 MPPI solve as one fused-kernel call (see the module
    docstring for the call contract).  The bits are (K_pad, D) with K_pad
    from :func:`fused_solve_block_and_pad`; only rows < K count.  As the JAX
    kernel, it ignores ``config.antithetic``, ``diag_sigma`` and
    ``noise_rho``: the noise is always ``chol @ z_t + mu``.  Raises
    ValueError for a non-float32 config or a model whose sizes differ from
    the config's, and :class:`~.fused_solve.FusedSolveUnavailable` for a
    step-dependent config (the device models take no timestep) or nx or nu
    above 32.  ``tile_k`` forces kernel A's samples a block, as for
    :func:`~.fused_solve.make_transposed_fused_solve`; kernel A's merge
    counter is its launch spec's and stream's (``fused_solve``'s
    docstring)."""
    if config.step_dependent_dynamics:
        raise FS.FusedSolveUnavailable(
            "step-dependent dynamics: the kernel's device models take no timestep")
    FS.check_kernel_model(config, model)
    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    D = T * nu
    block_k, K_pad = fused_solve_block_and_pad(K)
    # kernel A's launch with its rowmajor flag (FS.launch_kernel_a), through
    # the same operator
    spec = FS.LaunchSpec(FS.MPPI, model.model_id, K, T, nx, nu, D, 0, 0,
                         int(config.sample_null_action), int(config.noise_abs_cost), 1, 0, 1,
                         1, FS.check_tile(tile_k, K), 0, 0, rowmajor=1)
    spec_ints, u_scale = list(spec), float(config.u_scale)
    flags = dict(model=model, K=K, T=T, nu=nu, null_action=config.sample_null_action,
                 abs_cost=config.noise_abs_cost, u_scale=u_scale)

    def solve(seed_or_bits, x0, U, chol, mu, lo, hi, a_flat, lambda_):
        device = x0.device
        FS._check("x0", x0, device, shape=(nx,), contiguous=False)
        FS._check("U", U, device, shape=(T, nu))
        # a factor of any strides (torch.linalg.cholesky's are column-major)
        chol = FS._check("chol", chol, device, shape=(nu, nu), contiguous=False).contiguous()
        FS._check("a_flat", a_flat, device, shape=(D,))
        mu = _vec("mu", mu, nu, device)
        lo, hi = (_vec(name, v, nu, device, scalar_ok=True) for name, v in (("lo", lo),
                                                                            ("hi", hi)))
        lam = _vec("lambda_", lambda_, 1, device, scalar_ok=True)
        bits, key = _lead(seed_or_bits, (K_pad, D), device)
        args = (bits, key, x0, U, None, chol, mu, lo, hi, None, None, a_flat, None, lam, None,
                None, None, model.consts_on(device), None)
        if FS.via_ops():
            delta, ms, cost, _ = torch.ops.mppi_torch.kernel_a.default(*args, None, spec_ints,
                                                                       u_scale)
        else:
            delta, ms, cost, _ = FS.launch_kernel_a(spec, u_scale, *args)
        return delta.reshape(T, nu), ms[0], ms[1], cost

    geo = FS.launch_geometry(spec)
    return FS.finish(solve, rowmajor_solve_plain, flags,
                     dict(K_pad=K_pad, block_k=block_k, tile_k=spec.S,
                          tiles="shared" if geo["shared"] else "global", spec=spec))
