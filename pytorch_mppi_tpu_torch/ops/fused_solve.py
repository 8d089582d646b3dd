"""The fused MPPI, SMPPI, KMPPI and batched MPPI iterations: the CUDA
kernel's wrappers and their plain versions.

The counterparts of four of the eight TPU kernels of ``pytorch_mppi_tpu/
ops/pallas_rollout.py`` and their helpers (the other four are in
``ops/legacy.py`` and ``ops/rowmajor.py``), each with the JAX call contract:

* :func:`make_transposed_fused_solve` (``:512``) returns ``solve(seed_or_bits,
  x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_[, elites (E, D)]) ->
  (delta (D,), m, s, cost (K,)[, perturbed (D, K)])`` with ``U_new = U +
  delta / s``, the elites with ``config.num_elites``;
* :func:`make_transposed_smppi_solve` (``:755``) returns ``solve(seed_or_bits,
  x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t, ahi_t, a_flat, lambda_, w_seq,
  delta_t)``, the same results with ``delta`` in action-rate space and the
  perturbed actions after both clamps;
* :func:`make_transposed_kmppi_solve` (``:940``) returns ``solve(seed_or_bits,
  x0T, U2, theta2, op, mu_p, lop, hip, lo_t, hi_t, a_flat, Wt, lambda_)``
  with ``delta`` of Dp = nsp·nu rows (``theta_new = theta + delta / s``)
  and the full-horizon perturbed actions;
* :func:`make_transposed_batched_solve` (``:1118``) returns ``solve(lead,
  x0T (nx, N), U2T (D, N), op, mu_t, lo_t, hi_t, aT (D, N), lambda_) ->
  (delta (D, N), ms (2, N), cost (N, K))`` for N plants that share one
  noise draw, each with its own softmax: ``U_new = U + (delta / ms[1]).T``.

Each is built for a :class:`~.kernel_models.KernelModel` (a named one, or
one traced from the user's callables, ``ops/batch_last.py``, whose kernels
come from a library of its own: :func:`library_of`), and optionally a
final-state terminal cost (``terminal_final``: a
:func:`~.kernel_models.quadratic_terminal`, or any callable the tracer
takes):

* on CUDA tensors it launches ``csrc/fused_mppi.cu`` and raises if the
  launch fails: kernel A, whose blocks take :func:`tile_samples` samples
  each and whose last block to finish merges the per-block softmax
  statistics (one launch a call); or for N plants ``batched_partial``, one
  thread per sample for a group of :func:`plant_group` plants, then kernel
  B, the merge (two launches);
* on CPU tensors it runs its plain version (:func:`fused_solve_plain`,
  :func:`smppi_solve_plain`, :func:`kmppi_solve_plain`), the same function in
  plain torch ops on (rows, K) tensors (:func:`batched_solve_plain` on
  (N, D, K) ones); ``solve.plain`` is that version with the solve's flags
  bound, on any device.

``seed_or_bits`` selects the noise source.  An (R, K_pad) int32 tensor —
(R, K_pad/2) with antithetic sampling, R the drawn rows (D, or Dp for KMPPI)
— injects the random bits, as the JAX kernel's ``rng_in_kernel=False``; a
pair of 32-bit ints is a Philox4x32-10 key, and the kernel draws its own
bits; a (2,) int32 tensor on the solve's device holds such a key, which the
kernel reads when it runs (:func:`is_device_key`: the key buffer of a
command, which a CUDA graph of the command reads at each replay).  Word w of Philox counter (c, g, 0, 0) is the bits of row 4g + w of
source column c.  The batched solve also takes ``noise_operand=True``: its
``lead`` is then the final (D, ≥K) float32 noise, and the kernel draws
nothing.

Antithetic pairs sit inside pairing blocks of ``pair_block`` samples: sample
j of block b takes source column b·pair_block/2 + j for j < pair_block/2,
and the negated draw of column b·pair_block/2 + j − pair_block/2 otherwise.
This is the JAX kernel's pairing with its ``block_k``; the default block is
all of K (rounded up to even), which pairs rows k and K/2 + k as
``solve.sample_noise_flat`` does.  The pairing is independent of the CUDA
block size.

Float32 only.  Normals come from Giles' single-precision erfinv, the
polynomial XLA uses for ``erf_inv``, in both the kernel and the plain version.
The kernel keeps its per-block tiles in shared memory when they fit in
Hopper's 227 KB, else in a global scratch; the per-sample device models hold
nx and nu up to 32 in registers, a block model (and a per-sample program
beyond 32) in shared memory.  Kernel A's merge counts its finished blocks in
an int32 counter allocated once per launch configuration
(:class:`LaunchSpec`), device and stream: launches on one stream run in
order, and launches on two streams never share a counter.

The wrappers launch through :func:`launch_kernel_a`, directly or through
the ``torch.library`` operators of ``ops/library.py`` (:func:`via_ops`),
which ``torch.export`` records in a deployed command (``utils/deploy.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import MPPIConfig
from . import batch_last as BL
from . import kernel_models as KM
from .kernel_models import KernelModel, KernelTerminal

MPPI, SMPPI, KMPPI, BATCHED = 0, 1, 2, 3  # the kernel's variants (Variant in fused_mppi.cu)
VARIANTS = ("mppi", "smppi", "kmppi")  # the single-plant variants
# every kernel of fused_mppi.cu by the name of its launch count, one for each
# of the eight TPU kernels: the four variants of kernel A (each with kernel
# B), the legacy route's rollout and weighted update (ops/legacy.py), and the
# sampling front-end and the row-major round-1 solve (ops/rowmajor.py)
KERNELS = VARIANTS + ("batched", "rollout", "weighted_update", "sampler", "rowmajor")
ROLLOUT = 4  # the legacy rollout's Variant (kRollout in fused_mppi.cu)
# the kernels of a generated model's library (ops/batch_last.py), by the name of
# their launch count: kernel A's variants, the batched pair and the legacy rollout
GENERATED_KERNELS = tuple(f"generated_{k}" for k in VARIANTS + ("batched", "rollout"))
# the same kernels with a block model (kernel_models.RESIDUAL_MLP_BLOCK, or a
# generated model with dense layers), whose layers a block's threads compute
# together: their launches count apart (launch_name)
BLOCK_KERNELS = tuple(f"{k}_block" for k in VARIANTS + ("batched", "rollout"))
GENERATED_BLOCK_KERNELS = tuple(f"generated_{k}" for k in BLOCK_KERNELS)

# kernel launches (each kernel launched counts one); chip_smoke.py reads them.
# Two set-up runs put the counts back as they found them, so that a count
# is the launches of the commands a caller made: the warm-up and capture of
# runner._GraphLoop (a replay then counts its captured launches) and the run
# of each command before utils/deploy.export_solver traces it.
launches = dict.fromkeys(KERNELS + GENERATED_KERNELS + BLOCK_KERNELS + GENERATED_BLOCK_KERNELS,
                         0)

MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
SM_SMEM_BYTES = 233_472  # shared memory of an SM on Hopper (228 KB)
BLOCK_SMEM_RESERVED = 1024  # shared memory the runtime keeps for each block
# a block model's kernels take at least this many blocks an SM where shared
# memory allows (activation_rows): with two, one block's layers run while
# the other waits at a barrier; kernel A takes three (its registers are held
# to three blocks' worth, BLOCK_MODEL_BLOCKS in fused_mppi.cu), so that its
# 313 blocks of K = 10,000 run in one wave on 132 SMs
OCCUPANCY_TARGET = 2
KERNEL_A_BLOCK_BLOCKS = 3
_BLOCK = 128  # threads of a block, and samples of a block of batched_partial (BLOCK)
_MAXN = 32  # largest nx or nu of a device model (MAXN in fused_mppi.cu)
TILES = (32, 64, 128)  # the samples a block of kernel A may take
_MERGE_CHUNK_A = 512  # block scales kernel A's merge holds at a time
_HEAD = 32 + 2 * _BLOCK + _MERGE_CHUNK_A  # floats of kernel A's shared memory before its panel
_NVEC = 9  # the row vectors of D floats kernel A stages in shared memory
_ROW_TILE = 8  # rows of a thread's register tile in kernel A's products
_PANEL_COLS = 160  # columns of a panel of the operator of kernel A's products
H100_SMS = 132  # the SMs of an H100 SXM, where no card can be asked
# batched_partial: at most this many plants share one block's noise tile, and
# the grid keeps at least FILL_BLOCKS blocks (two on each SM) where N and K
# allow.  chip_smoke.py's sweep over P = 1-32 on an NVIDIA H100 80GB HBM3 at
# 700 W: at N = 1,024, K = 16,384 the device time falls until P = 16-32; at
# N = 16, K = 10,240, P = 4 (320 blocks) was as fast as P = 2 in operand mode
# and 7 % faster in seed mode (PERF.md).
PLANT_GROUP_MAX = 32
FILL_BLOCKS = 2 * H100_SMS

_sm_counts = {}


def sm_count() -> int:
    """The streaming multiprocessors of the current CUDA device, read once
    per device; the H100's 132 where there is no card (the factories are
    built before they see a tensor, and the CPU tests run their plain
    versions)."""
    if not torch.cuda.is_available():
        return H100_SMS
    index = torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def tile_samples(K: int, sms: int = H100_SMS) -> int:
    """S, the samples one block of kernel A takes: the largest of ``TILES``
    whose grid of ceil(K / S) blocks still gives each of the ``sms`` SMs two
    blocks, else the smallest.  Fewer samples a block split a block's draw,
    transform and update over more threads a sample and fill more SMs; more
    samples a block leave fewer partials to merge.  chip_smoke.py's sweep
    on an NVIDIA H100 80GB HBM3 at 700 W found S = 32 fastest at K = 1,000
    and 10,000, D = 60 and D = 300 (PERF.md)."""
    for S in TILES[:0:-1]:
        if -(-K // S) >= 2 * sms:
            return S
    return TILES[0]


class FusedSolveUnavailable(ValueError):
    """A configuration the fused kernel cannot take; routing falls back to
    the plain path."""


ELITE_WINDOW = 128  # the null row and the elites fit in JAX's one lane block


def transposed_eligible(config: MPPIConfig, has_specific_sampler: bool = False) -> bool:
    """Static eligibility for the fused kernel (``pallas_rollout.py:259-283``):
    one deterministic rollout a sample (M = 1, no ``stochastic_dynamics``),
    float32, no ``parameterized_dynamics`` (a device model holds its
    constants, not the controller's ``dynamics_params``), no specific-action
    sampler (its rows or its dynamics hook),
    and elite reuse only with ``fused_artifacts`` (the refresh reads the
    perturbed set the kernel emits) and with the null row and the elites
    within ``ELITE_WINDOW`` samples."""
    elites_ok = config.num_elites == 0 or (
        config.fused_artifacts
        and config.num_elites + (1 if config.sample_null_action else 0) <= ELITE_WINDOW)
    return (config.M == 1 and not has_specific_sampler and elites_ok
            and not config.stochastic_dynamics and not config.parameterized_dynamics
            and config.dtype == torch.float32)


def smem_bytes(variant: int, D: int, R: int, full_op: bool, S: int = _BLOCK) -> int:
    """Dynamic shared memory of kernel A with S samples a block and its
    tiles in shared memory (``fused_mppi_smem_bytes``): 32 reduction slots,
    two BLOCK vectors and 512 merge scales; an operator panel of
    (BLOCK / S) · 8 rows of min(R, 160) floats where the kernel computes a
    product (a full operator, KMPPI's interpolation), rounded up to four
    floats; nine
    row vectors of D floats; then one (D, S + 1) tile (MPPI with a diagonal
    scale) or two.  The batched kernel holds two BLOCK
    vectors, 32 reduction slots and two buffers of R (U, lo, hi, a)
    quadruples beside its tiles of R rows of BLOCK + 4 floats, one, or two
    with a full op."""
    if variant == BATCHED:
        return (2 * _BLOCK + 32 + 8 * R + (2 if full_op else 1) * R * (_BLOCK + 4)) * 4
    return (_HEAD + panel_floats(variant, full_op, R, S) + _NVEC * D
            + partial_tiles(variant, full_op) * D * (S + 1)) * 4


def panel_floats(variant: int, full_op: bool, R: int, S: int) -> int:
    """Kernel A's operator panel (``panel_floats`` in fused_mppi.cu): (BLOCK
    / S) · 8 rows of min(R, 160) floats, rounded up to four, where it
    computes a product (a full operator, KMPPI's interpolation); else 0."""
    return (-(-(_BLOCK // S * _ROW_TILE * min(R, _PANEL_COLS)) // 4) * 4
            if full_op or variant == KMPPI else 0)


def base_smem_bytes(variant: int, D: int, R: int, full_op: bool, S: int, shared: bool) -> int:
    """:func:`smem_bytes` with the tiles in shared memory (``shared``) or in
    a global scratch (none of them in shared memory)."""
    if shared:
        return smem_bytes(variant, D, R, full_op, S)
    tiles = ((2 if full_op else 1) * R * (_BLOCK + 4) if variant == BATCHED
             else partial_tiles(variant, full_op) * D * (S + 1))
    return smem_bytes(variant, D, R, full_op, S) - 4 * tiles


def act_stride(ld: int) -> int:
    """Floats between two activation rows of a block model in shared memory
    (``act_stride`` in fused_mppi.cu): ``ld`` rounded up to eight (an mma's
    depth), then to 8 mod 32, so that a warp's 8-byte A-fragment loads and
    epilogue stores are free of bank conflicts."""
    r = -(-ld // 8) * 8
    return r + (40 - r % 32) % 32


def state_ld(nx: int, nu: int) -> int:
    """Floats of a block model's row of per-sample values (state, action,
    SMPPI's previous action), an odd count (``state_ld`` in fused_mppi.cu)."""
    return (nx + 2 * nu) | 1


def activation_bytes(base: int, rows: int, ld: int, slots: int = 0, nx: int = 0,
                     nu: int = 0, least: int = 0) -> int:
    """A block model's kernel's dynamic shared memory: ``base`` bytes of the
    kernel's own, rounded up to 16, then two halves of ``rows`` activation
    rows of :func:`act_stride` floats and ``slots`` rows of per-sample values,
    at least ``least`` floats (kernel A's operator panel, which they hold
    before the layers run; ``kernel_smem`` in fused_mppi.cu)."""
    block = 2 * rows * act_stride(ld) + slots * state_ld(nx, nu)
    return -(-base // 16) * 16 + 4 * max(block, least)


def blocks_per_sm(smem: int) -> int:
    """The blocks of ``smem`` bytes of dynamic shared memory an H100's SM
    holds: its 228 KB, less 1 KB the runtime keeps for each block."""
    return SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED)


def activation_rows(slots: int, ld: int, bases, nx: int = 0, nu: int = 0,
                    target: int = None, least: int = 0) -> tuple:
    """``(rows, index)``: a block model's group of samples, of the ``slots``
    samples of a block halved down to ``kernel_models.DENSE_TILE`` (one m16
    tile), and the index of the one of the ``bases`` (bytes of the kernel's
    own: its tiles in shared memory, or in a global scratch) it runs
    beside, chosen by occupancy: the most blocks an SM up to ``target``
    (``OCCUPANCY_TARGET`` by default; :func:`blocks_per_sm`), then the
    larger group (fewer barriers, and each weight read for more samples),
    then the earlier base (each with at least ``least`` floats after it:
    :func:`activation_bytes`); a group of ``kernel_models.DENSE_ROWS`` (half
    a tile, whose other half the tensor cores compute from zeros) only
    where no whole tile fits, for the widest layers; ``(0, None)`` where
    none fits in a block's shared memory."""
    target = target or OCCUPANCY_TARGET
    best, pick = None, (0, None)
    rows = slots
    while rows >= KM.DENSE_TILE or (rows >= KM.DENSE_ROWS and not pick[0]):
        for i, base in enumerate(bases):
            smem = activation_bytes(base, rows, ld, slots, nx, nu, least)
            if smem <= MAX_SMEM_BYTES:
                key = (min(blocks_per_sm(smem), target), rows, -i)
                if best is None or key > best:
                    best, pick = key, (rows, i)
        rows //= 2
    return pick


def kernel_a_blocks(act_ld: int, nx: int, nu: int) -> int:
    """Kernel A's blocks an SM for a block model, to which its launch
    bounds hold its registers (``kBlocks`` in a generated model's struct,
    fused_mppi.cu's ``kBlocksOf``): ``KERNEL_A_BLOCK_BLOCKS`` where a whole
    m16 tile of samples' activations and the rows of 32 samples' state,
    beside kernel A's head, let that many blocks share an SM; else two (at
    TD-MPC's 512 units shared memory holds two, and at three blocks' 168
    registers a thread its kernel A spilled)."""
    smem = activation_bytes(4 * (_HEAD - _MERGE_CHUNK_A), KM.DENSE_TILE, act_ld, TILES[0], nx, nu)
    return KERNEL_A_BLOCK_BLOCKS if blocks_per_sm(smem) >= KERNEL_A_BLOCK_BLOCKS else 2


def partial_tiles(variant: int, full_op: bool) -> int:
    """Kernel A's (D, S) tiles: one for MPPI with a diagonal scale, else two."""
    return 1 if variant == MPPI and not full_op else 2


def plant_group(num_plants: int, nblocks: int, fill_blocks: int = FILL_BLOCKS) -> int:
    """P, the plants one block of the batched kernel takes: the largest P up
    to ``PLANT_GROUP_MAX`` whose grid of ``nblocks · ceil(N / P)`` blocks
    still holds ``fill_blocks`` (two a SM), then spread evenly over that many
    groups (``ceil(N / groups)``); 1 when even one plant a block underfills
    the card.  Each block draws or loads its noise tile once for its P
    plants."""
    for P in range(min(PLANT_GROUP_MAX, num_plants), 1, -1):
        groups = -(-num_plants // P)
        if nblocks * groups >= fill_blocks:
            return -(-num_plants // groups)
    return 1


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
    tensors of uint32 values, ``key`` two ints or a (2,) int32 key tensor
    (:func:`key_words`); returns the four output words (Random123's
    ``philox4x32``)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key_words(key)
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


def is_device_key(lead) -> bool:
    """A Philox key held in memory: a (2,) int32 tensor of the key's words
    (the command's key buffer, written before the kernel runs), where bits
    are an (R, cols) int32 tensor."""
    return isinstance(lead, torch.Tensor) and lead.dtype == torch.int32 and lead.ndim == 1


def key_words(key):
    """The key's two words as uint32 values (in int64): from a pair of ints,
    or from a (2,) int32 key tensor without a copy to the host."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64) & _M32
        return k[0], k[1]
    return key[0] & _M32, key[1] & _M32


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


def source_columns(K: int, pair_block: int, antithetic: bool, device, k_offset: int = 0):
    """Source column of every sample and its antithetic sign (None without
    antithetic sampling); the K samples of a shard are the global samples
    ``k_offset`` to ``k_offset + K - 1``."""
    k = torch.arange(k_offset, k_offset + K, device=device)
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
# The plain versions
# ---------------------------------------------------------------------------


def _noise(seed_or_bits, R: int, K: int, pair_block: int, antithetic: bool, op,
           mu, device, k_offset: int = 0):
    """(R, K) noise of the drawn rows: the normals of each sample's source
    column, the antithetic sign, then the diagonal scale or ``op @ z``."""
    src, sign = source_columns(K, pair_block, antithetic, device, k_offset)
    if is_device_key(seed_or_bits):
        bits = philox_bits(seed_or_bits.to(device), src, R)
    elif isinstance(seed_or_bits, torch.Tensor):
        bits = seed_or_bits.to(device)[:, src]
    else:
        bits = philox_bits(seed_or_bits, src, R)
    z = bits_to_normal(bits)
    if sign is not None:
        z = z * sign
    if op.ndim == 1:
        return z * op[:, None] + mu[:, None]
    return op @ z + mu[:, None]


def _action_cost(n, a_flat, abs_cost: bool):
    return ((torch.abs(n) if abs_cost else n) * a_flat[:, None]).sum(dim=0)


def _rollout_total(model: KernelModel, perturbed, x0T, T: int, nu: int, u_scale: float,
                   terminal: KernelTerminal = None):
    """(K,) running cost of the T-step rollout of the (D, K) actions, plus
    the terminal cost of the final state and the last scaled action
    (``_tp_rollout_total``, pallas_rollout.py:413-442)."""
    state = x0T.T
    total = torch.zeros(perturbed.shape[1], dtype=torch.float32, device=perturbed.device)
    for t in range(T):
        u_t = perturbed[t * nu:(t + 1) * nu].T
        if u_scale != 1.0:
            u_t = u_t * u_scale
        state, c = model.rollout_step(state, u_t, t)
        total = total + c
    if terminal is not None:
        total = total + terminal.cost(state, u_t)
    return total


def _softmax_update(cost, lambda_, upd):
    """(delta, m, s) of the update ``upd`` (R, K) under the weights of the
    costs: the un-normalised weights against the largest logit."""
    logits = -cost / lambda_
    m = torch.amax(logits)
    w = torch.exp(logits - m)
    return upd @ w, m, torch.sum(w)


def _null_row(perturbed, null_action: bool, gate=None):
    """Sample 0 as the null action, where the (1,) int32 ``gate`` is not 0
    if one is given (one shard of the samples); on a fresh tensor of the
    caller's."""
    if null_action:
        if gate is None:
            perturbed[:, 0] = 0.0
        else:
            on = gate.to(perturbed.device).reshape(()) != 0
            perturbed[:, 0] = torch.where(on, 0.0, perturbed[:, 0])
    return perturbed


def _elite_columns(perturbed, elites, null_action: bool):
    """The (E, D) elites into the columns [off, off + E) of the fresh (D, K)
    perturbed set, off = 1 after the null row (``pallas_rollout.py:
    638-644``): before the clamp, each over its own draw."""
    if elites is not None:
        off = 1 if null_action else 0
        perturbed[:, off:off + elites.shape[0]] = elites.to(perturbed.device).T
    return perturbed


def fused_solve_plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
                      lambda_, elites=None, gate=None, *, model: KernelModel, K: int, T: int,
                      nu: int, antithetic: bool = False, null_action: bool = False,
                      abs_cost: bool = False, u_scale: float = 1.0,
                      emit_perturbed: bool = False, pair_block: int = None,
                      terminal: KernelTerminal = None, k_offset: int = 0):
    """What the fused MPPI kernel computes, in torch ops on (D, K) tensors of
    any device.  Same arguments and results as the kernel's wrapper; the
    (E, D) ``elites`` take the samples after the null row before the
    clamp, the null row only where the (1,) int32 ``gate`` is not 0 if one
    is given, and sample k draws the noise of global sample ``k_offset`` +
    k (one shard of the samples)."""
    D = T * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, D, K, pair_block, antithetic, op, mu_t, x0T.device, k_offset)
    U_col = U2.reshape(D, 1)
    perturbed = _elite_columns(_null_row(U_col + noise, null_action, gate), elites,
                               null_action)
    perturbed = torch.clamp(perturbed, lo_t[:, None], hi_t[:, None])
    n = perturbed - U_col
    cost = _action_cost(n, a_flat, abs_cost) + _rollout_total(
        model, perturbed, x0T, T, nu, u_scale, terminal)
    out = _softmax_update(cost, lambda_, n) + (cost,)
    return out + (perturbed,) if emit_perturbed else out


def smppi_solve_plain(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t,
                      ahi_t, a_flat, lambda_, w_seq, delta_t, gate=None, *,
                      model: KernelModel, K: int, T: int, nu: int, antithetic: bool = False,
                      null_action: bool = False, abs_cost: bool = False,
                      u_scale: float = 1.0, emit_perturbed: bool = False,
                      pair_block: int = None, terminal: KernelTerminal = None,
                      k_offset: int = 0):
    """What the fused SMPPI kernel computes (pallas_rollout.py:829-861): the
    rate clamp, the integration, the null row, the action clamp, the noise
    back-computed through both clamps, the smoothness cost; ``delta`` is in
    rate space and the perturbed actions are the action-space ones.
    ``gate`` and ``k_offset`` as for :func:`fused_solve_plain`."""
    D = T * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, D, K, pair_block, antithetic, op, mu_t, x0T.device, k_offset)
    U_col, as_col = U2.reshape(D, 1), as2.reshape(D, 1)
    rate = torch.clamp(U_col + noise, lo_t[:, None], hi_t[:, None])
    pert_act = _null_row(as_col + rate * delta_t, null_action, gate)
    pert_act = torch.clamp(pert_act, alo_t[:, None], ahi_t[:, None])
    n = (pert_act - as_col) / delta_t - U_col  # mppi.py:552
    diff = pert_act[nu:] - pert_act[:-nu]
    if u_scale != 1.0:
        diff = diff * u_scale
    smooth = w_seq * torch.sum(diff * diff, dim=0)
    cost = (_action_cost(n, a_flat, abs_cost) + smooth) + _rollout_total(
        model, pert_act, x0T, T, nu, u_scale, terminal)
    out = _softmax_update(cost, lambda_, n) + (cost,)
    return out + (pert_act,) if emit_perturbed else out


def kmppi_solve_plain(seed_or_bits, x0T, U2, theta2, op, mu_p, lop, hip, lo_t,
                      hi_t, a_flat, Wt, lambda_, gate=None, *, model: KernelModel, K: int,
                      T: int, nu: int, nsp: int, antithetic: bool = False,
                      null_action: bool = False, abs_cost: bool = False,
                      u_scale: float = 1.0, emit_perturbed: bool = False,
                      pair_block: int = None, terminal: KernelTerminal = None,
                      k_offset: int = 0):
    """What the fused KMPPI kernel computes (pallas_rollout.py:1011-1040):
    support-point noise clamped there, interpolated to the full horizon by
    ``Wt`` (D, Dp) in float32, the null row, the trajectory clamp; ``delta``
    has Dp rows (theta space).  ``gate`` and ``k_offset`` as for
    :func:`fused_solve_plain`."""
    D, Dp = T * nu, nsp * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, Dp, K, pair_block, antithetic, op, mu_p, x0T.device, k_offset)
    th_col = theta2.reshape(Dp, 1)
    pts = torch.clamp(th_col + noise, lop[:, None], hip[:, None])
    perturbed = _null_row(Wt @ pts, null_action, gate)
    perturbed = torch.clamp(perturbed, lo_t[:, None], hi_t[:, None])
    n = perturbed - U2.reshape(D, 1)
    cost = _action_cost(n, a_flat, abs_cost) + _rollout_total(
        model, perturbed, x0T, T, nu, u_scale, terminal)
    out = _softmax_update(cost, lambda_, pts - th_col) + (cost,)
    return out + (perturbed,) if emit_perturbed else out


def batched_solve_plain(lead, x0T, U2T, op, mu_t, lo_t, hi_t, aT, lambda_, *,
                        model: KernelModel, K: int, T: int, nu: int,
                        antithetic: bool = False, abs_cost: bool = False,
                        u_scale: float = 1.0, pair_block: int = None,
                        noise_operand: bool = False, terminal: KernelTerminal = None):
    """What the batched MPPI kernel computes (pallas_rollout.py:1218-1242),
    on (N, D, K) tensors: one (D, K) noise shared by the N plants (drawn as
    :func:`fused_solve_plain` draws it, or the first K columns of the
    operand), each plant's clamp ``clip(U_n + noise, lo, hi)`` with no
    null-action row, its rectified noise and action cost (column n of
    ``aT``), the rollout from its column of ``x0T``, and one softmax per
    plant.  Same arguments and results as the kernel's wrapper."""
    D = T * nu
    N = x0T.shape[1]
    pair_block = pair_block or K + K % 2
    if noise_operand:
        # the wrapper's check: bits or a key are no noise
        noise = _check("noise", lead, lead.device, contiguous=False)[:, :K].to(x0T.device)
    else:
        noise = _noise(lead, D, K, pair_block, antithetic, op, mu_t, x0T.device)
    U_col = U2T.T[:, :, None]  # (N, D, 1)
    perturbed = torch.clamp(U_col + noise[None], lo_t[:, None], hi_t[:, None])
    n = perturbed - U_col
    pc = ((torch.abs(n) if abs_cost else n) * aT.T[:, :, None]).sum(dim=1)
    # the N·K rollouts as one flat batch, plant-major
    flat = perturbed.permute(1, 0, 2).reshape(D, N * K)
    x0_flat = x0T.repeat_interleave(K, dim=1)
    cost = pc + _rollout_total(model, flat, x0_flat, T, nu, u_scale, terminal).reshape(N, K)
    logits = -cost / lambda_
    m = torch.amax(logits, dim=1)
    w = torch.exp(logits - m[:, None])
    delta = torch.einsum("ndk,nk->dn", n, w)
    return delta, torch.stack([m, w.sum(dim=1)]), cost


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _set_argtypes(lib, generated: bool = False):
    """Declare the C entries of a loaded library: the named library's all,
    a generated one's launch, round-1 solve and rollout entries."""
    lib.fused_mppi_launch.argtypes = [
        _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, ctypes.c_uint32,
        ctypes.c_uint32, _P, _I, _I, _I, _I, _P, _L, _L, _P, _P, _P, _I, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P,
        _P, _P, _P, _I, _L, _L, _L, _L, _P, _L, _I, _I, _P, _P, _P, _I, _I, _P, _I,
        _I, _I,
    ]
    lib.fused_mppi_rollout.argtypes = [_I, _P, _I, _P, _I, _I, _I, _I, _P, _L, _L,
                                       _P, _P, _I, _I, _I]
    lib.fused_mppi_rollout_geometry.argtypes = [_I, _I, _I, _P]
    lib.fused_mppi_rollout_geometry.restype = _I
    lib.fused_mppi_rowmajor_solve.argtypes = [
        _I, _P, _I, _P, _I, _I, _I, _I, _P, ctypes.c_uint32, ctypes.c_uint32, _I,
        _I, _P, _L, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P,
        _I, _P, _I, _I,
    ]
    for fn in (lib.fused_mppi_launch, lib.fused_mppi_rollout, lib.fused_mppi_rowmajor_solve):
        fn.restype = _I
    lib.fused_mppi_error_string.argtypes = [_I]
    lib.fused_mppi_error_string.restype = ctypes.c_char_p
    if generated:
        return
    lib.fused_mppi_weighted_update.argtypes = [_I, _P, _I, _I, _I, _P, _P, _L, _P, _P,
                                               _P, _P, _P]
    lib.fused_mppi_weighted_group.argtypes = [_I]
    for fn in (lib.fused_mppi_weighted_group, lib.fused_mppi_weighted_counters):
        fn.restype = _I
    lib.fused_mppi_sampler.argtypes = [
        _I, _P, _I, _I, _P, ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    for fn in (lib.fused_mppi_weighted_update, lib.fused_mppi_sampler):
        fn.restype = _I
    lib.fused_mppi_sampler_geometry.argtypes = [_I, _I, _P]
    lib.fused_mppi_sampler_geometry.restype = _I
    lib.fused_mppi_block.restype = _I
    lib.fused_mppi_max_n.restype = _I
    lib.fused_mppi_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
    lib.fused_mppi_smem_bytes.restype = ctypes.c_longlong
    if lib.fused_mppi_block() != _BLOCK or lib.fused_mppi_max_n() != _MAXN:
        raise RuntimeError("fused_mppi.cu BLOCK or MAXN differs from fused_solve")
    lib.fused_mppi_mlp_limit.argtypes = [_I]
    lib.fused_mppi_mlp_limit.restype = _I
    if [lib.fused_mppi_mlp_limit(i) for i in range(8)] != [
            KM.MLP_HEAD, KM.MLP_MAX_WIDTH, KM.MLP_MAX_LAYERS, KM.MLP_GROUP, KM.MLP_GOAL,
            KM.MLP_MAX_N, KM.BMLP_FIXED, KM.DENSE_ROWS]:
        raise RuntimeError("fused_mppi.cu's ResidualMLP layout differs from kernel_models")
    if any(lib.fused_mppi_smem_bytes(v, D, R, f, S) != smem_bytes(v, D, R, bool(f), S)
           for v in (MPPI, SMPPI, KMPPI, BATCHED) for D, R in ((60, 30), (60, 60), (300, 300))
           for f in (0, 1) for S in TILES):
        raise RuntimeError("fused_mppi_smem_bytes differs from fused_solve.smem_bytes")


def _lib():
    """The named models' library, built and declared on first use."""
    from . import _build

    lib = _build.load()
    if not getattr(lib, "_argtypes_set", False):
        _set_argtypes(lib)
        lib._argtypes_set = True
    return lib


def library_of(model_id: int, variant: int):
    """The library whose kernels run ``model_id``'s ``variant``: the named
    library, or a generated model's own (``ops/batch_last.py``), built on
    first use."""
    if model_id < BL.GENERATED:
        return _lib()
    lib = BL.kernel_of(model_id).library(variant)
    if not getattr(lib, "_argtypes_set", False):
        _set_argtypes(lib, generated=True)
        lib._argtypes_set = True
    return lib


def is_block(model_id: int) -> bool:
    """Whether ``model_id``'s kernels run a block model: the named
    ``ResidualMLPBlock``, or a generated kernel with dense layers (or on
    ``ResidualMLPBlock``)."""
    if model_id >= BL.GENERATED:
        return BL.kernel_of(model_id).block
    return model_id == KM.RESIDUAL_MLP_BLOCK


def launch_name(model_id: int, kernel: str) -> str:
    """The launch count of ``kernel`` (a name of :data:`KERNELS`) for
    ``model_id``: its own, or its generated counterpart's, each with
    ``_block`` for a block model (:func:`is_block`)."""
    if kernel in VARIANTS + ("batched", "rollout") and is_block(model_id):
        kernel = f"{kernel}_block"
    return kernel if model_id < BL.GENERATED else f"generated_{kernel}"


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


def _ptr(t):
    return t.data_ptr() if t is not None else None


def device_index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.fused_mppi_error_string(rc).decode()})")


def as_kernel_model(config: MPPIConfig, model, terminal: KernelTerminal = None) -> KernelModel:
    """The device model a factory's kernels run for its ``model`` beside
    ``terminal``: a :class:`~.kernel_models.KernelModel`, or a ``(dynamics,
    running_cost)`` pair of the user's callables, which keeps the named
    model it carries or is traced into a generated one
    (:func:`~.batch_last.kernel_model`); a named per-sample model that its
    struct cannot run (beyond 32 states or actions, or beside a traced
    terminal cost with dense layers) is traced from its callables
    (:func:`~.batch_last.kernel_device_model`).  UnsupportedPrimitive where a
    trace fails."""
    if isinstance(model, tuple):
        model = BL.kernel_model(config, *model)
    return BL.kernel_device_model(config, model, terminal)


def check_kernel_model(config: MPPIConfig, model: KernelModel, act_ld: int = None):
    """The checks every kernel of ``fused_mppi.cu`` makes of its config and
    device model; ``act_ld`` the kernel's activation row where a traced
    terminal cost's layers widen it (``batch_last.kernel_act_ld``), else
    the model's.  A per-sample model holds at most ``MAXN`` states and
    actions (register arrays); a block model keeps them in shared memory,
    bounded, with its activations, by a block's."""
    nx, nu = config.nx, config.nu
    if config.dtype != torch.float32:
        raise ValueError("the fused solve requires float32")
    if (model.nx, model.nu) != (nx, nu):
        raise ValueError(
            f"kernel model {model.name!r} is (nx={model.nx}, nu={model.nu}); "
            f"the config is (nx={nx}, nu={nu})")
    ld = KM.activation_ld(model) if act_ld is None else act_ld
    if not ld and max(nx, nu) > _MAXN:
        raise FusedSolveUnavailable(
            f"nx={nx}, nu={nu}: the named per-sample device model {model.name!r} holds at most "
            f"{_MAXN} of each in registers (the trace of its callables, which keeps them in "
            f"shared memory, takes a config without step_dependent_dynamics)")
    if config.step_dependent_dynamics and not isinstance(model, BL.GeneratedModel):
        raise FusedSolveUnavailable(
            f"step_dependent_dynamics with the named kernel model {model.name!r}, which takes "
            f"no timestep (only a traced model does: ops/batch_last.py)")
    room = MAX_SMEM_BYTES - 4 * _HEAD
    if ld and activation_bytes(0, KM.DENSE_ROWS, ld, _BLOCK, nx, nu) > room:
        what = ("the residual MLP's block kernels" if model.model_id == KM.RESIDUAL_MLP_BLOCK
                else "a per-sample program's block kernels" if ld == BL.ROWS_LD
                else "a block model's kernels")
        rows = room - 4 * _BLOCK * state_ld(nx, nu)
        states = (room - activation_bytes(0, KM.DENSE_ROWS, ld)) // (4 * _BLOCK)
        raise FusedSolveUnavailable(
            f"{what} keep two activation rows of the widest layer for each of at least "
            f"{KM.DENSE_ROWS} samples, and a row of state and action (nx + 2 nu floats) for "
            f"each of {_BLOCK}, in shared memory beside their own, of the {MAX_SMEM_BYTES} "
            f"bytes a block may use: widths up to about {rows // (8 * KM.DENSE_ROWS) - 32} and "
            f"nx + 2 nu up to about {max(states - 1, 0)} here; the widest layer here needs {ld} "
            f"floats a row ({activation_bytes(0, KM.DENSE_ROWS, ld)} bytes), and nx + 2 nu is "
            f"{nx + 2 * nu}")
    if model.model_id == KM.RESIDUAL_MLP:
        head = KM.mlp_header(model.consts)
        if (max(nx, nu) > KM.MLP_MAX_N or head["layers"] > KM.MLP_MAX_LAYERS
                or max(head["widths"]) > KM.MLP_MAX_WIDTH):
            raise FusedSolveUnavailable(
                f"the residual MLP's kernel takes nx, nu <= {KM.MLP_MAX_N} and at most "
                f"{KM.MLP_MAX_LAYERS} layers of at most {KM.MLP_MAX_WIDTH} units; this one has "
                f"nx={nx}, nu={nu} and {head['layers']} layers, widths {head['widths']}")


def check_tile(tile_k, K: int) -> int:
    """Kernel A's samples a block: ``tile_k`` where given (one of
    ``TILES``), else the rule of :func:`tile_samples` on the current
    device."""
    S = tile_k or tile_samples(K, sm_count())
    if S not in TILES:
        raise ValueError(f"tile_k must be one of {TILES}, got {tile_k}")
    return S


def merge_counter(counters: dict, device, size: int = 1) -> torch.Tensor:
    """The int32 counter (``size`` of them) of an in-kernel merge for
    ``device``, zeroed once when first used there; the kernel sets it back
    to 0."""
    counter = counters.get(device)
    if counter is None:
        counter = counters[device] = torch.zeros(size, dtype=torch.int32, device=device)
    return counter


# How a wrapper reaches its kernel.  The wrappers call the launch functions
# below either directly or through their torch.library operators
# (ops/library.py), which torch.export records: utils/deploy.py routes through
# the operators while it exports a command (``library.exporting``, which on a
# CPU tensor routes to the operator's plain version too).  Both call the same
# launch function.
_exporting = 0


def via_ops() -> bool:
    """Whether a launch goes through its operator."""
    return bool(_exporting)


class LaunchSpec(NamedTuple):
    """The static configuration of one launch of kernel A (or of the batched
    pair), fixed when its wrapper is built: the integers its operator takes
    (``ops/library.py``), ``u_scale`` aside.  ``antithetic`` and
    ``null_action`` are the config's; ``R`` is the drawn rows (D, or Dp for
    KMPPI); ``S`` the samples a block (the batched kernel's BLOCK);
    ``rowmajor`` selects the round-1 solve's path (``ops/rowmajor.py``).
    A shard of the samples, ``shard`` of ``shards`` equal shards of the
    global K = K · shards, draws the noise of the global samples ``shard``
    · K to (``shard`` + 1) · K - 1 (``ops/solve.make_sharded_transposed_solve``).
    ``act_ld`` is a block model's activation row in floats
    (:func:`~.kernel_models.activation_ld`), 0 for a per-sample model (and
    in a deploy artifact of before it)."""

    variant: int
    model_id: int
    K: int
    T: int
    nx: int
    nu: int
    R: int
    pair_block: int
    antithetic: int
    null_action: int
    abs_cost: int
    full_op: int
    emit_perturbed: int
    plants: int
    group: int
    S: int
    noise_operand: int
    E: int
    rowmajor: int = 0
    shard: int = 0
    shards: int = 1
    act_ld: int = 0


@functools.lru_cache(maxsize=None)
def launch_geometry(spec: LaunchSpec) -> dict:
    """What a launch of ``spec`` derives from it: the tiles' place (shared
    memory, or a global scratch of one (rows, S) slice per launched block and
    tile), the blocks, the padded K (a shard's own K where the launch is one
    shard of the samples), the columns of injected bits (of the global K
    for a shard), and a block model's group of samples ``act_rows`` and the
    tiles' place, chosen together by occupancy (:func:`activation_rows`),
    with the dynamic shared memory they take, ``block_smem`` (0 for a
    per-sample model); FusedSolveUnavailable where none fits."""
    batched = spec.variant == BATCHED
    D = spec.T * spec.nu
    nblocks = -(-spec.K // spec.S)
    blocks = nblocks * -(-spec.plants // spec.group)
    act_rows = block_smem = 0
    # (the round-1 solve is kernel A's MPPI with a full operator and R = D:
    # its raw normals keep a tile of their own)
    full_op = bool(spec.full_op)
    shared = smem_bytes(spec.variant, D, spec.R, full_op, spec.S) <= MAX_SMEM_BYTES
    if spec.act_ld:
        # kernel A's merge takes its block scales, and its products their
        # operator panel, in a block model's activations (fused_mppi.cu's
        # block_head, kernel_smem)
        panel = 0 if batched else panel_floats(spec.variant, full_op, spec.R, spec.S)
        head = 0 if batched else 4 * (_MERGE_CHUNK_A + panel)
        bases = [base_smem_bytes(spec.variant, D, spec.R, full_op, spec.S, place) - head
                 for place in (True, False)]
        act_rows, place = activation_rows(
            spec.S, spec.act_ld, bases, spec.nx, spec.nu,
            OCCUPANCY_TARGET if batched else KERNEL_A_BLOCK_BLOCKS, panel)
        if not act_rows:
            raise FusedSolveUnavailable(
                f"a block model's activations ({KM.DENSE_ROWS} samples of two rows of "
                f"{spec.act_ld} floats) do not fit in shared memory beside the kernel's own "
                f"{bases[1]} bytes, of the {MAX_SMEM_BYTES} a block may use")
        shared = place == 0
        block_smem = activation_bytes(bases[place], act_rows, spec.act_ld, spec.S, spec.nx,
                                      spec.nu, panel)
    tiles = (2 if full_op else 1) * spec.R * _BLOCK if batched else \
        partial_tiles(spec.variant, full_op) * D * spec.S
    scratch = 0 if shared else blocks * tiles
    antithetic = bool(spec.antithetic) and not spec.noise_operand  # the operand holds the mirror
    if spec.shards > 1:  # the shard's own samples; the padding is the global bits'
        K_pad, bits_pad = spec.K, padded_k(spec.K * spec.shards, spec.pair_block)
    else:
        K_pad = spec.K if spec.noise_operand or spec.rowmajor else padded_k(spec.K, spec.pair_block)
        bits_pad = K_pad
    return dict(shared=shared, nblocks=nblocks, blocks=blocks, scratch=scratch,
                antithetic=antithetic, K_pad=K_pad,
                bits_cols=bits_pad // 2 if antithetic else bits_pad, act_rows=act_rows,
                block_smem=block_smem)


_launch_counters = {}  # kernel A's merge counters, by launch spec, stream and device


def launch_kernel_a(spec: LaunchSpec, u_scale: float, lead, key, x0T, U2, base, op, mu, lo,
                    hi, alo, ahi, a_flat, W, lam, w_seq, dt, elites, consts, term, gate=None):
    """Launch kernel A (or the batched pair) on CUDA tensors the wrapper has
    checked: ``lead`` is the noise operand, the (2,) int32 key buffer, the
    int32 bits, or None with the Philox ``key`` by value; ``gate`` the (1,)
    int32 null-action gate or None.  Returns ``(delta, ms (2[, N]), cost,
    perturbed or None)``, and counts the launches."""
    geo = launch_geometry(spec)
    batched = spec.variant == BATCHED
    device = x0T.device
    bits = noise = key_ptr = None
    if spec.noise_operand:
        noise = lead
    elif lead is not None and lead.ndim == 1:
        key_ptr = lead.data_ptr()
    else:
        bits = lead
    K, plants, D = spec.K, spec.plants, spec.T * spec.nu
    f32 = dict(dtype=torch.float32, device=device)
    cost = torch.empty((plants, K) if batched else K, **f32)
    partial = torch.empty((plants, geo["nblocks"], spec.R + 2), **f32)
    delta = torch.empty((spec.R, plants) if batched else spec.R, **f32)
    ms = torch.empty((2, plants) if batched else 2, **f32)
    pert = torch.empty((D, K), **f32) if spec.emit_perturbed else None
    scratch = torch.empty(geo["scratch"], **f32) if geo["scratch"] else None
    stream = stream_of(device)
    counter = None if batched else merge_counter(
        _launch_counters.setdefault((spec, stream), {}), device)
    null_action = bool(spec.null_action) and not batched
    lib = library_of(spec.model_id, MPPI if spec.rowmajor else spec.variant)
    if spec.rowmajor:
        rc = lib.fused_mppi_rowmajor_solve(
            device_index(device), stream, spec.model_id, consts.data_ptr(), K,
            spec.T, spec.nx, spec.nu, _ptr(bits), key[0], key[1], int(null_action),
            spec.abs_cost, x0T.data_ptr(), x0T.stride(0), U2.data_ptr(), op.data_ptr(),
            mu.data_ptr(), lo.data_ptr(), hi.data_ptr(), a_flat.data_ptr(), lam.data_ptr(),
            float(u_scale), cost.data_ptr(), partial.data_ptr(), delta.data_ptr(),
            ms.data_ptr(), _ptr(scratch), spec.S, counter.data_ptr(), geo["act_rows"],
            spec.act_ld)
        raise_on_error(lib, rc, "fused_mppi_rowmajor_solve")
        launches["rowmajor" if spec.model_id < BL.GENERATED else
                 launch_name(spec.model_id, "mppi")] += 1
        return delta, ms, cost, None
    rc = lib.fused_mppi_launch(
        device_index(device), stream,
        spec.variant, spec.model_id, consts.data_ptr(), K, spec.T, spec.nx, spec.nu, spec.R,
        _ptr(bits), geo["bits_cols"], key[0], key[1], key_ptr, spec.pair_block,
        int(geo["antithetic"]), int(null_action),
        spec.abs_cost, x0T.data_ptr(), x0T.stride(0), x0T.stride(1),
        U2.data_ptr(), _ptr(base), _ptr(op), spec.full_op,
        _ptr(mu), lo.data_ptr(), hi.data_ptr(), _ptr(alo), _ptr(ahi),
        a_flat.data_ptr(), _ptr(W), lam.data_ptr(), _ptr(w_seq), _ptr(dt),
        float(u_scale), cost.data_ptr(), partial.data_ptr(),
        delta.data_ptr(), ms.data_ptr(), _ptr(pert), _ptr(scratch),
        plants, U2.stride(0), U2.stride(-1) if batched else 0, a_flat.stride(0),
        a_flat.stride(-1) if batched else 0, _ptr(noise),
        noise.stride(0) if noise is not None else 0, spec.group, spec.S, _ptr(counter),
        _ptr(term), _ptr(elites) if spec.E else None, spec.E, int(null_action),
        _ptr(gate), spec.shard * K, geo["act_rows"], spec.act_ld,
    )
    raise_on_error(lib, rc, "fused_mppi")
    if batched:
        launches[launch_name(spec.model_id, "batched")] += 2
    else:
        launches[launch_name(spec.model_id, VARIANTS[spec.variant])] += 1
    return delta, ms, cost, pert


def plain_kernel_a(spec: LaunchSpec, u_scale: float, lead, key, x0T, U2, base, op, mu, lo,
                   hi, alo, ahi, a_flat, W, lam, w_seq, dt, elites, consts, term, gate=None):
    """:func:`launch_kernel_a`'s plain version, on tensors of any device: the
    variant's plain function with the device model rebuilt from its
    constants (:func:`~.kernel_models.plain_model`), as :func:`finish`
    routes a CPU tensor.  Same results, the perturbed set None unless
    emitted."""
    model = KM.plain_model(spec.model_id, consts, spec.nx, spec.nu)
    # a traced terminal cost is its kernel's; a named one is rebuilt from its constants
    traced = BL.kernel_of(spec.model_id).terminal if spec.model_id >= BL.GENERATED else None
    terminal = traced or (None if term is None else KM.plain_terminal(term, spec.nx))
    seed_or_bits = lead if lead is not None else tuple(key)
    if spec.rowmajor:
        from .rowmajor import rowmajor_solve_plain

        delta, m, s, cost = rowmajor_solve_plain(
            seed_or_bits, x0T, U2, op, mu, lo, hi, a_flat, lam, model=model, K=spec.K,
            T=spec.T, nu=spec.nu, null_action=bool(spec.null_action),
            abs_cost=bool(spec.abs_cost), u_scale=u_scale)
        return delta.reshape(-1), torch.stack([m, s]), cost, None
    flags = dict(model=model, K=spec.K, T=spec.T, nu=spec.nu,
                 antithetic=bool(spec.antithetic), abs_cost=bool(spec.abs_cost),
                 u_scale=u_scale, pair_block=spec.pair_block, terminal=terminal)
    if spec.variant == BATCHED:
        return batched_solve_plain(seed_or_bits, x0T, U2, op, mu, lo, hi, a_flat, lam,
                                   noise_operand=bool(spec.noise_operand), **flags) + (None,)
    flags.update(null_action=bool(spec.null_action), emit_perturbed=bool(spec.emit_perturbed),
                 k_offset=spec.shard * spec.K)
    if spec.variant == MPPI:
        out = fused_solve_plain(seed_or_bits, x0T, U2, op, mu, lo, hi, a_flat, lam, elites,
                                gate, **flags)
    elif spec.variant == SMPPI:
        out = smppi_solve_plain(seed_or_bits, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat,
                                lam, w_seq, dt, gate, **flags)
    else:
        out = kmppi_solve_plain(seed_or_bits, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat,
                                W, lam, gate, nsp=spec.R // spec.nu, **flags)
    return out[0], torch.stack([out[1], out[2]]), out[3], out[4] if len(out) > 4 else None


def gate_operand(rest, null_gate: bool, device, also: str = ""):
    """The trailing null-gate argument of a call, as a (1,) int32 tensor on
    ``device``, or None for a solve built without it (JAX's
    ``_tp_gate_operand``, ``pallas_rollout.py:496-509``).  Loud on arity:
    a gate passed to a solve built without one would otherwise leave every
    shard its own null row."""
    if len(rest) != (1 if null_gate else 0):
        raise TypeError(
            f"this fused solve takes {int(null_gate)} trailing null-gate argument(s) but was "
            f"called with {len(rest)}{also}; the gate exists only when BOTH "
            f"config.sample_null_action is set and the kernel was built with "
            f"null_dynamic_gate=True")
    if not null_gate:
        return None
    return torch.as_tensor(rest[0], dtype=torch.int32, device=device).reshape(1)


def _make_launch(variant: int, config: MPPIConfig, model: KernelModel, R: int,
                 pair_block, emit_perturbed: bool, terminal_final, plants: int = 1, noise_operand: bool = False,
                 group: int = 1, tile_k: int = None, shard=(0, 1)):
    """Checks shared by the four factories, and the launch of one variant:
    ``launch(lead, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W,
    lambda_, w_seq, dt[, elites][, gate])`` on CUDA tensors.  The single-plant
    variants take ``tile_k`` samples a block (see :func:`check_tile`), the
    (1,) int32 null-action ``gate`` of a solve built with it, and are
    ``shard`` = (i, n), shard i of n of the global samples (K · n of
    them).  The batched variant
    takes ``plants`` plants, ``group`` of them a block: x0T (nx, N), U2 and
    a_flat (D, N) of any strides, and in operand mode the final (D, ≥K)
    noise as ``lead``.  The launch calls :func:`launch_kernel_a`, directly
    or through its operator (:func:`via_ops`).  Returns ``(launch, flags,
    info)`` where ``flags`` are the plain version's keyword arguments."""
    # a named terminal cost, or the trace of any other (UnsupportedPrimitive
    # where it cannot be traced, which the routing takes to the plain path)
    terminal = BL.kernel_terminal(config, terminal_final)
    model = as_kernel_model(config, model, terminal)
    act_ld = BL.kernel_act_ld(model, terminal)
    check_kernel_model(config, model, act_ld)
    model_id = BL.launch_id(model, terminal)
    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    if terminal is not None and terminal.nx != nx:  # the kernel reads goal[:nx]
        raise ValueError(f"terminal cost {terminal.name!r} is for nx={terminal.nx}; the "
                         f"config is nx={nx}")
    D = T * nu
    batched = variant == BATCHED
    if batched:
        shard = (0, 1)
    if not 0 <= shard[0] < shard[1]:
        raise ValueError(f"shard must be (i, n) with 0 <= i < n, got {shard}")
    K_all = K * shard[1]  # the samples of every shard
    pair_block = pair_block or K_all + K_all % 2
    if config.antithetic and not noise_operand and pair_block % 2:
        raise ValueError(f"antithetic pairing needs an even pair_block, got {pair_block}")
    full_op = not (noise_operand or config.diag_sigma and not config.noise_rho)
    E = config.num_elites if variant == MPPI else 0
    spec = LaunchSpec(variant, model_id, K, T, nx, nu, R, pair_block,
                      int(config.antithetic), int(config.sample_null_action),
                      int(config.noise_abs_cost), int(full_op), int(emit_perturbed), plants,
                      group, _BLOCK if batched else check_tile(tile_k, K), int(noise_operand), E,
                      0, *shard, act_ld)
    geo = launch_geometry(spec)
    spec_ints, u_scale = list(spec), float(config.u_scale)
    flags = dict(model=model, K=K, T=T, nu=nu, antithetic=config.antithetic,
                 abs_cost=config.noise_abs_cost, u_scale=u_scale,
                 pair_block=pair_block, terminal=terminal)
    if batched:
        flags.update(noise_operand=noise_operand)
    else:
        flags.update(null_action=config.sample_null_action, emit_perturbed=emit_perturbed,
                     k_offset=spec.shard * K)
    cols = plants if batched else K

    def launch(lead, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W, lam,
               w_seq, dt, elites=None, gate=None):
        device = x0T.device
        _check("x0T", x0T, device, shape=(nx, cols), contiguous=False)
        for name, t in (("U2", U2), ("a_flat", a_flat)):
            _check(name, t, device, shape=(D, plants) if batched else (D,),
                   contiguous=not batched)
        for name, t in (("alo", alo), ("ahi", ahi)):
            if t is not None:
                _check(name, t, device, shape=(D,))
        for name, t in (("base", base), ("mu", mu), ("lo", lo), ("hi", hi)):
            if t is not None:
                _check(name, t, device, shape=(R,))
        if not noise_operand:
            _check("op", op, device, shape=(R, R) if full_op else (R,))
        if W is not None:
            _check("Wt", W, device, shape=(D, R))
        if E:
            _check("elites", elites, device, shape=(E, D))
        if gate is not None:
            _check("gate", gate, device, dtype=torch.int32, shape=(1,))
        for name, t in (("lambda_", lam), ("w_seq", w_seq), ("delta_t", dt)):
            if t is not None:
                _check(name, t.reshape(1), device, shape=(1,))
        key = (0, 0)
        if noise_operand:
            _check("noise", lead, device, contiguous=False)
            if lead.ndim != 2 or lead.shape[0] != R or lead.shape[1] < K or lead.stride(1) != 1:
                raise ValueError(f"the noise operand must be ({R}, >= {K}) with unit column "
                                 f"stride, got {tuple(lead.shape)} strides {lead.stride()}")
        elif is_device_key(lead):
            _check("key", lead, device, dtype=torch.int32, shape=(2,))
        elif isinstance(lead, torch.Tensor):
            _check("bits", lead, device, dtype=torch.int32, shape=(R, geo["bits_cols"]))
        else:
            key, lead = tuple(int(w) & 0xFFFFFFFF for w in lead), None
        args = (lead, key, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W, lam, w_seq, dt,
                elites if E else None, model.consts_on(device),
                terminal.consts_on(device) if terminal is not None else None)
        if via_ops():
            if batched:
                delta, ms, cost = torch.ops.mppi_torch.batched.default(
                    *args[:4], *args[5:9], args[11], args[13], *args[17:], spec_ints, u_scale)
            else:
                delta, ms, cost, pert = torch.ops.mppi_torch.kernel_a.default(
                    *args, gate, spec_ints, u_scale)
        else:
            delta, ms, cost, pert = launch_kernel_a(spec, u_scale, *args, gate)
        if batched:
            return delta, ms, cost
        out = (delta, ms[0], ms[1], cost)
        return out + (pert,) if emit_perturbed else out

    info = dict(K_pad=geo["K_pad"], pair_block=pair_block, bits_cols=geo["bits_cols"],
                tiles="shared" if geo["shared"] else "global", blocks=geo["blocks"], spec=spec,
                model=model, act_rows=geo["act_rows"])
    if not batched:
        info.update(tile_k=spec.S)
    return launch, flags, info


def finish(solve, plain, flags, info, device_arg: int = 1):
    """Route by the device of argument ``device_arg`` and attach the plain
    version and the shapes.  While a command is exported
    (:func:`via_ops`) every device goes to ``solve``, whose operator runs
    the plain version on the CPU."""

    def routed(*args):
        device = args[device_arg].device
        if device.type == "cuda" or via_ops():
            return solve(*args)
        if device.type != "cpu":
            raise ValueError(f"the fused solve runs on cuda or cpu tensors, not {device}")
        return plain(*args, **flags)

    routed.plain = lambda *args: plain(*args, **flags)
    for k, v in info.items():
        setattr(routed, k, v)
    return routed


def make_transposed_fused_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None, tile_k: int = None,
                                shard=(0, 1)):
    """The whole MPPI iteration as one fused-kernel call (see the module
    docstring for the call contract).  ``model`` is a kernel model or the
    user's ``(dynamics, running_cost)`` pair (:func:`as_kernel_model`; so
    for the other factories); ``solve.model`` holds the one it runs.
    Raises ValueError for a non-float32
    config or a model whose sizes differ from the config's, and
    :class:`FusedSolveUnavailable` for a block model (a residual MLP beyond
    nx, nu ≤ 8 and four layers of 64 units, a traced one with dense layers,
    a per-sample program beyond 32 states or actions) whose state and
    activations do not fit in shared memory (:func:`check_kernel_model`,
    :func:`launch_geometry`), for a step-dependent config with a named
    model, and for
    ``config.num_elites`` elites that with the null row exceed JAX's
    injection window of min(K, 128) samples (``pallas_rollout.py:596-603``);
    :class:`~.batch_last.UnsupportedPrimitive` for a ``terminal_final`` that
    is neither a kernel terminal cost
    (:func:`~.kernel_models.quadratic_terminal`) nor traceable.

    With ``null_dynamic_gate`` and ``config.sample_null_action`` the solve
    takes one more trailing argument, the null-action gate (a (1,) int32
    tensor, or an int): sample 0 is the null row only where it is not 0,
    which the kernel reads when it runs (JAX's ``null_dynamic_gate``,
    ``pallas_rollout.py:585, 633-636``).  A gate passed to a solve built
    without one, or missing from one built with it, raises TypeError.
    ``shard`` = (i, n) builds the solve of shard i of n of the samples:
    ``config.K`` is the shard's, and sample k draws the noise of global
    sample i · K + k, so that n shards draw what one solve of K · n samples
    with the same ``pair_block`` draws; injected bits are then the global
    (R, bits_cols) tensor (``ops/solve.make_sharded_transposed_solve``).
    ``terminal_final`` adds the terminal cost of each sample's final state and
    last scaled action to its cost, as the JAX kernel's.  ``tile_k`` forces
    the samples of a block of the kernel (32, 64 or 128; default
    :func:`tile_samples`); ``solve.tile_k`` holds it.

    With ``config.num_elites`` = E the solve takes an (E, D) float32 elites
    operand after ``lambda_``: sample off + j (off = 1 after the null row,
    else 0) takes elite row j in place of U + noise before the clamp, as
    JAX's (D, 128) operand with the elites at their global sample columns;
    the emitted perturbed set holds the clamped elites."""
    D, K, E = config.T * config.nu, config.K, config.num_elites
    off = 1 if config.sample_null_action else 0
    if E and E + off > min(K, ELITE_WINDOW):
        raise FusedSolveUnavailable(
            f"num_elites={E} (+{off} null) exceeds the kernel's one-lane-block "
            f"injection window (min(K, {ELITE_WINDOW}))")
    null_gate = null_dynamic_gate and config.sample_null_action
    launch, flags, info = _make_launch(MPPI, config, model, D, pair_block, emit_perturbed,
                                       terminal_final, tile_k=tile_k, shard=shard)

    def operands_of(rest, device):
        """The elites operand (JAX's TypeErrors, ``pallas_rollout.py:706-
        721``), or None without elite reuse, and the gate of a call."""
        rest = list(rest)
        elites = None
        if E:
            if not rest:
                raise TypeError(
                    f"this fused solve was built with num_elites = {E}: pass the ({E}, D) "
                    f"elites operand (elite j goes to sample {off} + j) after lambda")
            elites = rest.pop(0)
            if tuple(getattr(elites, "shape", ())) != (E, D):
                raise TypeError(f"elites operand must be (E, D) = ({E}, {D}), got "
                                f"{tuple(getattr(elites, 'shape', ()))}")
        also = "" if E else " (built without num_elites, it takes no elites operand)"
        return elites, gate_operand(rest, null_gate, device, also)

    def solve(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_, *rest):
        elites, gate = operands_of(rest, x0T.device)
        return launch(seed_or_bits, x0T, U2, U2, op, mu_t, lo_t, hi_t, None, None,
                      a_flat, None, lambda_, None, None, elites, gate)

    def plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_, *rest, **kw):
        return fused_solve_plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
                                 lambda_, *operands_of(rest, x0T.device), **kw)

    return finish(solve, plain, flags, dict(info, num_elites=E, elite_off=off,
                                            null_gate=null_gate))


def make_transposed_smppi_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None, tile_k: int = None,
                                shard=(0, 1)):
    """The whole SMPPI iteration as one fused-kernel call, with the call
    contract of ``pallas_rollout.py:775-784``: ``solve(seed_or_bits, x0T,
    U2, as2, op, mu_t, lo_t, hi_t (rate bounds), alo_t, ahi_t (action
    bounds), a_flat, lambda_, w_seq, delta_t[, gate])``, the three scalars
    as 0-d tensors.  Raises, and takes ``tile_k``, the gate and ``shard``,
    as :func:`make_transposed_fused_solve`."""
    D = config.T * config.nu
    null_gate = null_dynamic_gate and config.sample_null_action
    launch, flags, info = _make_launch(SMPPI, config, model, D, pair_block, emit_perturbed,
                                       terminal_final, tile_k=tile_k, shard=shard)

    def solve(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t, ahi_t,
              a_flat, lambda_, w_seq, delta_t, *gate):
        return launch(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t,
                      ahi_t, a_flat, None, lambda_, w_seq, delta_t, None,
                      gate_operand(gate, null_gate, x0T.device))

    def plain(*args, **kw):
        args, gate = args[:14], args[14:]
        return smppi_solve_plain(*args, gate_operand(gate, null_gate, args[1].device), **kw)

    return finish(solve, plain, flags, dict(info, null_gate=null_gate))


def make_transposed_kmppi_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None, tile_k: int = None,
                                shard=(0, 1)):
    """The whole KMPPI iteration as one fused-kernel call, with the call
    contract of ``pallas_rollout.py:958-967``: ``solve(seed_or_bits, x0T,
    U2, theta2 (Dp,), op, mu_p, lop, hip (Dp,), lo_t, hi_t (D,), a_flat,
    Wt (D, Dp), lambda_[, gate])`` with ``Dp = config.num_support_pts ·
    nu``.  Raises, and takes ``tile_k``, the gate and ``shard``, as
    :func:`make_transposed_fused_solve`."""
    nsp = config.num_support_pts
    if nsp < 1:
        raise ValueError(f"KMPPI needs num_support_pts >= 1, got {nsp}")
    null_gate = null_dynamic_gate and config.sample_null_action
    launch, flags, info = _make_launch(KMPPI, config, model, nsp * config.nu, pair_block,
                                       emit_perturbed, terminal_final, tile_k=tile_k,
                                       shard=shard)

    def solve(seed_or_bits, x0T, U2, theta2, op, mu_p, lop, hip, lo_t, hi_t,
              a_flat, Wt, lambda_, *gate):
        return launch(seed_or_bits, x0T, U2, theta2, op, mu_p, lop, hip, lo_t,
                      hi_t, a_flat, Wt, lambda_, None, None, None,
                      gate_operand(gate, null_gate, x0T.device))

    def plain(*args, **kw):
        args, gate = args[:13], args[13:]
        return kmppi_solve_plain(*args, gate_operand(gate, null_gate, args[1].device), **kw)

    return finish(solve, plain, dict(flags, nsp=nsp), dict(info, null_gate=null_gate))


def make_transposed_batched_solve(config: MPPIConfig, num_envs: int,
                                  model: KernelModel, pair_block: int = None,
                                  noise_operand: bool = False,
                                  terminal_final=None, group: int = None):
    """The N-plant MPPI iteration as one fused-kernel call, with the call
    contract of ``pallas_rollout.py:1142-1149``: ``solve(lead, x0T (nx, N),
    U2T (D, N), op, mu_t, lo_t, hi_t (D,), aT (D, N), lambda_) -> (delta
    (D, N), ms (2, N), cost (N, K))``, ``U_new = U + (delta / ms[1]).T``.

    Three sampling modes, as the JAX kernel's: a Philox key (seed mode)
    draws the shared noise in the kernel, from counters of the sample's
    source column only, so every plant draws the same; (D, K_pad[/2]) int32
    bits inject it; with ``noise_operand`` ``lead`` is the final (D, ≥K)
    float32 noise (one draw outside, already mirrored, correlated and
    mu-shifted) and the kernel draws nothing.  There is no null-action row.
    Each block of the kernel takes ``group`` plants (default: the rule of
    :func:`plant_group`, one for a block model); ``solve.plant_group``
    holds it.  Takes
    ``terminal_final`` and raises as :func:`make_transposed_fused_solve`."""
    plants = int(num_envs)
    if plants < 1:
        raise ValueError(f"num_envs must be >= 1, got {plants}")
    # a block model's plant takes its block alone: its layers outweigh the
    # shared draw, and 1,280 blocks at N = 16, K = 10,240 fill the waves
    # that 320 leave a fifth full
    terminal = BL.kernel_terminal(config, terminal_final)
    model = as_kernel_model(config, model, terminal)
    group = group or (1 if BL.kernel_act_ld(model, terminal) else
                      plant_group(plants, -(-config.K // _BLOCK), 2 * sm_count()))
    if not 1 <= group <= plants:
        raise ValueError(f"group must be in [1, num_envs={plants}], got {group}")
    D = config.T * config.nu
    launch, flags, info = _make_launch(BATCHED, config, model, D, pair_block, False,
                                       terminal, plants=plants,
                                       noise_operand=noise_operand, group=group)

    def solve(lead, x0T, U2T, op, mu_t, lo_t, hi_t, aT, lambda_):
        return launch(lead, x0T, U2T, None, op, mu_t, lo_t, hi_t, None, None, aT,
                      None, lambda_, None, None)

    return finish(solve, batched_solve_plain, flags,
                  dict(info, num_envs=plants, noise_operand=noise_operand,
                       plant_group=group))
