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

Each is built for a :class:`~.kernel_models.KernelModel`, and optionally a
final-state terminal cost (``terminal_final``, a
:func:`~.kernel_models.quadratic_terminal`):

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
Hopper's 227 KB, else in a global scratch; the device models hold nx and nu
up to 32.  Kernel A's merge counts its finished blocks in an int32 counter
that each factory allocates once per device: two calls of one factory must
not run at once on two streams.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import MPPIConfig
from . import kernel_models as KM
from .kernel_models import KernelModel, KernelTerminal, find_kernel_terminal

MPPI, SMPPI, KMPPI, BATCHED = 0, 1, 2, 3  # the kernel's variants (Variant in fused_mppi.cu)
VARIANTS = ("mppi", "smppi", "kmppi")  # the single-plant variants
# every kernel of fused_mppi.cu by the name of its launch count, one for each
# of the eight TPU kernels: the four variants of kernel A (each with kernel
# B), the legacy route's rollout and weighted update (ops/legacy.py), and the
# sampling front-end and the row-major round-1 solve (ops/rowmajor.py)
KERNELS = VARIANTS + ("batched", "rollout", "weighted_update", "sampler", "rowmajor")

# kernel launches (each kernel launched counts one); chip_smoke.py reads them
launches = dict.fromkeys(KERNELS, 0)

MAX_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_BLOCK = 128  # threads of a block, and samples of a block of batched_partial (BLOCK)
_MAXN = 32  # largest nx or nu of a device model (MAXN in fused_mppi.cu)
TILES = (32, 64, 128)  # the samples a block of kernel A may take
_HEAD = 32 + 2 * _BLOCK + 512  # floats of kernel A's shared memory before its panel
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
    float32, no step dependence (the kernel's device models take no
    timestep), no ``parameterized_dynamics`` (a device model holds its
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
            and config.dtype == torch.float32 and not config.step_dependent_dynamics)


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
    panel = (-(-(_BLOCK // S * _ROW_TILE * min(R, _PANEL_COLS)) // 4) * 4
             if full_op or variant == KMPPI else 0)
    return (_HEAD + panel + _NVEC * D + partial_tiles(variant, full_op) * D * (S + 1)) * 4


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
# The plain versions
# ---------------------------------------------------------------------------


def _noise(seed_or_bits, R: int, K: int, pair_block: int, antithetic: bool, op,
           mu, device):
    """(R, K) noise of the drawn rows: the normals of each sample's source
    column, the antithetic sign, then the diagonal scale or ``op @ z``."""
    src, sign = source_columns(K, pair_block, antithetic, device)
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
        state = model.dynamics(state, u_t)
        total = total + model.running_cost(state, u_t)
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


def _null_row(perturbed, null_action: bool):
    if null_action:
        perturbed[:, 0] = 0.0  # a fresh tensor of the caller's
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
                      lambda_, elites=None, *, model: KernelModel, K: int, T: int, nu: int,
                      antithetic: bool = False, null_action: bool = False,
                      abs_cost: bool = False, u_scale: float = 1.0,
                      emit_perturbed: bool = False, pair_block: int = None,
                      terminal: KernelTerminal = None):
    """What the fused MPPI kernel computes, in torch ops on (D, K) tensors of
    any device.  Same arguments and results as the kernel's wrapper; the
    (E, D) ``elites`` take the samples after the null row before the
    clamp."""
    D = T * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, D, K, pair_block, antithetic, op, mu_t, x0T.device)
    U_col = U2.reshape(D, 1)
    perturbed = _elite_columns(_null_row(U_col + noise, null_action), elites, null_action)
    perturbed = torch.clamp(perturbed, lo_t[:, None], hi_t[:, None])
    n = perturbed - U_col
    cost = _action_cost(n, a_flat, abs_cost) + _rollout_total(
        model, perturbed, x0T, T, nu, u_scale, terminal)
    out = _softmax_update(cost, lambda_, n) + (cost,)
    return out + (perturbed,) if emit_perturbed else out


def smppi_solve_plain(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t,
                      ahi_t, a_flat, lambda_, w_seq, delta_t, *, model: KernelModel,
                      K: int, T: int, nu: int, antithetic: bool = False,
                      null_action: bool = False, abs_cost: bool = False,
                      u_scale: float = 1.0, emit_perturbed: bool = False,
                      pair_block: int = None, terminal: KernelTerminal = None):
    """What the fused SMPPI kernel computes (pallas_rollout.py:829-861): the
    rate clamp, the integration, the null row, the action clamp, the noise
    back-computed through both clamps, the smoothness cost; ``delta`` is in
    rate space and the perturbed actions are the action-space ones."""
    D = T * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, D, K, pair_block, antithetic, op, mu_t, x0T.device)
    U_col, as_col = U2.reshape(D, 1), as2.reshape(D, 1)
    rate = torch.clamp(U_col + noise, lo_t[:, None], hi_t[:, None])
    pert_act = _null_row(as_col + rate * delta_t, null_action)
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
                      hi_t, a_flat, Wt, lambda_, *, model: KernelModel, K: int,
                      T: int, nu: int, nsp: int, antithetic: bool = False,
                      null_action: bool = False, abs_cost: bool = False,
                      u_scale: float = 1.0, emit_perturbed: bool = False,
                      pair_block: int = None, terminal: KernelTerminal = None):
    """What the fused KMPPI kernel computes (pallas_rollout.py:1011-1040):
    support-point noise clamped there, interpolated to the full horizon by
    ``Wt`` (D, Dp) in float32, the null row, the trajectory clamp; ``delta``
    has Dp rows (theta space)."""
    D, Dp = T * nu, nsp * nu
    pair_block = pair_block or K + K % 2
    noise = _noise(seed_or_bits, Dp, K, pair_block, antithetic, op, mu_p, x0T.device)
    th_col = theta2.reshape(Dp, 1)
    pts = torch.clamp(th_col + noise, lop[:, None], hip[:, None])
    perturbed = _null_row(Wt @ pts, null_action)
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
        noise = lead[:, :K].to(x0T.device)
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


def _lib():
    from . import _build

    lib = _build.load()
    if not getattr(lib, "_argtypes_set", False):
        lib.fused_mppi_launch.argtypes = [
            _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, ctypes.c_uint32,
            ctypes.c_uint32, _P, _I, _I, _I, _I, _P, _L, _L, _P, _P, _P, _I, _P,
            _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P,
            _P, _P, _P, _I, _L, _L, _L, _L, _P, _L, _I, _I, _P, _P, _P, _I, _I,
        ]
        lib.fused_mppi_rollout.argtypes = [_I, _P, _I, _P, _I, _I, _I, _I, _P, _L, _L,
                                           _P, _P, _I]
        lib.fused_mppi_rollout_geometry.argtypes = [_I, _I, _I, _P]
        lib.fused_mppi_rollout_geometry.restype = _I
        lib.fused_mppi_weighted_update.argtypes = [_I, _P, _I, _I, _I, _P, _P, _L, _P, _P,
                                                   _P, _P, _P]
        lib.fused_mppi_weighted_group.argtypes = [_I]
        for fn in (lib.fused_mppi_weighted_group, lib.fused_mppi_weighted_counters):
            fn.restype = _I
        lib.fused_mppi_rowmajor_solve.argtypes = [
            _I, _P, _I, _P, _I, _I, _I, _I, _P, ctypes.c_uint32, ctypes.c_uint32, _I,
            _I, _P, _L, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P,
            _I, _P,
        ]
        lib.fused_mppi_sampler.argtypes = [
            _I, _P, _I, _I, _P, ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _P, _P,
        ]
        for fn in (lib.fused_mppi_launch, lib.fused_mppi_rollout,
                   lib.fused_mppi_weighted_update, lib.fused_mppi_rowmajor_solve,
                   lib.fused_mppi_sampler):
            fn.restype = _I
        lib.fused_mppi_sampler_geometry.argtypes = [_I, _I, _P]
        lib.fused_mppi_sampler_geometry.restype = _I
        lib.fused_mppi_error_string.argtypes = [_I]
        lib.fused_mppi_error_string.restype = ctypes.c_char_p
        lib.fused_mppi_block.restype = _I
        lib.fused_mppi_max_n.restype = _I
        lib.fused_mppi_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
        lib.fused_mppi_smem_bytes.restype = ctypes.c_longlong
        if lib.fused_mppi_block() != _BLOCK or lib.fused_mppi_max_n() != _MAXN:
            raise RuntimeError("fused_mppi.cu BLOCK or MAXN differs from fused_solve")
        lib.fused_mppi_mlp_limit.argtypes = [_I]
        lib.fused_mppi_mlp_limit.restype = _I
        if [lib.fused_mppi_mlp_limit(i) for i in range(4)] != [
                KM.MLP_HEAD, KM.MLP_MAX_WIDTH, KM.MLP_MAX_LAYERS, KM.MLP_GROUP]:
            raise RuntimeError("fused_mppi.cu's ResidualMLP layout differs from kernel_models")
        if any(lib.fused_mppi_smem_bytes(v, D, R, f, S) != smem_bytes(v, D, R, bool(f), S)
               for v in (MPPI, SMPPI, KMPPI, BATCHED) for D, R in ((60, 30), (60, 60), (300, 300))
               for f in (0, 1) for S in TILES):
            raise RuntimeError("fused_mppi_smem_bytes differs from fused_solve.smem_bytes")
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


def check_kernel_model(config: MPPIConfig, model: KernelModel):
    """The checks every kernel of ``fused_mppi.cu`` makes of its config and
    device model."""
    nx, nu = config.nx, config.nu
    if config.dtype != torch.float32:
        raise ValueError("the fused solve requires float32")
    if (model.nx, model.nu) != (nx, nu):
        raise ValueError(
            f"kernel model {model.name!r} is (nx={model.nx}, nu={model.nu}); "
            f"the config is (nx={nx}, nu={nu})")
    if max(nx, nu) > _MAXN:
        raise FusedSolveUnavailable(
            f"nx={nx}, nu={nu}: the kernel's device models hold at most {_MAXN} of each")
    if model.model_id == KM.RESIDUAL_MLP:
        head = KM.mlp_header(model.consts)
        if (max(nx, nu) > 2 or head["layers"] > KM.MLP_MAX_LAYERS
                or max(head["widths"]) > KM.MLP_MAX_WIDTH):
            raise FusedSolveUnavailable(
                f"the residual MLP's kernel takes nx, nu <= 2 and at most "
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


def _make_launch(variant: int, config: MPPIConfig, model: KernelModel, R: int,
                 pair_block, emit_perturbed: bool, null_dynamic_gate: bool,
                 terminal_final, plants: int = 1, noise_operand: bool = False,
                 group: int = 1, tile_k: int = None):
    """Checks shared by the four factories, and the launch of one variant:
    ``launch(lead, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W,
    lambda_, w_seq, dt)`` on CUDA tensors.  The single-plant variants take
    ``tile_k`` samples a block (see :func:`check_tile`).  The batched variant
    takes ``plants`` plants, ``group`` of them a block: x0T (nx, N), U2 and
    a_flat (D, N) of any strides, and in operand mode the final (D, ≥K)
    noise as ``lead``.  Returns ``(launch, flags, info)`` where ``flags`` are
    the plain version's keyword arguments."""
    if null_dynamic_gate:
        raise FusedSolveUnavailable(
            "null_dynamic_gate is not ported yet (ROADMAP.md Queue 1 item 12, sharding)")
    terminal = find_kernel_terminal(terminal_final)
    if terminal_final is not None and terminal is None:
        raise FusedSolveUnavailable(
            f"terminal_final {getattr(terminal_final, '__name__', terminal_final)!r} is not a "
            f"kernel terminal cost: the kernel evaluates only those it names "
            f"(ops/kernel_models.quadratic_terminal)")
    check_kernel_model(config, model)
    if variant == BATCHED and model.model_id == KM.RESIDUAL_MLP:
        raise FusedSolveUnavailable(
            "the batched kernel has no residual-MLP instantiation yet (ROADMAP.md Queue 2a "
            "piece 4, the batched MLP)")
    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    if terminal is not None and terminal.nx != nx:  # the kernel reads goal[:nx]
        raise ValueError(f"terminal cost {terminal.name!r} is for nx={terminal.nx}; the "
                         f"config is nx={nx}")
    D = T * nu
    batched = variant == BATCHED
    antithetic = config.antithetic and not noise_operand  # the operand holds the mirror
    pair_block = pair_block or K + K % 2
    if antithetic and pair_block % 2:
        raise ValueError(f"antithetic pairing needs an even pair_block, got {pair_block}")
    full_op = not (noise_operand or config.diag_sigma and not config.noise_rho)
    S = _BLOCK if batched else check_tile(tile_k, K)
    # tiles that do not fit in shared memory go to a global scratch of one
    # (rows, S) slice per launched block and tile
    shared = smem_bytes(variant, D, R, full_op, S) <= MAX_SMEM_BYTES
    nblocks = -(-K // S)
    blocks = nblocks * -(-plants // group)
    if batched:
        scratch_elems = 0 if shared else blocks * (2 if full_op else 1) * R * _BLOCK
    else:
        scratch_elems = 0 if shared else blocks * partial_tiles(variant, full_op) * D * S
    counters = {}
    K_pad = K if noise_operand else padded_k(K, pair_block)
    bits_cols = K_pad // 2 if antithetic else K_pad
    flags = dict(model=model, K=K, T=T, nu=nu, antithetic=config.antithetic,
                 abs_cost=config.noise_abs_cost, u_scale=float(config.u_scale),
                 pair_block=pair_block, terminal=terminal)
    if batched:
        flags.update(noise_operand=noise_operand)
    else:
        flags.update(null_action=config.sample_null_action, emit_perturbed=emit_perturbed)
    null_action = config.sample_null_action and not batched
    cols = plants if batched else K
    E = config.num_elites if variant == MPPI else 0

    def launch(lead, x0T, U2, base, op, mu, lo, hi, alo, ahi, a_flat, W, lam,
               w_seq, dt, elites=None):
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
        for name, t in (("lambda_", lam), ("w_seq", w_seq), ("delta_t", dt)):
            if t is not None:
                _check(name, t.reshape(1), device, shape=(1,))
        bits = noise = key_ptr = None
        key = (0, 0)
        if noise_operand:
            noise = _check("noise", lead, device, contiguous=False)
            if noise.ndim != 2 or noise.shape[0] != R or noise.shape[1] < K or noise.stride(1) != 1:
                raise ValueError(f"the noise operand must be ({R}, >= {K}) with unit column "
                                 f"stride, got {tuple(noise.shape)} strides {noise.stride()}")
        elif is_device_key(lead):
            key_ptr = _check("key", lead, device, dtype=torch.int32, shape=(2,)).data_ptr()
        elif isinstance(lead, torch.Tensor):
            bits = _check("bits", lead, device, dtype=torch.int32, shape=(R, bits_cols))
        else:
            key = tuple(int(w) & 0xFFFFFFFF for w in lead)
        consts = model.consts_on(device)
        term = terminal.consts_on(device) if terminal is not None else None
        f32 = dict(dtype=torch.float32, device=device)
        cost = torch.empty((plants, K) if batched else K, **f32)
        partial = torch.empty((plants, nblocks, R + 2), **f32)
        delta = torch.empty((R, plants) if batched else R, **f32)
        ms = torch.empty((2, plants) if batched else 2, **f32)
        pert = torch.empty((D, K), **f32) if emit_perturbed else None
        scratch = torch.empty(scratch_elems, **f32) if scratch_elems else None
        counter = None if batched else merge_counter(counters, device)
        lib = _lib()
        rc = lib.fused_mppi_launch(
            device_index(device), stream_of(device),
            variant, model.model_id, consts.data_ptr(), K, T, nx, nu, R,
            _ptr(bits), bits_cols, key[0], key[1], key_ptr, pair_block,
            int(antithetic), int(null_action),
            int(config.noise_abs_cost), x0T.data_ptr(), x0T.stride(0), x0T.stride(1),
            U2.data_ptr(), _ptr(base), _ptr(op), int(full_op),
            _ptr(mu), lo.data_ptr(), hi.data_ptr(), _ptr(alo), _ptr(ahi),
            a_flat.data_ptr(), _ptr(W), lam.data_ptr(), _ptr(w_seq), _ptr(dt),
            float(config.u_scale), cost.data_ptr(), partial.data_ptr(),
            delta.data_ptr(), ms.data_ptr(), _ptr(pert), _ptr(scratch),
            plants, U2.stride(0), U2.stride(-1) if batched else 0, a_flat.stride(0),
            a_flat.stride(-1) if batched else 0, _ptr(noise),
            noise.stride(0) if noise is not None else 0, group, S, _ptr(counter),
            _ptr(term), _ptr(elites) if E else None, E, int(null_action),
        )
        raise_on_error(lib, rc, "fused_mppi")
        if batched:
            launches["batched"] += 2
        else:
            launches[VARIANTS[variant]] += 1
        if batched:
            return delta, ms, cost
        out = (delta, ms[0], ms[1], cost)
        return out + (pert,) if emit_perturbed else out

    info = dict(K_pad=K_pad, pair_block=pair_block, bits_cols=bits_cols,
                tiles="shared" if shared else "global", blocks=blocks)
    if not batched:
        info.update(tile_k=S)
    return launch, flags, info


def finish(solve, plain, flags, info, device_arg: int = 1):
    """Route by the device of argument ``device_arg`` and attach the plain
    version and the shapes."""

    def routed(*args):
        device = args[device_arg].device
        if device.type == "cuda":
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
                                terminal_final=None, tile_k: int = None):
    """The whole MPPI iteration as one fused-kernel call (see the module
    docstring for the call contract).  Raises ValueError for a non-float32
    config or a model whose sizes differ from the config's, and
    :class:`FusedSolveUnavailable` when nx or nu exceeds the device models'
    registers (32), for a ``terminal_final`` that is not a kernel terminal
    cost (:func:`~.kernel_models.quadratic_terminal`), for
    ``null_dynamic_gate``, which this port does not run yet, and for
    ``config.num_elites`` elites that with the null row exceed JAX's
    injection window of min(K, 128) samples (``pallas_rollout.py:596-603``).
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
    launch, flags, info = _make_launch(MPPI, config, model, D, pair_block,
                                       emit_perturbed, null_dynamic_gate,
                                       terminal_final, tile_k=tile_k)

    def elites_of(rest):
        """The elites operand of a call (JAX's TypeErrors,
        ``pallas_rollout.py:706-721``), or None without elite reuse."""
        if not E:
            if rest:
                raise TypeError("this fused solve was built without num_elites: it takes "
                                "no elites operand")
            return None
        if not rest:
            raise TypeError(
                f"this fused solve was built with num_elites = {E}: pass the ({E}, D) "
                f"elites operand (elite j goes to sample {off} + j) after lambda")
        if len(rest) > 1 or tuple(getattr(rest[0], "shape", ())) != (E, D):
            raise TypeError(f"elites operand must be (E, D) = ({E}, {D}), got "
                            f"{tuple(getattr(rest[0], 'shape', ()))}")
        return rest[0]

    def solve(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_, *rest):
        return launch(seed_or_bits, x0T, U2, U2, op, mu_t, lo_t, hi_t, None, None,
                      a_flat, None, lambda_, None, None, elites_of(rest))

    def plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat, lambda_, *rest, **kw):
        return fused_solve_plain(seed_or_bits, x0T, U2, op, mu_t, lo_t, hi_t, a_flat,
                                 lambda_, elites_of(rest), **kw)

    return finish(solve, plain, flags, dict(info, num_elites=E, elite_off=off))


def make_transposed_smppi_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None, tile_k: int = None):
    """The whole SMPPI iteration as one fused-kernel call, with the call
    contract of ``pallas_rollout.py:775-784``: ``solve(seed_or_bits, x0T,
    U2, as2, op, mu_t, lo_t, hi_t (rate bounds), alo_t, ahi_t (action
    bounds), a_flat, lambda_, w_seq, delta_t)``, the three scalars as 0-d
    tensors.  Raises, and takes ``tile_k``, as
    :func:`make_transposed_fused_solve`."""
    D = config.T * config.nu
    launch, flags, info = _make_launch(SMPPI, config, model, D, pair_block,
                                       emit_perturbed, null_dynamic_gate,
                                       terminal_final, tile_k=tile_k)

    def solve(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t, ahi_t,
              a_flat, lambda_, w_seq, delta_t):
        return launch(seed_or_bits, x0T, U2, as2, op, mu_t, lo_t, hi_t, alo_t,
                      ahi_t, a_flat, None, lambda_, w_seq, delta_t)

    return finish(solve, smppi_solve_plain, flags, info)


def make_transposed_kmppi_solve(config: MPPIConfig, model: KernelModel,
                                pair_block: int = None,
                                emit_perturbed: bool = False,
                                null_dynamic_gate: bool = False,
                                terminal_final=None, tile_k: int = None):
    """The whole KMPPI iteration as one fused-kernel call, with the call
    contract of ``pallas_rollout.py:958-967``: ``solve(seed_or_bits, x0T,
    U2, theta2 (Dp,), op, mu_p, lop, hip (Dp,), lo_t, hi_t (D,), a_flat,
    Wt (D, Dp), lambda_)`` with ``Dp = config.num_support_pts · nu``.
    Raises, and takes ``tile_k``, as :func:`make_transposed_fused_solve`."""
    nsp = config.num_support_pts
    if nsp < 1:
        raise ValueError(f"KMPPI needs num_support_pts >= 1, got {nsp}")
    launch, flags, info = _make_launch(KMPPI, config, model, nsp * config.nu,
                                       pair_block, emit_perturbed,
                                       null_dynamic_gate, terminal_final, tile_k=tile_k)

    def solve(seed_or_bits, x0T, U2, theta2, op, mu_p, lop, hip, lo_t, hi_t,
              a_flat, Wt, lambda_):
        return launch(seed_or_bits, x0T, U2, theta2, op, mu_p, lop, hip, lo_t,
                      hi_t, a_flat, Wt, lambda_, None, None)

    return finish(solve, kmppi_solve_plain, dict(flags, nsp=nsp), info)


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
    :func:`plant_group`); ``solve.plant_group`` holds it.  Takes
    ``terminal_final`` and raises as :func:`make_transposed_fused_solve`."""
    plants = int(num_envs)
    if plants < 1:
        raise ValueError(f"num_envs must be >= 1, got {plants}")
    group = group or plant_group(plants, -(-config.K // _BLOCK), 2 * sm_count())
    if not 1 <= group <= plants:
        raise ValueError(f"group must be in [1, num_envs={plants}], got {group}")
    D = config.T * config.nu
    launch, flags, info = _make_launch(BATCHED, config, model, D, pair_block, False,
                                       False, terminal_final, plants=plants,
                                       noise_operand=noise_operand, group=group)

    def solve(lead, x0T, U2T, op, mu_t, lo_t, hi_t, aT, lambda_):
        return launch(lead, x0T, U2T, None, op, mu_t, lo_t, hi_t, None, None, aT,
                      None, lambda_, None, None)

    return finish(solve, batched_solve_plain, flags,
                  dict(info, num_envs=plants, noise_operand=noise_operand,
                       plant_group=group))
