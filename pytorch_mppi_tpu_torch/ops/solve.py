"""The MPPI solve as plain functions on tensors.

The counterpart of ``pytorch_mppi_tpu/ops/solve.py`` for one optimisation
cycle per command.  :func:`make_mppi_step`, :func:`make_smppi_step`,
:func:`make_kmppi_step` (one plant) and :func:`make_batched_step` (N plants
that share the noise) each build the two ways a command runs:

* the plain path, ``_one_iteration``: noise in the flat ``(K, T·nu)`` layout,
  the null-action row, the clamp, the rectified noise and its action cost, a
  T-step rollout in a Python loop, the softmax weights and the nominal update;
* with ``use_pallas=True``, ``_one_iteration_fused``: the whole cycle in one
  call to the fused CUDA kernel (:mod:`.fused_solve`), which keeps the noise
  out of device memory.  On a CPU tensor that call runs the kernel's plain
  version.

``make_mppi_step(use_pallas="rollout")`` keeps the plain path's noise, clamp
and action cost and runs the rollout and the weighted update through the
legacy route's two kernels (:mod:`.legacy`).

SMPPI samples in action-rate space and integrates onto the commanded
sequence (reference mppi.py:451-570); KMPPI samples at support points and
interpolates them to the horizon (reference mppi.py:593-688).

Every factory takes JAX's two terminal hooks (:func:`rollout_costs`):
``terminal_state_cost`` over the stored rollout, which only the plain path
runs, and ``terminal_final_cost`` of the last step, which the fused kernels
evaluate when it is a kernel terminal cost
(:func:`~.kernel_models.quadratic_terminal`).  The single-plant factories
take a specific-action sampler's ``sample_trajectories`` and
``specific_dynamics`` (:func:`inject_specific_actions`, the plain path);
:func:`make_mppi_step` also runs elite reuse (``config.num_elites``; on the
fused kernel as its elites operand) and gradient refinement of the nominal
(:func:`make_nominal_refiner`).

Each factory's ``step`` is a host prologue, which positions the command's
random streams (:class:`CommandStreams`: the kernels' keys in a device
buffer, fixed generators reseeded), then a device body that makes no host
decision on a value, so that ``runner.run_mppi_jit`` can capture the body in
a CUDA graph.  The steps take the controller's ``dynamics_params``, which
go first to the dynamics with ``config.parameterized_dynamics``
(:func:`wrap_dynamics`; the plain path, as JAX's kernels take none).

The reference quirks stay: U is not clamped again after the update, the
running cost is taken at the state after the dynamics step, and ``u_scale``
is applied inside the rollout.  Tensors are not updated in place, except
fresh intermediates the function itself allocated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Callable, NamedTuple

import torch

from ..config import (
    Artifacts,
    BatchedState,
    KMPPIParams,
    KMPPIState,
    MPPIConfig,
    MPPIParams,
    MPPIState,
    SMPPIParams,
    SMPPIState,
)
from . import fused_solve as FS
from . import legacy as LG
from .kernel_models import find_kernel_model

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Random-number stream
# ---------------------------------------------------------------------------


def iteration_seed(seed: int, counter: int) -> int:
    """The 64-bit seed of solve number ``counter`` of a stream (splitmix64 of
    the stream position), the counterpart of splitting a JAX key per solve."""
    z = (seed + (counter + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


# XORed into a state's seed for the stream of the stochastic rollouts, so that
# an iteration's rollout draws are independent of its noise draws
_ROLLOUT_STREAM = 0xD1B54A32D192ED03


def rollout_seed(seed: int, counter: int) -> int:
    """The 64-bit seed of the stochastic rollout of iteration ``counter``: a
    second stream at the same position as :func:`iteration_seed`, the
    counterpart of JAX's ``k_roll`` from ``split(key, 3)``
    (``pytorch_mppi_tpu/ops/solve.py:1228``)."""
    return iteration_seed(seed ^ _ROLLOUT_STREAM, counter)


def _generator(s: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def step_generator(seed: int, t: int, device) -> torch.Generator:
    """The ``torch.Generator`` stochastic dynamics take at step ``t`` of a
    rollout seeded ``seed``, on the rollout's device: made afresh each step,
    so a step's draws do not depend on how many numbers earlier steps drew
    (JAX splits one key per step, ``solve.py:369``)."""
    return _generator(iteration_seed(seed, t), device)


class FedDraws:
    """An iteration's N(0, 1) draws given as a tensor, in place of its
    generator, while the body of a command is exported
    (:meth:`CommandStreams.fed`)."""

    def __init__(self, draws: torch.Tensor):
        self.draws = draws


def standard_normal(generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) draws: the one place the plain path takes random numbers
    (the tensor of a :class:`FedDraws` in place of a generator)."""
    if isinstance(generator, FedDraws):
        if tuple(generator.draws.shape) != tuple(shape):
            raise ValueError(f"fed draws are {tuple(generator.draws.shape)}, the step draws "
                             f"{tuple(shape)}")
        return generator.draws
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


class _DeviceStreams:
    """The generators and the kernels' key buffer of one step on one
    device (:class:`CommandStreams`), or in their place the tensors of
    :meth:`CommandStreams.feeds` (``feeds``)."""

    def __init__(self, streams: "CommandStreams", device: torch.device, feeds=None):
        n_iter, T = streams.n_iter, streams.T

        def gens(n):
            return [torch.Generator(device=device) for _ in range(n)]

        self.device = device
        feeds = None if feeds is None else list(feeds)
        if not streams.kernel_keys:
            self.keys = None
        elif feeds is None:
            self.keys = torch.zeros((n_iter, 2), dtype=torch.int32, device=device)
        else:
            self.keys = feeds.pop(0)
        # each iteration's noise source for the kernel: a row of the key
        # buffer, or the bits FS.key_to_seed gave in its place
        self.leads = ([None] * n_iter if feeds is None or self.keys is None
                      else [self.keys[it] for it in range(n_iter)])
        if not streams.noise:
            self.noise = None
        else:
            self.noise = gens(n_iter) if feeds is None else [FedDraws(d) for d in feeds]
        self.rollout = [gens(T) for _ in range(n_iter)] if streams.rollout else None
        self.refine = [gens(T) for _ in range(streams.refine_steps)]

    def generators(self) -> list:
        """Every generator a command draws from."""
        out = list(self.noise or [])
        for group in (self.rollout or []) + self.refine:
            out += group
        return out


class CommandStreams:
    """The random streams of one command, owned by the step that draws from
    them, and the host prologue that positions them.

    A command splits into a host prologue, :meth:`prologue`, which reads the
    stream position ``(seed, counter)`` and writes every key the command's
    iterations, rollouts and refinement draw from, and a device body, which
    draws from the fixed objects here and makes no host decision on a
    value.  So a CUDA graph of the body replays with fresh noise: the
    prologue runs before each replay.  The streams are those of
    :func:`iteration_seed`, :func:`rollout_seed` and :func:`refine_seed`:

    * ``kernel_keys``: the kernels' Philox key of iteration ``it``,
      ``FS.key_to_seed(iteration_seed(seed, counter + it))``, in a (n_iter,
      2) int32 buffer on the device (one copy from the host a command),
      which the kernels read when they run;
    * ``noise``: the plain path's generator of iteration ``it``, seeded with
      the same iteration seed (``manual_seed`` resets a generator, so a
      fixed generator draws what a new one would);
    * with stochastic dynamics one generator a rollout step ``t`` of each
      iteration (:func:`step_generator`'s seeds) and, with gradient
      refinement, of each descent step (all on ``refine_seed(seed,
      counter)``: every descent step draws the same numbers).

    A CUDA graph of the body registers ``on(device).generators()`` with
    ``torch.cuda.CUDAGraph.register_generator_state``, so that a replay
    reads the seed set by the prologue."""

    def __init__(self, config: MPPIConfig, kernel_keys: bool, noise: bool,
                 refine: bool = False):
        self.n_iter, self.T = config.num_iterations, config.T
        self.kernel_keys, self.noise = kernel_keys, noise
        self.rollout = config.stochastic_dynamics
        self.refine_steps = (config.gradient_refinement_steps
                             if refine and config.stochastic_dynamics else 0)
        self.dtype = config.dtype
        # an iteration's one draw from its noise generator: (K, reps·nu),
        # half the rows with antithetic sampling (sample_noise_flat)
        reps = config.num_support_pts or config.T
        self.draw_shape = ((config.K + 1) // 2 if config.antithetic else config.K,
                           reps * config.nu)
        self._on = {}

    def on(self, device) -> _DeviceStreams:
        """The streams on ``device``, made when first used there."""
        device = torch.device(device)
        slots = self._on.get(device)
        if slots is None:
            slots = self._on[device] = _DeviceStreams(self, device)
        return slots

    def prologue(self, seed: int, counter: int, device) -> _DeviceStreams:
        """Position every stream of the command that starts at ``counter``
        on ``device``; host work only, with at most one asynchronous copy
        to the device (the keys, from pinned memory that the caching host
        allocator keeps until the copy is done)."""
        slots = self.on(device)
        words = []
        for it in range(self.n_iter):
            pos = counter + it
            s = iteration_seed(seed, pos)
            if self.kernel_keys:
                lead = FS.key_to_seed(s)
                if isinstance(lead, torch.Tensor):  # bits injected in place of the key
                    slots.leads[it] = lead
                    lead = (0, 0)
                else:
                    slots.leads[it] = slots.keys[it]
                words.append(lead)
            if self.noise:
                slots.noise[it].manual_seed(s)
            if self.rollout:
                rs = rollout_seed(seed, pos)
                for t, g in enumerate(slots.rollout[it]):
                    g.manual_seed(iteration_seed(rs, t))
        if slots.refine:
            rs = refine_seed(seed, counter)
            for group in slots.refine:
                for t, g in enumerate(group):
                    g.manual_seed(iteration_seed(rs, t))
        if words:
            host = torch.tensor(words, dtype=torch.int64).to(torch.int32)  # wraps to 32 bits
            if slots.device.type == "cuda":
                slots.keys.copy_(host.pin_memory(), non_blocking=True)
            else:
                slots.keys.copy_(host)
        return slots

    def feeds(self, seed: int, counter: int, device) -> list:
        """What an exported body takes in place of the streams of the
        command at ``counter`` (``utils/deploy.py``): the (n_iter, 2) key
        buffer, then each iteration's N(0, 1) draws, drawn here from the
        generators the live body would draw them from.  Streams of the
        stochastic rollouts and of refinement have no feed."""
        if self.rollout or self.refine_steps:
            raise NotImplementedError("the streams of stochastic dynamics have no feed")
        slots = self.prologue(seed, counter, device)
        out = [slots.keys] if self.kernel_keys else []
        if self.noise:
            out += [standard_normal(g, self.draw_shape, self.dtype, slots.device)
                    for g in slots.noise]
        return out

    @contextlib.contextmanager
    def fed(self, device, feeds):
        """Run the body on ``device`` with the tensors of :meth:`feeds` in
        place of its streams (the key buffer and its rows, and a
        :class:`FedDraws` for each iteration's generator), so that an
        export of the body takes them as inputs."""
        device = torch.device(device)
        slots = _DeviceStreams(self, device, feeds)
        before = self._on.get(device)
        self._on[device] = slots
        try:
            yield slots
        finally:
            if before is None:
                del self._on[device]
            else:
                self._on[device] = before


_CONSTANTS = {}


def device_constant(device, key, make: Callable) -> torch.Tensor:
    """``make()``, a CPU tensor, on ``device``: copied there when first
    asked for and kept under ``key``, so that a command copies nothing from
    the host in its body (a CUDA graph of the body could not hold the
    copy).  The tensor is shared: nobody writes to it."""
    device = torch.device(device)
    t = _CONSTANTS.get((device, key))
    if t is None:
        t = _CONSTANTS[device, key] = make().to(device)
    return t


def device_scalar(value, dtype, device) -> torch.Tensor:
    """The 0-d ``torch.tensor(value, dtype=dtype)`` on ``device``
    (:func:`device_constant`)."""
    return device_constant(device, ("scalar", value, dtype),
                           lambda: torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# Small numeric helpers
# ---------------------------------------------------------------------------


def _sigma_factors(noise_sigma: torch.Tensor, diag: bool = False):
    """Cholesky factor and inverse of the (nu, nu) control covariance, derived
    inside every solve so that a changed sigma can never leave them stale.
    The ``_ex`` forms do not synchronise with the card to check the result;
    the controller rejects a sigma that is not positive definite where it is
    set (``controller._coerce_sigma``)."""
    if diag:
        d = torch.diagonal(noise_sigma)
        return torch.diag(torch.sqrt(d)), torch.diag(1.0 / d)
    chol, _ = torch.linalg.cholesky_ex(noise_sigma)
    sigma_inv, _ = torch.linalg.inv_ex(noise_sigma)
    return chol, sigma_inv


def sample_noise(generator: torch.Generator, leading_shape, params: MPPIParams,
                 dtype) -> torch.Tensor:
    """N(mu, Sigma) noise of shape ``(*leading_shape, nu)``, drawn on the
    generator's device and returned on the parameters' device."""
    nu = params.noise_mu.shape[-1]
    chol, _ = _sigma_factors(params.noise_sigma)
    z = standard_normal(generator, (*leading_shape, nu), dtype, generator.device)
    z = z.to(params.noise_mu.device)
    return z @ chol.T + params.noise_mu


def ar1_mixing(reps: int, rho: float, dtype, device=None) -> torch.Tensor:
    """Lower-triangular AR(1) mixing matrix A with unit row norms:
    A[t, s] = rho^(t-s) * (sqrt(1-rho^2) if s > 0 else 1) for s <= t, so
    per-step marginals stay N(0, 1) and the lag-1 correlation is rho."""
    t = torch.arange(reps, device=device)[:, None]
    s = torch.arange(reps, device=device)[None, :]
    r = device_scalar(rho, torch.float32, device)
    pw = torch.where(s <= t, r ** (t - s).to(torch.float32),
                     torch.zeros((), dtype=torch.float32, device=device))
    one = torch.ones((), dtype=torch.float32, device=device)
    scale = torch.where(s > 0, torch.sqrt(one - r * r), one)
    return (pw * scale).to(dtype)


def noise_operator(chol: torch.Tensor, reps: int, noise_rho: float, dtype) -> torch.Tensor:
    """The (reps·nu, reps·nu) operator that correlates flat noise rows in the
    row-vector convention ``z2 @ C``: ``kron(A_rhoᵀ, cholᵀ)`` (identity A for
    white noise).  ``torch.kron`` needs contiguous factors."""
    mix = (ar1_mixing(reps, noise_rho, dtype, chol.device) if noise_rho
           else torch.eye(reps, dtype=dtype, device=chol.device))
    return torch.kron(mix.T.contiguous(), chol.T.to(dtype).contiguous())


def sample_noise_flat(generator: torch.Generator, K: int, reps: int,
                      params: MPPIParams, dtype, antithetic: bool = False,
                      chol=None, noise_rho: float = 0.0,
                      diag_sigma: bool = False) -> torch.Tensor:
    """N(mu, Sigma) noise in the flat ``(K, reps·nu)`` layout.

    With ``antithetic`` the first ``ceil(K/2)`` rows are drawn and mirrored,
    so global rows k and K/2 + k form a pair.  A white diagonal sigma scales
    elementwise; otherwise the rows go through :func:`noise_operator`.
    """
    nu = params.noise_mu.shape[-1]
    device = params.noise_mu.device
    if chol is None:
        chol, _ = _sigma_factors(params.noise_sigma, diag=diag_sigma)
    if antithetic:
        Kh = (K + 1) // 2
        z_half = standard_normal(generator, (Kh, reps * nu), dtype, device)
        z2 = torch.cat([z_half, -z_half], dim=0)[:K]
    else:
        z2 = standard_normal(generator, (K, reps * nu), dtype, device)
    mu_t = params.noise_mu.tile(reps)
    if diag_sigma and not noise_rho:
        return z2 * torch.diagonal(chol).to(dtype).tile(reps) + mu_t
    return z2 @ noise_operator(chol, reps, noise_rho, dtype) + mu_t


def compute_weighting(cost_total: torch.Tensor, lambda_: torch.Tensor, dim: int = -1):
    """beta/eta/omega softmax weighting (reference mppi.py:12-13, 254-259)."""
    beta = torch.amin(cost_total, dim=dim, keepdim=True)
    cost_total_non_zero = torch.exp(-(cost_total - beta) / lambda_)
    eta = torch.sum(cost_total_non_zero, dim=dim, keepdim=True)
    return cost_total_non_zero, cost_total_non_zero / eta


def _bound(action: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Clamp; lo/hi are -inf/+inf when unbounded (mppi.py:120-126)."""
    return torch.clamp(action, lo, hi)


def _tile_bound(b: torch.Tensor, nu: int, reps: int, dtype) -> torch.Tensor:
    return torch.broadcast_to(b, (nu,)).to(dtype).tile(reps)


def adapt_covariance(config: MPPIConfig, sigma: torch.Tensor, omega: torch.Tensor,
                     noise: torch.Tensor, n_injected: int = 0) -> torch.Tensor:
    """Within-command covariance adaptation (``pytorch_mppi_tpu/ops/solve.py:
    189-234``): the omega-weighted second moment of the (K, T, nu) rectified
    noise about the old mean, averaged over the horizon, plus ``floor·I``,
    blended into ``sigma`` at ``config.adaptive_cov_lr``.  The first
    ``n_injected`` rows (the null row) are not draws of the sampling
    distribution: their weight is masked out and omega renormalised, and
    when it falls on those rows alone sigma is kept.  With ``diag_sigma``
    only the diagonal is adapted."""
    dtype = sigma.dtype
    T, nu = noise.shape[-2], noise.shape[-1]
    omega = omega.to(dtype)
    lr = device_scalar(config.adaptive_cov_lr, dtype, sigma.device)
    safe = None
    if n_injected:
        omega = omega.clone()
        omega[:n_injected] = 0.0
        w_sum = torch.sum(omega)
        safe = w_sum > device_scalar(1e-12, dtype, sigma.device)
        omega = omega / torch.where(safe, w_sum, torch.ones_like(w_sum))
    if config.diag_sigma:
        cov = torch.diag(torch.einsum("k,ktu->u", omega, noise * noise) / T)
    else:
        cov = torch.einsum("k,ktu,ktv->uv", omega, noise, noise) / T
    cov = cov + device_scalar(config.adaptive_cov_floor, dtype, sigma.device) * torch.eye(
        nu, dtype=dtype, device=sigma.device)
    blended = (1 - lr) * sigma + lr * cov
    if safe is not None:
        blended = torch.where(safe, blended, sigma)
    return blended


def _gate_iterations(config: MPPIConfig, variant: str):
    """At least one iteration a command, with the JAX factories' texts
    (``solve.py:1100-1104, 1482-1485``)."""
    if config.num_iterations < 1:
        raise ValueError(
            f"config.num_iterations must be >= 1, got {config.num_iterations}"
            + (" (0 would leave the solve with no update at all)" if variant == "MPPI" else ""))


def _gate_adaptive_covariance(config: MPPIConfig, use_pallas, variant: str):
    """Validate adaptive covariance and resolve its routing
    (``solve.py:854-883``): it reads each iteration's noise and omega, which
    the kernels keep out of memory, so ``use_pallas`` takes the plain path
    with a warning; with one iteration the adapted sigma drives no draw."""
    if not config.adaptive_covariance:
        return use_pallas
    if not 0.0 < config.adaptive_cov_lr <= 1.0:
        raise ValueError(f"adaptive_cov_lr must be in (0, 1], got {config.adaptive_cov_lr}")
    if config.num_iterations < 2:
        logger.warning(
            "adaptive_covariance with num_iterations=1 has no effect: the "
            "covariance adapted after the single update cycle never drives "
            "a sampling step; set num_iterations >= 2")
    if use_pallas:
        logger.warning(
            "adaptive_covariance on %s needs the per-iteration noise/omega "
            "artifacts, which the fused kernels keep out of device memory by "
            "design; using the plain torch path", variant)
        use_pallas = False
    return use_pallas


def _check_risk_alpha_range(config: MPPIConfig):
    """The [0, 1] range of ``risk_alpha`` (``solve.py:886-893``)."""
    if not 0.0 <= config.risk_alpha <= 1.0:
        raise ValueError(f"risk_alpha must be in [0, 1], got {config.risk_alpha}")


def _gate_risk_alpha(config: MPPIConfig):
    """``risk_alpha`` at the ops layer (``solve.py:896-907``): CVaR exists
    only over M > 1 rollouts, so ``risk_alpha > 0`` at M = 1 raises rather
    than being ignored."""
    _check_risk_alpha_range(config)
    if config.risk_alpha > 0.0 and config.M < 2:
        raise ValueError(
            "risk_alpha needs rollout_samples (M) > 1: CVaR over the "
            "stochastic rollouts is undefined with a single rollout")


def _gate_gradient_refinement(config: MPPIConfig, variant: str):
    """Gradient refinement's settings, with the JAX factories' texts
    (``solve.py:910-936``): MPPI only."""
    if config.gradient_refinement_steps == 0:
        return
    if config.gradient_refinement_steps < 0:
        raise ValueError(
            "gradient_refinement_steps must be >= 0, got "
            f"{config.gradient_refinement_steps}")
    if not (config.gradient_refinement_lr > 0.0
            and math.isfinite(config.gradient_refinement_lr)):
        raise ValueError(
            "gradient_refinement_lr must be a positive finite float, got "
            f"{config.gradient_refinement_lr}")
    if variant != "MPPI":
        raise ValueError(
            f"gradient_refinement_steps is only supported on MPPI, not "
            f"{variant}: SMPPI/KMPPI sample in lifted spaces (rates / support "
            f"points) and MPPI_Batched shares one solve across plants; use "
            f"plain MPPI controllers if you need the gradient stage")


def _gate_elites(config: MPPIConfig, variant: str, has_sampler: bool = True):
    """Elite reuse's settings, with the JAX factories' texts
    (``solve.py:938-970``): MPPI only, and the injected rows (null,
    sampler rows where a sampler is wired, elites) must leave fresh rows."""
    if config.num_elites == 0:
        return
    if config.num_elites < 0:
        raise ValueError(f"num_elites must be >= 0, got {config.num_elites}")
    if variant != "MPPI":
        raise ValueError(
            f"num_elites is only supported on MPPI, not {variant}: SMPPI/"
            f"KMPPI sample in lifted spaces (rates / support points) with no "
            f"action-space rows to re-inject, and MPPI_Batched shares one "
            f"sample set across plants; use plain MPPI controllers for "
            f"elite reuse")
    injected = (config.num_elites + (1 if config.sample_null_action else 0)
                + (config.num_specific_trajectories if has_sampler else 0))
    if injected >= config.K:
        raise ValueError(
            f"num_elites={config.num_elites} plus the other injected rows "
            f"(null action + specific trajectories = {injected - config.num_elites}) "
            f"fills all K={config.K} samples; leave room for fresh noise rows")


def _n_injected_rows(config: MPPIConfig, sample_trajectories) -> int:
    """The rows left out of the adaptive-covariance estimate
    (``solve.py:1114-1118``): the null row, a wired sampler's rows and the
    elites are not draws of the sampling distribution."""
    return ((1 if config.sample_null_action else 0)
            + (config.num_specific_trajectories if sample_trajectories is not None else 0)
            + config.num_elites)


# ---------------------------------------------------------------------------
# Dynamics / cost adapters
# ---------------------------------------------------------------------------


def _adapt_batch_rank(call: Callable) -> Callable:
    """``handle_batch_input(n=2)`` semantics on the ``(state, action)`` pair:
    extra leading batch dimensions are flattened before the call and
    restored on the output."""

    def adapted(s, u, *rest):
        if s.ndim <= 2:
            return call(s, u, *rest)
        lead = s.shape[:-1]
        out = call(s.reshape(-1, s.shape[-1]), u.reshape(-1, u.shape[-1]), *rest)
        return out.reshape(*lead, *out.shape[1:])

    return adapted


def wrap_dynamics(config: MPPIConfig, dynamics: Callable) -> Callable:
    """Resolve the user dynamics to ``(state, u, t, rng=None, params=None)
    -> next_state`` (``pytorch_mppi_tpu/ops/solve.py:262-289``).  The user's
    signature is ``dynamics(state, u)``, with ``step_dependent_dynamics``
    ``dynamics(state, u, t)``; with ``stochastic_dynamics`` a trailing
    ``rng``, a ``torch.Generator`` on the rollout's device for that step
    (:class:`CommandStreams`, :func:`step_generator`), is passed too:
    ``dynamics(state, u, rng)`` or ``dynamics(state, u, t, rng)``, where JAX
    passes a per-step key.  With ``parameterized_dynamics`` the dynamics
    parameters (a tensor, or a tuple, list or dict of tensors: a learned
    model's weights) lead: ``dynamics(params, state, u[, t][, rng])``."""
    lead, step, stochastic = (config.parameterized_dynamics, config.step_dependent_dynamics,
                              config.stochastic_dynamics)

    def call(s, u, t, rng=None, p=None):
        return dynamics(*((p,) if lead else ()), s, u, *((t,) if step else ()),
                        *((rng,) if stochastic else ()))

    return _adapt_batch_rank(call)


def wrap_cost(config: MPPIConfig, running_cost: Callable) -> Callable:
    """Resolve the user running cost to ``(state, u, t) -> cost``."""
    if config.step_dependent_dynamics:
        return _adapt_batch_rank(running_cost)
    return _adapt_batch_rank(lambda s, u, t: running_cost(s, u))


def wrap_final_cost(terminal_final_cost: Callable) -> Callable:
    """Resolve the user final-state terminal cost ``(final_state (..., nx),
    final_action (..., nu)) -> cost (...)`` with the batch-rank adaptation
    of :func:`wrap_cost` (``pytorch_mppi_tpu/ops/solve.py:300-310``).  A
    terminal cost of the last step only keeps lazy storage (no (K, T, nx)
    states tensor) and, as a kernel terminal cost
    (:func:`~.kernel_models.quadratic_terminal`), the fused kernels."""
    return _adapt_batch_rank(terminal_final_cost)


def _gate_terminal(terminal_state_cost, terminal_final_cost):
    """The two terminal hooks are mutually exclusive: the full-trajectory one
    forces rollout storage, the final-state one exists to avoid it
    (``solve.py:313-323``)."""
    if terminal_state_cost is not None and terminal_final_cost is not None:
        raise ValueError(
            "terminal_state_cost and terminal_final_cost are mutually "
            "exclusive: use terminal_state_cost for costs over the full "
            "(K, T, nx) trajectory, terminal_final_cost for costs of the "
            "final state only (keeps lazy storage and fused-kernel "
            "eligibility)"
        )


def _terminal_hooks(config: MPPIConfig, terminal_state_cost, terminal_final_cost):
    """The checks every step factory makes of the terminal hooks; returns
    the wrapped final-state cost (or None).  A ``terminal_state_cost`` needs
    ``config.has_terminal_cost``, which turns the rollout storage on."""
    _gate_terminal(terminal_state_cost, terminal_final_cost)
    if (terminal_state_cost is not None) != config.has_terminal_cost:
        raise ValueError(
            f"config.has_terminal_cost={config.has_terminal_cost} but terminal_state_cost is "
            f"{'set' if terminal_state_cost is not None else 'None'}: the config's flag keeps "
            f"the rollout states the terminal cost reads")
    return wrap_final_cost(terminal_final_cost) if terminal_final_cost is not None else None


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------


def rollout_costs(config: MPPIConfig, dynamics: Callable, running_cost: Callable,
                  x0: torch.Tensor, perturbed_actions: torch.Tensor,
                  terminal_state_cost: Callable = None, terminal_final_cost: Callable = None,
                  seed: int = None, specific_dynamics: Callable = None, rngs=None,
                  dyn_params=None):
    """T-step rollout of K·M trajectories from ``x0`` ((nx,) shared or
    (K, nx)), returning ``(cost (K,), states, actions)``
    (``pytorch_mppi_tpu/ops/solve.py:332-448``).  ``dynamics``,
    ``running_cost`` and ``terminal_final_cost`` are wrapped
    (:func:`wrap_dynamics`, :func:`wrap_final_cost`); the cost is taken at
    the state after each step, on the ``u_scale``-scaled action.  M
    (``config.M``) is folded into the batch, M outer and K inner: one
    (M·K, nx) dynamics call a step.  With ``stochastic_dynamics`` step t
    takes ``rngs[t]`` where the T generators are given (a command's, seeded
    by its prologue: :class:`CommandStreams`), else ``step_generator(seed,
    t)``.  ``dyn_params`` goes to the dynamics (``parameterized_dynamics``,
    :func:`wrap_dynamics`).

    Under ``config.store_rollouts`` the states (M, K, T, nx) and the scaled
    actions (M, K, T, nu) are kept, and ``terminal_state_cost(states,
    actions)`` ((K,) or (M, K)) is added to each rollout; otherwise both are
    None.  ``terminal_final_cost(final_state, last scaled action)`` is added
    from the loop's last state, with nothing stored.  At M > 1 the cost is
    the mean over the M rollouts (with ``risk_alpha`` the mean of the worst
    ``ceil(risk_alpha·M)``) plus ``rollout_var_cost`` times the running
    costs' variance over M (ddof=1), discounted by
    ``rollout_var_discount**t``.

    ``specific_dynamics(next_state, state, action, t)`` (a
    :class:`~pytorch_mppi_tpu_torch.controller.SpecificActionSampler`'s hook)
    post-processes each step's states, with the reference's quirks kept
    (``solve.py:379-392``): the shapes are (M, K, ·), ``action`` is the
    ``u_scale``-scaled action, and ``state`` is the new state again at M = 1
    but the initial state at every step at M > 1."""
    K, T, nu = perturbed_actions.shape
    M, nx, dtype = config.M, config.nx, config.dtype
    device = perturbed_actions.device
    state = x0 if x0.ndim == 2 else x0[None].expand(K, x0.shape[-1])
    if M > 1:
        state = state[None].expand(M, K, state.shape[-1]).reshape(M * K, -1)
        # the discount raised to t in config.dtype, as JAX casts it
        discount = device_constant(
            device, ("discount", config.rollout_var_discount, T, dtype),
            lambda: torch.tensor(config.rollout_var_discount, dtype=dtype) ** torch.arange(
                T, dtype=dtype))
        cost_var = torch.zeros(K, dtype=dtype, device=device)
    state0 = state
    u_scaled = perturbed_actions * config.u_scale
    cost = torch.zeros(M, K, dtype=dtype, device=device)
    store = config.store_rollouts
    kept, u_flat = [], None
    extra = () if dyn_params is None else (dyn_params,)
    for t in range(T):
        u_t = u_scaled[:, t]
        u_flat = u_t if M == 1 else u_t[None].expand(M, K, nu).reshape(M * K, nu)
        rng = None
        if config.stochastic_dynamics:
            rng = rngs[t] if rngs is not None else step_generator(seed, t, device)
        state = dynamics(state, u_flat, t, rng, *extra)
        if specific_dynamics is not None:
            s3 = state.reshape(M, K, -1)
            p3 = s3 if M == 1 else state0.reshape(M, K, -1)
            state = specific_dynamics(s3, p3, u_flat.reshape(M, K, nu), t).reshape(M * K, -1)
        c = running_cost(state, u_flat, t).reshape(M, K)
        cost = cost + c
        if M > 1:
            cost_var = cost_var + torch.var(c, dim=0, correction=1) * discount[t]
        if store:
            kept.append(state.reshape(M, K, -1)[..., :nx])
    states = actions = None
    if store:
        states = torch.stack(kept, dim=2)
        actions = u_scaled[None].expand(M, K, T, nu)
        if terminal_state_cost is not None:
            # a (K,) or (M, K) cost onto the (M, K) rollouts (mppi.py:324-328, 369-370)
            cost = cost + torch.as_tensor(terminal_state_cost(states, actions), dtype=dtype)
    if terminal_final_cost is not None:
        c = terminal_final_cost(state[..., :nx], u_flat)
        cost = cost + torch.as_tensor(c, dtype=dtype).reshape(M, K)
    if M == 1:
        return cost[0], states, actions
    if config.risk_alpha > 0.0:
        # CVaR: the mean of the worst ceil(alpha·M) rollout costs a sample
        m_w = max(1, min(M, int(math.ceil(config.risk_alpha * M))))
        cost_total = torch.mean(torch.topk(cost.T, m_w, dim=-1).values, dim=-1)
    else:
        cost_total = torch.mean(cost, dim=0)
    cost_total = cost_total + cost_var * device_scalar(config.rollout_var_cost, dtype, device)
    return cost_total, states, actions


def inject_specific_actions(config: MPPIConfig, perturbed2: torch.Tensor,
                            sample_trajectories: Callable = None, x0=None, info=None,
                            elites: torch.Tensor = None) -> torch.Tensor:
    """Overwrite the leading rows of the flat ``(K, D)`` sample set in the
    order [null, sampler rows, elites] (``pytorch_mppi_tpu/ops/solve.py:
    456-485``, reference ``_sample_specific_actions``, mppi.py:387-400): a
    zero row with ``sample_null_action``; the
    ``config.num_specific_trajectories`` rows of ``sample_trajectories(x0,
    info)`` (anything reshapeable to (n, T, nu)) where a sampler is wired;
    the (num_elites, T, nu) ``elites`` where elite reuse is on.
    ``perturbed2`` is a fresh tensor of the caller's, so the rows are set in
    place."""
    D = perturbed2.shape[1]
    i = 0
    if config.sample_null_action:
        perturbed2[0] = 0.0
        i = 1
    n = config.num_specific_trajectories
    if sample_trajectories is not None and n > 0:
        acts = torch.as_tensor(sample_trajectories(x0, info), dtype=perturbed2.dtype,
                               device=perturbed2.device)
        perturbed2[i:i + n] = acts.reshape(n, D)
        i += n
    if elites is not None and config.num_elites > 0:
        perturbed2[i:i + config.num_elites] = elites.to(perturbed2.dtype).reshape(-1, D)
    return perturbed2


def _top_elites(cost_total: torch.Tensor, num_elites: int) -> torch.Tensor:
    """The indices of the ``num_elites`` lowest costs, ties lowest index
    first, as JAX's ``lax.top_k(-cost, E)``: the first E of a stable
    ascending sort.  The next command writes elite j into row off + j, so
    the order is state; ``torch.topk`` promises no order among ties, which
    are real on the first command (E copies of the nominal)."""
    return torch.sort(cost_total, stable=True).indices[:num_elites]


def _shift_elites(elites: torch.Tensor, u_init: torch.Tensor) -> torch.Tensor:
    """Time-shift the stored elite trajectories like the nominal sequence
    (``solve.py:1057-1060``): the plan for [t, t+T) becomes a candidate for
    [t+1, t+T+1)."""
    elites = torch.roll(elites, -1, dims=1)
    elites[:, -1] = u_init
    return elites


# XORed into a state's seed for the stream of gradient refinement's stochastic
# rollouts, apart from the noise and the rollout streams
_REFINE_STREAM = 0x6A09E667F3BCC909


def refine_seed(seed: int, counter: int) -> int:
    """The rollout seed that every descent step of gradient refinement takes
    in the command that starts at stream position ``counter``: one seed for
    the whole descent (common random numbers, as JAX holds one key,
    ``solve.py:1244-1249``), from a stream of its own, so the command's
    iterations and the next command draw what they draw without it."""
    return iteration_seed(seed ^ _REFINE_STREAM, counter)


def make_nominal_refiner(config: MPPIConfig, dynamics: Callable, running_cost: Callable,
                         terminal_state_cost: Callable = None,
                         specific_dynamics: Callable = None,
                         terminal_final_cost: Callable = None) -> Callable:
    """Projected-Adam descent of the nominal sequence on the rollout cost
    (``pytorch_mppi_tpu/ops/solve.py:973-1041``): ``refine(params, U, x0,
    seed) -> U``.

    J(U) is the mean of :func:`rollout_costs` of the single trajectory U over
    the rows of x0 (one row for (nx,), Kx for (Kx, nx)): the running,
    terminal and M > 1 terms the sampling stage weighed, without the action
    cost, which is zero at the nominal.  ``config.gradient_refinement_steps``
    Adam steps (b1 = 0.9, b2 = 0.999, eps = 1e-8, bias correction at step
    i + 1 in ``config.dtype``) at ``config.gradient_refinement_lr``, each
    clamped into [u_min, u_max].  The gradient is ``torch.autograd``'s
    through the plain rollout, under ``torch.enable_grad()`` on a detached
    copy of U; the result is detached.  ``dynamics``, ``running_cost`` and
    ``terminal_final_cost`` are wrapped; stochastic dynamics draw from
    ``seed`` at every step of the descent, or descent step i from the T
    generators ``rngs[i]`` (a command's, each group seeded alike by its
    prologue).  ``dyn_params`` goes to the dynamics."""
    steps = config.gradient_refinement_steps
    dtype = config.dtype
    b1, b2, eps = 0.9, 0.999, 1e-8

    def refine(params: MPPIParams, U: torch.Tensor, x0: torch.Tensor, seed: int = None,
               rngs=None, dyn_params=None):
        device = U.device
        lr = device_scalar(config.gradient_refinement_lr, dtype, device)
        lo = torch.broadcast_to(params.u_min, (config.nu,)).to(dtype)
        hi = torch.broadcast_to(params.u_max, (config.nu,)).to(dtype)
        Kx = x0.shape[0] if x0.ndim == 2 else 1
        b1_t = device_scalar(b1, dtype, device)
        b2_t = device_scalar(b2, dtype, device)

        def J(U_, i):
            pert = U_[None].expand(Kx, *U_.shape)
            cost_total, _, _ = rollout_costs(config, dynamics, running_cost, x0, pert,
                                             terminal_state_cost, terminal_final_cost, seed,
                                             specific_dynamics,
                                             rngs=None if rngs is None else rngs[i],
                                             dyn_params=dyn_params)
            return torch.mean(cost_total)

        U_ = U.detach()
        m = torch.zeros_like(U_)
        v = torch.zeros_like(U_)
        with torch.enable_grad():
            for i in range(steps):
                leaf = U_.detach().requires_grad_(True)
                g, = torch.autograd.grad(J(leaf, i), leaf)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * (g * g)
                t = device_scalar(i + 1, dtype, device)
                m_hat = m / (1 - b1_t ** t)
                v_hat = v / (1 - b2_t ** t)
                U_ = _bound(U_ - lr * m_hat / (torch.sqrt(v_hat) + eps), lo, hi)
        return U_.detach()

    return refine


def _select_action(config: MPPIConfig, seq: torch.Tensor) -> torch.Tensor:
    """The first u_per_command actions, squeezed if 1 (mppi.py:271-275)."""
    action = seq[: config.u_per_command]
    if config.u_per_command == 1:
        action = action[0]
    return action


def _shift_U(U: torch.Tensor, u_init: torch.Tensor) -> torch.Tensor:
    """Roll the nominal sequence forward one step (mppi.py:232-238)."""
    U = torch.roll(U, -1, dims=0)
    U[-1] = u_init
    return U


def _unscaled(config: MPPIConfig, actions):
    """The stored actions artifact: the rollout's scaled actions over
    ``u_scale`` (``solve.py:1411``), or None; a rank's share stays one."""
    if actions is None:
        return None
    if not isinstance(actions, torch.Tensor):  # a parallel.Shard
        return actions._replace(local=actions.local / config.u_scale)
    return actions / config.u_scale


# ---------------------------------------------------------------------------
# Fused-kernel routing
# ---------------------------------------------------------------------------


def _transposed_operands(noise_sigma, noise_mu, u_min, u_max, config: MPPIConfig,
                         reps: int, nu: int, dtype):
    """Per-solve operands of the fused kernel: sigma⁻¹, the noise operator
    (per-row scale for a white diagonal sigma, else ``kron(A_rho, chol)``
    applied as ``op @ z``), and the tiled mu and bound columns."""
    chol, sigma_inv = _sigma_factors(noise_sigma, diag=config.diag_sigma)
    if config.diag_sigma and not config.noise_rho:
        op = torch.diagonal(chol).to(dtype).tile(reps)
    else:
        mix = (ar1_mixing(reps, config.noise_rho, dtype, chol.device)
               if config.noise_rho
               else torch.eye(reps, dtype=dtype, device=chol.device))
        op = torch.kron(mix, chol.to(dtype).contiguous())
    mu_t = noise_mu.tile(reps)
    return (sigma_inv, op, mu_t, _tile_bound(u_min, nu, reps, dtype),
            _tile_bound(u_max, nu, reps, dtype))


def _x0_to_lanes(x0: torch.Tensor, K: int) -> torch.Tensor:
    """(nx,) shared or (K, nx) per-sample initial states -> (nx, K); a shared
    state becomes a stride-0 view, which the kernel reads without a copy."""
    if x0.ndim == 2:
        return x0.T
    return x0[:, None].expand(x0.shape[-1], K)


# ---------------------------------------------------------------------------
# Sharding over a mesh axis (the counterpart of JAX's shard_map and sharding
# constraints, ``solve.py:536-760``)
# ---------------------------------------------------------------------------


class Split:
    """This rank's share of ``size`` items (samples or plants) split over
    the ranks of the mesh axis ``axis``: chunks of ``ceil(size / n)`` in
    rank order, the last one padded with copies of the last item so that
    every rank holds as many.  :meth:`take` cuts the share out of a
    replicated tensor, :meth:`join` gathers every rank's share back (a
    collective over the axis's process group), :meth:`shard` defers that
    gather to the first read of an artifact (``parallel.Shard``)."""

    def __init__(self, mesh, axis: str, size: int):
        from ..parallel import mesh as PM

        self.size = int(size)
        self.group, self.rank, self.n = (PM.axis_group(mesh, axis), PM.axis_rank(mesh, axis),
                                         PM.axis_size(mesh, axis))
        self.chunk = -(-self.size // self.n)
        self.start = self.rank * self.chunk
        self.even = self.size % self.n == 0
        self._index = {}

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.even:
            return t.narrow(dim, self.start, self.chunk)
        idx = self._index.get(t.device)
        if idx is None:
            idx = self._index[t.device] = torch.arange(
                self.start, self.start + self.chunk, device=t.device).clamp_(max=self.size - 1)
        return t.index_select(dim, idx)

    def join(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        from ..parallel.mesh import all_gather_cat

        return all_gather_cat(t, dim, self.group).narrow(dim, 0, self.size)

    def shard(self, t, dim: int = 0):
        from ..parallel.mesh import Shard

        return None if t is None else Shard(t, dim, self.group, self.size)


def _sample_split(mesh, sample_axis, K: int):
    """The split of the K samples over ``sample_axis``, or None without a
    mesh or an axis: ``sample_axis`` without a mesh is ignored, as JAX's
    ``make_constrainer`` is the identity there (``solve.py:51-66``)."""
    if mesh is None or sample_axis is None:
        return None
    return Split(mesh, sample_axis, K)


_SAMPLE_ARTIFACTS = ("cost_total", "cost_total_non_zero", "omega", "noise", "perturbed_action")


def _shard_artifacts(split, art: Artifacts) -> Artifacts:
    """A fused command's artifacts where each rank holds its share of the
    samples (dim 0 of the per-sample fields), gathered when read."""
    if split is None:
        return art
    return art._replace(**{f: split.shard(getattr(art, f)) for f in _SAMPLE_ARTIFACTS})


def _split_rollouts(split, config: MPPIConfig) -> Callable:
    """:func:`rollout_costs` on a mesh (the plain path's counterpart of
    JAX's sharding constraint on the noise and the cost, ``solve.py:1328,
    1380``): every rank holds the whole noise draw, rolls out its share of
    the K samples and gathers the (K,) costs, so the softmax and the update
    are the same on every rank and equal those of one process; the stored
    states and actions stay the rank's share until read.  Stochastic
    dynamics draw over the whole batch they are given, so with them every
    rank rolls out all K samples (one process's draws)."""
    if split is None or config.stochastic_dynamics:
        return rollout_costs

    def run(config, dynamics, running_cost, x0, perturbed_actions, *args, **kw):
        cost, states, actions = rollout_costs(
            config, dynamics, running_cost, split.take(x0) if x0.ndim == 2 else x0,
            split.take(perturbed_actions), *args, **kw)
        return split.join(cost), split.shard(states, 1), split.shard(actions, 1)

    return run


def _merge_stats(delta, m, s, group):
    """The flash-softmax merge of the ranks' statistics (``solve.py:609-
    614``): m_g = max m, s_g = Σ s · e^(m − m_g), delta_g = Σ delta ·
    e^(m − m_g), three collectives over ``group``."""
    import torch.distributed as dist

    m_g = m.reshape(1).clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g[0])
    s_g = (s * corr).reshape(1)
    dist.all_reduce(s_g, op=dist.ReduceOp.SUM, group=group)
    delta_g = delta * corr
    dist.all_reduce(delta_g, op=dist.ReduceOp.SUM, group=group)
    return delta_g, m_g[0], s_g[0]


def _make_sharded_solve(config: MPPIConfig, factory: Callable, model, mesh, sample_axis: str,
                        pair_block: int = None, emit_perturbed: bool = None,
                        terminal_final=None, tile_k: int = None):
    """A single-plant fused solve with K split over ``sample_axis``: each
    rank runs kernel A over its K/n samples, and the ranks' statistics merge
    with three collectives (:func:`_merge_stats`; JAX's
    ``_make_sharded_solve``, ``solve.py:536-639``).  Same call contract as
    ``factory``'s solve (the injected bits, if any, are the global tensor);
    ``cost`` and the emitted perturbed set (by default with
    ``config.fused_artifacts``, as JAX's) come back as the rank's (K/n,) and
    (D, K/n) slices, in rank order (``solve.split.join`` gathers them).

    The noise: rank r builds its kernel as shard (r, n) of the samples
    (``FS.make_transposed_fused_solve``'s ``shard``): its sample k draws
    the Philox counters (or the injected bits) of global sample r·K/n + k,
    with the global antithetic pairing, so the n ranks draw exactly what
    one solve of K samples draws, and no two ranks draw the same noise.
    The null row: every rank's kernel takes the null-action gate, 1 on the
    rank holding global sample 0 (``rank == 0`` on the axis) and 0
    elsewhere.  K not divisible by n raises :class:`FS.FusedSolveUnavailable`
    (``solve.py:576-581``)."""
    split = Split(mesh, sample_axis, config.K)
    if not split.even:
        raise FS.FusedSolveUnavailable(
            f"K={config.K} must divide evenly over the {split.n}-way {sample_axis!r} mesh "
            f"axis for the sharded fused solve")
    local = factory(dataclasses.replace(config, K=split.chunk), model,
                    pair_block=pair_block,
                    emit_perturbed=(config.fused_artifacts if emit_perturbed is None
                                    else emit_perturbed),
                    null_dynamic_gate=True, terminal_final=terminal_final, tile_k=tile_k,
                    shard=(split.rank, split.n))
    gated = config.sample_null_action
    on = int(split.rank == 0)

    def solve(lead, x0T, *rest):
        device = x0T.device
        gate = (device_constant(device, ("null_gate", on), lambda: torch.tensor(
            [on], dtype=torch.int32)),) if gated else ()
        out = local(lead, split.take(x0T, 1), *rest, *gate)
        delta, m, s_ = _merge_stats(out[0], out[1], out[2], split.group)
        return (delta, m, s_) + tuple(out[3:])

    solve.tiles, solve.tile_k, solve.local, solve.split = local.tiles, local.tile_k, local, split
    return solve


def make_sharded_transposed_solve(config: MPPIConfig, model, mesh, sample_axis: str = "k",
                                  **kw):
    """K-sharded MPPI fused solve (:func:`_make_sharded_solve`); the call
    contract of ``FS.make_transposed_fused_solve``'s solve, without the
    elites operand."""
    return _make_sharded_solve(config, FS.make_transposed_fused_solve, model, mesh,
                               sample_axis, **kw)


def make_sharded_smppi_solve(config: MPPIConfig, model, mesh, sample_axis: str = "k", **kw):
    """K-sharded SMPPI fused solve; the rate-space delta merges across the
    ranks as the plain one."""
    return _make_sharded_solve(config, FS.make_transposed_smppi_solve, model, mesh,
                               sample_axis, **kw)


def make_sharded_kmppi_solve(config: MPPIConfig, model, mesh, sample_axis: str = "k", **kw):
    """K-sharded KMPPI fused solve; the theta-space delta merges across the
    ranks as the plain one."""
    return _make_sharded_solve(config, FS.make_transposed_kmppi_solve, model, mesh,
                               sample_axis, **kw)


def make_sharded_batched_solve(config: MPPIConfig, num_envs: int, model, mesh,
                               env_axis: str = "data", **kw):
    """The batched fused solve with the N plants split over ``env_axis``
    (JAX's ``make_sharded_batched_solve``, ``solve.py:704-760``): each rank
    runs ``batched_partial`` and ``flash_merge`` over its N/n plants, with no
    collective.  The lead operand (the key, the bits or the noise operand)
    is the same on every rank, so the plants share the noise across the
    ranks as on one card.  Takes the global x0T (nx, N), U2T and aT (D, N);
    returns the rank's delta (D, N/n), ms (2, N/n) and cost (N/n, K).  N not
    divisible by n raises :class:`FS.FusedSolveUnavailable`; ``kw`` go to
    ``FS.make_transposed_batched_solve``."""
    split = Split(mesh, env_axis, num_envs)
    if not split.even:
        raise FS.FusedSolveUnavailable(
            f"num_envs={num_envs} must divide evenly over the {split.n}-way {env_axis!r} "
            f"mesh axis for the sharded batched fused solve")
    local = FS.make_transposed_batched_solve(config, split.chunk, model, **kw)

    def solve(lead, x0T, U2T, op, mu_t, lo_t, hi_t, aT, lambda_):
        return local(lead, split.take(x0T, 1), split.take(U2T, 1), op, mu_t, lo_t, hi_t,
                     split.take(aT, 1), lambda_)

    for name in ("tiles", "K_pad", "noise_operand", "plant_group"):
        setattr(solve, name, getattr(local, name))
    solve.local, solve.split = local, split
    return solve


def _fused_factory(factory: Callable, sharded_factory: Callable, mesh, split, sample_axis):
    """The fused solve's factory: ``factory``, or on a mesh the sharded one
    bound to it (``solve.py:1157-1168``)."""
    if split is None:
        return factory
    return lambda config, model, **kw: sharded_factory(config, model, mesh, sample_axis, **kw)


def _route_transposed_solve(config: MPPIConfig, dynamics: Callable,
                            running_cost: Callable,
                            factory: Callable = FS.make_transposed_fused_solve,
                            variant: str = "MPPI", terminal_state_cost: Callable = None,
                            terminal_final_cost: Callable = None, has_sampler: bool = False,
                            sharded: bool = False):
    """``use_pallas`` routing, decided once when the step is built: the fused
    solve that ``factory`` builds, or None (the plain path) with a warning
    saying why.  A ``terminal_state_cost`` reads the rollout storage the
    kernel keeps out of memory, so it takes the plain path, as JAX's
    eligibility check (``solve.py:817-830``); a ``terminal_final_cost`` goes
    into the kernel when it is a kernel terminal cost, and any other takes
    the plain path, as a terminal cost JAX cannot trace into its kernel
    (``solve.py:831``).  A specific-action sampler (``has_sampler``: its
    rows or its dynamics hook) takes the plain path; elite reuse keeps the
    kernel only with ``fused_artifacts``, and without it the warning names
    that flag (``solve.py:788-832``).  ``sharded``: the factory builds a
    K-sharded solve, which takes no elites operand (``solve.py:790-797``)."""
    if sharded and config.num_elites > 0:
        logger.warning(
            "use_pallas with num_elites on a K-sharded mesh is not supported by the fused "
            "kernels (the elites would have to reach the one rank holding their samples); "
            "using the plain torch path for %s", variant)
        return None
    if terminal_state_cost is not None:
        logger.warning(
            "use_pallas requested but terminal_state_cost reads the (K, T, nx) rollout "
            "storage the fused kernel keeps out of memory; using the plain torch path for "
            "%s (a terminal_final_cost keeps the kernel)", variant)
        return None
    if (config.num_elites > 0 and not config.fused_artifacts
            and FS.transposed_eligible(dataclasses.replace(config, fused_artifacts=True),
                                       has_specific_sampler=has_sampler)):
        # the one ineligibility the user can lift with a flag: say so
        logger.warning(
            "use_pallas with num_elites=%d needs fused_artifacts=True (the top-k elite "
            "refresh reads the kernel's materialized perturbed set); using the plain torch "
            "path - set fused_artifacts=True to keep the fused kernel", config.num_elites)
        return None
    if not FS.transposed_eligible(config, has_specific_sampler=has_sampler):
        logger.warning(
            "use_pallas requested but the configuration is ineligible "
            "(specific sampler / elite reuse without fused_artifacts / M>1 / "
            "stochastic / parameterized dynamics / non-float32 / step-dependent); "
            "using the plain torch path for %s", variant,
        )
        return None
    model = find_kernel_model(dynamics, running_cost)
    if model is None:
        logger.warning(
            "use_pallas: the dynamics and running cost carry no kernel model "
            "(ops/kernel_models.py); using the plain torch path for %s", variant,
        )
        return None
    try:
        solve = factory(config, model, emit_perturbed=config.fused_artifacts,
                        terminal_final=terminal_final_cost)
    except FS.FusedSolveUnavailable as e:
        logger.warning(
            "use_pallas: fused %s kernel unavailable for this configuration "
            "(%s); using the plain torch path", variant, e,
        )
        return None
    logger.info(
        "use_pallas: routing %s to the fused CUDA kernel with the %r kernel "
        "model (%s-memory tiles); noise/perturbed artifacts %s", variant,
        model.name, solve.tiles,
        "materialized (fused_artifacts)" if config.fused_artifacts
        else "are not materialized",
    )
    return solve


def _route_legacy_rollout(config: MPPIConfig, dynamics: Callable,
                          running_cost: Callable, has_terminal: bool = False,
                          has_specific: bool = False, sharded: bool = False):
    """``use_pallas="rollout"`` routing (``solve.py:1133-1157``): the legacy
    rollout kernel, or None (the plain path) with a warning saying why.  The
    kernel takes no terminal cost and runs no ``specific_dynamics`` hook, as
    JAX's ``pallas_eligible(has_terminal, has_specific)``, and does not
    shard (``sharded``: a mesh, ``solve.py:1138``); the null, sampler and
    elite rows are written before it."""
    model = find_kernel_model(dynamics, running_cost)
    why = None
    if sharded:
        why = "a mesh is set, and the legacy kernels do not shard"
    elif has_terminal:
        why = "a terminal cost is set, which the legacy rollout kernel does not take"
    elif has_specific:
        why = ("a specific_dynamics hook is set (a SpecificActionSampler's), which the "
               "legacy rollout kernel does not run")
    elif not LG.pallas_eligible(config):
        why = ("the configuration is ineligible (M>1 / stochastic / parameterized dynamics / "
               "non-float32 / step-dependent)")
    elif model is None:
        why = "the dynamics and running cost carry no kernel model (ops/kernel_models.py)"
    else:
        try:
            rollout = LG.make_fused_rollout(config, model)
        except FS.FusedSolveUnavailable as e:
            why = str(e)
    if why is not None:
        logger.warning("use_pallas='rollout' requested but %s; using the plain torch path",
                       why)
        return None
    logger.warning(
        "use_pallas='rollout' selects the legacy kernel pair (the rollout and the "
        "weighted update around the plain path's noise, %r kernel model); "
        "use_pallas=True runs the whole iteration in one fused kernel", model.name)
    return rollout


# ---------------------------------------------------------------------------
# Step factory
# ---------------------------------------------------------------------------


class StepFns(NamedTuple):
    """The entry points a factory builds.  ``step`` is ``streams.prologue``
    (host: the command's keys and generator seeds) then ``body`` (the device
    work, which a CUDA graph can capture: ``runner.run_mppi_jit``)."""

    step: Callable  # (params, state, x0[, info], dyn_params=None) -> (state, action, Artifacts)
    step_no_shift: Callable  # same, without the nominal-trajectory shift
    get_rollouts: Callable  # (params, x0 (R, nx), U (T, nu)) -> (R, T, nx)
    fused: bool = False  # commands run through the kernels of csrc/fused_mppi.cu
    # (params, state, x0[, info], dyn_params, shift) after streams.prologue(seed, counter, device)
    body: Callable = None
    streams: CommandStreams = None


def _steps(body: Callable, streams: CommandStreams, get_rollouts, fused: bool,
           info: bool = True) -> StepFns:
    """The step functions of a body: the prologue at the state's stream
    position, then the body (``info`` is False for the batched step, which
    takes none)."""
    if info:
        def run(params, state, x0, info=None, dyn_params=None, shift=True):
            streams.prologue(state.seed, state.counter, state.U.device)
            return body(params, state, x0, info, dyn_params, shift)

        step = lambda params, state, x0, info=None, dyn_params=None: run(
            params, state, x0, info, dyn_params)
        step_no_shift = lambda params, state, x0, info=None, dyn_params=None: run(
            params, state, x0, info, dyn_params, False)
    else:
        def run(params, state, x0, dyn_params=None, shift=True):
            streams.prologue(state.seed, state.counter, state.U.device)
            return body(params, state, x0, dyn_params, shift)

        step = lambda params, state, x0, dyn_params=None: run(params, state, x0, dyn_params)
        step_no_shift = lambda params, state, x0, dyn_params=None: run(
            params, state, x0, dyn_params, False)
    return StepFns(step=step, step_no_shift=step_no_shift, get_rollouts=get_rollouts,
                   fused=fused, body=body, streams=streams)


def make_mppi_step(config: MPPIConfig, dynamics: Callable, running_cost: Callable,
                   use_pallas=False, terminal_state_cost: Callable = None,
                   terminal_final_cost: Callable = None, sample_trajectories: Callable = None,
                   specific_dynamics: Callable = None, mesh=None,
                   sample_axis: str = "k") -> StepFns:
    """Build the MPPI solve for one configuration.

    With ``use_pallas`` (the JAX package's name for its fused kernel), an
    eligible configuration whose dynamics and cost carry a kernel model runs
    each command through the fused CUDA kernel; otherwise the plain path runs,
    after a warning.  The fused path draws its noise from the kernel's own
    Philox stream, so its samples differ from the plain path's.  With
    ``use_pallas="rollout"`` the plain path's noise stream is kept and the
    rollout and the weighted update run through the legacy kernels.

    ``terminal_state_cost(states (M, K, T, nx), actions (M, K, T, nu)) ->
    (K,) or (M, K)`` (with ``config.has_terminal_cost``) and
    ``terminal_final_cost(final_state (M·K, nx), final_action (M·K, nu)) ->
    (M·K,)``, mutually exclusive, add a terminal cost as JAX's
    (:func:`rollout_costs`); only a kernel terminal cost given as
    ``terminal_final_cost`` keeps the fused kernel, and neither the legacy
    route.

    Each command runs ``config.num_iterations`` iterations, each re-centred
    on the last one's nominal sequence (``solve.py:1219-1240``): iteration i
    draws its noise from ``iteration_seed(seed, counter + i)`` and its
    stochastic rollout from ``rollout_seed(seed, counter + i)``, and the
    counter advances by ``num_iterations``.  The route holds for every
    iteration: the fused kernel launches once an iteration, the legacy pair
    twice.  With ``adaptive_covariance`` the sigma of each iteration after
    the first is :func:`adapt_covariance` of the last (the plain path only);
    the next command starts again from ``params.noise_sigma``.  M > 1 and
    stochastic dynamics take the plain path.  The artifacts are the last
    iteration's.

    A specific-action sampler's ``sample_trajectories(x0, info)`` writes
    ``config.num_specific_trajectories`` rows after the null row, and its
    ``specific_dynamics`` runs in the rollout (:func:`rollout_costs`); either
    takes the plain path.  With ``config.num_elites`` (elite reuse,
    ``solve.py:1196-1415``) ``state.elites`` is shifted once a command and
    written after those rows before the clamp, and after each iteration it
    becomes that iteration's lowest-cost perturbed rows (:func:`_top_elites`):
    on the fused kernel (with ``fused_artifacts``) as an operand and the
    columns of its perturbed set, on the legacy route as the plain row write.
    With ``config.gradient_refinement_steps`` the nominal sequence of the
    last iteration is refined by :func:`make_nominal_refiner` on every
    route, with stochastic dynamics on ``refine_seed(seed, counter)``.
    The steps take ``dyn_params`` after ``info``
    (``config.parameterized_dynamics``, the plain path).

    With a ``mesh`` (``parallel.make_mesh``) the K samples split over its
    ``sample_axis`` ranks (``solve.py:1081-1180``): the fused kernel as
    :func:`make_sharded_transposed_solve` (elite reuse takes the plain path,
    with a warning), the plain path through :func:`_split_rollouts`, and
    the legacy route takes the plain path.  Every rank returns the same
    action; the per-sample artifacts of the fused route are the rank's
    share until read (``parallel.Shard``).
    """
    _gate_iterations(config, "MPPI")
    use_pallas = _gate_adaptive_covariance(config, use_pallas, "MPPI")
    _gate_risk_alpha(config)
    _gate_gradient_refinement(config, "MPPI")
    _gate_elites(config, "MPPI", has_sampler=sample_trajectories is not None)
    final_cost = _terminal_hooks(config, terminal_state_cost, terminal_final_cost)
    n_injected_rows = _n_injected_rows(config, sample_trajectories)
    dyn = wrap_dynamics(config, dynamics)
    cost = wrap_cost(config, running_cost)
    dtype = config.dtype
    K, T, nu = config.K, config.T, config.nu
    D = T * nu
    n_iter, adaptive = config.num_iterations, config.adaptive_covariance
    E = config.num_elites
    has_sampler = sample_trajectories is not None or specific_dynamics is not None

    legacy = use_pallas == "rollout"
    has_terminal = terminal_state_cost is not None or terminal_final_cost is not None
    split = _sample_split(mesh, sample_axis, K)
    fused_rollout = (_route_legacy_rollout(config, dynamics, running_cost, has_terminal,
                                           has_specific=specific_dynamics is not None,
                                           sharded=split is not None)
                     if legacy else None)
    transposed_solve = (_route_transposed_solve(config, dynamics, running_cost,
                                                _fused_factory(FS.make_transposed_fused_solve,
                                                               make_sharded_transposed_solve,
                                                               mesh, split, sample_axis),
                                                terminal_state_cost=terminal_state_cost,
                                                terminal_final_cost=terminal_final_cost,
                                                has_sampler=has_sampler,
                                                sharded=split is not None)
                        if use_pallas and not legacy else None)
    rollouts = _split_rollouts(split, config)
    # the gradient stage after the iterations, on every route: autograd
    # through the plain rollout
    refine_nominal = (make_nominal_refiner(config, dyn, cost, terminal_state_cost,
                                           specific_dynamics, final_cost)
                      if config.gradient_refinement_steps > 0 else None)
    streams = CommandStreams(config, kernel_keys=transposed_solve is not None,
                             noise=transposed_solve is None,
                             refine=refine_nominal is not None)

    def _one_iteration_fused(params: MPPIParams, U, elites, x0, lead):
        """The whole cycle as one fused-kernel call; only the tiny operands
        (sigma factors, noise operator, action-cost vector, the elites) are
        made here."""
        sigma_inv, op, mu_t, lo2, hi2 = _transposed_operands(
            params.noise_sigma, params.noise_mu, params.u_min, params.u_max,
            config, T, nu, dtype,
        )
        a_flat = (params.lambda_ * (U @ sigma_inv.T)).reshape(D)
        elites_in = (elites.to(dtype).reshape(E, D).contiguous(),) if E else ()
        out = transposed_solve(
            lead, _x0_to_lanes(x0, K), U.reshape(D), op, mu_t, lo2,
            hi2, a_flat, params.lambda_, *elites_in,
        )
        delta, m, s_, cost_total = out[:4]
        ctnz, omega = FS.weighting_from_stats(cost_total, params.lambda_, m, s_)
        U_new = U + (delta / s_).reshape(T, nu)
        if E:
            # the refresh gathers E columns of the emitted (D, K) set
            idx = _top_elites(cost_total, E)
            elites = out[4][:, idx].T.reshape(E, T, nu)
        noise_art = pert_art = None
        if config.fused_artifacts:
            # the rectified noise is the subtraction the kernel's update used
            perturbed2 = out[4].T
            noise_art = (perturbed2 - U.reshape(D)[None]).reshape(-1, T, nu)
            pert_art = perturbed2.reshape(-1, T, nu)
        return U_new, _shard_artifacts(split, Artifacts(cost_total, ctnz, omega, noise_art,
                                                        pert_art)), elites

    def _one_iteration(params: MPPIParams, U, elites, x0, info, slots, it: int, dyn_params):
        if transposed_solve is not None:
            return _one_iteration_fused(params, U, elites, x0, slots.leads[it])
        chol, sigma_inv = _sigma_factors(params.noise_sigma, diag=config.diag_sigma)
        noise2 = sample_noise_flat(
            slots.noise[it], K, T, params, dtype,
            antithetic=config.antithetic, chol=chol,
            noise_rho=config.noise_rho, diag_sigma=config.diag_sigma,
        )
        U2 = U.reshape(D)
        perturbed2 = inject_specific_actions(config, U2[None] + noise2, sample_trajectories,
                                             x0, info, elites)
        perturbed2 = _bound(perturbed2, _tile_bound(params.u_min, nu, T, dtype),
                            _tile_bound(params.u_max, nu, T, dtype))
        # rectified noise: recomputed after the clamp so that truncated noise
        # is not charged in the action cost (mppi.py:383-385)
        noise2 = perturbed2 - U2[None]
        # sum_{t,n} U λ (noise Σ⁻¹) == noise_flat @ (λ Σ⁻¹ U)_flat (mppi.py:407-417)
        a_flat = (params.lambda_ * (U @ sigma_inv.T)).reshape(D)
        n_for_cost = torch.abs(noise2) if config.noise_abs_cost else noise2
        perturbation_cost = n_for_cost @ a_flat
        perturbed = perturbed2.reshape(K, T, nu)
        states = actions = None
        if fused_rollout is None:
            rollout_cost, states, actions = rollouts(
                config, dyn, cost, x0, perturbed, terminal_state_cost, final_cost,
                specific_dynamics=specific_dynamics, rngs=slots.rollout[it] if slots.rollout else None,
                dyn_params=dyn_params)
            cost_total = rollout_cost + perturbation_cost
            cost_total_non_zero, omega = compute_weighting(cost_total, params.lambda_)
            U_new = U + (omega @ noise2).reshape(T, nu)
        else:
            # the legacy kernels (solve.py:1366-1391): x0 broadcast to (K, nx)
            x0_K = x0 if x0.ndim == 2 else x0[None].expand(K, x0.shape[-1])
            cost_total = fused_rollout(x0_K, perturbed * config.u_scale) + perturbation_cost
            pert_flat, m, s_ = LG.fused_weighted_update(cost_total, noise2, params.lambda_)
            cost_total_non_zero, omega = FS.weighting_from_stats(
                cost_total, params.lambda_, m, s_)
            U_new = U + (pert_flat / s_).reshape(T, nu)
        if E:
            # the injected elites compete with the fresh rows on their cost
            elites = perturbed2[_top_elites(cost_total, E)].reshape(E, T, nu)
        return U_new, Artifacts(cost_total, cost_total_non_zero, omega,
                                noise2.reshape(K, T, nu), perturbed, states,
                                _unscaled(config, actions)), elites

    def body(params: MPPIParams, state: MPPIState, x0, info, dyn_params, shift: bool):
        U, elites = state.U, state.elites
        if E and elites is None:
            raise ValueError(
                f"config.num_elites={E} but state.elites is None: seed MPPIState.elites "
                f"with (num_elites, T, nu) trajectories (e.g. broadcast copies of the "
                f"nominal, as MPPI._initial_elites does)")
        if shift:
            U = _shift_U(U, params.u_init)
            if E:
                # the elite plans advance one step with the receding horizon
                elites = _shift_elites(elites, params.u_init)
        x0 = torch.as_tensor(x0, dtype=dtype, device=U.device)
        slots = streams.on(U.device)
        sigma = params.noise_sigma
        for it in range(n_iter):
            it_params = params._replace(noise_sigma=sigma) if adaptive else params
            U, artifacts, elites = _one_iteration(it_params, U, elites, x0, info, slots, it,
                                                  dyn_params)
            if adaptive and it + 1 < n_iter:
                sigma = adapt_covariance(config, sigma, artifacts.omega, artifacts.noise,
                                         n_injected_rows)
        if refine_nominal is not None:
            U = refine_nominal(params, U, x0, rngs=slots.refine or None, dyn_params=dyn_params)
        new_state = MPPIState(U=U, seed=state.seed, counter=state.counter + n_iter,
                              elites=elites)
        return new_state, _select_action(config, U), artifacts

    return _steps(body, streams, make_get_rollouts(config, dyn),
                  fused=transposed_solve is not None or fused_rollout is not None)


def make_smppi_step(config: MPPIConfig, dynamics: Callable, running_cost: Callable,
                    use_pallas: bool = False, terminal_state_cost: Callable = None,
                    terminal_final_cost: Callable = None, sample_trajectories: Callable = None,
                    specific_dynamics: Callable = None, mesh=None,
                    sample_axis: str = "k") -> StepFns:
    """Build the SMPPI solve (``pytorch_mppi_tpu/ops/solve.py:1469-1696``):
    noise in action-rate space, clamped to the rate bounds, integrated onto
    the commanded sequence, clamped to the action bounds, the noise
    back-computed through both clamps and a smoothness cost added.  The
    steps take :class:`SMPPIParams` and :class:`SMPPIState`; ``use_pallas``,
    the terminal hooks and the iterations work as in :func:`make_mppi_step`.
    The iterations re-centre the rate-space draws on the updated ``U`` over
    one integration base, and the commanded sequence is integrated once
    with the final ``U`` (``solve.py:1547-1571``); adaptive covariance
    adapts the rate-space sigma.  A specific-action sampler writes its rows
    into the integrated actions before the action clamp (``solve.py:
    1636-1646``) and takes the plain path, as in :func:`make_mppi_step`;
    elite reuse and gradient refinement raise (MPPI only).  ``mesh`` and
    ``sample_axis`` split the K samples as in :func:`make_mppi_step`."""
    _gate_iterations(config, "SMPPI")
    use_pallas = _gate_adaptive_covariance(config, use_pallas, "SMPPI")
    _gate_risk_alpha(config)
    _gate_gradient_refinement(config, "SMPPI")
    _gate_elites(config, "SMPPI")
    final_cost = _terminal_hooks(config, terminal_state_cost, terminal_final_cost)
    n_injected_rows = _n_injected_rows(config, sample_trajectories)
    dyn = wrap_dynamics(config, dynamics)
    cost = wrap_cost(config, running_cost)
    dtype = config.dtype
    K, T, nu = config.K, config.T, config.nu
    D = T * nu
    n_iter, adaptive = config.num_iterations, config.adaptive_covariance

    split = _sample_split(mesh, sample_axis, K)
    transposed_solve = (
        _route_transposed_solve(config, dynamics, running_cost,
                                _fused_factory(FS.make_transposed_smppi_solve,
                                               make_sharded_smppi_solve, mesh, split,
                                               sample_axis), "SMPPI",
                                terminal_state_cost, terminal_final_cost,
                                sample_trajectories is not None or specific_dynamics is not None,
                                sharded=split is not None)
        if use_pallas else None)
    rollouts = _split_rollouts(split, config)
    streams = CommandStreams(config, kernel_keys=transposed_solve is not None,
                             noise=transposed_solve is None)

    def _one_iteration_fused(params: SMPPIParams, U, action_sequence, x0, lead):
        base = params.base
        sigma_inv, op, mu_t, lo2, hi2 = _transposed_operands(
            base.noise_sigma, base.noise_mu, base.u_min, base.u_max, config, T, nu, dtype)
        alo2 = _tile_bound(params.action_min, nu, T, dtype)
        ahi2 = _tile_bound(params.action_max, nu, T, dtype)
        a_flat = (base.lambda_ * (U @ sigma_inv.T)).reshape(D)
        out = transposed_solve(
            lead, _x0_to_lanes(x0, K), U.reshape(D),
            action_sequence.reshape(D), op, mu_t, lo2, hi2, alo2, ahi2, a_flat,
            base.lambda_, params.w_action_seq_cost, params.delta_t,
        )
        delta, m, s_, cost_total = out[:4]
        ctnz, omega = FS.weighting_from_stats(cost_total, base.lambda_, m, s_)
        U_new = U + (delta / s_).reshape(T, nu)
        noise_art = pert_art = None
        if config.fused_artifacts:
            # action-space sequences come back (D, K); the rate-space noise is
            # the kernel's own back-computation through both clamps
            pa2 = out[4].T
            noise_art = ((pa2 - action_sequence.reshape(D)[None]) / params.delta_t
                         - U.reshape(D)[None]).reshape(-1, T, nu)
            pert_art = pa2.reshape(-1, T, nu)
        return U_new, _shard_artifacts(split, Artifacts(cost_total, ctnz, omega, noise_art,
                                                        pert_art))

    def _one_iteration(params: SMPPIParams, U, action_sequence, x0, info, slots, it: int,
                       dyn_params):
        if transposed_solve is not None:
            return _one_iteration_fused(params, U, action_sequence, x0, slots.leads[it])
        base = params.base
        chol, sigma_inv = _sigma_factors(base.noise_sigma, diag=config.diag_sigma)
        noise2 = sample_noise_flat(
            slots.noise[it], K, T, base, dtype,
            antithetic=config.antithetic, chol=chol,
            noise_rho=config.noise_rho, diag_sigma=config.diag_sigma,
        )
        U2 = U.reshape(D)
        as2 = action_sequence.reshape(D)
        perturbed_control2 = _bound(U2[None] + noise2, _tile_bound(base.u_min, nu, T, dtype),
                                    _tile_bound(base.u_max, nu, T, dtype))
        perturbed_action2 = inject_specific_actions(
            config, as2[None] + perturbed_control2 * params.delta_t, sample_trajectories, x0,
            info)
        perturbed_action2 = _bound(perturbed_action2,
                                   _tile_bound(params.action_min, nu, T, dtype),
                                   _tile_bound(params.action_max, nu, T, dtype))
        # effective noise back-computed through both clamps (mppi.py:552)
        noise2 = (perturbed_action2 - as2[None]) / params.delta_t - U2[None]
        a_flat = (base.lambda_ * (U @ sigma_inv.T)).reshape(D)
        n_for_cost = torch.abs(noise2) if config.noise_abs_cost else noise2
        perturbation_cost = n_for_cost @ a_flat
        # smoothness w * sum ||u_scale * diff(actions)||^2 (mppi.py:558-562):
        # the time difference is a shift by nu in the flat layout
        action_diff = config.u_scale * (perturbed_action2[:, nu:] - perturbed_action2[:, :-nu])
        smoothness = params.w_action_seq_cost * torch.sum(action_diff * action_diff, dim=1)
        perturbed_action = perturbed_action2.reshape(K, T, nu)
        rollout_cost, states, actions = rollouts(
            config, dyn, cost, x0, perturbed_action, terminal_state_cost, final_cost,
            specific_dynamics=specific_dynamics,
            rngs=slots.rollout[it] if slots.rollout else None, dyn_params=dyn_params)
        cost_total = rollout_cost + perturbation_cost + smoothness
        cost_total_non_zero, omega = compute_weighting(cost_total, base.lambda_)
        U_new = U + (omega @ noise2).reshape(T, nu)
        return U_new, Artifacts(cost_total, cost_total_non_zero, omega,
                                noise2.reshape(K, T, nu), perturbed_action, states,
                                _unscaled(config, actions))

    def body(params: SMPPIParams, state: SMPPIState, x0, info, dyn_params, shift: bool):
        U, action_sequence = state.U, state.action_sequence
        if shift:
            # roll both sequences; repeat the last commanded action (mppi.py:489-493)
            U = _shift_U(U, params.base.u_init)
            action_sequence = _shift_sequence(action_sequence)
        x0 = torch.as_tensor(x0, dtype=dtype, device=U.device)
        slots = streams.on(U.device)
        sigma = params.base.noise_sigma
        for it in range(n_iter):
            it_params = (params._replace(base=params.base._replace(noise_sigma=sigma))
                         if adaptive else params)
            U, artifacts = _one_iteration(it_params, U, action_sequence, x0, info, slots, it,
                                          dyn_params)
            if adaptive and it + 1 < n_iter:
                sigma = adapt_covariance(config, sigma, artifacts.omega, artifacts.noise,
                                         n_injected_rows)
        # integrate the lifted control (mppi.py:529-531)
        action_sequence_new = action_sequence + U * params.delta_t
        new_state = SMPPIState(U=U, action_sequence=action_sequence_new,
                               seed=state.seed, counter=state.counter + n_iter)
        return new_state, _select_action(config, action_sequence_new), artifacts

    return _steps(body, streams, make_get_rollouts(config, dyn),
                  fused=transposed_solve is not None)


def _shift_sequence(seq: torch.Tensor) -> torch.Tensor:
    """Roll a commanded sequence forward one step and repeat its last row
    (mppi.py:489-493)."""
    seq = torch.roll(seq, -1, dims=0)
    seq[-1] = seq[max(seq.shape[0] - 2, 0)]
    return seq


def make_kmppi_step(config: MPPIConfig, dynamics: Callable, running_cost: Callable,
                    use_pallas: bool = False, terminal_state_cost: Callable = None,
                    terminal_final_cost: Callable = None, sample_trajectories: Callable = None,
                    specific_dynamics: Callable = None, mesh=None,
                    sample_axis: str = "k") -> StepFns:
    """Build the KMPPI solve (``pytorch_mppi_tpu/ops/solve.py:1704-1924``):
    noise at the ``num_support_pts`` control points, clamped there,
    interpolated to the horizon by ``kron(interp_full, I_nu)``, the null row,
    the trajectory clamp; the update is taken in theta space and
    ``U = interp_full @ theta``.  The steps take :class:`KMPPIParams` and
    :class:`KMPPIState`; ``use_pallas``, the terminal hooks and the
    iterations work as in :func:`make_mppi_step`.  Each iteration re-centres
    the support-point draws on the updated theta; adaptive covariance adapts
    the theta-space sigma from the rectified support-point noise
    (``solve.py:1780-1800``).  A specific-action sampler writes its rows into
    the full-horizon rows after the interpolation (``solve.py:1869-1876``)
    and takes the plain path; elite reuse and gradient refinement raise.
    ``mesh`` and ``sample_axis`` split the K samples as in
    :func:`make_mppi_step`."""
    _gate_iterations(config, "KMPPI")
    use_pallas = _gate_adaptive_covariance(config, use_pallas, "KMPPI")
    _gate_risk_alpha(config)
    _gate_gradient_refinement(config, "KMPPI")
    _gate_elites(config, "KMPPI")
    final_cost = _terminal_hooks(config, terminal_state_cost, terminal_final_cost)
    n_injected_rows = _n_injected_rows(config, sample_trajectories)
    dyn = wrap_dynamics(config, dynamics)
    cost = wrap_cost(config, running_cost)
    dtype = config.dtype
    K, T, nu, nsp = config.K, config.T, config.nu, config.num_support_pts
    D, Dp = T * nu, nsp * nu
    n_iter, adaptive = config.num_iterations, config.adaptive_covariance
    split = _sample_split(mesh, sample_axis, K)

    transposed_solve = (
        _route_transposed_solve(config, dynamics, running_cost,
                                _fused_factory(FS.make_transposed_kmppi_solve,
                                               make_sharded_kmppi_solve, mesh, split,
                                               sample_axis), "KMPPI",
                                terminal_state_cost, terminal_final_cost,
                                sample_trajectories is not None or specific_dynamics is not None,
                                sharded=split is not None)
        if use_pallas else None)
    rollouts = _split_rollouts(split, config)
    streams = CommandStreams(config, kernel_keys=transposed_solve is not None,
                             noise=transposed_solve is None)

    def _interp_rows(params: KMPPIParams):
        """kron(interp_full, I_nu): the (D, Dp) operator of the flat layout."""
        eye = torch.eye(nu, dtype=dtype, device=params.interp_full.device)
        return torch.kron(params.interp_full.to(dtype).contiguous(), eye)

    def _one_iteration_fused(params: KMPPIParams, U, theta, x0, lead):
        base = params.base
        sigma_inv, op, mu_p, lop, hip = _transposed_operands(
            base.noise_sigma, base.noise_mu, base.u_min, base.u_max, config, nsp, nu, dtype)
        a_flat = (base.lambda_ * (U @ sigma_inv.T)).reshape(D)
        out = transposed_solve(
            lead, _x0_to_lanes(x0, K), U.reshape(D), theta.reshape(Dp),
            op, mu_p, lop, hip, _tile_bound(base.u_min, nu, T, dtype),
            _tile_bound(base.u_max, nu, T, dtype), a_flat, _interp_rows(params),
            base.lambda_,
        )
        delta_th, m, s_, cost_total = out[:4]
        ctnz, omega = FS.weighting_from_stats(cost_total, base.lambda_, m, s_)
        theta_new = theta + (delta_th / s_).reshape(nsp, nu)
        noise_art = pert_art = None
        if config.fused_artifacts:
            # full-horizon perturbed trajectories come back (D, K); the noise
            # artifact is the full-horizon noise, as on the plain path
            perturbed2 = out[4].T
            noise_art = (perturbed2 - U.reshape(D)[None]).reshape(-1, T, nu)
            pert_art = perturbed2.reshape(-1, T, nu)
        return (params.interp_full @ theta_new, theta_new,
                _shard_artifacts(split, Artifacts(cost_total, ctnz, omega, noise_art, pert_art)))

    def _one_iteration(params: KMPPIParams, U, theta, x0, info, slots, it: int, dyn_params):
        """``(U, theta, artifacts, theta-space noise (K, Dp) or None)``: the
        fused kernel keeps its theta-space noise, which only the plain
        path's adaptive covariance reads."""
        if transposed_solve is not None:
            return _one_iteration_fused(params, U, theta, x0, slots.leads[it]) + (None,)
        base = params.base
        chol, sigma_inv = _sigma_factors(base.noise_sigma, diag=config.diag_sigma)
        noise_theta2 = sample_noise_flat(
            slots.noise[it], K, nsp, base, dtype,
            antithetic=config.antithetic, chol=chol,
            noise_rho=config.noise_rho, diag_sigma=config.diag_sigma,
        )
        theta2 = theta.reshape(Dp)
        perturbed_pts2 = _bound(theta2[None] + noise_theta2,
                                _tile_bound(base.u_min, nu, nsp, dtype),
                                _tile_bound(base.u_max, nu, nsp, dtype))
        noise_theta2 = perturbed_pts2 - theta2[None]
        # deparameterize to the full horizon: one (K, Dp) @ (Dp, D) product
        perturbed2 = inject_specific_actions(config, perturbed_pts2 @ _interp_rows(params).T,
                                             sample_trajectories, x0, info)
        perturbed2 = _bound(perturbed2, _tile_bound(base.u_min, nu, T, dtype),
                            _tile_bound(base.u_max, nu, T, dtype))
        noise2 = perturbed2 - U.reshape(D)[None]
        a_flat = (base.lambda_ * (U @ sigma_inv.T)).reshape(D)
        n_for_cost = torch.abs(noise2) if config.noise_abs_cost else noise2
        perturbation_cost = n_for_cost @ a_flat
        perturbed = perturbed2.reshape(K, T, nu)
        rollout_cost, states, actions = rollouts(
            config, dyn, cost, x0, perturbed, terminal_state_cost, final_cost,
            specific_dynamics=specific_dynamics,
            rngs=slots.rollout[it] if slots.rollout else None, dyn_params=dyn_params)
        cost_total = rollout_cost + perturbation_cost
        cost_total_non_zero, omega = compute_weighting(cost_total, base.lambda_)
        # weighted update in control-point space (mppi.py:672-682)
        theta_new = theta + (omega @ noise_theta2).reshape(nsp, nu)
        return (params.interp_full @ theta_new, theta_new,
                Artifacts(cost_total, cost_total_non_zero, omega,
                          noise2.reshape(K, T, nu), perturbed, states,
                          _unscaled(config, actions)), noise_theta2)

    def body(params: KMPPIParams, state: KMPPIState, x0, info, dyn_params, shift: bool):
        U, theta = state.U, state.theta
        if shift:
            U = _shift_U(U, params.base.u_init)
            # theta <- theta interpolated at Tk + 1 (mppi.py:617-619)
            theta = params.interp_shift @ theta
        x0 = torch.as_tensor(x0, dtype=dtype, device=U.device)
        slots = streams.on(U.device)
        sigma = params.base.noise_sigma
        for it in range(n_iter):
            it_params = (params._replace(base=params.base._replace(noise_sigma=sigma))
                         if adaptive else params)
            U, theta, artifacts, noise_theta = _one_iteration(it_params, U, theta, x0, info,
                                                              slots, it, dyn_params)
            if adaptive and it + 1 < n_iter:
                sigma = adapt_covariance(config, sigma, artifacts.omega,
                                         noise_theta.reshape(K, nsp, nu), n_injected_rows)
        new_state = KMPPIState(U=U, theta=theta, seed=state.seed,
                               counter=state.counter + n_iter)
        return new_state, _select_action(config, U), artifacts

    return _steps(body, streams, make_get_rollouts(config, dyn),
                  fused=transposed_solve is not None)


# The K from which the batched kernel's command is faster than the plain
# path's, from chip_smoke.py's crossover sweep on an NVIDIA H100 80GB HBM3 at
# 700 W (N = 64, T = 30, K = 256, 512, 1,024, 2,048, 4,096 and 10,240; plain
# and both kernel modes in turns in one call): the operand-mode command took
# 0.82-1.05 ms against the plain path's 3.19-4.25 ms at every K measured, so
# this is the smallest K measured.  PERF.md records the sweep.
_BATCHED_KERNEL_MIN_K = 256
BATCHED_USE_PALLAS = (False, True, "force", "kernel_rng")


def make_batched_step(config: MPPIConfig, num_envs: int, dynamics: Callable,
                      running_cost: Callable, use_pallas=False,
                      transposed_solve_override=None, terminal_state_cost: Callable = None,
                      terminal_final_cost: Callable = None, mesh=None,
                      env_axis: str = "data", sample_axis: str = None) -> StepFns:
    """Build the solve of N plants that share one noise draw
    (``pytorch_mppi_tpu/ops/solve.py:1944-2273``, reference
    ``mppi.py:691-873``): the rollout runs the (N·K,) flat batch, and each
    plant has its own softmax along K.  The steps take :class:`MPPIParams`,
    :class:`BatchedState` and (N, nx) states, and return (N, nu) actions, or
    (N, u_per_command, nu).

    ``use_pallas`` is decided once, here: ``True`` runs the batched kernel in
    operand mode (one ``sample_noise_flat`` draw passed to it) from
    ``_BATCHED_KERNEL_MIN_K`` samples on and the plain path below, with an
    info log; ``"force"`` keeps operand mode at any K and ``"kernel_rng"``
    the in-kernel draw (seed mode), each with a warning below that K.  A
    configuration the kernel cannot take goes to the plain path with a
    warning.  ``transposed_solve_override`` is a built batched solve that
    takes the route's place (the tests drive bits mode through it).

    ``terminal_state_cost(states (N, K, T, nx), actions (N, K, T, nu)) ->
    (N, K)`` (with ``config.has_terminal_cost``; the actions ``u_scale``-
    scaled) and ``terminal_final_cost(final_state (N·K, nx), final_action
    (N·K, nu)) -> (N·K,)`` add a terminal cost as JAX's (``solve.py:2201-
    2237``); a kernel terminal cost given as ``terminal_final_cost`` keeps
    the batched kernel, and a ``terminal_state_cost`` takes the plain path.

    ``config.num_iterations`` iterations a command, as in
    :func:`make_mppi_step` (``solve.py:2160-2164``): the batched kernel pair
    launches once an iteration.  ``stochastic_dynamics`` runs the plain path
    over the (N·K,) flat batch.  M > 1, ``risk_alpha`` and adaptive
    covariance raise JAX's ValueErrors (``solve.py:1984-2002``): the plants
    share one noise draw and the batched rollout has no M axis; so do
    gradient refinement and elite reuse (MPPI only).  The steps take
    ``dyn_params`` as the single-plant steps do (``parameterized_dynamics``:
    the plain path).

    With a ``mesh`` the N plants split over its ``env_axis`` ranks, and
    with ``sample_axis`` the K samples of each over those ranks too
    (``solve.py:1951-2243``): every rank draws the shared noise, solves its
    plants (the plain path splitting their rollouts over ``sample_axis``
    as :func:`_split_rollouts` does, the fused route as
    :func:`make_sharded_batched_solve` where only ``env_axis`` splits; both
    axes take the plain path, with a warning) and gathers the updated
    nominal sequences over ``env_axis``, so every rank holds every plant's
    sequence and returns every plant's action.  The per-plant artifacts are
    the rank's plants until read (``parallel.Shard``).  Stochastic dynamics
    draw over the whole batch they are given, so with them every rank
    solves all N plants on all K samples: one process's draws and results.
    """
    if use_pallas not in BATCHED_USE_PALLAS:
        raise ValueError(f"use_pallas must be one of {BATCHED_USE_PALLAS}, got {use_pallas!r}")
    _gate_iterations(config, "MPPI_Batched")
    _check_risk_alpha_range(config)
    if config.risk_alpha > 0.0 or config.M > 1:
        raise ValueError(
            "rollout_samples (M) > 1 / risk_alpha are not supported on "
            "MPPI_Batched: the batched rollout has no stochastic-rollout (M) "
            "axis (mppi.py:844-853); fold plant-dynamics uncertainty into "
            "extra plants instead")
    _gate_gradient_refinement(config, "MPPI_Batched")
    _gate_elites(config, "MPPI_Batched")
    if config.adaptive_covariance:
        raise ValueError(
            "adaptive_covariance is not supported on MPPI_Batched: the N "
            "plants share ONE noise draw (mppi.py:837-838), so a per-plant "
            "covariance would break the shared-noise design and a pooled one "
            "would mix unrelated plants; use per-plant MPPI controllers if "
            "you need it")
    final_cost = _terminal_hooks(config, terminal_state_cost, terminal_final_cost)
    dyn = wrap_dynamics(config, dynamics)
    cost = wrap_cost(config, running_cost)
    dtype = config.dtype
    N, K, T, nu, nx = int(num_envs), config.K, config.T, config.nu, config.nx
    D = T * nu
    n_iter = config.num_iterations

    if transposed_solve_override is not None and (config.fused_artifacts or mesh is not None):
        # the override bypasses the route's guards: fail loud rather than
        # drop the artifacts it cannot give or the sharding
        raise ValueError(
            "transposed_solve_override is incompatible with fused_artifacts and with a "
            "mesh: the injected kernel bypasses the guards the use_pallas route applies")
    plants = None if mesh is None else Split(mesh, env_axis, N)  # this rank's plants
    samples = _sample_split(mesh, sample_axis, K)
    # stochastic dynamics draw over the whole batch they are given, so with
    # them the plain path solves every plant on all K samples on every rank
    # (one process's draws), as _split_rollouts does for one plant
    plain_plants, plain_samples = ((None, None) if config.stochastic_dynamics
                                   else (plants, samples))
    transposed_solve = transposed_solve_override
    if config.sample_null_action:
        logger.warning("MPPI_Batched does not support sample_null_action (matching the "
                       "reference); the flag is ignored")
    if use_pallas and config.fused_artifacts:
        logger.warning(
            "use_pallas on MPPI_Batched with fused_artifacts: the batched kernel keeps "
            "the (N, K, T*nu) tensors out of device memory, so it cannot give them; "
            "using the plain torch path")
        use_pallas = False
    if use_pallas is True and K < _BATCHED_KERNEL_MIN_K:
        logger.info(
            "use_pallas=True on MPPI_Batched with K=%d: the batched kernel measured "
            "faster only for K >= %d, so the plain torch path is used; pass "
            "use_pallas='force' (operand mode) or 'kernel_rng' to keep the kernel",
            K, _BATCHED_KERNEL_MIN_K)
        use_pallas = False
    if use_pallas and samples is not None:
        logger.warning(
            "use_pallas on MPPI_Batched with both the env and the sample axes sharded is "
            "not supported by the fused kernels; using the plain torch path")
        use_pallas = False
    if use_pallas and transposed_solve is None:
        noise_operand = use_pallas != "kernel_rng"

        def batched_factory(c, n, model, **kw):
            if plants is None:
                return FS.make_transposed_batched_solve(c, n, model, **kw)
            return make_sharded_batched_solve(c, n, model, mesh, env_axis, **kw)

        transposed_solve = _route_transposed_solve(
            config, dynamics, running_cost,
            lambda c, model, terminal_final=None, **_: batched_factory(
                c, N, model, noise_operand=noise_operand, terminal_final=terminal_final),
            "MPPI_Batched", terminal_state_cost, terminal_final_cost)
        if transposed_solve is not None and K < _BATCHED_KERNEL_MIN_K:
            logger.warning(
                "use_pallas=%r on MPPI_Batched with K=%d: the batched kernel measured "
                "faster only for K >= %d; the plain torch path is likely faster here",
                use_pallas, K, _BATCHED_KERNEL_MIN_K)

    operand = transposed_solve is not None and transposed_solve.noise_operand
    streams = CommandStreams(config, kernel_keys=transposed_solve is not None and not operand,
                             noise=transposed_solve is None or operand)

    def _one_iteration_fused(params: MPPIParams, U, x0, slots, it: int):
        """The N-plant iteration as one batched-kernel call.  In operand mode
        the noise is the plain path's ``sample_noise_flat`` draw, padded to
        ``K_pad`` and laid out (D, K_pad), so the two paths differ only by
        float32 summation order."""
        sigma_inv, op, mu_t, lo2, hi2 = _transposed_operands(
            params.noise_sigma, params.noise_mu, params.u_min, params.u_max,
            config, T, nu, dtype)
        a2 = (params.lambda_ * torch.einsum("ntu,vu->ntv", U, sigma_inv)).reshape(N, D)
        if operand:
            chol, _ = _sigma_factors(params.noise_sigma, diag=config.diag_sigma)
            noise2 = sample_noise_flat(
                slots.noise[it], K, T, params, dtype,
                antithetic=config.antithetic, chol=chol,
                noise_rho=config.noise_rho, diag_sigma=config.diag_sigma)
            lead = torch.nn.functional.pad(
                noise2, (0, 0, 0, transposed_solve.K_pad - K)).T.contiguous()
        else:
            lead = slots.leads[it]
        delta, ms, cost_total = transposed_solve(
            lead, x0.T, U.reshape(N, D).T, op, mu_t, lo2, hi2, a2.T, params.lambda_)
        m, s_ = ms[0], ms[1]
        ctnz, omega = FS.weighting_from_stats(cost_total, params.lambda_, m[:, None],
                                              s_[:, None])
        if plants is None:
            return U + (delta / s_[None, :]).T.reshape(N, T, nu), Artifacts(
                cost_total, ctnz, omega, None, None)
        U_mine = plants.take(U) + (delta / s_[None, :]).T.reshape(-1, T, nu)
        return plants.join(U_mine), _shard_artifacts(plants, Artifacts(cost_total, ctnz, omega,
                                                                       None, None))

    def _one_iteration(params: MPPIParams, U, x0, slots, it: int, dyn_params):
        if transposed_solve is not None:
            return _one_iteration_fused(params, U, x0, slots, it)
        chol, sigma_inv = _sigma_factors(params.noise_sigma, diag=config.diag_sigma)
        noise2 = sample_noise_flat(
            slots.noise[it], K, T, params, dtype,
            antithetic=config.antithetic, chol=chol,
            noise_rho=config.noise_rho, diag_sigma=config.diag_sigma)  # (K, D), shared
        if plain_plants is not None:  # this rank's plants
            U, x0 = plain_plants.take(U), plain_plants.take(x0)
        Nr = U.shape[0]
        U2 = U.reshape(Nr, D)
        perturbed2 = _bound(U2[:, None] + noise2[None], _tile_bound(params.u_min, nu, T, dtype),
                            _tile_bound(params.u_max, nu, T, dtype))  # (N, K, D)
        del noise2
        actual_noise2 = perturbed2 - U2[:, None]
        # the N·K rollouts as one flat batch (mppi.py:844-853), of this rank's
        # samples where they split
        rolled = perturbed2 if plain_samples is None else plain_samples.take(perturbed2, 1)
        Kr = rolled.shape[1]
        state0 = x0[:, None].expand(Nr, Kr, nx).reshape(Nr * Kr, nx)
        rollout_cost, states, actions = rollout_costs(
            config, dyn, cost, state0, rolled.reshape(Nr * Kr, T, nu),
            terminal_final_cost=final_cost, rngs=slots.rollout[it] if slots.rollout else None,
            dyn_params=dyn_params)
        cost_total = rollout_cost.reshape(Nr, Kr)
        if states is not None:
            # (1, N·K, T, ·) -> (N, K, T, ·): the plants' rollouts (solve.py:2225-2237)
            states = states.reshape(Nr, Kr, T, nx)
            tc = terminal_state_cost(states, actions.reshape(Nr, Kr, T, nu))
            cost_total = cost_total + torch.as_tensor(tc, dtype=dtype).reshape(Nr, Kr)
        if plain_samples is not None:
            cost_total = plain_samples.join(cost_total, 1)
            states = plain_samples.shard(states, 1)
        a2 = (params.lambda_ * torch.einsum("ntu,vu->ntv", U, sigma_inv)).reshape(Nr, D)
        n_for_cost = torch.abs(actual_noise2) if config.noise_abs_cost else actual_noise2
        cost_total = cost_total + torch.einsum("nkd,nd->nk", n_for_cost, a2)
        del n_for_cost
        cost_total_non_zero, omega = compute_weighting(cost_total, params.lambda_, dim=1)
        U_new = U + torch.einsum("nk,nkd->nd", omega, actual_noise2).reshape(Nr, T, nu)
        art = Artifacts(cost_total, cost_total_non_zero, omega,
                        actual_noise2.reshape(Nr, K, T, nu),
                        perturbed2.reshape(Nr, K, T, nu), states)
        if plain_plants is None:
            return U_new, art
        return plain_plants.join(U_new), _shard_artifacts(plain_plants, art)._replace(
            states=plain_plants.shard(states))

    def body(params: MPPIParams, state: BatchedState, x0, dyn_params, shift: bool):
        U = state.U
        if shift:
            U = torch.roll(U, -1, dims=1)
            U[:, -1] = params.u_init
        x0 = torch.as_tensor(x0, dtype=dtype, device=U.device)
        slots = streams.on(U.device)
        for it in range(n_iter):
            U, artifacts = _one_iteration(params, U, x0, slots, it, dyn_params)
        action = U[:, : config.u_per_command]
        if config.u_per_command == 1:
            action = action[:, 0]
        return (BatchedState(U=U, seed=state.seed, counter=state.counter + n_iter),
                action, artifacts)

    return _steps(body, streams, None, fused=transposed_solve is not None, info=False)


def make_get_rollouts(config: MPPIConfig, wrapped_dynamics: Callable) -> Callable:
    """Roll a nominal sequence from given initial states (mppi.py:425-448).
    With stochastic dynamics step t takes ``step_generator(seed, t)``; the
    controller passes a fresh seed each call (``pytorch_mppi_tpu/
    controller.py:645-656``), and ``seed=None`` means the stream of 0.
    ``dyn_params`` goes to the dynamics."""
    dtype = config.dtype

    def get_rollouts(params: MPPIParams, x0, U, num_rollouts: int = 1, seed: int = None,
                     dyn_params=None):
        x0 = torch.as_tensor(x0, dtype=dtype, device=U.device).reshape(-1, config.nx)
        if x0.shape[0] == 1:
            x0 = x0.expand(num_rollouts, config.nx)
        state = x0
        states = []
        for t in range(U.shape[0]):
            u = U[t][None].expand(x0.shape[0], config.nu) * config.u_scale
            rng = (step_generator(seed or 0, t, U.device) if config.stochastic_dynamics
                   else None)
            state = wrapped_dynamics(state, u, t, rng, dyn_params)[..., : config.nx]
            states.append(state)
        return torch.stack(states, dim=1)  # (R, T, nx)

    return get_rollouts
