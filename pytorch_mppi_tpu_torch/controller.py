"""The stateful MPPI controller over the functional solve.

The counterpart of ``pytorch_mppi_tpu/controller.py``'s ``MPPI``, ``SMPPI``,
``KMPPI`` and ``MPPI_Batched``, with the same constructor surface so that code
moves across by changing its import.
Where JAX places arrays on a device of its choosing, the port takes an
explicit ``device``: ``None`` means ``"cuda"``, and with no CUDA device the
constructor raises and asks for ``device="cpu"``.  Random numbers come from
the controller's own ``torch.Generator``, seeded by ``seed``.

``use_pallas=True`` keeps its JAX name: here it runs each command through the
fused CUDA kernel (``csrc/fused_mppi.cu``) when the dynamics and running cost
carry a kernel model (``ops/kernel_models.py``) and the configuration is
eligible; otherwise the plain torch path runs, after a warning.  On a CPU
device it runs the kernel's plain version.  ``MPPI(use_pallas="rollout")``
selects the legacy kernel pair (``ops/legacy.py``); ``MPPI_Batched`` takes
``True``, ``"force"`` and ``"kernel_rng"`` (``ops/solve.make_batched_step``).

``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``) splits the work over
the ranks of a process group, one rank a card, as JAX's mesh splits it over
devices: the K samples over ``sample_axis`` for MPPI, SMPPI and KMPPI, the
N plants over ``env_axis`` (and the samples over ``sample_axis``) for
``MPPI_Batched``.  Every rank builds the same controller with the same seed
and calls ``command()`` with the same state; each returns the same action.
An artifact that a rank holds only its share of (the fused route's
per-sample ones, the batched per-plant ones) is gathered when first read, a
collective: every rank reads it.  ``sample_axis`` without a mesh is
ignored, as in JAX.  ``dynamics_params`` works as in JAX: set at construction (a
tensor, or a tuple, list or dict of tensors), it is passed first to the
dynamics, ``dynamics(params, state, action[, t][, rng])``, on every command
and rollout, and assigning a new ``mppi.dynamics_params`` takes effect at the
next command; it takes the plain path (the kernels' device models hold
their own constants).
The JAX keywords that pick its compiler or its random-number stream are taken
as far as they mean something here: ``scan_unroll`` is accepted and ignored
(it does not change results), ``prng_impl`` takes ``"auto"`` or ``None``, and
``key`` must be ``None`` (the port seeds torch's generators from ``seed``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from .config import (
    BatchedState,
    KMPPIParams,
    KMPPIState,
    MPPIConfig,
    MPPIParams,
    MPPIState,
    SMPPIParams,
    SMPPIState,
)
from .ops import solve as _solve
from .ops.kernels import RBFKernel, TimeKernel, interpolation_operators
from .utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["MPPI", "SMPPI", "KMPPI", "MPPI_Batched", "SpecificActionSampler"]

MPPI_USE_PALLAS = (False, True, "rollout")
PRNG_IMPLS = ("auto", None)  # the JAX prng_impl values that mean "the default stream"


class _Artifact:
    """An artifact of the last command: its tensor, or on a mesh the rank's
    share of it (a ``parallel.Shard``), gathered when first read."""

    def __set_name__(self, owner, name):
        self.slot = "_art_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        value = obj.__dict__.get(self.slot)
        if value is not None and not isinstance(value, torch.Tensor):
            value = obj.__dict__[self.slot] = value.gather()
        return value

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value


def _check_jax_rng(key, prng_impl):
    """The JAX controller's ``key`` and ``prng_impl``: the port cannot take a
    JAX key without importing JAX, nor select a TPU generator."""
    if key is not None:
        raise ValueError(
            "key= takes a JAX PRNG key, which pytorch_mppi_tpu_torch cannot use; pass "
            "seed= instead (the port draws its noise from seed, with Philox on the card)")
    if prng_impl not in PRNG_IMPLS:
        raise ValueError(
            f"prng_impl={prng_impl!r} selects a JAX generator; pytorch_mppi_tpu_torch draws "
            f"its noise with Philox from seed: pass prng_impl='auto' or None")


def _use_pallas(value, allowed):
    """``use_pallas`` as given: a bool, or one of the mode strings in
    ``allowed``."""
    if isinstance(value, str):
        if value not in allowed:
            raise ValueError(f"use_pallas must be one of {allowed}, got {value!r}")
        return value
    return bool(value)


def _coerce_sigma(noise_sigma, dtype=None):
    """Normalize noise_sigma to a (nu, nu) matrix (reference mppi.py:94,
    103-106); a 1-D vector of length nu > 1 is a diagonal.  A tensor keeps
    its dtype; anything else becomes torch's default dtype."""
    if dtype is None:
        dtype = (noise_sigma.dtype if isinstance(noise_sigma, torch.Tensor)
                 and noise_sigma.is_floating_point() else torch.get_default_dtype())
    sigma = torch.as_tensor(np.asarray(noise_sigma) if not isinstance(
        noise_sigma, torch.Tensor) else noise_sigma, dtype=dtype)
    if sigma.ndim == 0:
        sigma = sigma.reshape(1, 1)
    elif sigma.ndim == 1:
        sigma = sigma.reshape(-1, 1) if sigma.shape[0] == 1 else torch.diag(sigma)
    if sigma.ndim != 2 or sigma.shape[0] != sigma.shape[1]:
        raise ValueError(
            f"noise_sigma must be a scalar, (nu,) diagonal, or (nu, nu) covariance; "
            f"got shape {tuple(sigma.shape)}"
        )
    if torch.linalg.cholesky_ex(sigma.detach().cpu()).info != 0:
        raise ValueError("noise_sigma must be symmetric positive definite")
    return sigma


def _validate_rho(noise_rho):
    if not (0.0 <= float(noise_rho) < 1.0):
        raise ValueError("noise_rho must be in [0, 1)")
    return float(noise_rho)


def _is_diag(sigma) -> bool:
    """Diagonality, checked when sigma is set (reference mppi.py:131-139)."""
    s = sigma.detach().cpu().numpy()
    return bool(np.all(s == np.diag(np.diagonal(s))))


def _complete_bounds(u_min, u_max, nu, dtype, device):
    """Symmetric-bound completion, resolved to +-inf clamps (mppi.py:108-126)."""
    if u_max is not None and u_min is None:
        u_max = torch.as_tensor(u_max, dtype=dtype)
        u_min = -u_max
    if u_min is not None and u_max is None:
        u_min = torch.as_tensor(u_min, dtype=dtype)
        u_max = -u_min
    if u_min is None:
        lo = torch.full((nu,), -torch.inf, dtype=dtype, device=device)
        hi = torch.full((nu,), torch.inf, dtype=dtype, device=device)
        return lo, hi, False
    lo = torch.broadcast_to(torch.as_tensor(u_min, dtype=dtype), (nu,)).clone()
    hi = torch.broadcast_to(torch.as_tensor(u_max, dtype=dtype), (nu,)).clone()
    return lo.to(device), hi.to(device), True


def _vector(value, nu, dtype, device):
    return torch.broadcast_to(
        torch.as_tensor(value, dtype=dtype).reshape(-1), (nu,)).clone().to(device)


def _make_params(sigma, lambda_, noise_mu, u_min, u_max, u_init, device):
    """The tunable parameters on ``device``, with the reference's defaults
    (zero mean and u_init) and bound completion; also whether the actions
    are bounded."""
    nu, dtype = sigma.shape[0], sigma.dtype
    lo, hi, bounded = _complete_bounds(u_min, u_max, nu, dtype, device)
    params = MPPIParams(
        noise_mu=_vector(0.0 if noise_mu is None else noise_mu, nu, dtype, device),
        noise_sigma=sigma.to(device),
        lambda_=torch.tensor(float(lambda_), dtype=dtype, device=device),
        u_min=lo,
        u_max=hi,
        u_init=_vector(0.0 if u_init is None else u_init, nu, dtype, device),
    )
    return params, bounded


def _draw_seed(generator: torch.Generator) -> int:
    """A fresh 63-bit stream seed from a controller's generator."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


class SpecificActionSampler:
    """Hook to inject domain-knowledge action trajectories into the sample set
    (reference mppi.py:16-32; ``pytorch_mppi_tpu/controller.py:51-83``).

    Set ``num_trajectories`` (default 1): the controller writes that many
    rows after the null-action row.  ``sample_trajectories(state, info)``
    takes the command's state tensor and its ``info`` and returns anything
    reshapeable to (num_trajectories, T, nu); the rows are then clamped
    like every sample.  A sampler takes the plain torch path (the fused
    kernels sample every row themselves).
    """

    num_trajectories: int = 1

    def __init__(self):
        self.start_idx = 0
        self.end_idx = 0
        self.slice = slice(0, 0)

    def sample_trajectories(self, state, info):
        raise NotImplementedError

    def specific_dynamics(self, next_state, state, action, t):
        """Post-process each rollout step's states; the identity by default
        (mppi.py:25-27).  ``state`` follows the reference on each path: at
        M = 1 it is the new state again (mppi.py:315-317), at M > 1 the
        initial state at every step (mppi.py:349-361).  Shapes are (M, K,
        nx); ``action`` is ``u_scale``-scaled."""
        return next_state

    def register_sample_start_end(self, start_idx, end_idx):
        self.start_idx = start_idx
        self.end_idx = end_idx
        self.slice = slice(start_idx, end_idx)


class MPPI:
    """Model Predictive Path Integral control (Williams et al. 2017, Alg. 2).

    :param dynamics: ``(state (K, nx), action (K, nu)) -> (K, nx)`` on tensors;
        with ``step_dependent_dynamics`` it also takes the step index, and
        with ``stochastic_dynamics`` a trailing ``torch.Generator`` on the
        rollout's device, made for each step (``ops/solve.wrap_dynamics``):
        ``(state, action[, t], rng)``.
    :param running_cost: ``(state, action) -> (K,)``, taken at the state after
        the dynamics step (mppi.py:314-318).
    :param terminal_state_cost: ``(states (M, K, T, nx), actions (M, K, T,
        nu)) -> (K,) or (M, K)``: keeps the rollout's states
        (``self.states``) and actions; the plain path runs.
    :param rollout_samples: M rollouts a sample (folded into the batch);
        M > 1 keeps the (M, K, T, nx) states and adds ``rollout_var_cost``
        times their running costs' variance, discounted by
        ``rollout_var_discount`` a step; ``risk_alpha`` in (0, 1] takes the
        mean of the worst ``ceil(risk_alpha·M)`` in place of the mean.
    :param num_iterations: iterations a command, each re-centred on the
        last; ``adaptive_covariance`` re-estimates sigma between them at
        rate ``adaptive_cov_lr`` (the plain path).
    :param specific_action_sampler: a :class:`SpecificActionSampler` whose
        rows follow the null row; it receives ``command(..., info=)``'s
        ``info``, and its ``specific_dynamics`` runs in the rollout (the
        plain path).
    :param num_elites: elite reuse (MPPI only): the lowest-cost perturbed
        trajectories of each iteration, shifted a step a command, are
        sampled again after the null and sampler rows; on the fused kernel
        only with ``fused_artifacts``.
    :param gradient_refinement_steps: projected-Adam steps on the nominal
        sequence after the iterations, at ``gradient_refinement_lr``
        (MPPI only; ``torch.autograd`` through the plain rollout).
    :param terminal_final_cost: ``(final_state (K, nx), final_action (K,
        nu)) -> (K,)`` of the last step, the action ``u_scale``-scaled;
        stores nothing, and a ``ops.kernel_models.quadratic_terminal`` keeps
        the fused kernel.  The two are mutually exclusive (ValueError).
    :param dynamics_params: parameters passed first to the dynamics
        (``dynamics(params, state, action[, t][, rng])``): a tensor, or a
        tuple, list or dict of tensors; ``self.dynamics_params`` may be
        reassigned between commands.  The plain path runs.
    :param device: ``None`` (the card), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
    :param seed: seeds the controller's ``torch.Generator``.
    :param use_pallas: ``True`` runs each command through the fused CUDA
        kernel; ``"rollout"`` keeps the plain path's noise and runs the
        rollout and the weighted update through the legacy kernels.
    :param mesh: a ``DeviceMesh`` (``parallel.make_mesh``) whose
        ``sample_axis`` ranks split the K samples (the module docstring).
    :param scan_unroll, key, prng_impl: the JAX keywords, taken as the
        module docstring says.
    """

    cost_total = _Artifact()
    cost_total_non_zero = _Artifact()
    omega = _Artifact()
    noise = _Artifact()
    perturbed_action = _Artifact()
    states = _Artifact()
    actions = _Artifact()

    def __init__(
        self,
        dynamics: Callable,
        running_cost: Callable,
        nx: int,
        noise_sigma,
        num_samples: int = 100,
        horizon: int = 15,
        device=None,
        terminal_state_cost: Optional[Callable] = None,
        terminal_final_cost: Optional[Callable] = None,
        lambda_: float = 1.0,
        noise_mu=None,
        u_min=None,
        u_max=None,
        u_init=None,
        U_init=None,
        u_scale: float = 1.0,
        u_per_command: int = 1,
        step_dependent_dynamics: bool = False,
        rollout_samples: int = 1,
        rollout_var_cost: float = 0.0,
        rollout_var_discount: float = 0.95,
        risk_alpha: float = 0.0,
        sample_null_action: bool = False,
        specific_action_sampler=None,
        noise_abs_cost: bool = False,
        stochastic_dynamics: bool = False,
        antithetic_sampling: bool = False,
        num_iterations: int = 1,
        adaptive_covariance: bool = False,
        adaptive_cov_lr: float = 0.5,
        gradient_refinement_steps: int = 0,
        gradient_refinement_lr: float = 0.05,
        num_elites: int = 0,
        noise_rho: float = 0.0,
        scan_unroll: int = 1,
        dynamics_params=None,
        seed: Optional[int] = 0,
        key=None,
        mesh=None,
        sample_axis: str = "k",
        use_pallas=False,
        fused_artifacts: bool = False,
        prng_impl: Optional[str] = "auto",
    ):
        _check_jax_rng(key, prng_impl)
        self.d = resolve_device(device)
        self.mesh = mesh
        # a learned model's weights, passed first to the dynamics; None means
        # the dynamics take none (the config's parameterized_dynamics)
        self.dynamics_params = dynamics_params
        self.use_pallas = _use_pallas(use_pallas, MPPI_USE_PALLAS)
        self.fused_artifacts = bool(fused_artifacts)
        sigma = _coerce_sigma(noise_sigma)
        self.dtype = sigma.dtype
        self.K = int(num_samples)
        self.T = int(horizon)
        self.nx = int(nx)
        self.nu = int(sigma.shape[0])
        # the step factories, built below, validate risk_alpha, num_iterations
        # and adaptive_cov_lr with the JAX texts (ops/solve.py's gates)
        self.M = int(rollout_samples)
        self.rollout_var_cost = float(rollout_var_cost)
        self.rollout_var_discount = float(rollout_var_discount)
        self.risk_alpha = float(risk_alpha)
        self.stochastic_dynamics = bool(stochastic_dynamics)
        self.num_iterations = int(num_iterations)
        self.adaptive_covariance = bool(adaptive_covariance)
        self.adaptive_cov_lr = float(adaptive_cov_lr)
        # validated by the step factory (ops/solve.py's gates)
        self.gradient_refinement_steps = int(gradient_refinement_steps)
        self.gradient_refinement_lr = float(gradient_refinement_lr)
        self.num_elites = int(num_elites)
        self.sample_axis = sample_axis
        self.prng_impl = prng_impl

        self._params, self._bounded = _make_params(sigma, lambda_, noise_mu, u_min, u_max,
                                                   u_init, self.d)
        self.u_scale = float(u_scale)
        self.u_per_command = int(u_per_command)
        self.F = dynamics
        self.running_cost = running_cost
        # the final-state terminal cost (state, action) -> cost of the last step
        # keeps lazy storage and, as a kernel terminal cost, the fused kernel;
        # mutually exclusive with terminal_state_cost (the step factory checks)
        self.terminal_state_cost = terminal_state_cost
        self.terminal_final_cost = terminal_final_cost
        self.step_dependency = bool(step_dependent_dynamics)
        self.sample_null_action = bool(sample_null_action)
        self.noise_abs_cost = bool(noise_abs_cost)
        self.antithetic_sampling = bool(antithetic_sampling)
        self.noise_rho = _validate_rho(noise_rho)
        self._diag_sigma = _is_diag(sigma)
        self._gen = torch.Generator()
        self._gen.manual_seed(0 if seed is None else int(seed))

        self.specific_action_sampler = specific_action_sampler
        n_specific = 0
        if specific_action_sampler is not None:
            n_specific = int(getattr(specific_action_sampler, "num_trajectories", 1))
            i0 = 1 if self.sample_null_action else 0
            specific_action_sampler.register_sample_start_end(i0, i0 + n_specific)
        self._n_specific = n_specific

        self._build_config()
        self._build_step_fns()

        # initial nominal trajectory: user-provided or sampled noise (mppi.py:140-145)
        if U_init is not None:
            U0 = torch.as_tensor(U_init, dtype=self.dtype).reshape(self.T, self.nu).to(self.d)
        else:
            U0 = self._sample_noise_eager((self.T,))
        self._state = self._initial_state(U0)

        # per-solve artifacts (reference mppi.py:179-184)
        self.state = None
        self.info = None
        self.cost_total = None
        self.cost_total_non_zero = None
        self.omega = None
        self.noise = None
        self.perturbed_action = None
        self.states = None
        self.actions = None

    # -- construction helpers ------------------------------------------------

    def _build_config(self):
        self.config = MPPIConfig(
            nx=self.nx,
            nu=self.nu,
            K=self.K,
            T=self.T,
            M=self.M,
            u_scale=self.u_scale,
            u_per_command=self.u_per_command,
            rollout_var_cost=self.rollout_var_cost,
            rollout_var_discount=self.rollout_var_discount,
            risk_alpha=self.risk_alpha,
            sample_null_action=self.sample_null_action,
            noise_abs_cost=self.noise_abs_cost,
            has_terminal_cost=self.terminal_state_cost is not None,
            step_dependent_dynamics=self.step_dependency,
            stochastic_dynamics=self.stochastic_dynamics,
            antithetic=self.antithetic_sampling,
            num_iterations=self.num_iterations,
            noise_rho=self.noise_rho,
            adaptive_covariance=self.adaptive_covariance,
            adaptive_cov_lr=self.adaptive_cov_lr,
            num_specific_trajectories=self._n_specific,
            num_elites=self.num_elites,
            gradient_refinement_steps=self.gradient_refinement_steps,
            gradient_refinement_lr=self.gradient_refinement_lr,
            parameterized_dynamics=self.dynamics_params is not None,
            diag_sigma=self._diag_sigma,
            fused_artifacts=self.fused_artifacts,
            dtype=self.dtype,
        )

    def _cached_fns(self, factory):
        """Build (or reuse) the solve ``factory`` makes for the current
        config: a horizon toggled back reuses the step functions built for
        it."""
        cache = self.__dict__.setdefault("_fns_cache", {})
        key = (self.config, self.use_pallas)
        if key not in cache:
            sampler = self.specific_action_sampler
            cache[key] = factory(
                self.config, self.F, self.running_cost, use_pallas=self.use_pallas,
                terminal_state_cost=self.terminal_state_cost,
                terminal_final_cost=self.terminal_final_cost,
                sample_trajectories=None if sampler is None else sampler.sample_trajectories,
                specific_dynamics=None if sampler is None else sampler.specific_dynamics,
                mesh=self.mesh, sample_axis=self.sample_axis)
        return cache[key]

    def _build_step_fns(self):
        self._fns = self._cached_fns(_solve.make_mppi_step)

    def _initial_state(self, U0):
        return MPPIState(U=U0, seed=self._next_seed(), elites=self._initial_elites(U0))

    def _initial_elites(self, U0):
        """Cold-start elites: copies of the nominal sequence (zero-noise rows,
        replaced by the first iteration's best rows), or None without elite
        reuse."""
        if self.num_elites <= 0:
            return None
        return U0[None].expand(self.num_elites, *U0.shape).clone()

    def _update_elites(self, compute):
        """Recompute the stored elites where elite reuse is on: the one guard
        of the shift, the horizon change and the reset; ``compute`` takes the
        current (E, T, nu) elites."""
        elites = getattr(self._state, "elites", None)
        if elites is not None:
            self._state = self._state._replace(elites=compute(elites))

    def _full_params(self):
        """The parameters one command's step takes."""
        return self._params

    def _next_seed(self) -> int:
        return _draw_seed(self._gen)

    def _sample_noise_eager(self, leading_shape):
        """N(mu, Sigma) draws for init/reset (mppi.py:144-145, 286-290)."""
        return _solve.sample_noise(self._gen, leading_shape, self._params, self.dtype)

    # -- tunable hyperparameters (a tuner changes these between commands) -----

    @property
    def noise_sigma(self):
        return self._params.noise_sigma

    @noise_sigma.setter
    def noise_sigma(self, value):
        sigma = _coerce_sigma(value, self.dtype)
        diag = _is_diag(sigma)
        if diag != self._diag_sigma:
            # diagonality selects the noise transform: rebuild the solve
            self._diag_sigma = diag
            self._build_config()
            self._build_step_fns()
        self._params = self._params._replace(noise_sigma=sigma.to(self.d))

    @property
    def noise_mu(self):
        return self._params.noise_mu

    @noise_mu.setter
    def noise_mu(self, value):
        self._params = self._params._replace(
            noise_mu=_vector(value, self.nu, self.dtype, self.d))

    @property
    def lambda_(self):
        return float(self._params.lambda_)

    @lambda_.setter
    def lambda_(self, value):
        self._params = self._params._replace(
            lambda_=torch.tensor(float(value), dtype=self.dtype, device=self.d))

    @property
    def noise_sigma_inv(self):
        return torch.linalg.inv(self._params.noise_sigma)

    @property
    def u_min(self):
        return self._params.u_min

    @property
    def u_max(self):
        return self._params.u_max

    @property
    def u_init(self):
        return self._params.u_init

    @property
    def U(self):
        return self._state.U

    @U.setter
    def U(self, value):
        self._state = self._state._replace(
            U=torch.as_tensor(value, dtype=self.dtype).to(self.d))

    # -- public API ----------------------------------------------------------

    def get_params(self):
        return (
            f"K={self.K} T={self.T} M={self.M} lambda={self.lambda_} "
            f"noise_mu={self.noise_mu.cpu().numpy()} "
            f"noise_sigma={self.noise_sigma.cpu().numpy()}"
        ).replace("\n", ",")

    def compile(self, **kwargs):
        """Nothing to compile: PyTorch runs eagerly.  Returns self."""
        return self

    def get_action_sequence(self):
        return self._state.U

    def shift_nominal_trajectory(self):
        """Shift the nominal trajectory forward one step (mppi.py:232-238),
        and the stored elites with it."""
        self._state = self._state._replace(
            U=_solve._shift_U(self._state.U, self._params.u_init))
        self._update_elites(lambda el: _solve._shift_elites(el, self._params.u_init))

    def change_horizon(self, horizon: int):
        """Truncate/extend U and rebuild the solve (mppi.py:277-284)."""
        horizon = int(horizon)
        U = self._state.U
        if horizon < U.shape[0]:
            U = U[:horizon]
        elif horizon > U.shape[0]:
            pad = self._params.u_init.expand(horizon - U.shape[0], self.nu)
            U = torch.cat([U, pad], dim=0)
        if horizon != self.T:
            self.T = horizon
            self._build_config()
            self._build_step_fns()
        self._state = self._state._replace(U=U)
        # the (E, T_old, nu) elites restart from the adjusted nominal
        self._update_elites(lambda el: self._initial_elites(U))

    def reset(self):
        """Clear controller state after a trial: resample U (mppi.py:286-290);
        the elites restart from it."""
        U0 = self._sample_noise_eager((self.T,))
        self._state = self._state._replace(U=U0)
        self._update_elites(lambda el: self._initial_elites(U0))

    def command(self, state, shift_nominal_trajectory: bool = True, info=None):
        """One MPC solve (reference mppi.py:240-252).

        :param state: (nx,) or (K, nx) current state (array-like or tensor)
        :param info: kept as ``self.info`` and passed to the specific-action
            sampler's ``sample_trajectories(state, info)``
        :returns: (nu,) action, or (u_per_command, nu) when u_per_command > 1,
            as a tensor on the controller's device
        """
        x0 = torch.as_tensor(state, dtype=self.dtype, device=self.d)
        if x0.shape[-1] != self.nx:
            raise ValueError(
                f"state must have trailing dimension nx={self.nx}; got shape {tuple(x0.shape)}"
            )
        self.info = info
        fn = self._fns.step if shift_nominal_trajectory else self._fns.step_no_shift
        self._state, action, artifacts = fn(self._full_params(), self._state, x0, info,
                                            self.dynamics_params)
        self.state = x0
        self._store_artifacts(artifacts)
        return action

    def _store_artifacts(self, artifacts):
        self.cost_total = artifacts.cost_total
        self.cost_total_non_zero = artifacts.cost_total_non_zero
        self.omega = artifacts.omega
        self.noise = artifacts.noise
        self.perturbed_action = artifacts.perturbed_action
        self.states = artifacts.states
        self.actions = artifacts.actions

    def get_rollouts(self, state, num_rollouts: int = 1, U=None):
        """Roll the nominal action sequence from given states (mppi.py:425-448);
        stochastic dynamics draw from a fresh seed each call, as JAX's
        ``get_rollouts`` takes a fresh key.

        :returns: (num_rollouts, T, nx) trajectories
        """
        if U is None:
            U = self.get_action_sequence()
        seed = self._next_seed() if self.stochastic_dynamics else None
        return self._fns.get_rollouts(self._params, state, U, num_rollouts=num_rollouts,
                                      seed=seed, dyn_params=self.dynamics_params)


class SMPPI(MPPI):
    """Smooth MPPI: samples in action-rate space and penalizes action change
    (reference mppi.py:451-570; arXiv:2112.09988).

    ``U`` is the lifted action-rate sequence and starts at zero;
    ``action_sequence`` holds the commanded actions (``U_init``, or zero)
    and is what a command returns from.  ``u_min``/``u_max`` bound the
    rates, ``action_min``/``action_max`` the actions.  ``w_action_seq_cost``,
    ``delta_t`` and ``lambda_`` reach the solve as device scalars, so a
    tuner changes them without rebuilding it.
    """

    def __init__(self, *args, w_action_seq_cost: float = 1.0, delta_t: float = 1.0,
                 U_init=None, action_min=None, action_max=None, **kwargs):
        self._U_init_arg = U_init
        super().__init__(*args, U_init=None, **kwargs)
        self._action_min, self._action_max, _ = _complete_bounds(
            action_min, action_max, self.nu, self.dtype, self.d)
        self.w_action_seq_cost = w_action_seq_cost
        self.delta_t = delta_t

    def _scalar(self, value):
        return torch.tensor(float(value), dtype=self.dtype, device=self.d)

    @property
    def w_action_seq_cost(self):
        return float(self._w_action_seq_cost)

    @w_action_seq_cost.setter
    def w_action_seq_cost(self, value):
        self._w_action_seq_cost = self._scalar(value)

    @property
    def delta_t(self):
        return float(self._delta_t)

    @delta_t.setter
    def delta_t(self, value):
        self._delta_t = self._scalar(value)

    @property
    def action_min(self):
        return self._action_min

    @property
    def action_max(self):
        return self._action_max

    @property
    def action_sequence(self):
        return self._state.action_sequence

    @action_sequence.setter
    def action_sequence(self, value):
        self._state = self._state._replace(
            action_sequence=torch.as_tensor(value, dtype=self.dtype).to(self.d))

    def _build_config(self):
        super()._build_config()
        self.config = dataclasses.replace(self.config, smppi=True)

    def _build_step_fns(self):
        self._fns = self._cached_fns(_solve.make_smppi_step)

    def _full_params(self):
        return SMPPIParams(base=self._params, action_min=self._action_min,
                           action_max=self._action_max,
                           w_action_seq_cost=self._w_action_seq_cost,
                           delta_t=self._delta_t)

    def _initial_state(self, U0):
        # the smooth formulation starts from zero rates (mppi.py:479-484)
        zeros = torch.zeros((self.T, self.nu), dtype=self.dtype, device=self.d)
        if self._U_init_arg is not None:
            seq = torch.as_tensor(self._U_init_arg, dtype=self.dtype).reshape(
                self.T, self.nu).to(self.d)
        else:
            seq = zeros.clone()
        return SMPPIState(U=zeros, action_sequence=seq, seed=self._next_seed())

    def get_params(self):
        return f"{super().get_params()} w={self.w_action_seq_cost} t={self.delta_t}"

    def get_action_sequence(self):
        return self._state.action_sequence

    def shift_nominal_trajectory(self):
        """Roll both sequences; repeat the last commanded action (mppi.py:489-493)."""
        self._state = self._state._replace(
            U=_solve._shift_U(self._state.U, self._params.u_init),
            action_sequence=_solve._shift_sequence(self._state.action_sequence))

    def change_horizon(self, horizon: int):
        """Truncate or extend both sequences (the rates with ``u_init``, the
        actions with their last row) and rebuild the solve."""
        horizon = int(horizon)
        U, seq = self._state.U, self._state.action_sequence
        if horizon < U.shape[0]:
            U, seq = U[:horizon], seq[:horizon]
        elif horizon > U.shape[0]:
            extend = horizon - U.shape[0]
            U = torch.cat([U, self._params.u_init.expand(extend, self.nu)], dim=0)
            seq = torch.cat([seq, seq[-1].expand(extend, self.nu)], dim=0)
        if horizon != self.T:
            self.T = horizon
            self._build_config()
            self._build_step_fns()
        self._state = self._state._replace(U=U, action_sequence=seq)

    def reset(self):
        """Zero both sequences (mppi.py:498-500)."""
        z = torch.zeros((self.T, self.nu), dtype=self.dtype, device=self.d)
        self._state = self._state._replace(U=z, action_sequence=z.clone())


class KMPPI(MPPI):
    """Kernel MPPI: noise sampled at control points, kernel-interpolated to the
    full horizon (reference mppi.py:593-688).

    ``num_support_pts`` defaults to ``max(1, T // 2)`` and is frozen at
    construction (theta's shape depends on it); ``kernel`` defaults to
    ``RBFKernel()``.
    """

    def __init__(self, *args, num_support_pts: Optional[int] = None,
                 kernel: TimeKernel = None, **kwargs):
        self._nsp_arg = num_support_pts
        self.interpolation_kernel = kernel if kernel is not None else RBFKernel()
        super().__init__(*args, **kwargs)

    def _build_config(self):
        if not hasattr(self, "num_support_pts"):
            self.num_support_pts = max(1, int(self._nsp_arg or self.T // 2))
            if self.num_support_pts > self.T:
                raise ValueError(
                    f"num_support_pts={self.num_support_pts} exceeds horizon "
                    f"T={self.T}: support points would be denser than "
                    f"timesteps and the kernel Gram solve ill-conditioned")
        super()._build_config()
        self.config = dataclasses.replace(self.config,
                                          num_support_pts=self.num_support_pts)
        self._set_interpolation()

    def _set_interpolation(self):
        self._interp_full, self._interp_shift = interpolation_operators(
            self.interpolation_kernel, self.T, self.num_support_pts, self.dtype,
            device=self.d)

    def _build_step_fns(self):
        self._fns = self._cached_fns(_solve.make_kmppi_step)

    def _full_params(self):
        return KMPPIParams(base=self._params, interp_full=self._interp_full,
                           interp_shift=self._interp_shift)

    def _initial_state(self, U0):
        return KMPPIState(
            U=U0, theta=torch.zeros((self.num_support_pts, self.nu), dtype=self.dtype,
                                    device=self.d),
            seed=self._next_seed())

    @property
    def theta(self):
        return self._state.theta

    @theta.setter
    def theta(self, value):
        self._state = self._state._replace(
            theta=torch.as_tensor(value, dtype=self.dtype).to(self.d))

    @property
    def kernel_sigma(self):
        """Bandwidth of the interpolation kernel (RBF ``sigma``, B-spline
        ``scale``); setting it rebuilds the two interpolation operators and
        nothing else."""
        k = self.interpolation_kernel
        return float(getattr(k, "sigma", getattr(k, "scale", 1.0)))

    @kernel_sigma.setter
    def kernel_sigma(self, value):
        k = self.interpolation_kernel
        if hasattr(k, "sigma"):
            k.sigma = float(value)
        elif hasattr(k, "scale"):
            k.scale = float(value)
        else:
            raise AttributeError(f"kernel {k!r} exposes neither 'sigma' nor 'scale'")
        self._set_interpolation()

    def get_params(self):
        return (f"{super().get_params()} num_support_pts={self.num_support_pts} "
                f"kernel={self.interpolation_kernel}")

    def reset(self):
        """Resample U and zero theta (mppi.py:613-615)."""
        super().reset()
        self._state = self._state._replace(theta=torch.zeros_like(self._state.theta))

    def shift_nominal_trajectory(self):
        """Roll U; re-interpolate theta at Tk + 1 (mppi.py:617-619)."""
        self._state = self._state._replace(
            U=_solve._shift_U(self._state.U, self._params.u_init),
            theta=self._interp_shift @ self._state.theta)

    def change_horizon(self, horizon: int):
        """Change the horizon and rebuild the interpolation operators.
        ``num_support_pts`` is frozen, so the horizon is clamped to at least
        it: support points denser than timesteps make the Gram solve
        ill-conditioned."""
        horizon = int(horizon)
        if horizon < self.num_support_pts:
            logger.warning(
                "KMPPI horizon %d clamped to num_support_pts=%d (support points "
                "cannot be denser than timesteps)", horizon, self.num_support_pts)
            horizon = self.num_support_pts
        super().change_horizon(horizon)

    def deparameterize_to_trajectory_single(self, theta):
        """(nsp, nu) control points -> (T, nu) trajectory (mppi.py:650-651)."""
        theta = torch.as_tensor(theta, dtype=self.dtype).to(self.d)
        return self._interp_full @ theta, self._interp_full

    def deparameterize_to_trajectory_batch(self, theta):
        """(K, nsp, nu) -> (K, T, nu) in one product (mppi.py:653-655)."""
        theta = torch.as_tensor(theta, dtype=self.dtype).to(self.d)
        return torch.einsum("ts,ksu->ktu", self._interp_full, theta), self._interp_full


class MPPI_Batched:
    """MPPI for N plants that share one noise draw and one dynamics and cost
    call per step (reference mppi.py:691-873; ``pytorch_mppi_tpu/
    controller.py:978-1175``).  The rollout runs an (N·K,) flat batch; each
    plant has its own softmax along K.

    ``use_pallas=True`` runs each command through the batched CUDA kernel in
    operand mode (one ``sample_noise_flat`` draw passed to it) from
    ``ops/solve._BATCHED_KERNEL_MIN_K`` samples on, and the plain path below
    it (an info log says so); ``"force"`` keeps operand mode at any K and
    ``"kernel_rng"`` draws the noise in the kernel.  ``device=None`` means
    the card, as for :class:`MPPI`.  ``num_iterations``,
    ``stochastic_dynamics`` and ``dynamics_params`` work as for
    :class:`MPPI` (the last two on the plain path).  ``mesh`` splits the
    plants over ``env_axis`` and, with ``sample_axis``, their samples
    (``ops/solve.make_batched_step``).
    """

    cost_total = _Artifact()
    omega = _Artifact()
    states = _Artifact()

    def __init__(
        self,
        dynamics: Callable,
        running_cost: Callable,
        nx: int,
        noise_sigma,
        num_envs: int,
        num_samples: int = 100,
        horizon: int = 15,
        device=None,
        terminal_state_cost: Optional[Callable] = None,
        terminal_final_cost: Optional[Callable] = None,
        lambda_: float = 1.0,
        noise_mu=None,
        u_min=None,
        u_max=None,
        u_init=None,
        u_scale: float = 1.0,
        u_per_command: int = 1,
        step_dependent_dynamics: bool = False,
        noise_abs_cost: bool = False,
        stochastic_dynamics: bool = False,
        antithetic_sampling: bool = False,
        num_iterations: int = 1,
        noise_rho: float = 0.0,
        scan_unroll: int = 1,
        dynamics_params=None,
        seed: Optional[int] = 0,
        key=None,
        mesh=None,
        env_axis: str = "data",
        sample_axis: Optional[str] = None,
        use_pallas=False,
        fused_artifacts: bool = False,
        prng_impl: Optional[str] = "auto",
    ):
        _check_jax_rng(key, prng_impl)
        self.d = resolve_device(device)
        self.mesh, self.env_axis = mesh, env_axis
        self.dynamics_params = dynamics_params
        self.use_pallas = _use_pallas(use_pallas, _solve.BATCHED_USE_PALLAS)
        sigma = _coerce_sigma(noise_sigma)
        self.dtype = sigma.dtype
        self.N = int(num_envs)
        self.K = int(num_samples)
        self.T = int(horizon)
        self.nx = int(nx)
        self.nu = int(sigma.shape[0])
        self.u_scale = float(u_scale)
        self.u_per_command = int(u_per_command)
        self.sample_axis = sample_axis
        self.prng_impl = prng_impl

        self._params, _ = _make_params(sigma, lambda_, noise_mu, u_min, u_max, u_init, self.d)
        self.config = MPPIConfig(
            nx=self.nx,
            nu=self.nu,
            K=self.K,
            T=self.T,
            u_scale=self.u_scale,
            u_per_command=self.u_per_command,
            noise_abs_cost=bool(noise_abs_cost),
            has_terminal_cost=terminal_state_cost is not None,
            step_dependent_dynamics=bool(step_dependent_dynamics),
            stochastic_dynamics=bool(stochastic_dynamics),
            antithetic=bool(antithetic_sampling),
            num_iterations=int(num_iterations),
            noise_rho=_validate_rho(noise_rho),
            diag_sigma=_is_diag(sigma),
            fused_artifacts=bool(fused_artifacts),
            parameterized_dynamics=dynamics_params is not None,
            dtype=self.dtype,
        )
        self.terminal_state_cost = terminal_state_cost
        self.terminal_final_cost = terminal_final_cost
        self.running_cost = running_cost
        self._fns = _solve.make_batched_step(self.config, self.N, dynamics, running_cost,
                                             use_pallas=self.use_pallas,
                                             terminal_state_cost=terminal_state_cost,
                                             terminal_final_cost=terminal_final_cost,
                                             mesh=mesh, env_axis=env_axis,
                                             sample_axis=sample_axis)
        self._gen = torch.Generator()
        self._gen.manual_seed(0 if seed is None else int(seed))
        U0 = self._sample_noise_eager((self.N, self.T))
        self._state = BatchedState(U=U0, seed=_draw_seed(self._gen))
        self.cost_total = None
        self.omega = None
        self.states = None

    def _sample_noise_eager(self, leading_shape):
        return _solve.sample_noise(self._gen, leading_shape, self._params, self.dtype)

    @property
    def U(self):
        return self._state.U

    @U.setter
    def U(self, value):
        self._state = self._state._replace(
            U=torch.as_tensor(value, dtype=self.dtype).to(self.d))

    @property
    def noise_sigma(self):
        return self._params.noise_sigma

    @property
    def lambda_(self):
        return float(self._params.lambda_)

    @property
    def u_min(self):
        return self._params.u_min

    @property
    def u_max(self):
        return self._params.u_max

    def compile(self, **kwargs):
        """Nothing to compile: PyTorch runs eagerly.  Returns self."""
        return self

    def reset(self):
        """Resample every plant's nominal sequence (mppi.py:286-290)."""
        self._state = self._state._replace(U=self._sample_noise_eager((self.N, self.T)))

    def command(self, states, shift_nominal_trajectory: bool = True):
        """One solve for every plant.

        :param states: (N, nx) stacked plant states
        :returns: (N, nu) actions, or (N, u_per_command, nu), on the
            controller's device
        """
        x0 = torch.as_tensor(states, dtype=self.dtype, device=self.d)
        if x0.shape != (self.N, self.nx):
            raise ValueError(
                f"states must have shape (num_envs={self.N}, nx={self.nx}); "
                f"got {tuple(x0.shape)}")
        fn = self._fns.step if shift_nominal_trajectory else self._fns.step_no_shift
        self._state, action, artifacts = fn(self._params, self._state, x0,
                                            self.dynamics_params)
        self.cost_total = artifacts.cost_total
        self.omega = artifacts.omega
        # (N, K, T, nx) candidate rollouts; None without a terminal_state_cost
        # (lazy storage, as in the single-plant controller)
        self.states = artifacts.states
        return action
