"""Static configuration, tunable parameters and controller state of the MPPI solve.

The counterpart of ``pytorch_mppi_tpu/config.py``.  :class:`MPPIConfig` is a
frozen, hashable description of one solve configuration; the step factories
read it once when they build the solve, so every feature flag resolves to one
code path before the first command.  :class:`MPPIParams` holds the
hyperparameters a tuner changes between commands (tensors, so changing them
rebuilds nothing).  :class:`MPPIState` carries the nominal sequence and the
random-number state from one command to the next: in place of a JAX PRNG key
it holds a 64-bit ``seed`` and a ``counter`` that every iteration of a solve
advances by one, so a run is reproducible from the seed alone.

Only the fields this port runs are here; the JAX package's sharding flags
are rejected by :class:`~pytorch_mppi_tpu_torch.controller.MPPI` with
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI configuration (reference ``mppi.py:45-61`` minus the
    tensor-valued hyperparameters, which live in :class:`MPPIParams`)."""

    nx: int
    nu: int
    K: int
    T: int
    u_scale: float = 1.0
    u_per_command: int = 1
    sample_null_action: bool = False
    noise_abs_cost: bool = False
    # a terminal_state_cost is set: the rollout stores its states and actions
    has_terminal_cost: bool = False
    step_dependent_dynamics: bool = False
    # draw K/2 normals and mirror them (z, -z): rows k and K/2 + k form a pair
    antithetic: bool = False
    # AR(1) correlation of the noise across the horizon (0 = white noise)
    noise_rho: float = 0.0
    # sigma is diagonal: the noise transform is an elementwise scale
    diag_sigma: bool = False
    # the fused kernel also stores the clamped perturbed actions (D, K), so
    # the noise / perturbed_action artifacts exist on the fused path too
    fused_artifacts: bool = False
    dtype: torch.dtype = torch.float32
    # SMPPI extras (reference mppi.py:451-570); only the SMPPI factory reads it
    smppi: bool = False
    # KMPPI extras (reference mppi.py:593-688); only the KMPPI factory reads it
    num_support_pts: int = 0
    # stochastic rollouts (reference mppi.py:333-373): M rollouts a sample,
    # folded into the batch M outer; their running costs' variance (ddof=1,
    # discounted per step) weighs in with rollout_var_cost
    M: int = 1
    rollout_var_cost: float = 0.0
    rollout_var_discount: float = 0.95
    # CVaR over the M rollouts: the mean of the worst ceil(risk_alpha·M)
    # costs a sample in place of the mean (0 = the mean; needs M > 1)
    risk_alpha: float = 0.0
    # the dynamics take a trailing torch.Generator, one a step
    # (ops/solve.wrap_dynamics)
    stochastic_dynamics: bool = False
    # sample-rollout-weight-update cycles a command, each re-centred on the
    # last one's nominal sequence
    num_iterations: int = 1
    # re-estimate sigma from the omega-weighted rectified noise after each
    # iteration but the last: sigma <- (1-lr)·sigma + lr·(cov + floor·I),
    # reset to params.noise_sigma at the next command
    # (ops/solve.adapt_covariance)
    adaptive_covariance: bool = False
    adaptive_cov_lr: float = 0.5
    adaptive_cov_floor: float = 1e-6
    # rows a SpecificActionSampler writes after the null row (0: no sampler);
    # the injection needs the sampler itself wired into the step
    num_specific_trajectories: int = 0
    # elite reuse (iCEM): the num_elites lowest-cost perturbed trajectories
    # of each iteration, shifted one step a command, are written back as
    # sample rows after the null and sampler rows; they ride
    # MPPIState.elites.  MPPI only
    num_elites: int = 0
    # projected-Adam steps on the nominal sequence after the iterations,
    # descending the rollout cost J(U) at this step size (action units),
    # clamped into [u_min, u_max] after each step.  MPPI only
    gradient_refinement_steps: int = 0
    gradient_refinement_lr: float = 0.05
    # the dynamics take the controller's dynamics_params first (a learned
    # model's weights): dynamics(params, state, u[, t][, rng]); the kernels
    # take none, so the plain path runs
    parameterized_dynamics: bool = False

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")

    @property
    def store_rollouts(self) -> bool:
        """Lazy storage (reference mppi.py:307-331): the rollout's states and
        actions are kept only when a terminal cost reads them or when M > 1
        (mppi.py:350-351)."""
        return self.has_terminal_cost or self.M > 1


class MPPIParams(NamedTuple):
    """Tunable hyperparameters; ``noise_sigma`` is always a full (nu, nu)
    covariance whose factors are derived inside every solve, so a tuner can
    never leave the sampler stale."""

    noise_mu: torch.Tensor  # (nu,)
    noise_sigma: torch.Tensor  # (nu, nu)
    lambda_: torch.Tensor  # scalar
    u_min: torch.Tensor  # (nu,); -inf when unbounded
    u_max: torch.Tensor  # (nu,); +inf when unbounded
    u_init: torch.Tensor  # (nu,)


class SMPPIParams(NamedTuple):
    """SMPPI adds action-space bounds and the smoothing weights
    (mppi.py:456-477).  The scalars are 0-d tensors on the controller's
    device, so a tuner changes them without rebuilding the solve."""

    base: MPPIParams
    action_min: torch.Tensor  # (nu,); -inf when unbounded
    action_max: torch.Tensor  # (nu,); +inf when unbounded
    w_action_seq_cost: torch.Tensor  # scalar
    delta_t: torch.Tensor  # scalar


class KMPPIParams(NamedTuple):
    """KMPPI adds the precomputed kernel-interpolation operators: both are
    constant for a fixed horizon, so deparameterization is one product."""

    base: MPPIParams
    interp_full: torch.Tensor  # (T, nsp): K(Hs, Tk) @ inv(K(Tk, Tk))
    interp_shift: torch.Tensor  # (nsp, nsp): K(Tk + 1, Tk) @ inv(K(Tk, Tk))


class MPPIState(NamedTuple):
    """Controller state threaded through solves: the nominal sequence and the
    random-number stream position.  ``seed`` is drawn once from the
    controller's ``torch.Generator``; ``counter`` counts the iterations taken
    from it (``num_iterations`` a command), and
    :func:`~pytorch_mppi_tpu_torch.ops.solve.iteration_seed` maps the pair to
    the noise of one iteration (:func:`~pytorch_mppi_tpu_torch.ops.solve.
    rollout_seed` to its stochastic rollout).  ``elites`` holds the
    (num_elites, T, nu) elite trajectories with elite reuse, else None."""

    U: torch.Tensor  # (T, nu) nominal control sequence
    seed: int
    counter: int = 0
    elites: Optional[torch.Tensor] = None


class SMPPIState(NamedTuple):
    """SMPPI's state: the lifted action-rate sequence ``U`` and the commanded
    ``action_sequence`` (mppi.py:481-484), with the stream position of
    :class:`MPPIState`."""

    U: torch.Tensor  # (T, nu) action-rate sequence
    action_sequence: torch.Tensor  # (T, nu) commanded actions
    seed: int
    counter: int = 0


class KMPPIState(NamedTuple):
    """KMPPI's state: the nominal sequence and its control points ``theta``
    (mppi.py:600), with the stream position of :class:`MPPIState`."""

    U: torch.Tensor  # (T, nu)
    theta: torch.Tensor  # (nsp, nu) control points
    seed: int
    counter: int = 0


class BatchedState(NamedTuple):
    """MPPI_Batched's state (``pytorch_mppi_tpu/ops/solve.py:1932-1934``): the
    N plants' nominal sequences, with the stream position of
    :class:`MPPIState`; the plants share each solve's noise."""

    U: torch.Tensor  # (N, T, nu)
    seed: int
    counter: int = 0


class Artifacts(NamedTuple):
    """Per-solve introspection artifacts (reference ``mppi.py:179-184``)."""

    cost_total: torch.Tensor  # (K,); (N, K) for MPPI_Batched
    cost_total_non_zero: torch.Tensor  # (K,)
    omega: torch.Tensor  # (K,)
    noise: Optional[torch.Tensor]  # (K, T, nu) rectified noise; (N, K, T, nu)
    perturbed_action: Optional[torch.Tensor]  # (K, T, nu); (N, K, T, nu)
    # (M, K, T, nx) rollout states and (M, K, T, nu) unscaled actions under
    # store_rollouts ((N, K, T, nx) and None for MPPI_Batched); else None
    states: Optional[torch.Tensor] = None
    actions: Optional[torch.Tensor] = None


def as_dtype_array(value, dtype, shape=None, device=None):
    """Coerce python scalars / numpy / tensors to a tensor of ``dtype``."""
    arr = torch.as_tensor(value, dtype=dtype, device=device)
    if shape is not None:
        arr = torch.broadcast_to(arr, shape)
    return arr
