#!/usr/bin/env python3
"""On-card smoke test of pytorch_mppi_tpu_torch: builds the CUDA kernels,
holds each against its plain PyTorch version (the fused iteration's MPPI,
SMPPI, KMPPI and batched variants; the legacy route's rollout and weighted
update; the ops-level sampling front-end and row-major round-1 solve), and
drives the port's main paths.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It exits non-zero, printing no result, when no card is available or when
the package is not beside it.  Phases, each fatal when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` for ``csrc/fused_mppi.cu``;
3. kernel against plain: each variant of the fused kernel and its plain
   version on the same device inputs and bits, at the shapes of phases 4-6
   (K = 10,000, T = 30; the swing-up's K = 1,000, T = 15; the closed loops'
   K = 500) and more (D = 300 with a full operator, on the shared-memory
   tiles and, at 128 samples a block, on the global ones; a 12-state,
   4-action ``linear_quadratic``; 32 and 64 samples a block forced at
   K = 1,000 and with antithetic pairs in blocks of 128; the final-state
   terminal cost ``quadratic_terminal``, with ``u_scale`` and at D = 300), in
   bits mode and in seed mode (Philox in both), then the statistics of the
   seed-mode noise,
   and 50 calls in a row of each variant identical to the first (kernel A's
   merge counter resets); one flagship step of each variant with
   ``num_iterations = 3`` (three launches, each feeding the next one's
   nominal) against the same step with the kernel's plain version in its
   place, on the same bits an iteration and on the same seeds, and the
   batched pair's step with ``num_iterations = 2`` at N = 16 in operand and
   seed mode the same way; kernel A with the (E, D) elites operand (E = 4
   with and without the null row, E = 127 after the null row over four
   blocks of 32 samples, antithetic, the terminal cost) in bits and seed
   mode, the emitted elite columns equal to the clamped elites exactly, and
   one fused MPPI step with four elites against its plain twin;
   the batched variant in bits, seed and operand mode (N = 16, K = 10,240;
   the full width N = 1,024, K = 16,384 with the rule's plant group, which
   must be the largest P, and with P = 1; N = 1,023, not a multiple of P;
   N = 70,000 at K = 256, T = 10, more plants than a grid row; antithetic;
   D = 300 with a full operator; the pendulum and toy2d; the terminal cost
   at N = 16 and N = 1,024); the legacy rollout at K = 10,000, T = 30 (the
   rule's samples a block, and 32, 64 and 128 forced), at K not a multiple
   of the block, at D = 15 (4-byte copies), on actions at a 4-byte offset,
   at D = 300 (one buffer, and at 128 samples a block in chunks), then 50
   calls in a row identical to the first; the weighted
   update at the flagship (the rule's samples a block, and 32, 64 and 128
   forced), at K = 777, at D = 15 and D = 300, on a strided noise (16-byte
   and scalar loads), at K below the block (one block merges itself) and at
   K = 16,500 with 32 samples a block (more than 512 partials to merge),
   then 50 calls in a row identical to the first; the sampler
   (``ops/rowmajor.py``) in bits and seed mode at the flagship (diagonal,
   antithetic, null row with the absolute cost, null row with antithetic
   pairs, a full operator with ``noise_rho``), at K = 777 (also antithetic:
   mirror rows past K), at D = 15 (diagonal and full) and at D = 300, then
   the moments of its seed-mode draws and its normals against the
   transposed kernel's; the
   round-1 solve in bits and seed mode at the flagship, K = 130, with the
   null row, ``u_scale`` and a full sigma, on the pendulum, at D = 300 (both
   tiles) and at K = 1,000 with 64 samples a block, then the moments through
   its cost, its costs against the transposed kernel's on one key and 50
   calls in a row;
4. main paths: 500 closed-loop commands of ``MPPI``, ``SMPPI`` and
   ``KMPPI`` on ``linear_quadratic`` at K = 10,000, T = 30 (``bench.py``'s
   flagship problem), fused (``use_pallas=True``, one launch a command) with
   the launch count and the goal checked, then the same on the plain torch
   path, ``MPPI``'s legacy route (``use_pallas="rollout"``) held to the plain
   step, ``MPPI`` fused with ``terminal_final_cost=quadratic_terminal(...)``
   (one launch a command; its step held to the plain step's arithmetic on
   the kernel's perturbed actions) and plain with the same cost as
   ``terminal_state_cost`` (the rollout states kept); ``MPPI``, ``SMPPI``
   and ``KMPPI`` fused with ``num_iterations = 3`` (three launches of kernel
   A a command) and ``MPPI``'s legacy route with it (three of each legacy
   kernel), plain ``MPPI`` with adaptive covariance asked for the kernel
   (the plain path, with the warning; 200 commands), and plain ``MPPI``
   with M = 4 stochastic rollouts (200 commands), the variance cost and
   CVaR on a noisy plant model
   (the (4, K, T, nx) states, their M slices differ, the loop comes within
   1.0 of the goal, and two controllers on one seed give the same first ten
   commands bit for bit); elite reuse (``num_elites = 4``) on the fused
   path with ``fused_artifacts`` (one launch a command, and three with
   ``num_iterations = 3``), asked for the kernel without ``fused_artifacts``
   (the plain path, the warning naming the flag) and on the legacy route;
   plain ``MPPI`` with a ``SpecificActionSampler`` of two ramps, the null
   row and two elites asked for the kernel (the plain path; rows 0-4 are
   [null, ramps, shifted elites]), 200 commands each of ``SMPPI`` and
   ``KMPPI`` with the sampler, 50 fused commands with five steps of
   gradient refinement, and the refinement on JAX's small-K fixture (the
   mean distance at least halved); then
   ``MPPI_Batched`` on ``examples/scenario_batch.py``'s problem at N = 1,024,
   K = 16,384, T = 30 and at N = 16, K = 10,240: operand mode, seed mode and
   the plain path, the launch counts and the fused step held to the plain
   step on one seed; with ``num_iterations = 2`` at N = 1,024 in operand and
   seed mode (twice the launches) and with stochastic dynamics on the plain
   path at N = 16, each held to the scenario's goal check; the crossover
   sweep of the batched kernel (N = 64,
   K = 256 to 10,240); the ops-level kernels' loops at the flagship, 500
   commands each: the round-1 solve in seed mode (1 launch a command) and
   JAX's "psampler" solve from port kernels (the sampler, the legacy rollout
   and weighted update: 3 launches), each held to its plain versions for one
   command; the kernels alone at the main paths' shapes (device time per
   call replayed from a CUDA graph of 20 calls, the profiler's beside it),
   kernel A's S sweep (32, 64 and 128 samples a block; each variant at the
   flagship, at K = 1,000 and at D = 300, the round-1 solve at the flagship:
   the rule's S within 10 % of the best), kernel A and the batched kernel
   with the terminal cost beside their times without it, the weighted
   update's S sweep at the flagship and at D = 300 (the same check) beside
   one PyTorch call for the same function, the legacy rollout's S sweep at
   the flagship and at K = 1,000 (the same check) and its time against the
   parent's, the batched kernel's device time for each plant group
   P of 1-32 at N = 1,024 and N = 16, kernel A and the batched kernel in
   seed mode with the Philox key by pointer, as the commands pass it,
   against the key by value (the same results, and their device times in
   turns), and each kernel's time against its time in the parent commit's
   run (PERF.md); then ``run_mppi_jit`` (``graph_loops``): a CUDA graph of
   one loop step replayed once a command, on every route (MPPI, SMPPI and
   KMPPI fused and plain, the legacy route, ``MPPI_Batched`` in seed,
   operand and plain mode at N = 16, elites, three iterations, stochastic
   rollouts, five refinement steps), 20 steps bit for bit against a twin's
   eager ``command()`` loop with exact launch counts, fresh noise at every
   replay, and the graph loop timed against the eager loop at the flagship;
   then learned dynamics (``learned_dynamics``, phase 4e,
   ``examples/fused_kernel_demo.py``'s problem): a [3, 32, 32, 2] residual MLP
   trained by ``make_train_step`` for 300 epochs on 8,192 pendulum
   transitions, its ``ResidualMLP`` instantiations (kernel A's MPPI, SMPPI
   and KMPPI in bits and seed mode, the legacy rollout) against their plain
   versions at K = 10,000, T = 30 with the MLP's own tolerance and the count
   of samples beyond it (each must have come within ``WRAP_EDGE`` of the
   wrap at ±pi), each kernel alone (a CUDA graph of 20 calls) beside its
   plain version and bound, the main path (150 commands from [pi, 1],
   fused with one kernel A launch a command, plain and the legacy route,
   each ending with |angle| < 0.5; SMPPI and KMPPI fused), a
   ``run_mppi_jit`` graph loop of the fused and the plain route equal to the
   eager loop bit for bit over 20 steps, and ``pendulum_approximate`` at its
   JAX sizes (retraining through ``dynamics_params``, the plain path);
5. swing-up: the pendulum with ``use_pallas=True``, 150 steps;
6. closed loops through the kernels: the ``tests/test_mppi.py`` LQ problem
   (KMPPI reaches the goal, SMPPI stays finite), the toy2d comparison of
   ``examples/smooth_mppi.py`` (MPPI, SMPPI, KMPPI), and
   ``examples/scenario_batch.py``'s loops (N = 16 and N = 1,024: more than
   90 % of the plants end within 0.5 of the goal);
8. the utilities (``deployment``): the deploy artifact of fused MPPI (also
   with four elites and the terminal cost), SMPPI and KMPPI at the
   flagship, of MPPI's legacy route, of MPPI on the learned model and of
   ``MPPI_Batched`` in seed mode at N = 1,024, K = 16,384, each loaded in a
   fresh process that imports only the package and replays 20 commands bit
   for bit against the live controller, with the launch counters read
   there and the artifact's command median beside the live one; a
   checkpoint of fused MPPI with four elites restored there into a
   controller of another seed, whose next 10 commands, eager and in
   ``run_mppi_jit``'s graph loop, are the original's bit for bit;
   ``utils/timer.benchmark_command`` against this script's CUDA-event
   median; and the fused command and the graph loop's step with the
   kernels launched directly against through their ``torch.library``
   operators (``ops/library.py``), in turns;
9. sharding (``sharding``): kernel A's MPPI, SMPPI and KMPPI at the
   flagship with the null row and the emitted actions, in bits and seed
   mode, split into 2, 4 and 8 per-shard launches (each with its null gate
   and its shard of the global samples) and merged by the rule of
   ``ops/solve._merge_stats``, against the unsharded launch (JAX's
   tolerances) and the plain version, with exactly one all-zero column
   (column 0) and none with every gate 0; the batched pair over two halves
   of N = 1,024 plants bit for bit the whole; then a 2-rank Gloo world on
   the one card (``spawn``; ``initialize_multihost``, ``make_mesh``): 200
   closed-loop commands of fused MPPI, SMPPI and KMPPI and of plain MPPI
   with K split over "k", and 20 of ``MPPI_Batched`` at N = 1,024 with the
   plants over "data", one kernel launch a command a rank, the actions
   equal across the ranks and within ``SHARD_ACTION_ATOL`` of the
   unsharded controller's from the same plant and controller state; then a 1-rank NCCL world
   here whose sharded command is the unsharded one bit for bit; kernel A's
   time with the gate set against the static null row, and each sharded
   command's median against the unsharded one's;
10. the tuners (``tuning``), at benchmarks/tuning.py's sizes on a fused
   toy2d ``MPPI``: one generation of 16 candidates through
   ``autotune.PopulationEvaluator`` (a ``torch.func.vmap`` of the plain
   body, no kernel launched) within 1e-4 of a loop over its candidates of
   ``step_no_shift`` calls on the same seeds, both timed; ``CMAESOpt``,
   ``GlobalSearchOpt`` with horizon groups and ``CMAMEOpt`` on the
   population path; ``CMAESOpt`` on the sequential path with exactly
   (lambda + 1)·M·R launches of kernel A a step; ``GradientOpt`` on JAX's
   ``TestGradientOpt`` problem to below 0.3 of its start;
11. the dynamics bridge (``generated_models``, ``ops/batch_last.py``): the
   user's own callables passed untagged, traced into generated device
   models whose libraries (one ``nvcc`` for each model and variant) build
   beside the named library in phase 2: the flagship written as plain
   lambdas (bench.py's problem) through kernel A against the named
   ``linear_quadratic`` on the same seed, both timed from a CUDA graph of
   20 calls, and 100 commands of each route with their latency; the
   swing-up from [pi, 1] with ``models/pendulum.py``'s functions wrapped
   untagged (150 commands, |angle| < 0.25), its kernel A beside the named
   ``Pendulum``'s; JAX's ``test_step_dependent`` plant (B (1 + 0.01 t),
   cost (1 + 0.005 t)) through kernel A's three variants and the legacy
   rollout at the flagship, and the batched pair at N = 16, K = 10,240, each
   against its plain version (the traced program's evaluator) in bits mode,
   with exact launch counts of each route's loop; a traced terminal cost
   that is not ``quadratic_terminal`` in kernel A against its plain version;
12. the examples (``example_phase``, ``pytorch_mppi_tpu_torch/examples/``):
   the generated batched pair of ``scenario_batch``'s plant (the flagship
   lambdas' program, whose library builds in phase 2) at N = 1,024,
   K = 16,384, T = 30 in operand mode against its plain version and against
   the named ``LinearQuadratic`` pair, both timed from a CUDA graph of 20
   calls; ``scenario_batch --pod-scale --pallas`` eager and with
   ``--jit-loop`` (run_mppi_jit's CUDA graph), each with exactly 2 × 30
   ``generated_batched`` launches and no other, held to phase 6's goal
   check (more than 90 % of the plants come within 0.5 during the loop, the
   mean distance over the last 10 steps below 1.0), the same counts in
   both, the command median and plant-solves/s printed;
   ``differentiable_mpc`` at its JAX test's 15 Adam steps (the task loss
   lower) and its loss's gradient through a 2-command loop in float64 on
   the card against the CPU's on the same weights and draws;
   ``elite_reuse`` and ``deploy_serving`` at their JAX tests' sizes and
   ``gradient_refinement`` at one seed of its test's two, with those tests'
   checks; ``smooth_mppi``'s three rows finite after 20 steps;
7. the ``kernels`` line (eight kernels, the residual MLP's four
   instantiations, the generated models' eight and phase 12's generated
   batched pair), the card line, then the last line
   ``{"ok": true, "device": ...}``.
"""
import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

DEVICE = "cuda"
K, T, NX, NU = 10_000, 30, 2, 2
NSP = T // 2  # KMPPI's default support points at the flagship
# the flagship loops' commands, and the refinement loops' (REFINE_COMMANDS),
# cut from 1,000 and 200 to keep the run inside its time limit with phase 11
# on a slow host (a run at those depths took 1,135 s of the 1,200 s there)
COMMANDS = 500
REFINE_COMMANDS = 50
WARMUP = 20
LOOP_K = 500  # the closed loops of phase 6
# MPPI_Batched: examples/scenario_batch.py's north-star width, and its
# default closed loop
BATCH_N, BATCH_K = 1024, 16_384
BATCH_SMALL_N, BATCH_SMALL_K = 16, 10_240
WIDE_N, WIDE_K, WIDE_T = 70_000, 256, 10  # more plants than a grid row of 65,535
BATCH_COMMANDS, BATCH_PLAIN_COMMANDS, BATCH_WARMUP = 200, 50, 5
SWEEP_N, SWEEP_KS, SWEEP_COMMANDS = 64, (256, 512, 1024, 2048, 4096, 10_240), 40
SCENARIO_N, SCENARIO_K, SCENARIO_T, SCENARIO_STEPS = 16, 256, 10, 30
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
FIRST_MPPI_SEED_MS = 0.04754  # the MPPI pair, seed mode, flagship, as first ported (PERF.md)
# each kernel's device time in the parent commit's run (PERF.md, §6 table;
# NVIDIA H100 80GB HBM3, 700 W): kernel A at the flagship in seed mode and at
# D = 300 with a full operator; the batched pair at the main paths' widths;
# the legacy route's kernels and the sampler (seed and bits mode) at the
# flagship; and the parent's build time
BEFORE_MS = {"mppi": 0.019026, "smppi": 0.019557, "kmppi": 0.021437, "rowmajor": 0.021706,
             "mppi_D300": 0.392058, "smppi_D300": 0.425274, "kmppi_D300": 0.319928,
             "weighted_update": 0.010437, "rollout": 0.003950, "sampler": 0.005701,
             "sampler_bits": 0.005506, "batched_operand": 1.071776, "batched_seed": 1.156416,
             "batched_small_operand": 0.031957}
BEFORE_BUILD_S = 161.2
# the final-state terminal cost of the terminal cases and loops: w_state
# |x_T - goal|^2 + w_action |u_T|^2 toward the flagship's goal
TERMINAL_W = (1.0, 0.1)
PLANT_GROUPS = (1, 2, 4, 8, 16, 32)  # the P sweep of the batched kernel
REPEATS = 50  # calls in a row of one merging kernel: its merge counter resets
BATCHED_NAMES = ("batched_partial", "flash_merge")
ITERS, BATCH_ITERS = 3, 2  # num_iterations of the single-plant and batched iteration loops
ELITES = 4  # num_elites of the elite loops
REFINE_STEPS = 5  # gradient_refinement_steps of the refinement loop
SHORT_COMMANDS = 200  # the refinement loop's and SMPPI's and KMPPI's sampler loops' commands
M_STOCH = 4  # rollout_samples of the stochastic loop
STOCH_SCALE = 0.05  # the stochastic loop's dynamics noise (a standard deviation)
GRAPH_STEPS = 20  # plant steps of each route's graph loop held to the eager loop
# the sharding phase (9): kernel A split into SHARDS per-shard launches in one
# process; the 2-rank Gloo world's closed loops (SHARD_COMMANDS commands a
# single-plant route, SHARD_BATCH_COMMANDS for MPPI_Batched at N = 1,024),
# each rank's time limit, and how far a sharded command's action may be from
# the unsharded controller's from the same state: the float32 rounding of
# the merge (delta/s within 1e-4 relative, JAX's tolerance, on actions of
# magnitude up to a few units)
SHARDS = (2, 4, 8)
SHARD_COMMANDS, SHARD_BATCH_COMMANDS, SHARD_TIMEOUT = 200, 20, 300
SHARD_ACTION_ATOL = 1e-4
# the residual MLP (phase 4e): examples/fused_kernel_demo.py's problem
MLP_K, MLP_T, MLP_COMMANDS = 10_000, 30, 150
# its cost tolerance against the plain version: 30 steps through the
# network carry the matrix products' summation order (a CPU emulation of
# the kernel's arithmetic differed by up to 1.1e-4 relative at this shape)
MLP_RTOL, MLP_ATOL = 2e-4, 1e-4
WRAP_EDGE = 1e-4  # within this of ±pi the kernel and the plain version may wrap apart
# the deployment phase (8): commands each artifact replays in a fresh process
# against the live controller, commands timed for the medians (after a
# warm-up), and the commands a restored checkpoint continues for
DEPLOY_COMMANDS, DEPLOY_TIMED, DEPLOY_WARMUP, CKPT_COMMANDS = 20, 200, 10, 10
# the tuning phase (10): benchmarks/tuning.py's sizes (toy2d, K = 1,024,
# T = 15, R = 10 no-shift commands in each of M = 5 streams a candidate,
# populations of 16, float32); TUNE_STEPS optimize_steps a tuner; the
# vmapped generation held to the loop over its candidates at TUNE_RTOL (a
# float32 rounding of batched against single products over R refinements);
# GradientOpt on JAX's TestGradientOpt problem (tests/test_autotune.py:898-
# 912: sigma 0.05, lambda 20, K = 256, T = 10, R = 5, M = 2), GRAD_STEPS
# optimize_steps of GRAD_ADAM Adam updates, to below GRAD_RATIO of its start
TUNE_K, TUNE_T, TUNE_R, TUNE_M, TUNE_POP, TUNE_STEPS = 1024, 15, 10, 5, 16, 3
TUNE_RTOL = 1e-4
GRAD_K, GRAD_T, GRAD_R, GRAD_M, GRAD_STEPS, GRAD_ADAM, GRAD_RATIO = 256, 10, 5, 2, 6, 10, 0.3
# the fresh process of phase 8: it imports only pytorch_mppi_tpu_torch (and
# torch and numpy), loads each artifact and replays its commands on the
# live controller's states, then restores the checkpoint into a controller
# of another seed and continues it eagerly and in run_mppi_jit's graph loop
# the dynamics bridge (phase 11): commands of each generated route's loop,
# calls a CUDA graph replays for the kernel-alone times, the plain lambdas'
# plant (the flagship's), the swing-up (phase 5's sizes), the batched width,
# and the traced terminal cost's state weights
GEN_COMMANDS = 100
GEN_GRAPH_CALLS = 20
GEN_B, GEN_GOAL, GEN_TERM_W = ((1.0, 0.0), (0.0, -1.0)), (2.0, 2.0), (3.0, 1.0)
GEN_PEND_K, GEN_PEND_T, GEN_PEND_COMMANDS = 1000, 15, 150
# the examples (phase 12): scenario_batch's closed-loop steps (its default);
# cut, to keep the phase near 40 s (a slow host takes up to 1.9x): the
# Adam steps of differentiable_mpc (25, JAX's example, to 15, JAX's test),
# gradient_refinement's seeds (2, JAX's test, to 1) and smooth_mppi's steps
# (40 to 20)
EX_STEPS = 30
EX_TRAIN_STEPS, EX_REFINE_SEEDS, EX_SMOOTH_STEPS = 15, 1, 20
SERVE_CHILD = r"""
import json, statistics, sys
import numpy as np
import torch
from pytorch_mppi_tpu_torch import MPPI, linear_quadratic, run_mppi_jit
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.utils import checkpoint, deploy

torch.backends.cuda.matmul.allow_tf32 = False
jobs = json.load(open(sys.argv[1]))
dev = torch.device(jobs["device"])
report = {"artifacts": {}}
if dev.type == "cpu":  # a rehearsal without a card: the host clock for the events
    import time

    class _Event:
        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    torch.cuda.Event = lambda **kw: _Event()
    torch.cuda.synchronize = lambda *a: None


def reset():
    torch.cuda.synchronize()
    for name in FS.launches:
        FS.launches[name] = 0


for job in jobs["artifacts"]:
    solver = deploy.load_solver(job["path"])
    xs = torch.from_numpy(np.load(job["states"])).to(solver.device)
    reset()
    acts = [solver.command(x) for x in xs]
    torch.cuda.synchronize()
    launched = dict(FS.launches)
    np.save(job["actions"], torch.stack(acts).cpu().numpy())
    lat = []
    for i in range(jobs["warmup"] + jobs["timed"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        solver.command(xs[-1])
        end.record()
        if i >= jobs["warmup"]:
            lat.append((start, end))
    torch.cuda.synchronize()
    report["artifacts"][job["name"]] = dict(
        launches=launched, route=solver.meta["route"],
        median_ms=statistics.median(a.elapsed_time(b) for a, b in lat))

ck = jobs["checkpoint"]
lq = linear_quadratic(torch.tensor(ck["B"], device=dev), torch.tensor(ck["goal"], device=dev))


def restored():
    ctrl = MPPI(lq.dynamics, lq.running_cost, 2, torch.eye(2, device=dev),
                num_samples=ck["K"], horizon=ck["T"], lambda_=1.0, seed=ck["seed"],
                use_pallas=True, num_elites=ck["elites"], fused_artifacts=True, device=dev)
    return checkpoint.load_controller(ck["path"], ctrl)


x0 = torch.tensor(ck["x"], device=dev)
x, acts, ctrl = x0, [], restored()
reset()
for _ in range(ck["commands"]):
    a = ctrl.command(x)
    acts.append(a)
    x = lq.dynamics(x, a)
torch.cuda.synchronize()
eager_launches = dict(FS.launches)
ctrl = restored()
reset()
_, graph_acts, _ = run_mppi_jit(ctrl, lq.dynamics, x0, ck["commands"])
torch.cuda.synchronize()
np.savez(ck["actions"], eager=torch.stack(acts).cpu().numpy(), graph=graph_acts.cpu().numpy())
report["checkpoint"] = dict(eager_launches=eager_launches, graph_launches=dict(FS.launches),
                            counter=ctrl._state.counter)
json.dump(report, open(sys.argv[2], "w"))
print("SERVED OK")
"""


START = time.perf_counter()


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stamp(phase):
    """The phase's start on the host clock, for the run's time budget."""
    print(f"# phase {phase} starts at {time.perf_counter() - START:.1f} s")


def check(cond, msg):
    if not cond:
        fail(msg)


def _per_step(model, nx, nu):
    """Operations of one device-model step plus its running cost."""
    if getattr(model, "program", None) is not None:  # a generated model: scale, nodes, sum
        from pytorch_mppi_tpu_torch.ops.batch_last import _count_ops

        return nu + _count_ops(model.program, model.outputs) + 1
    if model.name == "pendulum":  # scale 1, step 12, cost 9, sum 1
        return nu + 12 + 9 + 1
    if model.name == "residual_mlp":
        # scale; each layer's n_in * n_out fused multiply-adds and n_out bias
        # additions, tanh on the hidden units; the wrap (fmodf, compare, add,
        # two sums) on the way in and out, sin and cos of an encoded
        # dimension, the clip, the residual; the cost (pendulum 9, or a
        # difference and a multiply-add a state); the sum
        from pytorch_mppi_tpu_torch.ops.kernel_models import mlp_header

        head = mlp_header(model.consts)
        w = head["widths"]
        ops = nu + sum(2 * a * b + b for a, b in zip(w, w[1:])) + sum(w[1:-1])
        ops += 10 * len(head["wrap"]) + 2 * len(head["encode"])
        ops += (2 * nu if head["clip"] else 0) + nx
        ops += 9 if head["cost"] == "pendulum" else 3 * nx
        return ops + 1
    # scale, u Bᵀ + x, |goal - x|², sum
    ops = nu + nx * (2 * nu + 1) + 3 * nx + 1
    if model.name == "toy2d":  # hill (c - x)ᵀ Q (c - x), r|u|², exp and sums
        ops += nx * (3 + 3 * nx) + 2 * nu + 6
    return ops


def fused_work(config, model, seed_or_bits, x0T, op, emit_perturbed=False,
               variant="mppi", plants=1, terminal=False, elites=None):
    """``(operations, bytes)`` one fused iteration needs on these inputs,
    for the least time the card could take (the ``bound_ms`` below).

    Operations are counted from ``csrc/fused_mppi.cu`` for the K live
    samples (of each of the ``plants`` plants of the batched variant): every
    arithmetic instruction on the data, integer or float, once (a fused
    multiply-add twice, a library function such as ``log1pf``, ``expf``,
    ``sinf`` or ``fmodf`` once), erfinv on its common branch (|z| < 2.9).
    The draw (Philox, the normal, the transform) is counted once a sample,
    and for the batched variant once a source column, which every plant
    shares (K/2 columns with antithetic pairs); the rest once a sample of
    each plant.  Bytes count each input read once (a stride-0 ``x0T`` is
    its nx values) and each output written once; the (plants, nblocks,
    R + 2) partials between the two kernels are not the function's.  R is
    the rows drawn and updated: D = T·nu, or Dp = nsp·nu for KMPPI.  A
    float32 ``seed_or_bits`` is the batched variant's final noise operand:
    nothing is drawn, and the operator is not read.  The round-1 solve
    (``variant="rowmajor"``) takes x0 (nx,), ``op`` the (nu, nu) Cholesky
    factor applied per timestep and mu, lo, hi of nu values, and draws with
    no antithetic sign.  A traced ``terminal`` cost (``ops/batch_last.py``)
    adds its program's operations and reads its constants; any other
    ``terminal`` cost (``quadratic_terminal``) adds,
    per sample, nx subtractions and fused multiply-adds, nu fused
    multiply-adds, two products and two sums, and reads its nx + 2
    constants.  An (E, D) ``elites`` operand is read once; its rows take the
    place of U + noise, which adds no operation."""
    from pytorch_mppi_tpu_torch.ops.fused_solve import _BLOCK

    K, T, nx, nu = config.K, config.T, config.nx, config.nu
    D = T * nu
    R = config.num_support_pts * nu if variant == "kmppi" else D
    seed_mode = not isinstance(seed_or_bits, torch.Tensor)
    operand = not seed_mode and seed_or_bits.is_floating_point()
    full_op = op.ndim == 2 and not operand
    absc = int(config.noise_abs_cost)
    # per drawn row: the normal (bits -> u: 6; Giles' erfinv: 22; sqrt(2)
    # and the antithetic sign: 2), the transform; nothing for an operand.
    # The round-1 solve: no sign, and nu multiply-adds and mu a row
    if variant == "rowmajor":
        draw = 29 + 2 * nu + 1
    else:
        draw = 0 if operand else 30 + (2 * R + 1 if full_op else 2)
    # Philox4x32-10: 10 rounds of 2 mulhi, 2 mullo, 4 xor; 9 key bumps of 2
    philox = -(-R // 4) * 98 if seed_mode else 0
    if variant in ("mppi", "batched", "rowmajor"):
        # U + n, the clamp, the rectified noise and its action cost, the
        # weighted update (3)
        per_sample = D * (6 + absc + 3)
    elif variant == "smppi":
        # U + n, rate clamp, integrate, action clamp, (pa - as)/dt - U, the
        # action cost, the smoothness term (sub, fma, u_scale), the update
        # (sub, div, sub, fma)
        per_sample = D * (1 + 2 + 2 + 2 + 3 + 2 + absc
                          + 2 + int(config.u_scale != 1.0) + 5) + 2
    else:
        # theta + n, the clamp, the update (3); per horizon row the
        # interpolation (Dp fmas), the clamp, the rectified noise and its cost
        per_sample = R * (1 + 2 + 3) + D * (2 * R + 2 + 1 + 2 + absc)
    # per sample: the total, the logit, the block max, exp, the block sum
    per_sample += T * _per_step(model, nx, nu) + 7
    term_consts = nx + 2
    if getattr(terminal, "program", None) is not None:  # a traced terminal cost
        from pytorch_mppi_tpu_torch.ops.batch_last import _count_ops

        per_sample += _count_ops(terminal.program, [terminal.output]) + 1
        term_consts = terminal.consts.numel()
    elif terminal:
        per_sample += 3 * nx + 2 * nu + 4
    if variant != "batched":
        draws = K
    elif operand:
        draws = 0
    else:
        draws = -(-K // 2) if config.antithetic else K
    nblocks = -(-K // _BLOCK)
    operations = (plants * (K * per_sample + nblocks * (5 + 4 * R))
                  + draws * (R * draw + philox))
    x0_elems = nx if x0T.ndim == 1 or x0T.stride(1) == 0 else x0T.numel()
    vectors = {"mppi": 5 * D + 1, "smppi": 8 * D + 3,
               "kmppi": 4 * D + 4 * R + D * R + 1,
               "batched": 2 * D * plants + 3 * D + 1,
               "rowmajor": 2 * D + 3 * nu + 1}[variant]
    in_elems = (x0_elems + vectors + (0 if operand else op.numel())
                + model.consts.numel() + (0 if seed_mode else seed_or_bits.numel())
                + (term_consts if terminal else 0) + (0 if elites is None else elites.numel()))
    out_elems = plants * (K + R + 2) + (D * K if emit_perturbed else 0)
    return operations, 4 * (in_elems + out_elems)


def sampler_work(config, sample, seed_or_bits, op):
    """``(operations, bytes)`` of the sampling front-end on these inputs.
    One draw (30 operations, as ``fused_work``'s, plus Philox's 98 for each
    counter of four words in seed mode) for each element of a source row
    that a live sample reads (a mirrored row reads its partner's); per
    output element the transform (2, or 2D + 1 with a full op), U + n, the
    clamp, the rectified noise and its cost.  Bytes: the bits as given, the
    five D-vectors and the op read once, perturbed (K, D) and the cost (K,)
    written once."""
    from pytorch_mppi_tpu_torch.ops.fused_solve import source_columns

    K, D = config.K, config.T * config.nu
    src, _ = source_columns(K, sample.block_k, config.antithetic, "cpu")
    draws = int(src.unique().numel())
    seed_mode = not isinstance(seed_or_bits, torch.Tensor)
    transform = 2 * D + 1 if op.ndim == 2 else 2
    per_elem = transform + 1 + 2 + 1 + 2 + int(config.noise_abs_cost)
    operations = draws * D * 30 + K * D * per_elem
    if seed_mode:
        operations += draws * -(-D // 4) * 98
    in_elems = (0 if seed_mode else seed_or_bits.numel()) + 5 * D + op.numel()
    return operations, 4 * (in_elems + K * D + K)


def rollout_work(model, x0_K, u_scaled):
    """``(operations, bytes)`` of the legacy rollout kernel: T model steps
    and running costs a sample (the actions come scaled); its x0 (nx values
    when shared), the (K, T·nu) actions and the constants read once, the
    (K,) cost written once."""
    K, T, nu = u_scaled.shape
    nx = x0_K.shape[1]
    x0_elems = nx if x0_K.stride(0) == 0 else x0_K.numel()
    operations = K * T * (_per_step(model, nx, nu) - nu)
    return operations, 4 * (x0_elems + u_scaled.numel() + model.consts.numel() + K)


def weighted_update_work(K, D):
    """``(operations, bytes)`` of the legacy weighted update: a sample's
    logit (negate, divide), the block max, exp, the block sum and D fused
    multiply-adds; each block's merge (max, exp, s and D fmas); the (K,)
    cost, the (K, D) noise and lambda read once, (D,) and m, s written."""
    from pytorch_mppi_tpu_torch.ops.fused_solve import _BLOCK

    nblocks = -(-K // _BLOCK)
    operations = K * (5 + 2 * D) + nblocks * (5 + 4 * D)
    return operations, 4 * (K + K * D + 1 + D + 2)


def bound(work):
    """The least time (ms) and what bounds it, from ``(operations, bytes)``."""
    ops, nbytes = work
    return max((nbytes / H100_BYTES_PER_S * 1e3, "bytes"),
               (ops / H100_F32_PER_S * 1e3, "operations"))


def agree(cost_k, cost_p, upd_k, upd_p, lam, m_k=None, m_p=None, s_k=None, s_p=None,
          rtol=2e-5, atol=1e-5, excused=None):
    """The kernel's results against the plain version's.  A cost error e
    moves each softmax weight by a factor e^(+-e/lam), so m, s and the
    update may move by that much; the update is compared on the scale of
    its largest element (of each plant's column for the batched variant).
    The costs are held to ``rtol``/``atol`` but for the ``excused`` samples
    (a mask).  Returns ``(ok, cost error, update error, weight
    tolerance)``."""
    c_err = float((cost_k - cost_p).abs().max())
    within = (cost_k - cost_p).abs() <= atol + rtol * cost_p.abs()
    ok = bool((within if excused is None else within | excused).all())
    w_tol = 2e-4 + 2 * c_err / lam
    if m_k is not None:
        ok = ok and float((m_k - m_p).abs().max()) <= c_err / lam + 1e-6
        ok = ok and float((s_k / s_p - 1).abs().max()) <= w_tol
    u_err = float((upd_k - upd_p).abs().max())
    scale = upd_p.abs().amax(dim=0) if upd_p.ndim == 2 else upd_p.abs().max()
    ok = ok and bool(((upd_k - upd_p).abs() <= w_tol * scale).all())
    return ok, c_err, u_err, w_tol


def events_ms(fn, iters):
    """Mean time per call on the card's timeline, between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters, names):
    """Device time per call of the kernels whose names contain ``names``,
    from the profiler's trace; None when the trace holds no device time.
    Late in this long process the profiler drops or misses kernels, so this
    is a cross-check of ``graph_ms``, and the trace's kernel count is
    returned beside the time: ``(ms or None, kernels seen)``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if any(n in e.key for n in names)]
    total = sum(e.self_device_time_total for e in events)
    return (total / iters / 1e3 if total > 0 else None), sum(e.count for e in events)


def graph_ms(fn, iters):
    """Device time per call of ``fn`` replayed from a CUDA graph of ``iters``
    calls, between two CUDA events: no host time between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def breakdown(name, ctrl, step, x, n=50):
    """Where a command's time goes: device kernels per command from the
    profiler, and the device's idle share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for _ in range(n):
            x = step(x, ctrl.command(x))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall) * 1e6
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern)
    count = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"# breakdown [{name}] over {n} commands (profiler on): host "
          f"{wall / n:.1f} us/command | device busy {busy / n:.1f} us/command in "
          f"{count / n:.1f} kernels | device idle {1 - busy / wall:.3f} | top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / n:.1f} us x{e.count / n:.1f}"
              for e in top))


class Captured(logging.Handler):
    """The port's log records while it is attached (the routing warnings)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("pytorch_mppi_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("pytorch_mppi_tpu_torch").removeHandler(self)


class EventGraph:
    """A captured graph whose replays record a CUDA event first: the
    interval between two such events is one loop step on the card's
    timeline."""

    def __init__(self, graph):
        self.graph, self.events = graph, []

    def replay(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)
        self.graph.replay()


def step_stats(events):
    """Median and p90 ms a step from the events at each step's start (the
    last one at the loop's end)."""
    lat = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return statistics.median(lat), lat[int(0.9 * len(lat))]


def idle_share(run):
    """The device's idle share of the host-clock window of ``run()`` (which
    ends by synchronising), from the profiler's kernel times, and the
    kernels it saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        run()
        wall = (time.perf_counter() - wall) * 1e6
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern)
    return 1 - busy / wall, sum(e.count for e in kern)


def graph_loops(dev, lq, goal):
    """Phase 4d: ``run_mppi_jit`` on the card, a CUDA graph of one loop step
    replayed once a command, against a twin controller's eager
    ``command()`` loop on the same seed.

    Every route runs GRAPH_STEPS plant steps: the actions, the states, the
    total cost and the final U (and elites) must be equal bit for bit, and
    the launch counters must read the steps times the route's launches a
    command.  With a plant that holds its state still, the second replayed
    command must differ from the one a repeated stream would give (the
    counter set back), and equal the eager loop's.  Then the graph loop
    and the eager loop are timed in turns at the flagship (fused and plain
    MPPI, refinement, MPPI_Batched seed mode at N = 1,024): the median and
    p90 ms a step between CUDA events at each step's start, the host clock,
    and the device's idle share from the profiler.  Returns the rows for
    the ``kernels`` line and ``PERF.md``."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel, run_mppi_jit
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import solve as PS

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    def lq_step(x, action):
        return lq.dynamics(x[None], action[None])[0]

    def noisy_lq(s_, a, rng):
        return lq.dynamics(s_, a) + STOCH_SCALE * torch.randn(
            s_.shape, generator=rng, device=s_.device, dtype=s_.dtype)

    eye = torch.eye(NU, device=dev)
    extra = {"mppi": (MPPI, {}),
             "smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                                   action_min=torch.tensor([-3.0, -3.0]),
                                   action_max=torch.tensor([3.0, 3.0]))),
             "kmppi": (KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0)))}

    def single(variant, use_pallas, dynamics=None, K_=K, **kw):
        cls, ekw = extra[variant]
        return lambda seed: cls(dynamics or lq.dynamics, lq.running_cost, nx=NX,
                                noise_sigma=eye, num_samples=K_, horizon=T, lambda_=1.0,
                                seed=seed, use_pallas=use_pallas, device=dev, **ekw, **kw)

    def batched(use_pallas, N_=BATCH_SMALL_N, K_=BATCH_SMALL_K):
        return lambda seed: MPPI_Batched(
            lq.dynamics, lq.running_cost, nx=NX, noise_sigma=eye * 0.5, num_envs=N_,
            num_samples=K_, horizon=T, lambda_=1.0, u_min=-torch.tensor([1.0, 1.0]),
            u_max=torch.tensor([1.0, 1.0]), seed=seed, use_pallas=use_pallas, device=dev)

    def start(ctrl):
        if isinstance(ctrl, MPPI_Batched):
            g = torch.Generator(device=dev)
            g.manual_seed(42)
            return torch.rand(ctrl.N, NX, generator=g, device=dev) * 4 - 4
        return torch.tensor([-3.0, -2.0], device=dev)

    def plant_of(ctrl):
        return lq.dynamics if isinstance(ctrl, MPPI_Batched) else lq_step

    # route -> (controller on a seed, the launches of one command)
    routes = {
        "mppi fused": (single("mppi", True), dict(mppi=1)),
        "mppi plain": (single("mppi", False), {}),
        "mppi rollout": (single("mppi", "rollout"), dict(rollout=1, weighted_update=1)),
        "smppi fused": (single("smppi", True), dict(smppi=1)),
        "smppi plain": (single("smppi", False), {}),
        "kmppi fused": (single("kmppi", True), dict(kmppi=1)),
        "kmppi plain": (single("kmppi", False), {}),
        "batched seed": (batched("kernel_rng"), dict(batched=2)),
        "batched operand": (batched(True), dict(batched=2)),
        "batched plain": (batched(False), {}),
        "mppi fused_elites": (single("mppi", True, num_elites=ELITES, fused_artifacts=True),
                              dict(mppi=1)),
        "mppi fused_iter3": (single("mppi", True, num_iterations=ITERS), dict(mppi=ITERS)),
        "mppi plain_stochastic": (single("mppi", False, dynamics=noisy_lq, rollout_samples=M_STOCH,
                                         rollout_var_cost=0.1, risk_alpha=0.5,
                                         stochastic_dynamics=True), {}),
        "mppi fused_refine5": (single("mppi", True, gradient_refinement_steps=REFINE_STEPS),
                               dict(mppi=1)),
    }

    def eager(ctrl, plant, x, steps):
        """The eager loop: the command, then each action of its block on
        the plant and the running cost after it, as ``run_mppi_jit``."""
        cost = PS.wrap_cost(ctrl.config, ctrl.running_cost)
        batched_ = isinstance(ctrl, MPPI_Batched)
        acc = torch.zeros(ctrl.N if batched_ else (), device=dev)
        xs, acts = [], []
        for _ in range(steps // ctrl.u_per_command):
            a = ctrl.command(x)
            block = (a.reshape(ctrl.N, -1, NU).transpose(0, 1) if batched_
                     else a.reshape(-1, NU))
            for j, a_j in enumerate(block):
                x = plant(x, a_j)
                acc = acc + (cost(x, a_j, j) if batched_ else cost(x[None], a_j[None], j)[0])
                xs.append(x)
                acts.append(a_j)
        return torch.stack(xs), torch.stack(acts), acc

    # every route: GRAPH_STEPS steps bit for bit against the eager loop
    report = {"routes": {}, "timed": {}}
    for name, (build, per_command) in routes.items():
        c_graph, c_eager = build(7), build(7)
        fused = bool(per_command)
        check(c_graph._fns.fused == fused, f"graph loop [{name}] took the wrong route")
        x0 = start(c_graph)
        plant = plant_of(c_graph)
        reset_launches()
        states, actions, total = run_mppi_jit(c_graph, plant, x0, GRAPH_STEPS)
        torch.cuda.synchronize()
        launched = dict(FS.launches)
        xs, acts, acc = eager(c_eager, plant, x0, GRAPH_STEPS)
        torch.cuda.synchronize()
        same = (torch.equal(states[1:], xs) and torch.equal(states[0], x0)
                and torch.equal(actions, acts) and torch.equal(total, acc)
                and torch.equal(c_graph.U, c_eager.U)
                and c_graph._state.counter == c_eager._state.counter)
        if getattr(c_graph._state, "elites", None) is not None:
            same = same and torch.equal(c_graph._state.elites, c_eager._state.elites)
        expect = {k: GRAPH_STEPS * per_command.get(k, 0) for k in FS.launches}
        print(f"# graph loop [{name}] {GRAPH_STEPS} steps: equal to the eager loop bit for bit "
              f"{same} (max |action diff| {float((actions - acts).abs().max()):.3e}, total "
              f"{total.flatten()[:2].tolist()} vs {acc.flatten()[:2].tolist()}) | launches "
              f"{ {k: v for k, v in launched.items() if v} }, expected "
              f"{ {k: v for k, v in expect.items() if v} }")
        check(same, f"graph loop [{name}] differs from the eager command() loop")
        check(launched == expect, f"graph loop [{name}] launched {launched}, expected {expect}")
        check(bool(torch.isfinite(states).all()) and states.shape[0] == GRAPH_STEPS + 1,
              f"graph loop [{name}]: non-finite or misshapen states")
        report["routes"][name] = dict(equal=same, launches=launched)
        del c_graph, c_eager

    # fresh noise at every replay: with the plant held still, the second
    # replayed command is the eager loop's, not the one of a repeated stream
    for name in ("mppi fused", "mppi plain", "batched seed", "mppi plain_stochastic"):
        build = routes[name][0]
        c_graph, c_fresh, c_rep = build(11), build(11), build(11)
        x0 = start(c_graph)
        _, actions, _ = run_mppi_jit(c_graph, lambda x, a: x, x0, 2)
        fresh = [c_fresh.command(x0) for _ in range(2)]
        first = c_rep.command(x0)
        n_iter = c_rep.config.num_iterations
        c_rep._state = c_rep._state._replace(counter=c_rep._state.counter - n_iter)
        repeated = c_rep.command(x0)
        ok = (torch.equal(actions[0], fresh[0]) and torch.equal(actions[1], fresh[1])
              and torch.equal(first, fresh[0]) and not torch.equal(actions[1], repeated))
        print(f"# graph loop [{name}] held still: replay 2 equals the eager loop's command 2 "
              f"{torch.equal(actions[1], fresh[1])}, differs from a repeated stream's "
              f"{not torch.equal(actions[1], repeated)}")
        check(ok, f"graph loop [{name}]: a replay did not draw fresh noise")
        del c_graph, c_fresh, c_rep
    torch.cuda.empty_cache()

    # the graph loop against the eager loop at the flagship, in turns
    timed_routes = {"mppi fused": (routes["mppi fused"][0], COMMANDS),
                    "mppi plain": (routes["mppi plain"][0], COMMANDS),
                    "mppi fused_refine5": (routes["mppi fused_refine5"][0], REFINE_COMMANDS),
                    f"batched seed N={BATCH_N}": (batched("kernel_rng", BATCH_N, BATCH_K),
                                                  SHORT_COMMANDS)}
    for name, (build, steps) in timed_routes.items():
        row = {}
        for mode in ("graph", "eager", "eager", "graph"):
            ctrl = build(5)
            x0 = start(ctrl)
            plant = plant_of(ctrl)
            if mode == "graph":
                run_mppi_jit(ctrl, plant, x0, steps)  # capture
                loop = next(iter(ctrl._runner_cache.values()))
                loop.graph = EventGraph(loop.graph)
                torch.cuda.synchronize()
                wall = time.perf_counter()
                _, _, total = run_mppi_jit(ctrl, plant, x0, steps)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - wall
                events = loop.graph.events + [end]
                loop.graph = loop.graph.graph
                idle, seen = idle_share(lambda: (run_mppi_jit(ctrl, plant, x0, min(steps, 100)),
                                                 torch.cuda.synchronize()))
            else:
                cost = PS.wrap_cost(ctrl.config, ctrl.running_cost)
                batched_ = isinstance(ctrl, MPPI_Batched)
                x = x0
                for _ in range(WARMUP if steps >= COMMANDS else 5):
                    x = plant(x, ctrl.command(x))
                torch.cuda.synchronize()
                events = []
                acc = torch.zeros(ctrl.N if batched_ else (), device=dev)
                wall = time.perf_counter()
                for _ in range(steps):
                    e = torch.cuda.Event(enable_timing=True)
                    e.record()
                    events.append(e)
                    a = ctrl.command(x)
                    x = plant(x, a)
                    acc = acc + (cost(x, a, 0) if batched_ else cost(x[None], a[None], 0)[0])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - wall
                events.append(end)

                def run_eager(ctrl=ctrl, x=x):
                    for _ in range(min(steps, 100) if steps >= COMMANDS else 20):
                        x = plant(x, ctrl.command(x))
                    torch.cuda.synchronize()

                idle, seen = idle_share(run_eager)
            med, p90 = step_stats(events)
            row.setdefault(mode, []).append(dict(median_ms=med, p90_ms=p90,
                                                 host_ms=wall / steps * 1e3, idle=idle,
                                                 kernels_seen=seen))
            print(f"# graph vs eager [{name}] {mode}, {steps} steps: median {med:.4f} ms p90 "
                  f"{p90:.4f} ms a step (CUDA events at each step's start) | host clock "
                  f"{wall / steps * 1e3:.4f} ms a step | device idle {idle:.3f} "
                  f"({seen} kernels in the profiled window)")
            check(math.isfinite(med), f"graph vs eager [{name}] {mode}: no time")
            del ctrl
            torch.cuda.empty_cache()
        g = statistics.median(r["median_ms"] for r in row["graph"])
        e_ = statistics.median(r["median_ms"] for r in row["eager"])
        print(f"# graph vs eager [{name}]: graph / eager median {g / e_:.4f}")
        report["timed"][name] = dict(row, steps=steps, ratio=g / e_)
    return report


def ptxas_entries(log):
    """Each kernel of ``nvcc -Xptxas -v`` output: ``{name, registers,
    stack, spills, compile_ms}``."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(name=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            cur.update(stack=int(m.group(1)), spills=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"Compile time = ([\d.]+) ms", line)
        if m:
            cur["compile_ms"] = float(m.group(1))
    return out


def wrap_edge(model, perturbed, x0T, idx, T_, nu, u_scale=1.0):
    """Of the samples ``idx``, those whose plain rollout over their (D, K)
    ``perturbed`` actions came within WRAP_EDGE of ±π (the wrapped angle of
    the residual MLP's state dimension 0) at some step: a sample there may
    take the other branch of the wrap in the kernel, its state then differing
    by 2π; and each sample's least distance."""
    st = x0T.T[idx]
    dist = torch.full((idx.numel(),), math.inf, device=st.device)
    for t in range(T_):
        st = model.dynamics(st, perturbed[t * nu:(t + 1) * nu, idx].T * u_scale)
        dist = torch.minimum(dist, math.pi - st[:, 0].abs())
    return idx[dist < WRAP_EDGE], dist


def learned_dynamics(dev, gen):
    """Phase 4e: the residual MLP in the kernels (``examples/
    fused_kernel_demo.py``'s problem): its ``ResidualMLP`` instantiations
    against their plain versions, the kernels alone, the main path, a
    ``run_mppi_jit`` graph loop and ``pendulum_approximate``.  Returns the
    rows for the ``kernels`` line and PERF.md."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, RBFKernel, run_mppi_jit
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.examples import fused_kernel_demo as FKD
    from pytorch_mppi_tpu_torch.examples import pendulum_approximate
    from pytorch_mppi_tpu_torch.models import pendulum_dynamics
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import solve as PS
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    report = {"cases": {}, "timed": {}, "loops": {}}
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the plain versions' float32 products must not run in TF32")
    # the new instantiation's registers, spills and stack (its activations
    # live in local memory) from the build's log
    log = _build.library_path().with_suffix(".log")
    entries = ptxas_entries(log.read_text()) if log.is_file() else []
    mlp_entries = [e for e in entries if "ResidualMLP" in e["name"]]
    for e in mlp_entries:
        print(f"# ptxas [{e['name']}]: {e.get('registers')} registers, {e.get('spills')} bytes "
              f"spill stores, {e.get('stack')} bytes stack frame, {e.get('compile_ms')} ms")
    report["ptxas"] = mlp_entries

    # the model: fused_kernel_demo's, trained by make_train_step
    wall = time.perf_counter()
    params, loss = FKD.train_model(device=dev)
    torch.cuda.synchronize()
    model = FKD.kernel_model(params)
    report["params"] = params  # for the deployment phase
    print(f"# learned model [3, 32, 32, 2]: loss {loss:.5f} after 300 full-batch epochs on 8,192 "
          f"transitions, {time.perf_counter() - wall:.1f} s on the card")
    check(math.isfinite(loss) and loss < 0.1, f"the learned model did not train: loss {loss}")

    # kernel A's three variants against their plain versions at the demo's
    # shape, bits and seed mode, with the perturbed actions emitted
    K_, T_, nu = MLP_K, MLP_T, 1
    D = T_ * nu
    nsp = T_ // 2
    x0T = torch.tensor([math.pi, 1.0], device=dev)[:, None].expand(2, K_)
    full = lambda v, n=D: torch.full((n,), v, device=dev)  # noqa: E731
    lam = torch.tensor(1.0, device=dev)
    U2 = torch.randn(D, generator=gen, device=dev) * 0.5
    a_flat = (U2 / 10.0).contiguous()  # lambda U sigma^-1 at sigma = 10
    interp, _ = interpolation_operators(RBFKernel(2.0), T_, nsp, torch.float32, device=dev)
    operands = {
        "mppi": (x0T, U2, full(math.sqrt(10.0)), full(0.0), full(-2.0), full(2.0), a_flat, lam),
        "smppi": (x0T, U2, torch.randn(D, generator=gen, device=dev) * 0.5,
                  full(math.sqrt(10.0)), full(0.0), full(-2.0), full(2.0), full(-2.0), full(2.0),
                  a_flat, lam, torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)),
        "kmppi": (x0T, U2, torch.randn(nsp, generator=gen, device=dev) * 0.5,
                  full(math.sqrt(10.0), nsp), full(0.0, nsp), full(-2.0, nsp), full(2.0, nsp),
                  full(-2.0), full(2.0), a_flat, interp.contiguous(), lam),
    }
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}

    def config(variant):
        return MPPIConfig(nx=2, nu=nu, K=K_, T=T_, diag_sigma=True,
                          num_support_pts=nsp if variant == "kmppi" else 0,
                          smppi=variant == "smppi")

    print(f"# kernel vs plain [residual MLP]: cost rtol {MLP_RTOL} atol {MLP_ATOL} (the MLP's own: "
          f"30 steps through the network carry the matrix products' summation order), a sample "
          f"beyond it excused only where its plain rollout came within {WRAP_EDGE} of the wrap at "
          f"±pi; m, s and delta/s as the other cases (agree)")
    max_err = dict.fromkeys(FS.VARIANTS + ("rollout",), 0.0)
    for variant in FS.VARIANTS:
        cfg = config(variant)
        R = nsp if variant == "kmppi" else D
        solve = factories[variant](cfg, model, emit_perturbed=True)
        for mode in ("bits", "seed"):
            lead = (torch.randint(-2**31, 2**31 - 1, (R, solve.bits_cols), dtype=torch.int32,
                                  generator=gen, device=dev) if mode == "bits"
                    else tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                             device=dev)))
            out_k = solve(lead, *operands[variant])
            torch.cuda.synchronize()
            out_p = solve.plain(lead, *operands[variant])
            dk, mk, sk, ck, pk = out_k
            dp, mp, sp, cp, pp = out_p
            beyond = ((ck - cp).abs() > MLP_ATOL + MLP_RTOL * cp.abs()).nonzero().flatten()
            edge, dist = wrap_edge(model, pp, x0T, beyond, T_, nu)
            excused = torch.zeros(K_, dtype=torch.bool, device=dev)
            excused[edge] = True
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                            rtol=MLP_RTOL, atol=MLP_ATOL, excused=excused)
            ok = ok and all(bool(torch.isfinite(v).all()) for v in out_k)
            p_err = float((pk - pp).abs().max())
            ok = ok and bool(((pk - pp).abs() <= 1e-6 + 1e-5 * pp.abs()).all())
            within = (ck - cp).abs()
            within[beyond] = 0.0
            print(f"# {mode:4s} {variant:5s} residual_mlp K={K_} D={D} S={solve.tile_k}: cost err "
                  f"{c_err:.3e} (within tolerance {float(within.max()):.3e}) | samples beyond "
                  f"tolerance {beyond.numel()}, at the wrap {edge.numel()} (least distances "
                  f"{[round(float(v), 8) for v in dist[:5]]}) | m err {abs(float(mk - mp)):.3e} | "
                  f"s rel {abs(float(sk / sp - 1)):.3e} (tol {w_tol:.3e}) | delta/s err "
                  f"{u_err:.3e} | perturbed err {p_err:.3e}" + ("" if ok else "  <-- FAIL"))
            check(ok, f"the residual-MLP kernel disagrees with its plain version: {mode}/{variant}")
            max_err[variant] = max(max_err[variant], u_err)
            report["cases"][variant, mode] = dict(beyond=beyond.numel(), at_wrap=edge.numel(),
                                                  cost_err=c_err, update_err=u_err)
    # the legacy rollout on clamped actions of the demo's scale
    cfg_r = MPPIConfig(nx=2, nu=nu, K=K_, T=T_)
    rollout = LG.make_fused_rollout(cfg_r, model)
    x0_K = torch.tensor([math.pi, 1.0], device=dev)[None].expand(K_, 2)
    u = torch.clamp(torch.randn(K_, T_, nu, generator=gen, device=dev) * math.sqrt(10.0), -2, 2)
    ck = rollout(x0_K, u)
    torch.cuda.synchronize()
    cp = rollout.plain(x0_K, u)
    beyond = ((ck - cp).abs() > MLP_ATOL + MLP_RTOL * cp.abs()).nonzero().flatten()
    edge, dist = wrap_edge(model, u.reshape(K_, D).T, x0T, beyond, T_, nu)
    r_err = float((ck - cp).abs().max())
    ok = bool(torch.isfinite(ck).all()) and edge.numel() == beyond.numel()
    print(f"# rollout residual_mlp K={K_} D={D}: cost err {r_err:.3e} | samples beyond tolerance "
          f"{beyond.numel()}, at the wrap {edge.numel()}" + ("" if ok else "  <-- FAIL"))
    check(ok, "the residual-MLP rollout disagrees with its plain version")
    max_err["rollout"] = r_err
    report["cases"]["rollout"] = dict(beyond=beyond.numel(), at_wrap=edge.numel(), cost_err=r_err)
    report["max_err"] = max_err

    # the kernels alone at the main path's shape (seed mode), a CUDA graph of
    # 20 calls, beside the plain version and the bound
    key = (0x2468ACE0, 0x13579BDF)
    for variant in FS.VARIANTS:
        cfg = config(variant)
        solve = factories[variant](cfg, model)
        args = operands[variant]
        dev_ms = graph_ms(lambda: solve(key, *args), 20)
        plain_ms = events_ms(lambda: solve.plain(key, *args), 5)
        op = args[3] if variant != "mppi" else args[2]
        bound_ms, bound_by = bound(fused_work(cfg, model, key, x0T, op, variant=variant))
        report["timed"][variant] = (dev_ms, plain_ms, bound_ms, bound_by)
        print(f"# kernel alone [{variant} residual_mlp] K={K_} T={T_} S={solve.tile_k}: device "
              f"{dev_ms:.6f} ms (a CUDA graph of 20 calls) | plain version {plain_ms:.5f} ms | "
              f"bound {bound_ms:.3e} ms by {bound_by}: {dev_ms / bound_ms:.1f}x | the linear "
              f"model's flagship call before: {BEFORE_MS[variant]} ms")
    dev_ms = graph_ms(lambda: rollout(x0_K, u), 20)
    plain_ms = events_ms(lambda: rollout.plain(x0_K, u), 5)
    bound_ms, bound_by = bound(rollout_work(model, x0_K, u))
    report["timed"]["rollout"] = (dev_ms, plain_ms, bound_ms, bound_by)
    print(f"# kernel alone [rollout residual_mlp] K={K_} T={T_}: device {dev_ms:.6f} ms (a CUDA "
          f"graph of 20 calls) | plain version {plain_ms:.5f} ms | bound {bound_ms:.3e} ms by "
          f"{bound_by}: {dev_ms / bound_ms:.1f}x")

    # the main path: fused_kernel_demo's loop, 150 commands from [pi, 1] on
    # the true plant, fused (one kernel A launch a command) and plain, each
    # ending within |angle| < 0.5 (the demo's own check); the legacy route
    # (the rollout and the weighted update a command) held to the same; and
    # SMPPI and KMPPI on kernel A with the same model (finite actions)
    def pend_step(x, a):
        return pendulum_dynamics(x[None], a[None])[0]

    extra = {"smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                                   action_min=torch.tensor([-2.0]),
                                   action_max=torch.tensor([2.0]))),
             "kmppi": (KMPPI, dict(num_support_pts=nsp, kernel=RBFKernel(2.0)))}

    def planner(variant, use_pallas, seed=42):
        if variant == "mppi":
            return FKD.planner(params, use_pallas, K_, T_, seed=seed, device=dev)
        cls, kw = extra[variant]
        return cls(model.dynamics, model.running_cost, 2, torch.eye(1, device=dev) * 10.0,
                   num_samples=K_, horizon=T_, lambda_=1.0, u_min=torch.tensor(-2.0),
                   u_max=torch.tensor(2.0), seed=seed, use_pallas=use_pallas, device=dev, **kw)

    loops = [("mppi", "fused", True), ("mppi", "plain", False), ("mppi", "rollout", "rollout"),
             ("smppi", "fused", True), ("kmppi", "fused", True)]
    for variant, path, use_pallas in loops:
        ctrl = planner(variant, use_pallas)
        check(ctrl._fns.fused == bool(use_pallas),
              f"residual MLP {variant} {path} took the wrong route")
        torch.cuda.synchronize()
        reset_launches()  # count the main path's launches only
        r = FKD.run_closed(ctrl, MLP_COMMANDS)
        launched = dict(FS.launches)
        n = MLP_COMMANDS + 1  # and run_closed's warm-up command
        expect = {name: 0 for name in FS.launches}
        if path == "rollout":
            expect.update(rollout=n, weighted_update=n)
        elif use_pallas:
            expect[variant] = n
        print(f"# main path [residual MLP {variant} {path}] K={K_} T={T_}, {MLP_COMMANDS} commands "
              f"from [pi, 1] after one warm-up command: {r['ms_per_command']:.4f} ms a command "
              f"(host clock) | final |angle| "
              f"{r['final_angle']:.4f} | launches {launched}")
        check(launched == expect, f"residual MLP {variant} {path} launched {launched}, "
              f"expected {expect}")
        check(math.isfinite(r["final_angle"]) and bool(torch.isfinite(ctrl.U).all()),
              f"residual MLP {variant} {path}: non-finite actions")
        if variant == "mppi":
            check(r["final_angle"] < 0.5, f"residual MLP {path} swing-up failed: final |angle| "
                  f"{r['final_angle']}")
        # the command's latency, as the flagship loops time it: CUDA events
        # around each of MLP_COMMANDS more commands from where the loop ended
        x = r["state"]
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(MLP_COMMANDS)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(MLP_COMMANDS)]
        wall = time.perf_counter()
        for i in range(MLP_COMMANDS):
            starts[i].record()
            a = ctrl.command(x)
            ends[i].record()
            x = pend_step(x, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        lat = sorted(b.elapsed_time(e) for b, e in zip(starts, ends))
        med, p90 = statistics.median(lat), lat[int(0.9 * len(lat))]
        print(f"# main path [residual MLP {variant} {path}] latency over {MLP_COMMANDS} more "
              f"commands: median {med:.4f} ms p90 {p90:.4f} ms (CUDA events) | "
              f"{MLP_COMMANDS / wall:.1f} solves/s (host clock)")
        breakdown(f"residual MLP {variant} {path}", ctrl, pend_step, x)
        report["loops"][variant, path] = dict(r, launches=launched, median_ms=med, p90_ms=p90,
                                              solves_per_s=MLP_COMMANDS / wall)
        del ctrl

    # run_mppi_jit with the model: the graph loop equal to the eager loop bit
    # for bit over GRAPH_STEPS steps, with exact launch counts
    for path, use_pallas, per_command in (("fused", True, dict(mppi=1)),
                                          ("plain", False, {})):
        c_graph, c_eager = planner("mppi", use_pallas, 7), planner("mppi", use_pallas, 7)
        x0 = torch.tensor([math.pi, 1.0], device=dev)
        reset_launches()
        states, actions, total = run_mppi_jit(c_graph, pend_step, x0, GRAPH_STEPS)
        torch.cuda.synchronize()
        launched = dict(FS.launches)
        cost = PS.wrap_cost(c_eager.config, c_eager.running_cost)
        x, acc, xs, acts = x0, torch.zeros((), device=dev), [], []
        for _ in range(GRAPH_STEPS):
            a = c_eager.command(x)
            x = pend_step(x, a)
            acc = acc + cost(x[None], a[None], 0)[0]
            xs.append(x)
            acts.append(a)
        torch.cuda.synchronize()
        same = (torch.equal(states[1:], torch.stack(xs)) and torch.equal(actions, torch.stack(acts))
                and torch.equal(total, acc) and torch.equal(c_graph.U, c_eager.U))
        expect = {k: GRAPH_STEPS * per_command.get(k, 0) for k in FS.launches}
        print(f"# graph loop [residual MLP {path}] {GRAPH_STEPS} steps: equal to the eager loop bit "
              f"for bit {same} | launches { {k: v for k, v in launched.items() if v} }")
        check(same, f"graph loop [residual MLP {path}] differs from the eager command() loop")
        check(launched == expect, f"graph loop [residual MLP {path}] launched {launched}")
        report["loops"]["graph", path] = dict(equal=same, launches=launched)
        del c_graph, c_eager

    # pendulum_approximate at its JAX sizes: online retraining through
    # dynamics_params on the plain path (K = 1,000, T = 30, 300 steps)
    reset_launches()
    wall = time.perf_counter()
    r = pendulum_approximate.main(device=dev)
    wall = time.perf_counter() - wall
    print(f"# pendulum_approximate (K=1000, T=30, 300 steps, a retrain every 50): final angle "
          f"{r['final_angle']:.4f} | validation error {r['val_error']:.4f} | total reward "
          f"{r['total_reward']:.2f} | {wall:.1f} s | launches {sum(FS.launches.values())}")
    check(math.isfinite(r["val_error"]) and math.isfinite(r["final_angle"]),
          "pendulum_approximate went non-finite")
    check(sum(FS.launches.values()) == 0, "pendulum_approximate launched a kernel")
    report["pendulum_approximate"] = dict(r, seconds=wall)
    return report


def deployment(dev, lq, goal, mlp_params):
    """Phase 8: the utilities on the card.

    * the deploy artifact: fused MPPI (also with 4 elites and the terminal
      cost), SMPPI and KMPPI at the flagship, MPPI on the legacy route,
      MPPI on ``fused_kernel_demo``'s learned model and ``MPPI_Batched`` in
      seed mode at N = 1,024, K = 16,384, each exported after three
      commands and loaded in a fresh process (``SERVE_CHILD``) that
      replays DEPLOY_COMMANDS commands on the live controller's states: the
      actions bit for bit the live controller's, the launch counters read
      in the child; the artifact's command median against the live one;
    * a checkpoint of fused MPPI with 4 elites after CKPT_COMMANDS
      commands, restored in the fresh process into a controller of
      another seed: its next commands, eagerly and in ``run_mppi_jit``'s
      graph loop, bit for bit the original's;
    * ``utils/timer.benchmark_command`` against this script's CUDA-event
      median of the same commands;
    * the live route through the operators against direct launches: the
      fused flagship command median and ``run_mppi_jit``'s step, in turns.
    """
    from pytorch_mppi_tpu_torch import (
        KMPPI,
        MPPI,
        SMPPI,
        MPPI_Batched,
        RBFKernel,
        quadratic_terminal,
        run_mppi_jit,
    )
    from pytorch_mppi_tpu_torch.examples import fused_kernel_demo as FKD
    from pytorch_mppi_tpu_torch.models import pendulum_dynamics
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import library
    from pytorch_mppi_tpu_torch.utils import checkpoint, deploy, timer

    import numpy as np

    out_dir = Path(__file__).resolve().parent / "build" / "deploy"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"artifacts": {}}

    def reset_launches():
        torch.cuda.synchronize()
        for name in FS.launches:
            FS.launches[name] = 0

    def only(**counts):
        return {name: counts.get(name, 0) for name in FS.launches}

    def flagship(cls=MPPI, seed=42, **kw):
        return cls(lq.dynamics, lq.running_cost, nx=NX, noise_sigma=torch.eye(NU, device=dev),
                   num_samples=K, horizon=T, lambda_=1.0, seed=seed, device=dev, **kw)

    def lq_plant(x, a):
        return lq.dynamics(x, a)

    def pendulum_plant(x, a):
        return pendulum_dynamics(x[None], a[None])[0]

    def median_command_ms(ctrl, x, n=DEPLOY_TIMED, reset=False):
        """Median ms of ``command(x)`` between CUDA events, after a warm-up."""
        lat = []
        for i in range(DEPLOY_WARMUP + n):
            if reset:
                ctrl.reset()
                torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ctrl.command(x)
            end.record()
            if i >= DEPLOY_WARMUP:
                lat.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in lat)

    sigma_b = 0.5 * torch.eye(NX, device=dev)
    ub = torch.ones(NX, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    batch_x0 = torch.rand(BATCH_N, NX, generator=g, device=dev) * 4 - 4
    flag_x0 = torch.tensor([-3.0, -2.0], device=dev)
    paths = {  # name: (controller, plant, start, launches of one command)
        "mppi fused": (lambda: flagship(use_pallas=True), lq_plant, flag_x0, dict(mppi=1)),
        "mppi fused, 4 elites, terminal": (
            lambda: flagship(use_pallas=True, num_elites=ELITES, fused_artifacts=True,
                             terminal_final_cost=quadratic_terminal(goal, *TERMINAL_W)),
            lq_plant, flag_x0, dict(mppi=1)),
        "smppi fused": (lambda: flagship(SMPPI, use_pallas=True, w_action_seq_cost=1.0,
                                         delta_t=1.0, action_min=torch.tensor([-3.0, -3.0]),
                                         action_max=torch.tensor([3.0, 3.0])),
                        lq_plant, flag_x0, dict(smppi=1)),
        "kmppi fused": (lambda: flagship(KMPPI, use_pallas=True, num_support_pts=NSP,
                                         kernel=RBFKernel(2.0)), lq_plant, flag_x0,
                        dict(kmppi=1)),
        "mppi rollout": (lambda: flagship(use_pallas="rollout"), lq_plant, flag_x0,
                         dict(rollout=1, weighted_update=1)),
        "mlp mppi fused": (lambda: FKD.planner(mlp_params, True, device=dev), pendulum_plant,
                           torch.tensor([math.pi, 1.0], device=dev), dict(mppi=1)),
        f"batched seed N={BATCH_N}": (
            lambda: MPPI_Batched(lq.dynamics, lq.running_cost, nx=NX, noise_sigma=sigma_b,
                                 num_envs=BATCH_N, num_samples=BATCH_K, horizon=T, lambda_=1.0,
                                 u_min=-ub, u_max=ub, seed=0, use_pallas="kernel_rng",
                                 device=dev), lq_plant, batch_x0, dict(batched=2)),
    }
    jobs = {"artifacts": [], "warmup": DEPLOY_WARMUP, "timed": DEPLOY_TIMED, "device": str(dev)}
    live = {}
    for i, (name, (build, plant, x, per_command)) in enumerate(paths.items()):
        ctrl = build()
        check(ctrl._fns.fused, f"deploy [{name}] did not take a kernel route")
        for _ in range(3):
            x = plant(x, ctrl.command(x))
        path = out_dir / f"artifact{i}.npz"
        wall = time.perf_counter()
        deploy.export_solver(ctrl, str(path))
        export_s = time.perf_counter() - wall
        xs, acts = [], []
        reset_launches()
        for _ in range(DEPLOY_COMMANDS):
            xs.append(x)
            a = ctrl.command(x)
            acts.append(a)
            x = plant(x, a)
        torch.cuda.synchronize()
        expect = only(**{k: v * DEPLOY_COMMANDS for k, v in per_command.items()})
        check(FS.launches == expect, f"deploy [{name}] live launches {FS.launches}, expected "
              f"{expect}")
        np.save(out_dir / f"states{i}.npy", torch.stack(xs).cpu().numpy())
        live[name] = dict(actions=torch.stack(acts).cpu().numpy(), expect=expect,
                          median_ms=median_command_ms(ctrl, xs[-1]), export_s=export_s,
                          mbytes=path.stat().st_size / 2**20)
        jobs["artifacts"].append(dict(name=name, path=str(path),
                                      states=str(out_dir / f"states{i}.npy"),
                                      actions=str(out_dir / f"actions{i}.npy")))
        del ctrl
        torch.cuda.empty_cache()

    # the checkpoint: fused MPPI with 4 elites, saved after CKPT_COMMANDS
    # commands; the original continues eagerly, then from a snapshot of the
    # same state in run_mppi_jit's graph loop
    ctrl = flagship(use_pallas=True, num_elites=ELITES, fused_artifacts=True)
    x = flag_x0
    for _ in range(CKPT_COMMANDS):
        x = lq.dynamics(x, ctrl.command(x))
    ck_path = out_dir / "checkpoint.npz"
    checkpoint.save_controller(str(ck_path), ctrl)
    snap, x_s = checkpoint.snapshot(ctrl), x
    acts = []
    for _ in range(CKPT_COMMANDS):
        a = ctrl.command(x)
        acts.append(a)
        x = lq.dynamics(x, a)
    ck_eager = torch.stack(acts).cpu().numpy()
    checkpoint.restore(ctrl, snap)
    _, ck_graph, _ = run_mppi_jit(ctrl, lq.dynamics, x_s, CKPT_COMMANDS)
    ck_graph = ck_graph.cpu().numpy()
    check(np.array_equal(ck_eager, ck_graph), "checkpoint: the original's graph loop differs "
          "from its eager loop after the restore")
    jobs["checkpoint"] = dict(path=str(ck_path), actions=str(out_dir / "ck_actions.npz"),
                              B=lq.consts[:NX * NU].reshape(NX, NU).tolist(),
                              goal=goal.tolist(), K=K, T=T, seed=1234, elites=ELITES,
                              x=x_s.tolist(), commands=CKPT_COMMANDS)
    del ctrl
    torch.cuda.empty_cache()

    # the fresh process
    job_file, result_file = out_dir / "jobs.json", out_dir / "served.json"
    job_file.write_text(json.dumps(jobs))
    root = Path(__file__).resolve().parent
    wall = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(job_file), str(result_file)],
                           cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                           capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - wall
    check(child.returncode == 0 and "SERVED OK" in child.stdout,
          f"the serving process failed: {child.stdout[-3000:]} {child.stderr[-3000:]}")
    served = json.loads(result_file.read_text())
    print(f"# deploy: the fresh process loaded {len(paths)} artifacts and the checkpoint in "
          f"{child_s:.1f} s")
    for i, (name, row) in enumerate(live.items()):
        got = np.load(out_dir / f"actions{i}.npy")
        child_row = served["artifacts"][name]
        same = np.array_equal(got, row["actions"])
        print(f"# deploy [{name}] ({child_row['route']} route): {DEPLOY_COMMANDS} commands in "
              f"the fresh process bit for bit the live controller's: {same} | launches "
              f"{child_row['launches']} | command median artifact {child_row['median_ms']:.4f} ms "
              f"against live {row['median_ms']:.4f} ms ({child_row['median_ms'] / row['median_ms']:.3f}x) "
              f"| export {row['export_s']:.2f} s, {row['mbytes']:.3f} MiB")
        check(same, f"deploy [{name}]: the artifact's actions differ from the live controller's")
        check(child_row["launches"] == row["expect"],
              f"deploy [{name}]: the child launched {child_row['launches']}, expected "
              f"{row['expect']}")
        report["artifacts"][name] = dict(child_row, live_median_ms=row["median_ms"],
                                         export_s=row["export_s"], mbytes=row["mbytes"])
    ck = np.load(jobs["checkpoint"]["actions"])
    ck_report = served["checkpoint"]
    same_eager, same_graph = np.array_equal(ck["eager"], ck_eager), np.array_equal(ck["graph"],
                                                                                    ck_graph)
    print(f"# checkpoint: fused MPPI with {ELITES} elites after {CKPT_COMMANDS} commands, "
          f"restored in the fresh process into a controller of seed 1234: the next "
          f"{CKPT_COMMANDS} commands bit for bit the original's, eager {same_eager}, graph loop "
          f"{same_graph} | launches eager {ck_report['eager_launches']['mppi']}, graph loop "
          f"{ck_report['graph_launches']['mppi']}")
    check(same_eager and same_graph, "checkpoint: the restored controller did not continue bit "
          "for bit")
    check(ck_report["eager_launches"] == only(mppi=CKPT_COMMANDS)
          and ck_report["graph_launches"] == only(mppi=CKPT_COMMANDS),
          f"checkpoint: launches {ck_report}")
    report["checkpoint"] = dict(ck_report, eager_same=same_eager, graph_same=same_graph)

    # the timer against this script's CUDA-event median, same protocol
    ctrl = flagship(use_pallas=True)
    stats = timer.benchmark_command(ctrl, flag_x0, num_warmup=DEPLOY_WARMUP,
                                    num_iters=DEPLOY_TIMED)
    own = median_command_ms(ctrl, flag_x0, reset=True)
    ratio = stats["median_s"] * 1e3 / own
    print(f"# timer.benchmark_command [mppi fused]: median {stats['median_s'] * 1e3:.4f} ms (host "
          f"clock, synchronised) against this script's CUDA-event median {own:.4f} ms: {ratio:.3f}x")
    check(1 / 3 <= ratio <= 3, f"timer.benchmark_command disagrees with the CUDA events: {ratio}")
    report["timer"] = dict(benchmark_median_ms=stats["median_s"] * 1e3, events_median_ms=own)
    del ctrl

    # the live route: direct launches against launches through the
    # operators, in turns, at the flagship (commands and the graph loop)
    turns = {False: [], True: []}
    for through_op in (False, True, True, False):
        with library.exporting() if through_op else contextlib.nullcontext():
            ctrl = flagship(use_pallas=True)
            cmd_ms = median_command_ms(ctrl, flag_x0, n=COMMANDS)
            ctrl = flagship(use_pallas=True)
            run_mppi_jit(ctrl, lq.dynamics, flag_x0, COMMANDS)  # captures
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_mppi_jit(ctrl, lq.dynamics, flag_x0, COMMANDS)
            end.record()
            torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / COMMANDS
        turns[through_op].append(dict(command_ms=cmd_ms, graph_step_ms=step_ms))
        route = "through the operators" if through_op else "direct launch"
        print(f"# live route [mppi fused] {route}: command median {cmd_ms:.4f} ms over "
              f"{COMMANDS} commands | run_mppi_jit graph step {step_ms:.4f} ms (mean over "
              f"{COMMANDS} steps)")
        del ctrl
    med = {k: {m: statistics.median(t[m] for t in v) for m in ("command_ms", "graph_step_ms")}
           for k, v in turns.items()}
    cost = med[True]["command_ms"] - med[False]["command_ms"]
    print(f"# live route: the operators' dispatch costs {cost:.4f} ms a command, "
          f"{cost / med[False]['command_ms']:.3f} of the direct command median "
          f"{med[False]['command_ms']:.4f} ms (limit 0.10); graph step through the operators "
          f"{med[True]['graph_step_ms']:.4f} ms against direct {med[False]['graph_step_ms']:.4f} ms"
          f" | the live path launches directly")
    report["live_route"] = dict(turns=turns, median=med)
    return report


def merge_shards(parts):
    """The per-shard (delta, m, s) merged by the rule of
    ``ops/solve._merge_stats`` (m_g = max m, s_g = sum s e^(m - m_g),
    delta_g = sum delta e^(m - m_g)), here in one process."""
    m = torch.stack([p[1] for p in parts])
    m_g = m.max()
    corr = torch.exp(m - m_g)
    s = (torch.stack([p[2] for p in parts]) * corr).sum()
    delta = (torch.stack([p[0] for p in parts]) * corr[:, None]).sum(0)
    return delta, m_g, s


def shard_operands(variant, dev, K_, nsp):
    """Kernel A's operands at the flagship after the noise source: x0T, then
    the variant's (bounds of +-1 straddle 0, so the null row is all zero)."""
    from pytorch_mppi_tpu_torch import RBFKernel
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    g = torch.Generator(device=dev).manual_seed(14)
    D = T * NU
    R = nsp * NU if variant == "kmppi" else D
    U2 = torch.randn(D, generator=g, device=dev) * 0.3
    full = lambda v, n=D: torch.full((n,), v, device=dev)  # noqa: E731
    lam, a_flat = torch.tensor(1.0, device=dev), (U2 * 0.7).contiguous()
    x0T = torch.tensor([-3.0, -2.0], device=dev)[:, None].expand(NX, K_)
    if variant == "mppi":
        return x0T, (U2, full(1.0), full(0.0), full(-1.0), full(1.0), a_flat, lam)
    if variant == "smppi":
        as2 = torch.randn(D, generator=g, device=dev) * 0.2
        return x0T, (U2, as2, full(1.0), full(0.0), full(-2.0), full(2.0), full(-1.0),
                     full(1.0), a_flat, lam, torch.tensor(1.0, device=dev),
                     torch.tensor(0.5, device=dev))
    th = torch.randn(R, generator=g, device=dev) * 0.2
    interp, _ = interpolation_operators(RBFKernel(2.0), T, nsp, torch.float32, device=dev)
    Wt = torch.kron(interp, torch.eye(NU, device=dev)).contiguous()
    return x0T, (U2, th, full(1.0, R), full(0.0, R), full(-1.0, R), full(1.0, R), full(-1.0),
                 full(1.0), a_flat, Wt, lam)


def shard_kernels(dev, lq):
    """Phase 9, part 1: kernel A split into n = 2, 4, 8 per-shard launches in
    one process (each with its null gate and its shard of the global
    samples), merged by the documented rule, against the unsharded launch
    on the same bits and key (JAX's tolerances, tests/test_pallas_transposed.py:
    630-642) and against the plain version; one all-zero column, column 0,
    and none with every gate 0; the batched pair split over two halves of
    N = 1,024 plants against the whole, bit for bit; the gate's cost and the
    split's on the card's timeline (CUDA graphs of 20 calls)."""
    import dataclasses

    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    factories = {"mppi": FS.make_transposed_fused_solve,
                 "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}
    report = {"errors": {}, "ms": {}}
    for variant in FS.VARIANTS:
        nsp = NSP if variant == "kmppi" else 0
        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True, sample_null_action=True,
                         fused_artifacts=True, num_support_pts=nsp)
        factory = factories[variant]
        whole = factory(cfg, lq, emit_perturbed=True)
        gated = factory(cfg, lq, emit_perturbed=True, null_dynamic_gate=True)
        x0T, args = shard_operands(variant, dev, K, nsp)
        R = nsp * NU if variant == "kmppi" else T * NU
        bits = torch.randint(-2**31, 2**31 - 1, (R, whole.bits_cols), dtype=torch.int32,
                             device=dev)
        for mode, lead in (("bits", bits), ("seed", (0x2014, 0x5EED))):
            d1, m1, s1, c1, p1 = whole(lead, x0T, *args)
            dp, mp, sp, cp, pp = whole.plain(lead, x0T, *args)
            for n in SHARDS:
                Kl = K // n
                shards = [factory(dataclasses.replace(cfg, K=Kl), lq, emit_perturbed=True,
                                  null_dynamic_gate=True, shard=(r, n), tile_k=whole.tile_k)
                          for r in range(n)]
                gates = [torch.tensor([int(r == 0)], dtype=torch.int32, device=dev)
                         for r in range(n)]

                def launch_all(gates=gates, shards=shards, lead=lead):
                    outs = [s_(lead, x0T[:, r * Kl:(r + 1) * Kl], *args, gates[r])
                            for r, s_ in enumerate(shards)]
                    return outs, merge_shards(outs)

                outs, (d, m, s) = launch_all()
                cost = torch.cat([o[3] for o in outs])
                pert = torch.cat([o[4] for o in outs], dim=1)
                c_err = float((cost - c1).abs().max())
                u_err = float((d / s - d1 / s1).abs().max())
                check(bool(((cost - c1).abs() <= 1e-6 + 1e-6 * c1.abs()).all()),
                      f"{variant} {mode} {n} shards: costs differ from the whole launch by "
                      f"{c_err}")
                check(abs(float(m - m1)) <= 1e-7 * abs(float(m1)) + 1e-7
                      and abs(float(s / s1) - 1) <= 1e-5
                      and bool(((d / s - d1 / s1).abs() <= 1e-7 + 1e-4 * (d1 / s1).abs()).all()),
                      f"{variant} {mode} {n} shards: the merge differs from the whole launch "
                      f"(update error {u_err})")
                check(bool(((pert - p1).abs() <= 1e-7 + 1e-6 * p1.abs()).all()),
                      f"{variant} {mode} {n} shards: the perturbed actions differ")
                zero = (pert == 0).all(dim=0)
                check(int(zero.sum()) == 1 and bool(zero[0]),
                      f"{variant} {mode} {n} shards: {int(zero.sum())} all-zero columns, "
                      f"column 0 {bool(zero[0])}; the gate must null global sample 0 alone")
                ok, pc_err, pu_err, _ = agree(cost, cp, d / s, dp / sp, 1.0, m, mp, s, sp)
                check(ok, f"{variant} {mode} {n} shards against the plain version: cost "
                          f"{pc_err}, update {pu_err}")
                report["errors"][variant, mode, n] = dict(
                    cost=c_err, update=u_err, cost_exact=bool(torch.equal(cost, c1)),
                    pert_exact=bool(torch.equal(pert, p1)), plain_cost=pc_err,
                    plain_update=pu_err)
                if n == SHARDS[0]:
                    off = [torch.zeros(1, dtype=torch.int32, device=dev)] * n
                    p_off = torch.cat([o[4] for o in launch_all(gates=off)[0]], dim=1)
                    check(not bool((p_off == 0).all(dim=0).any()),
                          f"{variant} {mode}: gate 0 on every shard left an all-zero column")
                if mode == "seed" and n == SHARDS[-1]:
                    report["ms"][variant, "shards"] = graph_ms(launch_all, 20)
            if mode == "seed":
                on = torch.ones(1, dtype=torch.int32, device=dev)
                report["ms"][variant, "whole"] = graph_ms(lambda: whole(lead, x0T, *args), 20)
                report["ms"][variant, "gate"] = graph_ms(
                    lambda: gated(lead, x0T, *args, on), 20)
                check(torch.equal(gated(lead, x0T, *args, on)[3], c1),
                      f"{variant}: the gated launch with gate 1 differs from the static null row")
        e = report["errors"]
        print(f"# shards [{variant}] n = {SHARDS}: cost errors "
              f"{[e[variant, md, n]['cost'] for md in ('bits', 'seed') for n in SHARDS]}, "
              f"update errors {[e[variant, md, n]['update'] for md in ('bits', 'seed') for n in SHARDS]} | "
              f"device ms: whole {report['ms'][variant, 'whole']:.6f}, gate set "
              f"{report['ms'][variant, 'gate']:.6f}, {SHARDS[-1]} shards + merge "
              f"{report['ms'][variant, 'shards']:.6f}")
    # the batched pair over two halves of the plants, operand and seed mode
    cfg_b = MPPIConfig(nx=NX, nu=NU, K=BATCH_K, T=T, diag_sigma=True)
    g = torch.Generator(device=dev).manual_seed(15)
    D = T * NU
    x0T = torch.rand(NX, BATCH_N, generator=g, device=dev) * 4 - 2
    U2T = torch.randn(D, BATCH_N, generator=g, device=dev) * 0.3
    aT = U2T * 0.7
    ops_ = (torch.full((D,), 0.7, device=dev), torch.zeros(D, device=dev),
            torch.full((D,), -1.0, device=dev), torch.full((D,), 1.0, device=dev))
    lam = torch.tensor(1.0, device=dev)
    half = BATCH_N // 2
    for mode in ("operand", "seed"):
        operand = mode == "operand"
        lead = (torch.randn(D, BATCH_K, generator=g, device=dev) * 0.7 if operand
                else (0x2014, 0x0B))
        whole = FS.make_transposed_batched_solve(cfg_b, BATCH_N, lq, noise_operand=operand)
        part = FS.make_transposed_batched_solve(cfg_b, half, lq, noise_operand=operand)
        want = whole(lead, x0T, U2T, ops_[0], ops_[1], ops_[2], ops_[3], aT, lam)
        got = [part(lead, x0T[:, sl], U2T[:, sl], *ops_, aT[:, sl], lam)
               for sl in (slice(0, half), slice(half, BATCH_N))]
        same = (torch.equal(torch.cat([o[0] for o in got], 1), want[0])
                and torch.equal(torch.cat([o[1] for o in got], 1), want[1])
                and torch.equal(torch.cat([o[2] for o in got], 0), want[2]))
        check(same, f"batched {mode}: two halves of {BATCH_N} plants differ from the whole")
        report["batched", mode] = dict(group_whole=whole.plant_group, group_half=part.plant_group)
    print(f"# shards [batched] N = {BATCH_N}, K = {BATCH_K} over two halves: bit for bit in "
          f"operand and seed mode (plant groups {report['batched', 'operand']})")
    return report


def shard_child(rank, init_file, out_path, root, device):
    """One rank of phase 9's 2-rank Gloo world, both ranks on the one card:
    the K-sharded flagship commands (fused MPPI, SMPPI and KMPPI, plain
    MPPI) and the env-sharded ``MPPI_Batched`` at N = 1,024, each beside the
    unsharded controller of the same seed, which takes each command from the
    sharded controller's plant state and its own state (nominal sequence,
    counter) before that command; writes its report as JSON to
    ``out_path``."""
    sys.path.insert(0, root)
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel, linear_quadratic
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.parallel import (all_gather_cat, initialize_multihost,
                                                 make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    # Gloo (the CPU's backend) carries the card's tensors: NCCL refuses two
    # ranks on one card
    initialize_multihost(f"file://{init_file}", 2, rank, device="cpu")
    k_mesh = make_mesh((2,), ("k",), device=device)
    d_mesh = make_mesh((2,), ("data",), device=device)
    group = k_mesh.get_group("k")
    lq = linear_quadratic(torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev),
                          torch.tensor([2.0, 2.0], device=dev))
    goal = torch.tensor([2.0, 2.0], device=dev)
    report = {"routes": {}}

    def timed(ctrl, states, xs):
        """``ctrl``'s commands from the sharded controller's state before
        each of its commands (one command's difference, not the loop's)."""
        acts, lat = [], []
        for st, x in zip(states, xs):
            ctrl._state = st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acts.append(ctrl.command(x))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(acts), statistics.median(lat)

    def reset():
        torch.cuda.synchronize()
        for name in FS.launches:
            FS.launches[name] = 0

    routes = (("mppi fused", MPPI, {}, True),
              ("smppi fused", SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                                          action_min=torch.tensor([-3.0, -3.0]),
                                          action_max=torch.tensor([3.0, 3.0])), True),
              ("kmppi fused", KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0)), True),
              ("mppi plain", MPPI, {}, False))
    for name, cls, extra, use_pallas in routes:
        make = lambda mesh: cls(lq.dynamics, lq.running_cost, nx=NX,  # noqa: E731
                                noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                                horizon=T, lambda_=1.0, seed=42, use_pallas=use_pallas,
                                device=dev, mesh=mesh, **extra)
        sh, un = make(k_mesh), make(None)
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(WARMUP):
            un.command(x)
            x = lq.dynamics(x[None], sh.command(x)[None])[0]
        reset()
        xs, states, acts, lat, dists = [], [], [], [], []
        for _ in range(SHARD_COMMANDS):
            xs.append(x)
            states.append(sh._state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = sh.command(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            acts.append(a)
            x = lq.dynamics(x[None], a[None])[0]
            dists.append(float(torch.linalg.norm(x - goal)))
        launched = dict(FS.launches)
        acts = torch.stack(acts)
        reset()
        acts_un, un_ms = timed(un, states, xs)
        both = all_gather_cat(acts[None], 0, group)
        report["routes"][name] = dict(
            launches=launched, twin_launches=dict(FS.launches), fused=sh._fns.fused,
            median_ms=statistics.median(lat), unsharded_median_ms=un_ms,
            same_across_ranks=bool(torch.equal(both[0], both[1])),
            max_diff_unsharded=float((acts - acts_un).abs().max()),
            exact_unsharded=bool(torch.equal(acts, acts_un)),
            min_dist=min(dists), final_dist=dists[-1], cost_total_shape=list(sh.cost_total.shape))
    # MPPI_Batched with the plants over "data": operand mode, N = 1,024
    g = torch.Generator(device=dev).manual_seed(9)
    make = lambda mesh: MPPI_Batched(lq.dynamics, lq.running_cost, nx=NX,  # noqa: E731
                                     noise_sigma=0.5 * torch.eye(NU, device=dev),
                                     num_envs=BATCH_N, num_samples=BATCH_K, horizon=T,
                                     lambda_=1.0, u_min=-torch.ones(NU), u_max=torch.ones(NU),
                                     seed=42, use_pallas=True, device=dev, mesh=mesh)
    sh, un = make(d_mesh), make(None)
    x = torch.rand(BATCH_N, NX, generator=g, device=dev) * 6 - 3
    sh.command(x)
    un.command(x)
    reset()
    xs, states, acts, lat = [], [], [], []
    for _ in range(SHARD_BATCH_COMMANDS):
        xs.append(x)
        states.append(sh._state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = sh.command(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        acts.append(a)
        x = lq.dynamics(x, a)
    launched = dict(FS.launches)
    acts = torch.stack(acts)
    reset()
    acts_un, un_ms = timed(un, states, xs)
    both = all_gather_cat(acts[None], 0, group)
    report["routes"]["batched operand"] = dict(
        launches=launched, twin_launches=dict(FS.launches), fused=sh._fns.fused,
        median_ms=statistics.median(lat), unsharded_median_ms=un_ms,
        same_across_ranks=bool(torch.equal(both[0], both[1])),
        max_diff_unsharded=float((acts - acts_un).abs().max()),
        exact_unsharded=bool(torch.equal(acts, acts_un)),
        cost_total_shape=list(sh.cost_total.shape))
    dist.destroy_process_group()
    report["ok"] = True
    with open(out_path, "w") as f:
        json.dump(report, f)


def shard_world(dev, out_dir):
    """Phase 9, part 2: the 2-rank Gloo world on the one card (``spawn``),
    each rank's report read back; a child that fails, hangs or writes no
    report fails the phase."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = out_dir / "shard_world.init"
    init.unlink(missing_ok=True)
    outs = [out_dir / f"shard_world_rank{r}.json" for r in range(2)]
    for o in outs:
        o.unlink(missing_ok=True)
    procs = [ctx.Process(target=shard_child, args=(r, str(init), str(outs[r]),
                                                    str(Path(__file__).resolve().parent),
                                                    str(dev)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SHARD_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    check(not hung, f"the 2-rank world hung past {SHARD_TIMEOUT} s")
    check(all(p.exitcode == 0 for p in procs),
          f"a rank of the 2-rank world failed: exit codes {[p.exitcode for p in procs]}")
    check(all(o.is_file() for o in outs), "a rank of the 2-rank world wrote no report")
    reports = [json.loads(o.read_text()) for o in outs]
    check(all(r.get("ok") for r in reports), "a rank of the 2-rank world did not finish")
    for name in reports[0]["routes"]:
        for rank, rep in enumerate(reports):
            r = rep["routes"][name]
            fused = not name.endswith("plain")
            variant = name.split()[0]
            n = SHARD_BATCH_COMMANDS if variant == "batched" else SHARD_COMMANDS
            want = {k: 0 for k in r["launches"]}
            if fused:
                want[variant] = 2 * n if variant == "batched" else n
            check(r["fused"] == fused and r["launches"] == want,
                  f"[{name}] rank {rank}: launched {r['launches']} in {n} commands, "
                  f"expected {want}")
            check(r["same_across_ranks"], f"[{name}]: the ranks' actions differ")
            check(r["max_diff_unsharded"] <= SHARD_ACTION_ATOL,
                  f"[{name}] rank {rank}: {r['max_diff_unsharded']} from the unsharded "
                  f"controller's actions")
            if "min_dist" in r:
                check(r["min_dist"] < 1.0 and r["final_dist"] < 10.0,
                      f"[{name}] failed bench.py's sanity check")
        r = reports[0]["routes"][name]
        print(f"# shards [{name}] 2-rank Gloo world on one card: median {r['median_ms']:.4f} ms "
              f"against {r['unsharded_median_ms']:.4f} ms unsharded (host clock) | launches "
              f"rank 0 {r['launches']} | max diff to unsharded {r['max_diff_unsharded']:.3g} "
              f"(exact {r['exact_unsharded']}) | cost_total {r['cost_total_shape']}")
    return reports


def shard_nccl(dev, lq, out_dir):
    """Phase 9, part 3: a 1-rank NCCL world in this process: the sharded
    fused MPPI command (gate 1, offset 0) equals the unsharded one bit for
    bit; both medians (CUDA events)."""
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch import MPPI
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    init = out_dir / "shard_nccl.init"
    init.unlink(missing_ok=True)
    initialize_multihost(f"file://{init}", 1, 0, device=str(dev))
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1,), ("k",), device=str(dev))
        make = lambda mesh: MPPI(lq.dynamics, lq.running_cost, nx=NX,  # noqa: E731
                                 noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                                 horizon=T, lambda_=1.0, seed=42, use_pallas=True, device=dev,
                                 mesh=mesh)
        out = {}
        for tag, ctrl in (("sharded", make(mesh)), ("unsharded", make(None))):
            x = torch.tensor([-3.0, -2.0], device=dev)
            for _ in range(WARMUP):
                ctrl.command(x)
            torch.cuda.synchronize()
            for name in FS.launches:
                FS.launches[name] = 0
            acts, lat = [], []
            for _ in range(SHARD_COMMANDS):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                act = ctrl.command(x)
                b.record()
                acts.append(act)
                lat.append((a, b))
                x = lq.dynamics(x[None], act[None])[0]
            torch.cuda.synchronize()
            out[tag] = dict(acts=torch.stack(acts), launches=dict(FS.launches),
                            median_ms=statistics.median(s.elapsed_time(e) for s, e in lat))
    finally:
        dist.destroy_process_group()
    check(backend == "nccl" or dev.type == "cpu", f"the 1-rank world took {backend}")
    check(torch.equal(out["sharded"]["acts"], out["unsharded"]["acts"]),
          "the 1-rank NCCL world's sharded commands differ from the unsharded ones")
    want = {k: (SHARD_COMMANDS if k == "mppi" else 0) for k in FS.launches}
    check(out["sharded"]["launches"] == want,
          f"the 1-rank world launched {out['sharded']['launches']}, expected {want}")
    print(f"# shards [mppi fused] 1-rank {backend} world: bit for bit the unsharded commands | "
          f"median {out['sharded']['median_ms']:.4f} ms against "
          f"{out['unsharded']['median_ms']:.4f} ms unsharded (CUDA events) | launches "
          f"{out['sharded']['launches']['mppi']}")
    return {k: dict(median_ms=v["median_ms"], launches=v["launches"]) for k, v in out.items()}


def sharding(dev, lq):
    """Phase 9: sharding (``parallel``), its three parts."""
    out_dir = Path(__file__).resolve().parent / "build" / "sharding"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    report = {"kernels": shard_kernels(dev, lq)}
    report["world"] = shard_world(dev, out_dir)
    report["nccl"] = shard_nccl(dev, lq, out_dir)
    report["seconds"] = time.perf_counter() - t0
    print(f"# phase 9 took {report['seconds']:.1f} s")
    return report


def tuning(dev):
    """Phase 10: the tuners (``autotune``, ``autotune_global``,
    ``autotune_qd``) at benchmarks/tuning.py's sizes, on a fused toy2d
    ``MPPI`` (``use_pallas=True``, no terminal cost, so that its commands
    launch kernel A).

    a. one generation of TUNE_POP candidates through ``PopulationEvaluator``
       (one ``torch.func.vmap`` of the plain body, no kernel launched)
       against a loop over the candidates of R ``step_no_shift`` calls in
       each of M streams on the same seeds, within TUNE_RTOL; the seconds
       a generation of each (median of 3, host clock after a synchronise)
       and the vmapped generation's peak device memory;
    b. ``CMAESOpt``, ``GlobalSearchOpt`` with the horizon in RandInt(5, 30)
       (the horizon groups) and ``CMAMEOpt`` on the population path,
       TUNE_STEPS steps each: a finite best, CMA-ES's best no worse than its
       first result, a non-empty archive, no kernel launched;
    c. ``CMAESOpt`` on the sequential path, whose evaluation runs M x R
       no-shift commands of the fused controller: exactly (lambda + 1) M R
       launches of kernel A a step, the + 1 the re-evaluation of the best;
    d. ``GradientOpt`` on JAX's TestGradientOpt problem: the best cost below
       GRAD_RATIO of the first; the ms an Adam step.
    """
    import numpy as np

    from pytorch_mppi_tpu_torch import MPPI, autotune, autotune_global, autotune_qd
    from pytorch_mppi_tpu_torch.models import Toy2DEnvironment
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    t0 = time.perf_counter()
    report = {}
    env = Toy2DEnvironment(terminal_scale=10.0, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def toy_mppi():
        return MPPI(env.dynamics, env.running_cost, 2,
                    noise_sigma=torch.diag(torch.tensor([5.0, 5.0], **f32)),
                    num_samples=TUNE_K, horizon=TUNE_T, u_max=torch.tensor([2.0, 2.0], **f32),
                    lambda_=1.0, seed=1, use_pallas=True, device=dev)

    def launched():
        torch.cuda.synchronize()
        return {k: v for k, v in FS.launches.items() if v}

    def reset():
        torch.cuda.synchronize()
        for name in FS.launches:
            FS.launches[name] = 0

    def clock(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - start, out

    # -- a. the vmapped generation against the loop ----------------------------
    mppi = toy_mppi()
    check(mppi._fns.fused, "phase 10: the fused toy2d MPPI does not take kernel A")
    rng = np.random.RandomState(10)
    cands = [{"sigma": torch.tensor(np.exp(rng.uniform(np.log(0.5), np.log(10.0), 2)), **f32),
              "lambda": float(np.exp(rng.uniform(np.log(0.1), np.log(5.0)))),
              "mu": torch.tensor(rng.uniform(-0.2, 0.2, 2), **f32)} for _ in range(TUNE_POP)]
    ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=TUNE_R,
                                      num_trajectories=TUNE_M, seed=3)
    seeds = autotune.PopulationEvaluator(mppi, env.start, seed=3)._stream_seeds(
        TUNE_POP * TUNE_M)
    fns = ev._planning_fns()
    own_fns = mppi._fns
    score = ev._default_cost_fn()
    reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    vm_s, res = clock(lambda: ev(cands))
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    check(not launched(), f"phase 10a: the population evaluation launched {launched()}")
    check(mppi._fns is own_fns and mppi.use_pallas is True,
          "phase 10a: the evaluator changed the controller's route")

    def loop(seeds_):
        costs = []
        for p, cand in enumerate(cands):
            params = mppi._params._replace(
                noise_sigma=torch.diag(cand["sigma"]), noise_mu=cand["mu"],
                lambda_=torch.tensor(cand["lambda"], **f32))
            per = []
            for m in range(TUNE_M):
                state = mppi._state._replace(seed=seeds_[p * TUNE_M + m])
                for _ in range(TUNE_R):
                    state, _, _ = fns.step_no_shift(params, state, env.start)
                rollout = fns.get_rollouts(params, env.start, state.U)[0]
                per.append(score(rollout, state.U))
            costs.append(torch.stack(per).mean())
        return torch.stack(costs)

    loop_s, loop_costs = clock(lambda: loop(seeds))
    check(not launched(), f"phase 10a: the loop launched {launched()}")
    rel = float(((res.costs - loop_costs).abs() / loop_costs.abs()).max())
    finite = bool(torch.isfinite(res.costs).all()) and tuple(res.rollouts.shape) == (
        TUNE_POP, TUNE_T, 2)
    check(finite and rel <= TUNE_RTOL,
          f"phase 10a: the vmapped generation against the loop: {rel:.3g} relative "
          f"(limit {TUNE_RTOL}), finite and shaped {finite}")
    # the loop (800 plain commands, 10-14 s) is timed once, to keep the run
    # inside its time with phase 11; the vmapped generation three times
    vm_times, loop_times = [vm_s], [loop_s]
    for _ in range(2):
        vm_times.append(clock(lambda: ev(cands))[0])
    report["generation"] = dict(vmapped_s=statistics.median(vm_times),
                                loop_s=statistics.median(loop_times), max_rel=rel,
                                peak_mib=peak_mib, vmapped_all_s=vm_times,
                                loop_all_s=loop_times)
    print(f"# tuning generation ({TUNE_POP} candidates x {TUNE_M} streams x {TUNE_R} "
          f"refinements, K={TUNE_K} T={TUNE_T}): vmapped {report['generation']['vmapped_s']:.4f}"
          f" s (median of 3), loop {report['generation']['loop_s']:.4f} s (once; "
          f"{vm_times} / {loop_times}), max relative difference {rel:.3g}, "
          f"peak {peak_mib:.1f} MiB above what was held before it, 0 launches")

    # -- b. the three optimisers on the population path ----------------------
    G = autotune_global
    optimizers = {
        "cmaes": (lambda m: [G.SigmaGlobalParameter(m), G.LambdaGlobalParameter(m)],
                  lambda: autotune.CMAESOpt(population=TUNE_POP, sigma=0.5, seed=0)),
        "global_horizon": (lambda m: [G.SigmaGlobalParameter(m), G.HorizonGlobalParameter(
            m, search_space=G.RandInt(5, 30)), G.LambdaGlobalParameter(m)],
                           lambda: G.GlobalSearchOpt(batch_size=TUNE_POP, seed=0)),
        "cmame": (lambda m: [G.SigmaGlobalParameter(m), G.LambdaGlobalParameter(m)],
                  lambda: autotune_qd.CMAMEOpt(population=TUNE_POP, sigma=1.0, bins=10,
                                               seed=0)),
    }
    report["population"] = {}
    for name, (params, make_opt) in optimizers.items():
        mppi = toy_mppi()
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=TUNE_R,
                                          num_trajectories=TUNE_M)

        def must_not_run():
            fail(f"phase 10b: {name} called the sequential evaluate_fn")

        tuner = G.AutotuneGlobal(params(mppi), evaluate_fn=must_not_run, optimizer=make_opt(),
                                 population_evaluate_fn=ev)
        reset()
        times, costs = [], []
        for _ in range(TUNE_STEPS):
            secs, res = clock(tuner.optimize_step)
            times.append(secs)
            costs.append(autotune.mean_cost(res.costs))
        best = autotune.mean_cost(tuner.get_best_result().costs)
        check(not launched(), f"phase 10b: {name} launched {launched()}")
        check(math.isfinite(best), f"phase 10b: {name}'s best cost is {best}")
        if name == "cmaes":
            check(best <= costs[0], f"phase 10b: CMA-ES's best {best} above its first {costs[0]}")
        if name == "cmame":
            check(len(tuner.optim.archive) > 0, "phase 10b: CMA-ME's archive is empty")
        report["population"][name] = dict(step_s=statistics.median(times), all_s=times,
                                          costs=costs, best=best)
        print(f"# tuning {name} population path: {statistics.median(times):.4f} s a step "
              f"({times}), costs {costs}, best {best:.4f}"
              + (f", archive {len(tuner.optim.archive)}" if name == "cmame" else "")
              + f", horizon now {mppi.T}")

    # -- c. CMA-ES on the sequential path through kernel A ---------------------
    mppi = toy_mppi()
    nominal = mppi.U.clone()

    def evaluate():
        costs, rollouts = [], []
        for _ in range(TUNE_M):
            mppi.U = nominal
            for _ in range(TUNE_R):
                mppi.command(env.start, shift_nominal_trajectory=False)
            rollout = mppi.get_rollouts(env.start)[0]
            costs.append(env.running_cost(rollout, mppi.U).sum())
            rollouts.append(rollout)
        return autotune.EvaluationResult(torch.stack(costs), torch.stack(rollouts))

    tuner = autotune.Autotune([autotune.SigmaParameter(mppi), autotune.LambdaParameter(mppi)],
                              evaluate_fn=evaluate,
                              optimizer=autotune.CMAESOpt(population=TUNE_POP, sigma=0.5, seed=0))
    lam = tuner.optim.optim.lam
    want = {"mppi": (lam + 1) * TUNE_M * TUNE_R}
    times = []
    for i in range(TUNE_STEPS):
        reset()
        secs, res = clock(tuner.optimize_step)
        times.append(secs)
        check(launched() == want, f"phase 10c: step {i} launched {launched()}, expected {want} "
              f"((lambda + 1) M R with lambda = {lam})")
        check(bool(torch.isfinite(res.costs).all()), "phase 10c: a non-finite cost")
    report["sequential"] = dict(step_s=statistics.median(times), all_s=times, lam=lam,
                                launches_per_step=want["mppi"])
    pop_s = report["population"]["cmaes"]["step_s"]
    print(f"# tuning cmaes sequential path: {statistics.median(times):.4f} s a step ({times}), "
          f"{want['mppi']} kernel A launches a step (lambda = {lam}), "
          f"{statistics.median(times) / pop_s:.2f}x the population path's {pop_s:.4f} s")

    # -- d. GradientOpt ----------------------------------------------------------
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], **f32)
    goal = torch.tensor([2.0, 2.0], **f32)
    ctrl = MPPI(lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(dim=-1), 2,
                noise_sigma=torch.eye(2, **f32) * 0.05, num_samples=GRAD_K, horizon=GRAD_T,
                lambda_=20.0, seed=0, device=dev)
    ev = autotune.PopulationEvaluator(ctrl, torch.tensor([-3.0, -2.0], **f32),
                                      num_refinement_steps=GRAD_R, num_trajectories=GRAD_M,
                                      seed=1)
    tuner = autotune.Autotune([autotune.SigmaParameter(ctrl), autotune.LambdaParameter(ctrl)],
                              evaluate_fn=lambda: ev([{}]),
                              optimizer=autotune.GradientOpt(lr=0.2,
                                                             steps_per_iteration=GRAD_ADAM),
                              population_evaluate_fn=ev)
    c0 = autotune.mean_cost(ev([{}]).costs)
    times = []
    for _ in range(GRAD_STEPS):
        times.append(clock(tuner.optimize_step)[0])
    best = autotune.mean_cost(tuner.get_best_result().costs)
    check(best < GRAD_RATIO * c0, f"phase 10d: GradientOpt's best {best} not below "
          f"{GRAD_RATIO} x its first {c0}")
    adam_ms = [1e3 * s / GRAD_ADAM for s in times]
    report["gradient"] = dict(first=c0, best=best, adam_ms=statistics.median(adam_ms),
                              all_adam_ms=adam_ms)
    print(f"# tuning GradientOpt: first {c0:.4f}, best {best:.4f} ({best / c0:.4f} of it); "
          f"{statistics.median(adam_ms):.3f} ms an Adam step (an optimize_step over "
          f"{GRAD_ADAM}, its scoring included; {adam_ms})")
    report["seconds"] = time.perf_counter() - t0
    print(f"# phase 10 took {report['seconds']:.1f} s")
    print("# tuning " + json.dumps(report))
    return report

def generated_callables(dev):
    """Phase 11's user callables, untagged, so that no named device model
    applies: bench.py's flagship as plain lambdas, ``models/pendulum.py``'s
    functions wrapped, JAX's ``test_step_dependent`` plant, and a terminal
    cost that is not ``quadratic_terminal`` (its weights a closure)."""
    from pytorch_mppi_tpu_torch.models import pendulum_dynamics, pendulum_running_cost

    B = torch.tensor(GEN_B, device=dev)
    goal = torch.tensor(GEN_GOAL, device=dev)
    w = torch.tensor(GEN_TERM_W, device=dev)
    return dict(
        lq=(lambda s, u: s + u @ B.T, lambda s, u: ((goal - s) ** 2).sum(-1)),
        pendulum=(lambda s, u: pendulum_dynamics(s, u), lambda s, u: pendulum_running_cost(s, u)),
        step=(lambda s, u, t: s + u @ B.T * (1.0 + 0.01 * t),
              lambda s, u, t: ((goal - s) ** 2).sum(-1) * (1.0 + 0.005 * t)),
        terminal=lambda s, u: (w * (s - goal) ** 2).sum(-1) + 0.2 * (u ** 2).sum(-1))


def generated_builds(dev):
    """Trace phase 11's models and start each generated library's build (one
    ``nvcc`` a model and variant, in a thread), to run beside the named
    library's build.  Returns the plan: the callables, the traced models and
    ``builds``, label -> (thread, kernel, variant, result)."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    fns = generated_callables(dev)
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
    cfg_sd = dataclasses.replace(cfg, step_dependent_dynamics=True)
    models = dict(lq=BL.kernel_model(cfg, *fns["lq"]),
                  pendulum=BL.kernel_model(MPPIConfig(nx=2, nu=1, K=GEN_PEND_K, T=GEN_PEND_T),
                                           *fns["pendulum"]),
                  step=BL.kernel_model(cfg_sd, *fns["step"]),
                  terminal=BL.trace_terminal(cfg, fns["terminal"]))
    step = BL.generated_kernel(models["step"], None)
    plan = {"lq mppi": (BL.generated_kernel(models["lq"], None), FS.MPPI),
            "pendulum mppi": (BL.generated_kernel(models["pendulum"], None), FS.MPPI),
            "step mppi": (step, FS.MPPI), "step smppi": (step, FS.SMPPI),
            "step kmppi": (step, FS.KMPPI), "step rollout": (step, FS.ROLLOUT),
            "step batched": (step, FS.BATCHED),
            # phase 12's: scenario_batch's plant is the flagship lambdas' program,
            # so its batched library is this one (the same header)
            "lq batched": (BL.generated_kernel(models["lq"], None), FS.BATCHED),
            "terminal mppi": (BL.generated_kernel(models["lq"], models["terminal"]), FS.MPPI)}
    builds = {}
    for label, (kernel, variant) in plan.items():
        result = {}

        def run(kernel=kernel, variant=variant, result=result):
            start = time.perf_counter()
            try:
                kernel.library(variant)
            except BaseException as e:  # reported, with nvcc's output, after the join
                result["error"] = e
            result["wall_s"] = time.perf_counter() - start

        thread = threading.Thread(target=run, name=f"nvcc {label}")
        thread.start()
        builds[label] = (thread, kernel, variant, result)
    return dict(fns=fns, models=models, builds=builds)


def join_generated_builds(plan):
    """Wait for phase 11's builds; fail with nvcc's output on the first that
    failed; print each build's seconds."""
    secs = {}
    for label, (thread, kernel, variant, result) in plan["builds"].items():
        thread.join()
        if "error" in result:
            fail(f"generated library [{label}] did not build: {result['error']}")
        secs[label] = kernel.build_seconds.get(variant)
        print(f"# build generated [{label}]: {secs[label]} s of nvcc (None: already built), "
              f"{result['wall_s']:.1f} s wall from the script's build start")
    plan["build_s"] = secs
    return secs


def generated_models(dev, plan, lq_named):
    """Phase 11: the dynamics bridge on the card (see the module
    docstring).  Returns the report phase 7's kernel rows read."""
    from pytorch_mppi_tpu_torch import MPPI, KMPPI, SMPPI, MPPI_Batched, run_mppi, run_mppi_jit
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import PENDULUM_MODEL, PendulumEnv, angle_normalize
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators
    from pytorch_mppi_tpu_torch import RBFKernel

    fns, models = plan["fns"], plan["models"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    rows, loops = {}, {}

    def reset():
        for name in FS.launches:
            FS.launches[name] = 0

    def only(**counts):
        return {name: counts.get(name, 0) for name in FS.launches}

    def full(n, v):
        return torch.full((n,), float(v), device=dev)

    def operands(variant, cfg, op_diag=0.8, bound=1.0):
        """One call's device operands after the noise source."""
        nu, T_, K_ = cfg.nu, cfg.T, cfg.K
        D = T_ * nu
        R = cfg.num_support_pts * nu if variant == "kmppi" else D
        x0T = torch.tensor([-3.0, -2.0], device=dev)[:cfg.nx, None].expand(cfg.nx, K_)
        U2 = torch.randn(D, generator=gen, device=dev) * 0.3
        a_flat = (U2 * 0.7).contiguous()
        lam = torch.tensor(1.0, device=dev)
        if variant == "mppi":
            return (x0T, U2, full(R, op_diag), full(R, 0.05), full(D, -bound), full(D, bound),
                    a_flat, lam)
        if variant == "smppi":
            as2 = torch.randn(D, generator=gen, device=dev) * 0.2
            return (x0T, U2, as2, full(D, op_diag), full(D, 0.0), full(D, -bound),
                    full(D, bound), full(D, -2.0), full(D, 2.0), a_flat, lam,
                    torch.tensor(2.0, device=dev), torch.tensor(0.5, device=dev))
        th = torch.randn(R, generator=gen, device=dev) * 0.2
        interp, _ = interpolation_operators(RBFKernel(2.0), T_, cfg.num_support_pts,
                                            torch.float32, device=dev)
        Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
        return (x0T, U2, th, full(R, op_diag), full(R, 0.0), full(R, -bound), full(R, bound),
                full(D, -1.5), full(D, 1.5), a_flat, Wt, lam)

    def bits_for(solve, R, K_pad):
        return torch.randint(-2**31, 2**31 - 1, (R, K_pad), generator=gen, device=dev,
                             dtype=torch.int32)

    def held(label, solve, lead, ops, variant, cfg, model, terminal=None, plants=1):
        """The kernel against its plain version on the same inputs: agree,
        the update's error, both times and the bound."""
        out_k = solve(lead, *ops)
        out_p = solve.plain(lead, *ops)
        torch.cuda.synchronize()
        if plants > 1:
            (dk, msk, ck), (dp, msp, cp) = out_k, out_p
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0],
                                            msp[0], msk[1], msp[1])
        else:
            ok, c_err, u_err, w_tol = agree(out_k[3], out_p[3], out_k[0] / out_k[2],
                                            out_p[0] / out_p[2], 1.0, out_k[1], out_p[1],
                                            out_k[2], out_p[2])
        print(f"# generated [{label}] kernel vs plain: cost err {c_err:.3g}, update err "
              f"{u_err:.3g} (tol {w_tol:.3g})")
        check(ok, f"generated [{label}] disagrees with its plain version: cost {c_err}, "
              f"update {u_err}")
        ms = graph_ms(lambda: solve(lead, *ops), GEN_GRAPH_CALLS)
        plain_ms = events_ms(lambda: solve.plain(lead, *ops), 2)
        b_ms, b_by = bound(fused_work(cfg, model, lead, ops[0], ops[3 if variant == "smppi"
                                                                  else 2 if variant != "kmppi"
                                                                  else 3],
                                      variant=variant, plants=plants, terminal=terminal))
        print(f"# generated [{label}] {ms:.6f} ms a call (CUDA graph of {GEN_GRAPH_CALLS}), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=u_err)

    def loop(label, ctrl, x, step, n, expect):
        """``n`` commands from ``x`` after one warm-up, the launches counted
        and held to ``expect``; the command latency by CUDA events.  Returns
        the last state and the closest approach to the flagship's goal."""
        check(ctrl._fns.fused, f"generated [{label}] did not route to the kernels")
        a = ctrl.command(x)
        torch.cuda.synchronize()
        reset()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        dists = []
        for i in range(n):
            starts[i].record()
            a = ctrl.command(x)
            ends[i].record()
            x = step(x, a)
            dists.append((x - goal).norm(dim=-1).max())
        torch.cuda.synchronize()
        closest = float(torch.stack(dists).min())
        launched = {k: v for k, v in FS.launches.items() if v}
        lat = sorted(b.elapsed_time(e) for b, e in zip(starts, ends))
        med, p90 = statistics.median(lat), lat[int(0.9 * len(lat))]
        print(f"# generated loop [{label}] {n} commands: median {med:.4f} ms p90 {p90:.4f} ms "
              f"(CUDA events) | launches {launched}")
        check(FS.launches == only(**expect), f"generated [{label}] launched {launched}, "
              f"expected {expect}")
        check(bool(torch.isfinite(x).all()), f"generated [{label}]: non-finite state")
        loops[label] = dict(median_ms=med, p90_ms=p90, launches=launched, closest=closest)
        return x, closest

    B = torch.tensor(GEN_B, device=dev)
    goal = torch.tensor(GEN_GOAL, device=dev)

    def lq_step(x, a):
        return x + a @ B.T

    # 1. the flagship as plain lambdas against the named linear_quadratic
    cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
    check(isinstance(models["lq"], BL.GeneratedModel), "the lambdas did not trace")
    solve_g = FS.make_transposed_fused_solve(cfg, models["lq"])
    solve_n = FS.make_transposed_fused_solve(cfg, lq_named)
    ops = operands("mppi", cfg)
    key = (7, 11)
    out_g, out_n = solve_g(key, *ops), solve_n(key, *ops)
    ok, c_err, u_err, _ = agree(out_g[3], out_n[3], out_g[0] / out_g[2], out_n[0] / out_n[2],
                                1.0, out_g[1], out_n[1], out_g[2], out_n[2])
    print(f"# generated [lq] kernel A, generated model vs named LinearQuadratic, same seed: "
          f"cost err {c_err:.3g}, update err {u_err:.3g}")
    check(ok, f"generated LQ disagrees with the named LinearQuadratic: {c_err}, {u_err}")
    rows["lq mppi"] = held("lq mppi", solve_g, key, ops, "mppi", cfg, models["lq"])
    rows["lq mppi"]["ms_named"] = graph_ms(lambda: solve_n(key, *ops), GEN_GRAPH_CALLS)
    rows["lq mppi"]["max_abs_err_named"] = u_err
    print(f"# generated [lq] kernel A: generated {rows['lq mppi']['ms']:.6f} ms, named "
          f"{rows['lq mppi']['ms_named']:.6f} ms (ratio "
          f"{rows['lq mppi']['ms'] / rows['lq mppi']['ms_named']:.4f})")
    for label, dyn, cost in (("lq fused", *fns["lq"]),
                             ("lq named fused", lq_named.dynamics, lq_named.running_cost)):
        ctrl = MPPI(dyn, cost, nx=NX, noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                    horizon=T, lambda_=1.0, use_pallas=True, device=dev)
        x, closest = loop(label, ctrl, torch.tensor([-3.0, -2.0], device=dev), lq_step,
                          GEN_COMMANDS,
                          {"generated_mppi" if label == "lq fused" else "mppi": GEN_COMMANDS})
        # bench.py's check, as every flagship loop's: within 1.0 at some
        # command, within 10 at the last (the loop wanders about the goal)
        dist = float((x - goal).norm())
        check(closest < 1.0 and dist < 10.0, f"generated [{label}] did not reach the goal: "
              f"closest {closest}, last {dist}")
        del ctrl

    # run_mppi_jit's CUDA graph of the loop step with the generated kernel A:
    # bit for bit the eager loop of commands from the same seed
    steps = 20
    c_graph, c_eager = (MPPI(*fns["lq"], nx=NX, noise_sigma=torch.eye(NU, device=dev),
                             num_samples=K, horizon=T, lambda_=1.0, use_pallas=True, seed=7,
                             device=dev) for _ in range(2))
    x0 = torch.tensor([-3.0, -2.0], device=dev)
    reset()
    _, acts_g, _ = run_mppi_jit(c_graph, lq_step, x0, steps)
    launched = {k: v for k, v in FS.launches.items() if v}
    check(FS.launches == only(generated_mppi=steps),
          f"the generated graph loop launched {launched}, expected {steps}")
    x, acts_e = x0, []
    for _ in range(steps):
        acts_e.append(c_eager.command(x))
        x = lq_step(x, acts_e[-1])
    same = bool(torch.equal(acts_g, torch.stack(acts_e)))
    print(f"# generated [lq graph loop] run_mppi_jit {steps} steps bit for bit the eager loop: "
          f"{same} | launches {launched}")
    check(same, "the generated graph loop differs from the eager loop")
    loops["lq graph"] = dict(equal=same, launches=launched)
    del c_graph, c_eager

    # 2. the swing-up with the pendulum's functions wrapped untagged
    cfg_p = MPPIConfig(nx=2, nu=1, K=GEN_PEND_K, T=GEN_PEND_T, diag_sigma=True)
    sp_g = FS.make_transposed_fused_solve(cfg_p, models["pendulum"])
    sp_n = FS.make_transposed_fused_solve(cfg_p, PENDULUM_MODEL)
    ops_p = operands("mppi", cfg_p, op_diag=math.sqrt(10.0), bound=2.0)
    rows["pendulum mppi"] = held("pendulum mppi", sp_g, key, ops_p, "mppi", cfg_p,
                                 models["pendulum"])
    rows["pendulum mppi"]["ms_named"] = graph_ms(lambda: sp_n(key, *ops_p), GEN_GRAPH_CALLS)
    print(f"# generated [pendulum] kernel A: generated {rows['pendulum mppi']['ms']:.6f} ms, "
          f"named {rows['pendulum mppi']['ms_named']:.6f} ms")
    ctrl = MPPI(*fns["pendulum"], nx=2, noise_sigma=torch.tensor([[10.0]], device=dev),
                num_samples=GEN_PEND_K, horizon=GEN_PEND_T, lambda_=1.0,
                u_min=torch.tensor([-2.0]), u_max=torch.tensor([2.0]), use_pallas=True,
                device=dev)
    check(ctrl._fns.fused, "the wrapped pendulum did not route to the kernels")
    reset()
    env = PendulumEnv(downward_start=True)
    run_mppi(ctrl, env, lambda dataset: None, iter=GEN_PEND_COMMANDS, render=False)
    angle = abs(float(angle_normalize(env.state[0])))
    launched = {k: v for k, v in FS.launches.items() if v}
    print(f"# generated loop [pendulum swing-up] final |angle| {angle:.4f} after "
          f"{GEN_PEND_COMMANDS} commands | launches {launched}")
    check(angle < 0.25, f"generated pendulum swing-up failed: final |angle| {angle}")
    check(FS.launches == only(generated_mppi=GEN_PEND_COMMANDS),
          f"generated swing-up launched {launched}")
    loops["pendulum swing-up"] = dict(final_angle=angle, launches=launched)
    del ctrl

    # 3. the step-dependent plant through kernel A's variants, bits mode
    cfg_sd = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True, step_dependent_dynamics=True)
    sd = models["step"]
    factories = {"mppi": FS.make_transposed_fused_solve,
                 "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}
    for variant, factory in factories.items():
        c = cfg_sd if variant != "kmppi" else dataclasses.replace(cfg_sd, num_support_pts=NSP)
        solve = factory(c, sd)
        R = NSP * NU if variant == "kmppi" else T * NU
        bits = bits_for(solve, R, solve.bits_cols)
        rows[f"step {variant}"] = held(f"step {variant}", solve, bits,
                                       operands(variant, c), variant, c, sd)
    cls = {"mppi": MPPI, "smppi": SMPPI, "kmppi": KMPPI}
    for variant in ("mppi", "smppi", "kmppi"):
        kw = dict(num_support_pts=NSP, kernel=RBFKernel(2.0)) if variant == "kmppi" else {}
        ctrl = cls[variant](*fns["step"], nx=NX, noise_sigma=torch.eye(NU, device=dev),
                            num_samples=K, horizon=T, lambda_=1.0, use_pallas=True, device=dev,
                            step_dependent_dynamics=True, **kw)
        loop(f"step {variant}", ctrl, torch.tensor([-3.0, -2.0], device=dev), lq_step,
             GEN_COMMANDS, {f"generated_{variant}": GEN_COMMANDS})
        del ctrl
    # the legacy rollout
    rollout = LG.make_fused_rollout(cfg_sd, sd)
    x0_K = torch.tensor([-3.0, -2.0], device=dev)[None].expand(K, NX)
    u_sc = torch.randn(K, T, NU, generator=gen, device=dev) * 0.5
    c_k, c_p = rollout(x0_K, u_sc), rollout.plain(x0_K, u_sc)
    r_err = float((c_k - c_p).abs().max())
    check(bool(((c_k - c_p).abs() <= 1e-5 + 2e-5 * c_p.abs()).all()),
          f"generated rollout disagrees with its plain version: {r_err}")
    b_ms, b_by = bound(rollout_work(sd, x0_K, u_sc))
    rows["step rollout"] = dict(ms=graph_ms(lambda: rollout(x0_K, u_sc), GEN_GRAPH_CALLS),
                                plain_ms=events_ms(lambda: rollout.plain(x0_K, u_sc), 2),
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=r_err)
    print(f"# generated [step rollout] cost err {r_err:.3g} | {rows['step rollout']}")
    ctrl = MPPI(*fns["step"], nx=NX, noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                horizon=T, lambda_=1.0, use_pallas="rollout", device=dev,
                step_dependent_dynamics=True)
    loop("step rollout", ctrl, torch.tensor([-3.0, -2.0], device=dev), lq_step, GEN_COMMANDS,
         {"generated_rollout": GEN_COMMANDS, "weighted_update": GEN_COMMANDS})
    del ctrl

    # 4. the batched pair at N = 16, K = 10,240
    cfg_b = MPPIConfig(nx=NX, nu=NU, K=BATCH_SMALL_K, T=T, diag_sigma=True,
                       step_dependent_dynamics=True)
    N_ = BATCH_SMALL_N
    solve_b = FS.make_transposed_batched_solve(cfg_b, N_, sd)
    x0N = torch.randn(NX, N_, generator=gen, device=dev)
    UN = torch.randn(T * NU, N_, generator=gen, device=dev) * 0.3
    ops_b = (x0N, UN, full(T * NU, 0.8), full(T * NU, 0.0), full(T * NU, -1.0),
             full(T * NU, 1.0), (UN * 0.7).contiguous(), torch.tensor(1.0, device=dev))
    bits_b = bits_for(solve_b, T * NU, solve_b.bits_cols)
    rows["step batched"] = held("step batched", solve_b, bits_b, ops_b, "batched", cfg_b, sd,
                                plants=N_)
    ctrl = MPPI_Batched(*fns["step"], nx=NX, noise_sigma=torch.eye(NU, device=dev),
                        num_envs=N_, num_samples=BATCH_SMALL_K, horizon=T, lambda_=1.0,
                        use_pallas="force", device=dev, step_dependent_dynamics=True)
    xb = torch.randn(N_, NX, generator=gen, device=dev)
    loop("step batched", ctrl, xb, lq_step, GEN_COMMANDS,
         {"generated_batched": 2 * GEN_COMMANDS})
    del ctrl

    # 5. a traced terminal cost that is not quadratic_terminal
    solve_t = FS.make_transposed_fused_solve(cfg, models["lq"], terminal_final=fns["terminal"])
    rows["terminal mppi"] = held("terminal mppi", solve_t, key, ops, "mppi", cfg, models["lq"],
                                 terminal=models["terminal"])
    ctrl = MPPI(*fns["lq"], nx=NX, noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                horizon=T, lambda_=1.0, use_pallas=True, device=dev,
                terminal_final_cost=fns["terminal"])
    loop("terminal fused", ctrl, torch.tensor([-3.0, -2.0], device=dev), lq_step, GEN_COMMANDS,
         {"generated_mppi": GEN_COMMANDS})
    del ctrl
    return dict(rows=rows, loops=loops)


def generated_kernel_rows(report, build_s):
    """Phase 7's rows for the generated instantiations (phase 11)."""
    rows = []
    names = {
        "lq mppi": ("fused_mppi MPPI, generated model: bench.py's flagship as plain lambdas "
                    "(mppi_fused_partial<Generated, 2, ..., kMPPI>)", 512, "lq fused",
                    "generated_mppi"),
        "pendulum mppi": ("fused_mppi MPPI, generated model: the pendulum's functions "
                          "untagged (mppi_fused_partial<Generated, 2, ..., kMPPI>)", 512,
                          "pendulum swing-up", "generated_mppi"),
        "step mppi": ("fused_mppi MPPI, generated step-dependent model "
                      "(mppi_fused_partial<Generated, 2, ..., kMPPI>)", 512, "step mppi",
                      "generated_mppi"),
        "step smppi": ("fused_mppi SMPPI, generated step-dependent model "
                       "(mppi_fused_partial<Generated, 2, ..., kSMPPI>)", 755, "step smppi",
                       "generated_smppi"),
        "step kmppi": ("fused_mppi KMPPI, generated step-dependent model "
                       "(mppi_fused_partial<Generated, 2, ..., kKMPPI>)", 940, "step kmppi",
                       "generated_kmppi"),
        "step batched": ("fused_mppi batched, generated step-dependent model "
                         "(batched_partial<Generated, 2, kGlobal> + flash_merge)", 1118,
                         "step batched", "generated_batched"),
        "step rollout": ("fused_rollout, generated step-dependent model "
                         "(fused_rollout<Generated, 2>)", 75, "step rollout",
                         "generated_rollout"),
        "terminal mppi": ("fused_mppi MPPI, generated model and traced terminal cost "
                          "(mppi_fused_partial<Generated, 2, ..., kMPPI>, Generated::terminal)",
                          512, "terminal fused", "generated_mppi"),
    }
    for key, (label, line, loop, count) in names.items():
        r = report["rows"][key]
        row = {
            "name": label,
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            # the struct Generated that fused_mppi.cu includes, emitted from
            # the traced callables
            "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": report["loops"][loop]["launches"].get(count, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "ms_source": "cuda_graph",
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "build_s": build_s.get(key),
        }
        if "ms_named" in r:
            row["ms_named_model"] = r["ms_named"]
        if key in report["loops"] and "median_ms" in report["loops"][key]:
            row["command_median_ms"] = report["loops"][key]["median_ms"]
        rows.append(row)
    graph = report["loops"]["lq graph"]["launches"]
    rows[0]["launches_graph_loop"] = graph.get("generated_mppi", 0)
    rows[0]["command_median_ms"] = report["loops"]["lq fused"]["median_ms"]
    rows[0]["command_median_ms_named"] = report["loops"]["lq named fused"]["median_ms"]
    return rows


def example_phase(dev, plan, lq_named):
    """Phase 12: the port's examples on the card (see the module
    docstring).  Returns the report phase 7's kernel row reads."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.examples import (deploy_serving, differentiable_mpc,
                                                 elite_reuse, gradient_refinement,
                                                 scenario_batch, smooth_mppi)
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    start = time.perf_counter()
    report = {"seconds": {}}

    def reset():
        torch.cuda.synchronize()
        for name in FS.launches:
            FS.launches[name] = 0

    def only(**counts):
        return {name: counts.get(name, 0) for name in FS.launches}

    # (a) the generated batched pair at scenario_batch --pod-scale's shape,
    # operand mode (use_pallas=True), against its plain version and against
    # the named LinearQuadratic pair on the same operands, both timed
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    N_, K_, T_ = BATCH_N, BATCH_K, T
    D = T_ * NU
    cfg = MPPIConfig(nx=NX, nu=NU, K=K_, T=T_, diag_sigma=True)
    sigma = math.sqrt(0.5)  # the example's noise_sigma = 0.5 I
    solve_g = FS.make_transposed_batched_solve(cfg, N_, plan["models"]["lq"], noise_operand=True)
    solve_n = FS.make_transposed_batched_solve(cfg, N_, lq_named, noise_operand=True)
    x0N = torch.rand(NX, N_, generator=gen, device=dev) * 4 - 4
    UN = torch.randn(D, N_, generator=gen, device=dev) * 0.3
    full = lambda v: torch.full((D,), float(v), device=dev)  # noqa: E731
    rest = (x0N, UN, full(sigma), full(0.0), full(-1.0), full(1.0), (UN / 0.5).contiguous(),
            torch.tensor(1.0, device=dev))
    lead = torch.randn(D, solve_g.K_pad, generator=gen, device=dev) * sigma
    row = {}
    for label, solve in (("plain", None), ("named", solve_n)):
        dk, msk, ck = solve_g(lead, *rest)
        torch.cuda.synchronize()
        dp, msp, cp = solve_g.plain(lead, *rest) if solve is None else solve(lead, *rest)
        ok, c_err, u_err, w_tol = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0], msp[0],
                                        msk[1], msp[1])
        print(f"# example [generated batched] N={N_} K={K_} T={T_} operand, kernel vs {label}: "
              f"cost err {c_err:.3g}, delta/s err {u_err:.3g} (tol {w_tol:.3g})")
        check(ok, f"phase 12: the generated batched pair disagrees with the {label} version: "
              f"cost {c_err}, update {u_err}")
        row["max_abs_err" if solve is None else "max_abs_err_named"] = u_err
        del dk, msk, ck, dp, msp, cp
    torch.cuda.empty_cache()
    row["ms"] = graph_ms(lambda: solve_g(lead, *rest), GEN_GRAPH_CALLS)
    row["ms_named"] = graph_ms(lambda: solve_n(lead, *rest), GEN_GRAPH_CALLS)
    row["plain_ms"] = events_ms(lambda: solve_g.plain(lead, *rest), 2)
    row["bound_ms"], row["bound_by"] = bound(fused_work(cfg, plan["models"]["lq"], lead, x0N,
                                                        rest[2], variant="batched",
                                                        plants=N_))
    print(f"# example [generated batched] {row['ms']:.6f} ms a call against the named "
          f"LinearQuadratic's {row['ms_named']:.6f} ms (ratio {row['ms'] / row['ms_named']:.4f}; "
          f"CUDA graph of {GEN_GRAPH_CALLS} calls) | plain {row['plain_ms']:.4f} ms | bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    torch.cuda.empty_cache()

    # (b) scenario_batch --pod-scale --pallas: the user's own plant in the
    # generated batched pair, eager and through run_mppi_jit's CUDA graph
    lib = _build_path_of(plan["models"]["lq"])
    runs = {}
    for name, extra in (("eager", []), ("jit-loop", ["--jit-loop"])):
        before = len(BL._KERNELS)
        stats = {}
        reset()
        converged, N = scenario_batch.main(["--pod-scale", "--pallas"] + extra, device=dev,
                                           stats=stats)
        torch.cuda.synchronize()
        launched = {k: v for k, v in FS.launches.items() if v}
        new = BL._KERNELS[before:]
        reused = bool(new) and all(not k.build_seconds and _build_path_of(k.model) == lib
                                   for k in new)
        print(f"# example [scenario_batch --pod-scale --pallas {name}] {converged}/{N} plants "
              f"within 0.5 after {EX_STEPS} steps, {stats['reached']}/{N} came within 0.5 "
              f"during the loop, mean distance over the last 10 steps {stats['settled']:.4f} "
              f"| command median {stats['command_ms']:.4f} ms "
              f"({'CUDA events' if name == 'eager' else 'the loop wall time a step'}) | "
              f"{stats['plant_solves_per_s']:.1f} plant-solves/s (host clock, "
              f"{stats['wall_s']:.3f} s) | launches {launched} | the generated library built in phase 2 reused: "
              f"{reused}")
        check(FS.launches == only(generated_batched=2 * EX_STEPS),
              f"phase 12: scenario_batch {name} launched {launched}, expected "
              f"{2 * EX_STEPS} generated_batched")
        # phase 6's goal check: the share within 0.5 at the last step, which
        # the JAX example asserts above 90 %, is 19-47 % at this K and T in
        # both packages (the example's __main__)
        check(stats["reached"] > 0.9 * N and stats["settled"] < 1.0,
              f"phase 12: scenario_batch {name}: {stats['reached']}/{N} plants came within "
              f"0.5, settled at {stats['settled']}")
        runs[name] = dict(stats, converged=converged, launches=launched, reused=reused)
    counts = {name: (r["converged"], r["reached"]) for name, r in runs.items()}
    check(counts["jit-loop"] == counts["eager"],
          f"phase 12: the jit loop's counts {counts['jit-loop']} differ from the eager loop's "
          f"{counts['eager']}")
    report["seconds"]["scenario_batch"] = time.perf_counter() - start  # (a) and (b)

    # (c) the other examples, each at its JAX test's sizes with its check
    t = time.perf_counter()
    # JAX's "below half its start" is a draw in both packages (the
    # example's __main__): hold the loss's fall, and the gradient on the card
    # to the CPU's on the same weights and draws
    l0, l1 = differentiable_mpc.main(train_steps=EX_TRAIN_STEPS, device=dev)
    print(f"# example [differentiable_mpc] task loss {l0:.4f} -> {l1:.4f} (ratio "
          f"{l1 / l0:.4f}) after {EX_TRAIN_STEPS} Adam steps")
    check(l1 < l0, f"phase 12: differentiable_mpc {l0} -> {l1}")
    (lc, gc), (lg, gg) = (closed_loop_grad(differentiable_mpc, d)
                          for d in (torch.device("cpu"), dev))
    g_err = max(float((a - b.cpu()).abs().max()) for a, b in zip(gc, gg))
    g_scale = max(float(a.abs().max()) for a in gc)
    print(f"# example [differentiable_mpc] float64 2-command loop on the card against the CPU: "
          f"loss {lg:.12g} / {lc:.12g}, gradient err {g_err:.3g} of its largest {g_scale:.4g}")
    check(abs(lg - lc) <= 1e-9 * abs(lc) and g_err <= 1e-9 * g_scale,
          f"phase 12: the closed loop's gradient on the card differs from the CPU's: {g_err}")
    report["differentiable_mpc"] = (l0, l1)
    lap = time.perf_counter()
    print(f"# example [differentiable_mpc] {lap - t:.1f} s")
    rows = elite_reuse.main(["--samples", "16", "--elites", "4", "--steps", "60", "--seeds",
                             "2"], device=dev)
    print(f"# example [elite_reuse] {rows} | {time.perf_counter() - lap:.1f} s")
    check(rows[1][1] < rows[0][1], f"phase 12: elite_reuse {rows}")
    lap = time.perf_counter()
    rows = gradient_refinement.main(["--samples", "5", "--steps", "60", "--seeds",
                                     str(EX_REFINE_SEEDS)], device=dev)
    print(f"# example [gradient_refinement] {rows} | {time.perf_counter() - lap:.1f} s")
    check(rows[1][2] < rows[0][2] and math.isfinite(rows[1][1]),
          f"phase 12: gradient_refinement {rows}")
    lap = time.perf_counter()
    rows = smooth_mppi.main(steps=EX_SMOOTH_STEPS, device=dev)
    print(f"# example [smooth_mppi] {time.perf_counter() - lap:.1f} s")
    check(len(rows) == 3 and all(math.isfinite(v) for r in rows for v in r[1:]),
          f"phase 12: smooth_mppi {rows}")
    lap = time.perf_counter()
    served = deploy_serving.main(["--steps", "8", "--samples", "64"], device=dev)
    print(f"# example [deploy_serving] {served} | {time.perf_counter() - lap:.1f} s")
    check(served["steps"] == 8 and math.isfinite(served["final_angle"])
          and served["device"].startswith("cuda"), f"phase 12: deploy_serving {served}")
    report["seconds"]["others"] = time.perf_counter() - t
    report.update(row=row, runs=runs, seconds_total=time.perf_counter() - start)
    print(f"# phase 12 took {report['seconds_total']:.1f} s (the generated pair and "
          f"scenario_batch {report['seconds']['scenario_batch']:.1f} s, the other examples "
          f"{report['seconds']['others']:.1f} s)")
    return report


def closed_loop_grad(differentiable_mpc, dev):
    """``differentiable_mpc``'s task loss of a 2-command loop in float64 and
    its gradient with respect to seeded weights, on ``dev``, with the
    solve's N(0, 1) draws fed from one seeded CPU stream (the same on every
    device): ``(loss, [gradients])``."""
    from pytorch_mppi_tpu_torch.models import mlp_init
    from pytorch_mppi_tpu_torch.ops import solve as PS

    g = torch.Generator().manual_seed(3)
    w = mlp_init([4, 16, 2], g, torch.float64, dev)
    leaves = [p.requires_grad_() for layer in w for p in layer]
    draws = [torch.randn(128, 16, generator=g, dtype=torch.float64) for _ in range(2)]
    fed = iter(draws)
    standard_normal = PS.standard_normal
    PS.standard_normal = lambda gen, shape, dtype, device: next(fed).to(device, dtype)
    try:
        loss = differentiable_mpc.make_task_loss(2, dev, torch.float64)(w)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        PS.standard_normal = standard_normal
    return float(loss.detach()), [t.detach() for t in grads]


def _build_path_of(model):
    """The library file of ``model``'s batched kernels (``ops/_build``)."""
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    return _build.generated_path(BL.generated_kernel(model, None).header(), 1 << FS.BATCHED)


def example_kernel_row(report):
    """Phase 7's row for the generated batched pair of phase 12."""
    row, runs = report["row"], report["runs"]
    return {
        "name": "fused_mppi batched, generated model: scenario_batch's plant at N = 1,024, "
                "K = 16,384 (batched_partial<Generated, 2, kGlobal> + flash_merge)",
        "route": "cuda",
        "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
        "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
        "replaces": "pytorch_mppi_tpu/ops/pallas_rollout.py:1118",
        "launches": runs["eager"]["launches"].get("generated_batched", 0),
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "ms_source": "cuda_graph",
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "ms_named_model": row["ms_named"],
        "launches_graph_loop": runs["jit-loop"]["launches"].get("generated_batched", 0),
        "command_median_ms": runs["eager"]["command_ms"],
    }


def card_line():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi failed"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pytorch_mppi_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no pytorch_mppi_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))  # the checkout's package, never an installed one
    from pytorch_mppi_tpu_torch import (
        KMPPI,
        MPPI,
        SMPPI,
        MPPI_Batched,
        RBFKernel,
        SpecificActionSampler,
        linear_quadratic,
        quadratic_terminal,
        run_mppi,
    )
    from pytorch_mppi_tpu_torch.config import BatchedState, MPPIConfig, MPPIState
    from pytorch_mppi_tpu_torch.models import (
        PENDULUM_MODEL,
        PendulumEnv,
        Toy2DEnvironment,
        angle_normalize,
        pendulum_dynamics,
        pendulum_running_cost,
    )
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import library
    from pytorch_mppi_tpu_torch.ops import rowmajor as RM
    from pytorch_mppi_tpu_torch.ops import solve as PS
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    # float32 products stay float32: no TF32 anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    def only(**counts):
        """The launch counts of a run that launched only these kernels."""
        return {name: counts.get(name, 0) for name in FS.launches}

    # -- 1. device -----------------------------------------------------------
    card = card_line()
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    stamp("2")
    gen_plan = generated_builds(dev)  # phase 11's libraries, beside the named one
    built = _build.build()
    if built is None:
        print(f"# build: {_build.library_path().name} already built")
    else:
        secs, log = built
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        log_path = _build.library_path().with_suffix(".log")
        log_path.write_text(log)
        print(f"# build {_build.SOURCE.name} ({_build.PARTS} parts in parallel): {secs:.1f} s "
              f"({secs / BEFORE_BUILD_S:.3f} of the parent's {BEFORE_BUILD_S} s on another call) | "
              f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers | "
              f"spill stores in {sum(b > 0 for b in spills)}, up to {max(spills, default=0)} "
              f"bytes | nvcc -Xptxas -v output in {log_path}")
    join_generated_builds(gen_plan)
    print(f"# build phase (the named library and phases 11's and 12's generated ones): "
          f"{time.perf_counter() - START:.1f} s from the script's start")

    # -- 3. kernel against its plain version ----------------------------------
    stamp("3")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev)
    goal = torch.tensor([2.0, 2.0], device=dev)
    lq = linear_quadratic(B, goal)
    term = quadratic_terminal(goal, *TERMINAL_W)
    g_cpu = torch.Generator().manual_seed(12)
    lq3 = linear_quadratic(torch.randn(2, 3, generator=g_cpu) * 0.5, torch.tensor([2.0, 2.0]))
    lq12 = linear_quadratic(torch.randn(12, 4, generator=g_cpu) * 0.3,
                            torch.randn(12, generator=g_cpu))
    toy = Toy2DEnvironment(device=dev)
    X0 = {"pendulum": [math.pi, 1.0], "linear_quadratic": [-3.0, -2.0],
          "toy2d": [-3.0, -2.0]}
    factories = {"mppi": FS.make_transposed_fused_solve,
                 "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}

    def operands(variant, cfg, model, rho, op_diag, mu, bound, abound, lam, w, dt):
        """The device operands of one kernel case, in call order after the
        noise source."""
        K_, T_, nu, nx = cfg.K, cfg.T, cfg.nu, cfg.nx
        D = T_ * nu
        reps = cfg.num_support_pts if variant == "kmppi" else T_
        R = reps * nu
        if rho:
            sig = torch.eye(nu, device=dev) + 0.3 * (torch.ones(nu, nu, device=dev)
                                                     - torch.eye(nu, device=dev))
            z = torch.zeros(nu, device=dev)
            op = PS._transposed_operands(sig, z, z, z, cfg, reps, nu, torch.float32)[1]
        else:
            op = torch.full((R,), op_diag, device=dev)
        x0 = torch.tensor(X0.get(model.name, [0.5] * nx), device=dev)[:nx]
        if x0.numel() < nx:
            x0 = torch.randn(nx, generator=gen, device=dev)
        x0T = x0[:, None].expand(nx, K_)
        U2 = torch.randn(D, generator=gen, device=dev) * 0.3
        a_flat = (U2 * 0.7).contiguous()
        full = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
        lam_t = torch.tensor(lam, device=dev)
        if variant == "mppi":
            return (x0T, U2, op.contiguous(), full(mu), full(-bound), full(bound), a_flat, lam_t)
        if variant == "smppi":
            as2 = torch.randn(D, generator=gen, device=dev) * 0.2
            return (x0T, U2, as2, op.contiguous(), full(mu), full(-bound), full(bound),
                    full(-abound), full(abound), a_flat, lam_t, torch.tensor(w, device=dev),
                    torch.tensor(dt, device=dev))
        th = torch.randn(R, generator=gen, device=dev) * 0.2
        interp, _ = interpolation_operators(RBFKernel(2.0), T_, cfg.num_support_pts,
                                            torch.float32, device=dev)
        Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
        pfull = lambda v: torch.full((R,), v, device=dev)  # noqa: E731
        return (x0T, U2, th, op.contiguous(), pfull(mu), pfull(-bound), pfull(bound),
                full(-abound), full(abound), a_flat, Wt, lam_t)

    # (name, model, K, T, nu, nsp, config flags, noise_rho, emit, pairing
    # block, operand overrides).  The overrides give the diagonal op, mu, the
    # drawn rows' bound, the action/trajectory bound, lambda, w and delta_t
    # of the main paths' and closed loops' own operands, and kernel A's
    # samples a block where it is forced (``tile``; else the rule's).
    inf = math.inf
    base_cases = [
        ("lq_diag", lq, K, T, NU, NSP, {}, 0.0, False, None, {}),
        ("lq_full_rho", lq, K, T, NU, NSP, {}, 0.5, False, None, {}),
        ("lq_antithetic_5120", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, False, 5120, {}),
        ("lq_null_abs", lq, K, T, NU, NSP,
         {"sample_null_action": True, "noise_abs_cost": True}, 0.0, False, None, {}),
        ("lq_u_scale", lq, K, T, NU, NSP, {"u_scale": 2.5}, 0.0, False, None, {}),
        ("lq_emit_antithetic", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, True, None, {}),
        ("pendulum_null", PENDULUM_MODEL, K, 15, 1, 7, {"sample_null_action": True}, 0.0,
         False, None, {}),
        ("pendulum_full_rho", PENDULUM_MODEL, K, 15, 1, 7, {}, 0.5, True, None, {}),
        ("D300_full_rho_global", lq3, K, 100, 3, 50, {}, 0.5, False, None, {"tile": 128}),
        ("lq12_nx12_nu4", lq12, K, T, 4, NSP, {}, 0.0, True, None, {}),
        # the tiled operator in shared memory at D = 300; S forced at K not a
        # multiple of S, with the perturbed (D, K) output
        ("D300_full_rho_shared", lq3, K, 100, 3, 50, {}, 0.5, False, None, {}),
        ("K1000_S32", lq, 1000, T, NU, NSP, {}, 0.0, True, None, {"tile": 32}),
        ("K1000_S64", lq, 1000, T, NU, NSP, {}, 0.0, True, None, {"tile": 64}),
        ("antithetic_128_S32", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, True, 128,
         {"tile": 32}),
        ("antithetic_128_S64", lq, K, T, NU, NSP, {"antithetic": True}, 0.0, True, 128,
         {"tile": 64}),
        # the final-state terminal cost (the last action u_scale-scaled), and at
        # D = 300 with a full operator
        ("lq_terminal_u_scale", lq, K, T, NU, NSP, {"u_scale": 1.5}, 0.0, False, None,
         {"terminal": True}),
        ("D300_full_rho_terminal", lq3, K, 100, 3, 50, {}, 0.5, False, None, {"terminal": True}),
    ]
    cases = [("mppi",) + c for c in base_cases] + [
        # phase 5's operands: sigma = 10 (op sqrt(10)), mu = 0, bounds +-2
        ("mppi", "swing_up", PENDULUM_MODEL, 1000, 15, 1, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(10.0), mu=0.0, bound=2.0)),
        # phase 4's: the flagship main paths
        ("smppi", "main_path", lq, K, T, NU, 0, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=3.0, w=1.0, dt=1.0)),
        ("kmppi", "main_path", lq, K, T, NU, NSP, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf)),
        # phase 6's: the LQ loops and the toy2d comparison
        ("smppi", "lq_loop", lq, LOOP_K, 15, NU, 0, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf, w=5.0, dt=1.0)),
        ("kmppi", "lq_loop", lq, LOOP_K, 15, NU, 5, {}, 0.0, False, None,
         dict(op=1.0, mu=0.0, bound=inf, abound=inf)),
        ("mppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0)),
        ("smppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 0, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0, abound=1.0, w=50.0, dt=1.0)),
        ("kmppi", "toy2d_loop", toy.kernel_model, LOOP_K, 20, NU, 5, {}, 0.0, False, None,
         dict(op=math.sqrt(0.2), mu=0.0, bound=1.0, abound=1.0)),
    ]
    cases += [("smppi",) + c for c in base_cases] + [("kmppi",) + c for c in base_cases]
    # A cost error e moves each softmax weight by a factor e^(+-e/lam), so m,
    # s and the update may move by that much; the update is compared on the
    # scale of its largest element (its terms cancel, K = 10,000 of them).
    print("# kernel vs plain: cost rtol 2e-5 atol 1e-5; with e the largest cost "
          "error: |dm| <= e/lam + 1e-6, s rtol w = 2e-4 + 2e/lam, delta/s atol "
          "w * max|delta/s|; perturbed rtol 1e-5 atol 1e-6")
    max_update_err = dict.fromkeys(FS.VARIANTS, 0.0)
    n_cases = dict.fromkeys(FS.VARIANTS, 0)
    for mode in ("bits", "seed"):
        for variant, name, model, K_, T_, nu, nsp, flags, rho, emit, pb, over in cases:
            lam = 1.0
            pend = model is PENDULUM_MODEL
            cfg = MPPIConfig(nx=model.nx, nu=nu, K=K_, T=T_, diag_sigma=not rho,
                             noise_rho=rho, num_support_pts=nsp if variant == "kmppi" else 0,
                             smppi=variant == "smppi", **flags)
            solve = factories[variant](cfg, model, pair_block=pb, emit_perturbed=emit,
                                       tile_k=over.get("tile"),
                                       terminal_final=term if over.get("terminal") else None)
            for tiles in ("global", "shared"):
                check(not name.endswith("_" + tiles) or solve.tiles == tiles,
                      f"{variant}/{name} did not take {tiles} tiles")
            args = operands(variant, cfg, model, rho, over.get("op", 0.8), over.get("mu", 0.05),
                            over.get("bound", 2.0 if pend else 1.5),
                            over.get("abound", 2.0 if pend else 1.0), lam,
                            over.get("w", 3.0), over.get("dt", 0.5))
            R = (nsp if variant == "kmppi" else T_) * nu
            if mode == "bits":
                lead = torch.randint(-2**31, 2**31 - 1, (R, solve.bits_cols),
                                     dtype=torch.int32, generator=gen, device=dev)
            else:
                lead = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                           device=dev))
            out_k = solve(lead, *args)
            torch.cuda.synchronize()
            out_p = solve.plain(lead, *args)
            for v in out_k:
                check(bool(torch.isfinite(v).all()),
                      f"{mode}/{variant}/{name}: non-finite kernel output")
            dk, mk, sk, ck = out_k[:4]
            dp, mp, sp, cp = out_p[:4]
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, lam, mk, mp, sk, sp)
            m_err = abs(float(mk - mp))
            s_rel = abs(float(sk / sp - 1))
            line = (f"# {mode:4s} {variant:5s} {name:22s} K={K_:5d} D={T_ * nu:3d} "
                    f"S={solve.tile_k:3d} tiles={solve.tiles:6s} cost err {c_err:.3e} | m err "
                    f"{m_err:.3e} "
                    f"| s rel {s_rel:.3e} (tol {w_tol:.3e}) | delta/s err {u_err:.3e}")
            if emit:
                p_err = float((out_k[4] - out_p[4]).abs().max())
                ok = ok and bool(((out_k[4] - out_p[4]).abs()
                                  <= 1e-6 + 1e-5 * out_p[4].abs()).all())
                line += f" | perturbed err {p_err:.3e}"
            print(line + ("" if ok else "  <-- FAIL"))
            check(ok, f"kernel disagrees with its plain version: {mode}/{variant}/{name}")
            max_update_err[variant] = max(max_update_err[variant], u_err)
            n_cases[variant] += 1
    print(f"# kernel vs plain: {sum(n_cases.values())} cases agreed "
          f"({', '.join(f'{v} {n}' for v, n in n_cases.items())})")

    # statistics of the seed-mode noise: U = 0, sigma = I, mu = 0, no bounds
    D = T * NU
    zeros, ones = torch.zeros(D, device=dev), torch.ones(D, device=dev)
    free = (torch.zeros(2, device=dev)[:, None].expand(2, K), zeros, ones, zeros,
            torch.full((D,), -torch.inf, device=dev), torch.full((D,), torch.inf, device=dev),
            zeros, torch.tensor(1.0, device=dev))
    for anti in (False, True):
        cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True, antithetic=anti)
        solve = FS.make_transposed_fused_solve(cfg, lq, emit_perturbed=True)
        z = solve((0x12345678, 0x9ABCDEF0), *free)[4].double()
        if anti:
            pair_sum = float((z[:, : K // 2] + z[:, K // 2:]).abs().max())
            var = float(z[:, : K // 2].var())
            n = z[:, : K // 2].numel()
            print(f"# seed-mode noise, antithetic: max |z_k + z_(k+K/2)| = {pair_sum} "
                  f"| var {var:.5f} over {n} (5 sigma: {5 * (2 / n) ** 0.5:.5f})")
            check(pair_sum == 0.0, "antithetic pairs do not sum to zero")
        else:
            mean, var, n = float(z.mean()), float(z.var()), z.numel()
            print(f"# seed-mode noise: mean {mean:.5f} (5 sigma: {5 / n ** 0.5:.5f}) "
                  f"| var {var:.5f} (5 sigma: {5 * (2 / n) ** 0.5:.5f}) over {n}")
            check(abs(mean) <= 5 / n ** 0.5, "seed-mode noise mean is not 0")
        check(abs(var - 1) <= 5 * (2 / n) ** 0.5, "seed-mode noise variance is not 1")

    # one solve REPEATS times in a row on the same inputs: the block that
    # merges sets kernel A's counter back to 0, so every call merges, and
    # agrees with the first bit for bit (every sum keeps a fixed order)
    def repeats_agree(solve, lead, args):
        first = [v.clone() for v in solve(lead, *args)]
        outs = [solve(lead, *args) for _ in range(REPEATS)]
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for out in outs for a, b in zip(first, out))

    # directly and through kernel A's operator (ops/library.py), whose
    # merge counter torch.export does not see: it resets all the same
    for through_op in (False, True):
        for variant in FS.VARIANTS:
            cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True,
                             num_support_pts=NSP if variant == "kmppi" else 0,
                             smppi=variant == "smppi")
            with library.exporting() if through_op else contextlib.nullcontext():
                same = repeats_agree(factories[variant](cfg, lq), (4321, 8765),
                                     operands(variant, cfg, lq, 0.0, 0.8, 0.05, 1.5, 1.0, 1.0,
                                              3.0, 0.5))
            route = "through its operator" if through_op else "directly"
            print(f"# {variant}: {REPEATS} calls in a row {route} identical to the first: {same}")
            check(same, f"{variant}: repeated calls {route} differ (the merge counter did not "
                  f"reset)")

    # elite reuse: kernel A with the (E, D) elites operand against its plain
    # version at the flagship, with the perturbed set emitted: (name, E,
    # config flags, terminal cost, samples a block where forced).  E = 127
    # after the null row is the window's edge, samples 1-127 over four
    # blocks of 32.  The emitted elite columns must be the clamped elites
    # exactly.
    elite_cases = [("E4", 4, {}, False, None),
                   ("E4_null", 4, {"sample_null_action": True}, False, None),
                   ("E127_null_S32", 127, {"sample_null_action": True}, False, 32),
                   ("E4_antithetic_null", 4, {"antithetic": True, "sample_null_action": True},
                    False, None),
                   ("E4_terminal_u_scale", 4, {"u_scale": 1.5}, True, None)]
    n_elite = 0
    for mode in ("bits", "seed"):
        for name, E, flags, with_term, tile in elite_cases:
            cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True, num_elites=E, **flags)
            solve = FS.make_transposed_fused_solve(cfg, lq, emit_perturbed=True, tile_k=tile,
                                                   terminal_final=term if with_term else None)
            args = operands("mppi", cfg, lq, 0.0, 0.8, 0.05, 1.5, 1.0, 1.0, 3.0, 0.5)
            elites = torch.randn(E, T * NU, generator=gen, device=dev) * 2.0
            lead = (torch.randint(-2**31, 2**31 - 1, (T * NU, solve.bits_cols), dtype=torch.int32,
                                  generator=gen, device=dev) if mode == "bits"
                    else tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                             device=dev)))
            out_k = solve(lead, *args, elites)
            torch.cuda.synchronize()
            out_p = solve.plain(lead, *args, elites)
            dk, mk, sk, ck, pk = out_k
            dp, mp, sp, cp, pp = out_p
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp)
            ok = ok and all(bool(torch.isfinite(v).all()) for v in out_k)
            p_err = float((pk - pp).abs().max())
            ok = ok and bool(((pk - pp).abs() <= 1e-6 + 1e-5 * pp.abs()).all())
            off = solve.elite_off
            lo, hi = args[4][:, None], args[5][:, None]
            exact = torch.equal(pk[:, off:off + E], torch.clamp(elites.T, lo, hi))
            print(f"# {mode:4s} mppi  elites {name:20s} K={K} D={T * NU} S={solve.tile_k} "
                  f"samples {off}-{off + E - 1}: cost err {c_err:.3e} | m err "
                  f"{abs(float(mk - mp)):.3e} | s rel {abs(float(sk / sp - 1)):.3e} (tol "
                  f"{w_tol:.3e}) | delta/s err {u_err:.3e} | perturbed err {p_err:.3e} | elite "
                  f"columns exact {exact}" + ("" if ok and exact else "  <-- FAIL"))
            check(ok, f"kernel with elites disagrees with its plain version: {mode}/{name}")
            check(exact, f"{mode}/{name}: the emitted elite columns are not the clamped elites")
            max_update_err["mppi"] = max(max_update_err["mppi"], u_err)
            n_elite += 1
    print(f"# kernel vs plain: {n_elite} elite cases agreed")

    # the batched variant: (name, model, N, K, T, nu, config flags, noise_rho,
    # pairing block, modes, operand overrides).  The overrides give the
    # diagonal op, mu and the bound of phase 4's and phase 6's own operands
    # (examples/scenario_batch.py: sigma = 0.5 I, bounds +-1), and the plant
    # group P where it is forced.
    scenario_ops = dict(op=math.sqrt(0.5), mu=0.0, bound=1.0)
    all_modes = ("bits", "seed", "operand")
    batched_cases = [
        ("lq", lq, BATCH_SMALL_N, BATCH_SMALL_K, T, NU, {}, 0.0, None, all_modes, {}),
        ("lq_antithetic_5120", lq, BATCH_SMALL_N, BATCH_SMALL_K, T, NU,
         {"antithetic": True}, 0.0, BATCH_SMALL_K // 2, all_modes, {}),
        ("lq_abs_u_scale", lq, BATCH_SMALL_N, BATCH_SMALL_K, T, NU,
         {"noise_abs_cost": True, "u_scale": 2.5}, 0.0, None, all_modes, {}),
        ("main_path_full_width", lq, BATCH_N, BATCH_K, T, NU, {}, 0.0, None,
         ("seed", "operand"), scenario_ops),
        ("main_path_small", lq, BATCH_SMALL_N, BATCH_SMALL_K, T, NU, {}, 0.0, None,
         ("seed", "operand"), scenario_ops),
        ("D300_full_rho_global", lq3, 4, BATCH_SMALL_K, 100, 3, {}, 0.5, None, all_modes, {}),
        ("pendulum", PENDULUM_MODEL, 8, 1000, 15, 1, {}, 0.0, None, all_modes, {}),
        ("toy2d_K777", toy.kernel_model, 8, 777, 20, NU, {}, 0.0, None, all_modes, {}),
        ("scenario_loop", lq, SCENARIO_N, SCENARIO_K, SCENARIO_T, NU, {}, 0.0, None,
         all_modes, scenario_ops),
        # one plant a block at the full width (where the rule takes the
        # largest group, checked below); N not a multiple of P; more plants
        # than a grid row of 65,535 blocks
        ("full_width_P1", lq, BATCH_N, BATCH_K, T, NU, {}, 0.0, None, ("seed", "operand"),
         dict(scenario_ops, group=1)),
        ("N1023", lq, BATCH_N - 1, BATCH_K, T, NU, {}, 0.0, None, all_modes, scenario_ops),
        (f"N{WIDE_N}", lq, WIDE_N, WIDE_K, WIDE_T, NU, {}, 0.0, None, all_modes, scenario_ops),
        # the final-state terminal cost, at the main paths' widths
        ("terminal_u_scale", lq, BATCH_SMALL_N, BATCH_SMALL_K, T, NU, {"u_scale": 1.5}, 0.0,
         None, ("seed", "operand"), dict(scenario_ops, terminal=True)),
        ("terminal_full_width", lq, BATCH_N, BATCH_K, T, NU, {}, 0.0, None,
         ("seed", "operand"), dict(scenario_ops, terminal=True)),
    ]
    n_batched = 0
    for name, model, N_, K_, T_, nu, flags, rho, pb, modes, over in batched_cases:
        D_ = T_ * nu
        cfg = MPPIConfig(nx=model.nx, nu=nu, K=K_, T=T_, diag_sigma=not rho, noise_rho=rho,
                         **flags)
        op_, mu_, bnd = over.get("op", 0.8), over.get("mu", 0.05), over.get("bound", 1.5)
        if rho:
            op = operands("mppi", cfg, model, rho, op_, mu_, bnd, bnd, 1.0, 0.0, 1.0)[2]
        else:
            op = torch.full((D_,), op_, device=dev)
        x0T = (torch.rand(model.nx, N_, generator=gen, device=dev) * 4 - 4)
        U2T = (torch.randn(N_, D_, generator=gen, device=dev) * 0.3).T
        aT = (torch.randn(N_, D_, generator=gen, device=dev) * 0.5).T
        vec = lambda v: torch.full((D_,), v, device=dev)  # noqa: E731
        rest = (x0T, U2T, op, vec(mu_), vec(-bnd), vec(bnd), aT, torch.tensor(1.0, device=dev))
        for mode in modes:
            solve = FS.make_transposed_batched_solve(
                cfg, N_, model, pair_block=pb, noise_operand=mode == "operand",
                group=over.get("group"), terminal_final=term if over.get("terminal") else None)
            check(name != "main_path_full_width" or solve.plant_group == FS.PLANT_GROUP_MAX,
                  f"the rule takes P={solve.plant_group} at N={N_}, K={K_}, not "
                  f"{FS.PLANT_GROUP_MAX}")
            if mode == "bits":
                lead = torch.randint(-2**31, 2**31 - 1, (D_, solve.bits_cols),
                                     dtype=torch.int32, generator=gen, device=dev)
            elif mode == "seed":
                lead = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                           device=dev))
            else:
                lead = (torch.randn(D_, solve.K_pad, generator=gen, device=dev) * op_ + mu_)
            dk, msk, ck = solve(lead, *rest)
            torch.cuda.synchronize()
            dp, msp, cp = solve.plain(lead, *rest)
            check(all(bool(torch.isfinite(v).all()) for v in (dk, msk, ck)),
                  f"batched/{name}/{mode}: non-finite kernel output")
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0],
                                            msp[0], msk[1], msp[1])
            print(f"# {mode:7s} batched {name:22s} N={N_:5d} K={K_:5d} D={D_:3d} "
                  f"P={solve.plant_group:2d} tiles={solve.tiles:6s} cost err {c_err:.3e} | m err "
                  f"{float((msk[0] - msp[0]).abs().max()):.3e} | s rel "
                  f"{float((msk[1] / msp[1] - 1).abs().max()):.3e} (tol {w_tol:.3e}) | "
                  f"delta/s err {u_err:.3e}" + ("" if ok else "  <-- FAIL"))
            check(ok, f"batched kernel disagrees with its plain version: {mode}/{name}")
            max_update_err["batched"] = max(max_update_err.get("batched", 0.0), u_err)
            n_batched += 1
            del dk, msk, ck, dp, msp, cp
        torch.cuda.empty_cache()
    print(f"# kernel vs plain: {n_batched} batched cases agreed")

    # num_iterations: one fused step of ITERS iterations (one launch each,
    # each launch's update feeding the next one's nominal) against the same
    # step with the kernel's plain version in the kernel's place, on the same
    # bits an iteration (key_to_seed fed in call order) or the same seeds;
    # the batched pair at N = 16 with BATCH_ITERS iterations in operand and
    # seed mode.  The plain twin is built with ops/solve's route patched to
    # hand back the kernel's plain version.
    def twin(build):
        """``build()`` with the kernel, then with its plain version in its
        place (every other line of the step the same)."""
        route = PS._route_transposed_solve

        def plain_route(*a, **kw):
            solve = route(*a, **kw)
            if solve is None:
                return None
            plain = lambda *args: solve.plain(*args)  # noqa: E731
            plain.__dict__.update(solve.__dict__)
            return plain

        kernel = build()
        PS._route_transposed_solve = plain_route
        try:
            return kernel, build()
        finally:
            PS._route_transposed_solve = route

    def moved(variant, params, state, new):
        """What a step's iterations added: U (rates for SMPPI) less the
        shifted U, or for KMPPI theta less the shifted theta."""
        if variant == "kmppi":
            return (new.theta - params.interp_shift @ state.theta).reshape(-1)
        base = params.base if variant != "mppi" else params
        return (new.U - PS._shift_U(state.U, base.u_init)).reshape(-1)

    ITER_MAIN = {  # the flagship controllers of phase 4
        "mppi": (MPPI, {}),
        "smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                              action_min=torch.tensor([-3.0, -3.0]),
                              action_max=torch.tensor([3.0, 3.0]))),
        "kmppi": (KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0))),
    }
    real_key_to_seed = FS.key_to_seed
    n_chained = 0
    for mode in ("bits", "seed"):
        for variant, (cls, extra) in ITER_MAIN.items():
            ck, cp = twin(lambda: cls(lq.dynamics, lq.running_cost, nx=NX,
                                      noise_sigma=torch.eye(NU, device=dev), num_samples=K,
                                      horizon=T, lambda_=1.0, seed=5, use_pallas=True,
                                      num_iterations=ITERS, device=dev, **extra))
            check(ck._fns.fused and cp._fns.fused, f"{variant} num_iterations twin not fused")
            params, state = ck._full_params(), ck._state
            x0 = torch.tensor([-3.0, -2.0], device=dev)
            bits = None
            if mode == "bits":
                R = (NSP if variant == "kmppi" else T) * NU
                cols = FS.make_transposed_fused_solve(ck.config, lq).bits_cols
                bits = [torch.randint(-2**31, 2**31 - 1, (R, cols), dtype=torch.int32,
                                      generator=gen, device=dev) for _ in range(ITERS)]
            outs = []
            for c in (ck, cp):
                if bits is not None:
                    fed = iter(bits)
                    FS.key_to_seed = lambda s_, fed=fed: next(fed)
                reset_launches()
                try:
                    outs.append(c._fns.step(params, state, x0))
                finally:
                    FS.key_to_seed = real_key_to_seed
                torch.cuda.synchronize()
                outs[-1] += (dict(FS.launches),)
            (s_k, _, art_k, l_k), (s_p, _, art_p, l_p) = outs
            ok, c_err, u_err, w_tol = agree(art_k.cost_total, art_p.cost_total,
                                            moved(variant, params, state, s_k),
                                            moved(variant, params, state, s_p), 1.0)
            launches_ok = l_k == only(**{variant: ITERS}) and l_p == only()
            print(f"# {mode:4s} {variant:5s} num_iterations={ITERS} step vs {ITERS} chained plain "
                  f"iterations K={K} D={T * NU}: cost err {c_err:.3e} | update err {u_err:.3e} "
                  f"(tol {w_tol:.3e} of its largest element) | launches {l_k[variant]} "
                  f"(plain twin {sum(l_p.values())}) | counter {s_k.counter}"
                  + ("" if ok and launches_ok else "  <-- FAIL"))
            check(ok, f"{mode}/{variant}: the num_iterations step disagrees with its plain twin")
            check(launches_ok, f"{mode}/{variant}: the num_iterations step launched {l_k}, "
                               f"the plain twin {l_p}")
            check(s_k.counter == s_p.counter == state.counter + ITERS,
                  f"{variant}: the counter did not advance by num_iterations")
            max_update_err[variant] = max(max_update_err[variant], u_err)
            n_chained += 1
    sigma_b = torch.eye(NU, device=dev) * 0.5
    ub = torch.tensor([1.0, 1.0])
    for mode, use_pallas in (("operand", True), ("seed", "kernel_rng")):
        ck, cp = twin(lambda: MPPI_Batched(
            lq.dynamics, lq.running_cost, nx=NX, noise_sigma=sigma_b, num_envs=BATCH_SMALL_N,
            num_samples=BATCH_SMALL_K, horizon=T, lambda_=1.0, u_min=-ub, u_max=ub, seed=0,
            use_pallas=use_pallas, num_iterations=BATCH_ITERS, device=dev))
        check(ck._fns.fused and cp._fns.fused, f"batched {mode} num_iterations twin not fused")
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        x = torch.rand(BATCH_SMALL_N, NX, generator=g, device=dev) * 4 - 4
        st = BatchedState(U=ck.U.clone(), seed=2025)
        reset_launches()
        s_k, _, art_k = ck._fns.step(ck._params, st, x)
        torch.cuda.synchronize()
        l_k = dict(FS.launches)
        reset_launches()
        s_p, _, art_p = cp._fns.step(ck._params, st, x)
        l_p = dict(FS.launches)
        U0 = torch.roll(st.U, -1, dims=1)
        U0[:, -1] = ck._params.u_init
        ok, c_err, u_err, w_tol = agree(art_k.cost_total, art_p.cost_total,
                                        (s_k.U - U0).reshape(BATCH_SMALL_N, -1).T,
                                        (s_p.U - U0).reshape(BATCH_SMALL_N, -1).T, 1.0)
        launches_ok = l_k == only(batched=2 * BATCH_ITERS) and l_p == only()
        print(f"# {mode:7s} batched num_iterations={BATCH_ITERS} step vs {BATCH_ITERS} chained "
              f"plain iterations N={BATCH_SMALL_N} K={BATCH_SMALL_K}: cost err {c_err:.3e} | "
              f"update err {u_err:.3e} (tol {w_tol:.3e} of each plant's largest element) | "
              f"launches {l_k['batched']} (plain twin {sum(l_p.values())})"
              + ("" if ok and launches_ok else "  <-- FAIL"))
        check(ok, f"batched {mode}: the num_iterations step disagrees with its plain twin")
        check(launches_ok, f"batched {mode}: the num_iterations step launched {l_k}, the "
                           f"plain twin {l_p}")
        max_update_err["batched"] = max(max_update_err["batched"], u_err)
        n_chained += 1
    print(f"# kernel vs plain: {n_chained} num_iterations steps agreed with their chained "
          f"plain iterations")

    # elite reuse: one fused MPPI step with four elites (injected as the
    # kernel's operand, refreshed from its emitted columns) against its
    # plain twin on the same seed.  Costs summed in another order may swap
    # near-tied ranks, so the refreshed elites are held by their costs; each
    # side's elites are its own emitted columns of its lowest costs.
    ck, cp = twin(lambda: MPPI(lq.dynamics, lq.running_cost, nx=NX,
                               noise_sigma=torch.eye(NU, device=dev), num_samples=K, horizon=T,
                               lambda_=1.0, seed=5, use_pallas=True, num_elites=4,
                               fused_artifacts=True, device=dev))
    check(ck._fns.fused and cp._fns.fused, "the elite twin is not fused")
    params = ck._params
    st = ck._state._replace(elites=torch.randn(4, T, NU, generator=gen, device=dev))
    x0 = torch.tensor([-3.0, -2.0], device=dev)
    outs = []
    for c in (ck, cp):
        reset_launches()
        outs.append(c._fns.step(params, st, x0) + (dict(FS.launches),))
        torch.cuda.synchronize()
    (s_k, _, art_k, l_k), (s_p, _, art_p, l_p) = outs
    U0 = PS._shift_U(st.U, params.u_init)
    ok, c_err, u_err, w_tol = agree(art_k.cost_total, art_p.cost_total, (s_k.U - U0).reshape(-1),
                                    (s_p.U - U0).reshape(-1), 1.0)
    idx_k, idx_p = (PS._top_elites(a.cost_total, 4) for a in (art_k, art_p))
    el_cost_err = float((art_k.cost_total[idx_k] - art_p.cost_total[idx_p]).abs().max())
    ok = ok and el_cost_err <= 1e-5 + 2e-5 * float(art_p.cost_total[idx_p].abs().max())
    own = torch.equal(s_k.elites, art_k.perturbed_action[idx_k]) and torch.equal(
        s_p.elites, art_p.perturbed_action[idx_p])
    injected = torch.equal(art_k.perturbed_action[:4], PS._shift_elites(st.elites, params.u_init))
    launches_ok = l_k == only(mppi=1) and l_p == only()
    print(f"# seed mppi  elites step (E=4) vs its plain twin K={K} D={T * NU}: cost err "
          f"{c_err:.3e} | update err {u_err:.3e} (tol {w_tol:.3e} of its largest element) | "
          f"the elites' costs err {el_cost_err:.3e} | refreshed from the emitted columns {own} | "
          f"injected rows the shifted elites {injected} | launches {l_k['mppi']} (plain twin "
          f"{sum(l_p.values())})" + ("" if ok and own and injected and launches_ok
                                      else "  <-- FAIL"))
    check(ok and own and injected, "the fused elite step disagrees with its plain twin")
    check(launches_ok, f"the fused elite step launched {l_k}, the plain twin {l_p}")

    # the legacy route's kernels.  The rollout: (name, model, K, T, nu, shared
    # x0, samples a block where forced, a 4-byte offset of the actions): the
    # flagship with the rule's S and with 32, 64 and 128 forced, K not a
    # multiple of the block, D = 15 (rows not 16-byte aligned: 4-byte copies),
    # actions at a 4-byte offset (the same), D = 300 in one buffer and, at
    # S = 128, in chunks of two buffers
    legacy_cases = [
        ("lq", lq, K, T, NU, True, None, 0), ("lq_per_sample_x0", lq, K, T, NU, False, None, 0),
        ("lq_K777", lq, 777, T, NU, True, None, 0),
        ("pendulum", PENDULUM_MODEL, 1000, 15, 1, True, None, 0),
        ("toy2d_K777", toy.kernel_model, 777, 20, NU, False, None, 0),
        ("lq_S32", lq, K, T, NU, True, 32, 0), ("lq_S64", lq, K, T, NU, True, 64, 0),
        ("lq_S128", lq, K, T, NU, False, 128, 0),
        ("pendulum_D15_K777", PENDULUM_MODEL, 777, 15, 1, False, None, 0),
        ("lq_offset4", lq, K, T, NU, True, None, 1),
        ("D300", lq3, K, 100, 3, True, None, 0), ("D300_S128_chunks", lq3, K, 100, 3, False, 128, 0),
    ]
    for name, model, K_, T_, nu, shared, tile, off in legacy_cases:
        rollout = LG.make_fused_rollout(MPPIConfig(nx=model.nx, nu=nu, K=K_, T=T_), model,
                                        tile_k=tile)
        x0_K = (torch.randn(model.nx, device=dev)[None].expand(K_, model.nx) if shared
                else torch.randn(K_, model.nx, generator=gen, device=dev))
        u = torch.randn(K_ * T_ * nu + off, generator=gen, device=dev)[off:].view(K_, T_, nu)
        ck = rollout(x0_K, u)
        torch.cuda.synchronize()
        cp = rollout.plain(x0_K, u)
        c_err = float((ck - cp).abs().max())
        ok = bool(((ck - cp).abs() <= 1e-5 + 2e-5 * cp.abs()).all())
        S = tile or FS.tile_samples(K_, FS.sm_count())
        geo = LG.rollout_geometry(T_, nu, S)
        copies = (16 if (T_ * nu) % 4 == 0 and (geo["steps"] * nu) % 4 == 0
                  and u.data_ptr() % 16 == 0 else 4)
        print(f"# rollout {name:18s} K={K_:5d} T={T_:3d} D={T_ * nu:3d} S={S:3d} "
              f"({-(-K_ // S)} blocks; {geo['chunks']} chunk(s) of {geo['steps']} steps, rows of "
              f"{geo['ldr']} floats, {geo['smem']} B, {copies}-byte copies): cost err {c_err:.3e}"
              + ("" if ok else "  <-- FAIL"))
        check(ok, f"rollout kernel disagrees with its plain version: {name}")
        max_update_err["rollout"] = max(max_update_err.get("rollout", 0.0), c_err)
    # REPEATS calls in a row repeat the first bit for bit (one thread a sample,
    # sums in a fixed order)
    rollout = LG.make_fused_rollout(MPPIConfig(nx=NX, nu=NU, K=K, T=T), lq)
    x0_K = torch.randn(K, NX, generator=gen, device=dev)
    u = torch.randn(K, T, NU, generator=gen, device=dev)
    first = rollout(x0_K, u).clone()
    outs = [rollout(x0_K, u) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    same = all(torch.equal(first, o) for o in outs)
    print(f"# rollout: {REPEATS} calls in a row identical to the first: {same}")
    check(same, "rollout: repeated calls differ")
    # the weighted update: (K, D, samples a block where forced, extra columns
    # of a strided noise: 4 keeps its rows 16-byte aligned, 3 does not)
    lam_t = torch.tensor(0.8, device=dev)
    wu_cases = [(K, T * NU, None, 0), (777, T * NU, None, 0), (1000, 15, None, 0),
                (K, 300, None, 0), (K, T * NU, 32, 0), (K, T * NU, 64, 0), (K, T * NU, 128, 0),
                (K, T * NU, None, 4), (K, T * NU, None, 3), (20, T * NU, None, 0),
                (16_500, T * NU, 32, 0)]
    print("# weighted_update vs plain: |dm| <= 1e-6 (1 + |m|), s rtol 1e-5, pert/s atol "
          "1e-4 max|pert/s|; one launch a call")
    for K_, D_, tile, pad in wu_cases:
        cost = torch.rand(K_, generator=gen, device=dev) * 60 + 5
        noise = torch.randn(K_, D_ + pad, generator=gen, device=dev)[:, :D_]
        update = LG.make_weighted_update(tile)
        before = FS.launches["weighted_update"]
        pk, mk, sk = update(cost, noise, lam_t)
        torch.cuda.synchronize()
        launched = FS.launches["weighted_update"] - before
        pp, mp, sp = update.plain(cost, noise, lam_t)
        u_err = float((pk / sk - pp / sp).abs().max())
        ok = (abs(float(mk - mp)) <= 1e-6 * (1 + abs(float(mp)))
              and abs(float(sk / sp - 1)) <= 1e-5
              and bool(((pk / sk - pp / sp).abs() <= 1e-4 * float((pp / sp).abs().max())).all())
              and launched == 1)
        S = tile or FS.tile_samples(K_, FS.sm_count())
        print(f"# weighted_update K={K_:5d} D={D_:3d} ld={noise.stride(0):3d} S={S:3d} "
              f"({-(-K_ // S)} blocks): m err {abs(float(mk - mp)):.3e} | s rel "
              f"{abs(float(sk / sp - 1)):.3e} | pert/s err {u_err:.3e} | launches {launched}"
              + ("" if ok else "  <-- FAIL"))
        check(ok, f"weighted update kernel disagrees with its plain version: K={K_} D={D_} "
                  f"S={S} ld={noise.stride(0)}")
        max_update_err["weighted_update"] = max(max_update_err.get("weighted_update", 0.0),
                                                u_err)
    # REPEATS calls in a row: the merging block sets the counter back to 0
    cost = torch.rand(K, generator=gen, device=dev) * 60 + 5
    noise = torch.randn(K, T * NU, generator=gen, device=dev)
    first = [v.clone() for v in LG.fused_weighted_update(cost, noise, lam_t)]
    outs = [LG.fused_weighted_update(cost, noise, lam_t) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for out in outs for a, b in zip(first, out))
    print(f"# weighted_update: {REPEATS} calls in a row identical to the first: {same}")
    check(same, "weighted_update: repeated calls differ (the merge counter did not reset)")
    print(f"# kernel vs plain: {len(legacy_cases)} rollout and {len(wu_cases)} weighted-update "
          f"cases agreed")

    # the ops-level kernels (ops/rowmajor.py).  The sampler: (name, K, T, nu,
    # config flags, sigma); the flagship takes block 1024 and K_pad 10,240,
    # K = 777 block 128.  The op is the config's: sigma's Cholesky diagonal
    # tiled, or kron(A_rho^T, chol^T).
    sig_full = torch.tensor([[1.0, 0.3], [0.3, 0.5]], device=dev)
    sig3 = torch.eye(3, device=dev) + 0.2 * (torch.ones(3, 3, device=dev) - torch.eye(3, device=dev))
    eye2 = torch.eye(NU, device=dev)

    def sampler_op(cfg, sig):
        z = torch.zeros(cfg.nu, device=dev)
        op = PS._transposed_operands(sig, z, z, z, cfg, cfg.T, cfg.nu, torch.float32)[1]
        return op.T.contiguous() if op.ndim == 2 else op

    sampler_cases = [
        ("diag", K, T, NU, {}, eye2),
        ("antithetic", K, T, NU, {"antithetic": True}, eye2),
        ("null_abs", K, T, NU, {"sample_null_action": True, "noise_abs_cost": True}, eye2),
        ("full_rho", K, T, NU, {"noise_rho": 0.5}, sig_full),
        ("K777_block128", 777, T, NU, {}, eye2),
        ("D300_full_rho", K, 100, 3, {"noise_rho": 0.5}, sig3),
        # D not a multiple of 4 (scalar loads and stores); mirror rows past K;
        # the null row with antithetic pairs
        ("D15", 1000, 15, 1, {}, torch.eye(1, device=dev)),
        ("D15_full_rho", 1000, 15, 1, {"noise_rho": 0.4}, torch.eye(1, device=dev) * 2),
        ("K777_antithetic", 777, T, NU, {"antithetic": True}, eye2),
        ("null_antithetic", K, T, NU, {"antithetic": True, "sample_null_action": True}, eye2),
    ]
    print("# sampler vs plain: perturbed rtol 1e-5 atol 1e-6, cost rtol 1e-4 atol 1e-4 "
          "(tpu_tests/test_tpu_pallas.py:497-500)")
    n_sampler = 0
    for name, K_, T_, nu, flags, sig in sampler_cases:
        D_ = T_ * nu
        cfg = MPPIConfig(nx=2, nu=nu, K=K_, T=T_, diag_sigma=not flags.get("noise_rho"), **flags)
        sample = RM.make_fused_sampler(cfg)
        args = (torch.randn(D_, generator=gen, device=dev) * 0.3, sampler_op(cfg, sig),
                torch.full((D_,), 0.05, device=dev), torch.full((D_,), -1.5, device=dev),
                torch.full((D_,), 1.5, device=dev), torch.randn(D_, generator=gen, device=dev))
        for mode in ("bits", "seed"):
            lead = (torch.randint(-2**31, 2**31 - 1, (sample.bits_rows, D_), dtype=torch.int32,
                                  generator=gen, device=dev) if mode == "bits"
                    else tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                             device=dev)))
            pk, ck = sample(lead, *args)
            torch.cuda.synchronize()
            pp, cp = sample.plain(lead, *args)
            p_err, c_err = float((pk - pp).abs().max()), float((ck - cp).abs().max())
            ok = (bool(torch.isfinite(pk).all() and torch.isfinite(ck).all())
                  and bool(((pk - pp).abs() <= 1e-6 + 1e-5 * pp.abs()).all())
                  and bool(((ck - cp).abs() <= 1e-4 + 1e-4 * cp.abs()).all()))
            print(f"# {mode:4s} sampler {name:16s} K={K_:5d} D={D_:3d} block {sample.block_k} "
                  f"bits {sample.bits_rows}x{D_} ({sample.blocks} blocks of "
                  f"{sample.geometry['threads']} threads): perturbed err {p_err:.3e} | cost err "
                  f"{c_err:.3e}" + ("" if ok else "  <-- FAIL"))
            check(ok, f"sampler kernel disagrees with its plain version: {mode}/{name}")
            max_update_err["sampler"] = max(max_update_err.get("sampler", 0.0), p_err)
            n_sampler += 1
    # the seed-mode draws' moments (tpu_tests/test_tpu_pallas.py:501-507)
    D = T * NU
    zeros, ones = torch.zeros(D, device=dev), torch.ones(D, device=dev)
    sample = RM.make_fused_sampler(MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True))
    z = sample((0x2468ACE0, 0x13579BDF), zeros, ones, zeros, zeros - 10, zeros + 10,
               zeros)[0].double()
    mean, std = float(z.mean()), float(z.std())
    print(f"# sampler seed-mode draws, sigma = I, bounds +-10: mean {mean:.5f} | std {std:.5f} "
          f"over {z.numel()} (limits |mean| < 0.02, |std - 1| < 0.02)")
    check(abs(mean) < 0.02 and abs(std - 1) < 0.02, "sampler seed-mode draws' moments")
    # one key: the sampler's normals are the transpose of the transposed
    # solve's with pair_block = block_k (ops/rowmajor.py)
    for anti in (False, True):
        cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True, antithetic=anti)
        sample = RM.make_fused_sampler(cfg)
        inf_t = torch.full((D,), math.inf, device=dev)
        key = (0x0BADF00D, 0xFEEDFACE)
        zs = sample(key, zeros, ones, zeros, -inf_t, inf_t, zeros)[0]
        zt = FS.make_transposed_fused_solve(cfg, lq, pair_block=sample.block_k,
                                            emit_perturbed=True)(
            key, torch.zeros(2, 1, device=dev).expand(2, K), zeros, ones, zeros, -inf_t,
            inf_t, zeros, torch.tensor(1.0, device=dev))[4]
        same = bool(torch.equal(zs, zt.T))
        print(f"# sampler seed mode vs the transposed kernel's normals, antithetic={anti}: "
              f"identical {same}")
        check(same, f"sampler seed-mode normals differ from the transposed kernel's ({anti})")

    # the round-1 solve: (name, model, K, T, nu, config flags, sigma, kernel
    # A's samples a block where forced)
    rowmajor_cases = [
        ("flagship", lq, K, T, NU, {}, eye2, None),
        ("K130_pad256", lq, 130, T, NU, {}, eye2, None),
        ("null_abs_uscale2_full", lq, K, T, NU,
         {"sample_null_action": True, "noise_abs_cost": True, "u_scale": 2.0}, sig_full, None),
        ("pendulum", PENDULUM_MODEL, 1000, 15, 1, {}, torch.tensor([[10.0]], device=dev), None),
        ("D300_global", lq3, K, 100, 3, {}, sig3, 128),
        ("D300_shared", lq3, K, 100, 3, {}, sig3, None),
        ("K1000_S64", lq, 1000, T, NU, {}, sig_full, 64),
    ]

    def rowmajor_args(model, T_, nu, sig, lam=1.0, bound=1.5):
        """x0, U, chol, mu, lo, hi, a_flat = λ·(U @ Σ⁻¹ᵀ) and λ of one case."""
        U = torch.randn(T_, nu, generator=gen, device=dev) * 0.3
        lam_t = torch.tensor(lam, device=dev)
        return (torch.tensor(X0[model.name], device=dev) if model.name in X0
                else torch.zeros(model.nx, device=dev), U, torch.linalg.cholesky(sig),
                torch.full((nu,), 0.05, device=dev), torch.full((nu,), -bound, device=dev),
                torch.full((nu,), bound, device=dev),
                (lam_t * (U @ torch.linalg.inv(sig).T)).reshape(-1), lam_t)

    n_rowmajor = 0
    for name, model, K_, T_, nu, flags, sig, tile in rowmajor_cases:
        D_ = T_ * nu
        solve = RM.make_fused_solve(MPPIConfig(nx=model.nx, nu=nu, K=K_, T=T_, **flags), model,
                                    tile_k=tile)
        for tiles in ("global", "shared"):
            check(not name.endswith("_" + tiles) or solve.tiles == tiles,
                  f"rowmajor/{name} did not take {tiles} tiles")
        args = rowmajor_args(model, T_, nu, sig, bound=2.0 if model is PENDULUM_MODEL else 1.5)
        for mode in ("bits", "seed"):
            lead = (torch.randint(-2**31, 2**31 - 1, (solve.K_pad, D_), dtype=torch.int32,
                                  generator=gen, device=dev) if mode == "bits"
                    else tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                             device=dev)))
            dk, mk, sk, ck = solve(lead, *args)
            torch.cuda.synchronize()
            dp, mp, sp, cp = solve.plain(lead, *args)
            check(all(bool(torch.isfinite(v).all()) for v in (dk, mk, sk, ck)),
                  f"rowmajor/{name}/{mode}: non-finite kernel output")
            ok, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp)
            print(f"# {mode:4s} rowmajor {name:22s} K={K_:5d} (K_pad {solve.K_pad}) D={D_:3d} "
                  f"S={solve.tile_k:3d} tiles={solve.tiles:6s} cost err {c_err:.3e} | m err "
                  f"{abs(float(mk - mp)):.3e} | s rel {abs(float(sk / sp - 1)):.3e} (tol "
                  f"{w_tol:.3e}) | delta/s err {u_err:.3e}" + ("" if ok else "  <-- FAIL"))
            check(ok, f"round-1 solve kernel disagrees with its plain version: {mode}/{name}")
            max_update_err["rowmajor"] = max(max_update_err.get("rowmajor", 0.0), u_err)
            n_rowmajor += 1
    # the moments through the cost (tpu_tests/test_tpu_pallas.py:574-596):
    # K = 4,096, T = 1, U = 0, x0 = 0, no bounds: one step of x' = x + u B^T
    # gives E[cost] = |goal|^2 + nu
    solve = RM.make_fused_solve(MPPIConfig(nx=2, nu=NU, K=4096, T=1), lq)
    free_u = torch.zeros(1, NU, device=dev)
    cost = solve((0x0F1E2D3C, 0x4B5A6978), torch.zeros(2, device=dev), free_u, eye2,
                 torch.zeros(NU, device=dev), -math.inf, math.inf,
                 torch.zeros(NU, device=dev), 1.0)[3]
    expected = float((goal ** 2).sum()) + NU
    print(f"# rowmajor seed-mode moments: mean cost {float(cost.mean()):.4f}, expected "
          f"{expected} (limit 0.35)")
    check(abs(float(cost.mean()) - expected) < 0.35, "round-1 solve seed-mode moments")
    # one key, chol = I, mu = 0, no antithetic: the round-1 kernel's costs
    # are the transposed kernel's
    cfg = MPPIConfig(nx=2, nu=NU, K=K, T=T, diag_sigma=True)
    x0, U, _, _, lo, hi, a_flat, lam_t = rowmajor_args(lq, T, NU, eye2)
    key = (0x5EED5EED, 0x00C0FFEE)
    cost_r = RM.make_fused_solve(cfg, lq)(key, x0, U, eye2, torch.zeros(NU, device=dev), lo, hi,
                                          a_flat, lam_t)[3]
    cost_t = FS.make_transposed_fused_solve(cfg, lq)(
        key, x0[:, None].expand(2, K), U.reshape(-1), ones, zeros, lo.repeat(T), hi.repeat(T),
        a_flat, lam_t)[3]
    x_err = float((cost_r - cost_t).abs().max())
    print(f"# rowmajor vs transposed kernel, one key, chol = I: cost max difference {x_err:.3e}")
    check(bool(((cost_r - cost_t).abs() <= 1e-5 + 2e-5 * cost_t.abs()).all()),
          "round-1 kernel's costs differ from the transposed kernel's on one key")
    same = repeats_agree(RM.make_fused_solve(cfg, lq), key,
                         (x0, U, eye2, torch.zeros(NU, device=dev), lo, hi, a_flat, lam_t))
    print(f"# rowmajor: {REPEATS} calls in a row identical to the first: {same}")
    check(same, "rowmajor: repeated calls differ (the merge counter did not reset)")
    print(f"# kernel vs plain: {n_sampler} sampler and {n_rowmajor} round-1 solve cases agreed")

    # -- 4. the main paths at full width ---------------------------------------
    stamp("4")
    def lq_step(x, action):
        return lq.dynamics(x[None], action[None])[0]

    MAIN = {  # the flagship problem of each controller
        "mppi": (MPPI, {}),
        "smppi": (SMPPI, dict(w_action_seq_cost=1.0, delta_t=1.0,
                              action_min=torch.tensor([-3.0, -3.0]),
                              action_max=torch.tensor([3.0, 3.0]))),
        "kmppi": (KMPPI, dict(num_support_pts=NSP, kernel=RBFKernel(2.0))),
    }

    def last_state_cost(states, actions):
        """The terminal cost as a full-trajectory hook (terminal_state_cost)."""
        return term(states[..., -1, :], actions[..., -1, :])

    def noisy_lq(s_, a, rng):
        """The flagship's plant plus N(0, STOCH_SCALE²) a step, drawn from the
        step's generator (stochastic_dynamics)."""
        return lq.dynamics(s_, a) + STOCH_SCALE * torch.randn(
            s_.shape, generator=rng, device=s_.device, dtype=s_.dtype)

    # the keywords of each path beyond the flagship's: the terminal loops
    # (the kernel terminal cost on the fused path, one launch a command; the
    # full-trajectory hook on the plain path), the iteration loops (ITERS
    # launches of kernel A a command, or ITERS of each legacy kernel), plain
    # MPPI with adaptive covariance (asked for the kernel: the plain path,
    # with a warning) and the stochastic loop (M = 4, the variance cost,
    # CVaR, the noisy plant model)
    class Ramps(SpecificActionSampler):
        """Two ramps from the command's state toward the goal (B = diag(1,
        -1)), the second twice as steep, decaying to 0 over the horizon."""

        num_trajectories = 2

        def sample_trajectories(self, state, info):
            d = (goal - state) * torch.tensor([1.0, -1.0], device=dev)
            w = torch.linspace(2.0 / T, 0.0, T, device=dev)
            return torch.stack([torch.outer(w, d), torch.outer(w, 2.0 * d)])

    # ... and the paths of the extensions: elite reuse on the fused kernel (with the
    # emitted perturbed set it reads), with three iterations, asked for the
    # kernel without fused_artifacts (the plain path, the warning naming the
    # flag) and on the legacy route; the sampler with the null row and elites
    # asked for the kernel (the plain path), SMPPI's and KMPPI's with the
    # sampler; gradient refinement on the fused route
    PATH_KW = {"fused_terminal": dict(terminal_final_cost=term),
               "plain_terminal_state": dict(terminal_state_cost=last_state_cost),
               "fused_iter3": dict(num_iterations=ITERS),
               "rollout_iter3": dict(num_iterations=ITERS),
               "plain_adaptive_iter3": dict(num_iterations=ITERS, adaptive_covariance=True),
               "plain_stochastic": dict(dynamics=noisy_lq, rollout_samples=M_STOCH,
                                        rollout_var_cost=0.1, risk_alpha=0.5,
                                        stochastic_dynamics=True),
               "fused_elites": dict(num_elites=ELITES, fused_artifacts=True),
               "fused_elites_iter3": dict(num_elites=ELITES, fused_artifacts=True,
                                          num_iterations=ITERS),
               "plain_elites_no_artifacts": dict(num_elites=ELITES),
               "rollout_elites": dict(num_elites=ELITES),
               "plain_sampler_elites": dict(specific_action_sampler=Ramps,
                                            sample_null_action=True, num_elites=2),
               "plain_sampler": dict(specific_action_sampler=Ramps),
               "fused_refine5": dict(gradient_refinement_steps=REFINE_STEPS)}
    # the slowest plain loops (adaptive covariance, the stochastic rollouts)
    # take SHORT_COMMANDS too, to keep the run's time
    PATH_COMMANDS = {"plain_sampler": SHORT_COMMANDS, "fused_refine5": REFINE_COMMANDS,
                     "plain_adaptive_iter3": SHORT_COMMANDS, "plain_stochastic": SHORT_COMMANDS}
    PATH_WARNS = {"plain_adaptive_iter3": "per-iteration noise/omega artifacts",
                  "plain_elites_no_artifacts": "fused_artifacts=True",
                  "plain_sampler_elites": "specific sampler", "plain_sampler": "specific sampler"}

    def flagship_ctrl(variant, use_pallas, path, seed=42):
        cls, extra = MAIN[variant]
        kw = dict(PATH_KW.get(path, {}))
        dynamics = kw.pop("dynamics", lq.dynamics)
        if "specific_action_sampler" in kw:  # a sampler of its own a controller
            kw["specific_action_sampler"] = kw["specific_action_sampler"]()
        with Captured() as cap:
            ctrl = cls(dynamics, lq.running_cost, nx=NX,
                       noise_sigma=torch.eye(NU, device=dev), num_samples=K, horizon=T,
                       lambda_=1.0, seed=seed, use_pallas=use_pallas, device=dev, **extra,
                       **kw)
        return ctrl, cap.messages

    def closed_loop(variant, use_pallas, path):
        ctrl, warned = flagship_ctrl(variant, use_pallas, path)
        commands = PATH_COMMANDS.get(path, COMMANDS)
        fused = bool(use_pallas) and not path.startswith("plain")
        check(ctrl._fns.fused == fused,
              f"{variant} {path} use_pallas={use_pallas!r} took the wrong route")
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(WARMUP):
            x = lq_step(x, ctrl.command(x))
        torch.cuda.synchronize()
        reset_launches()  # count the main path's launches only
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(commands)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(commands)]
        min_d = torch.tensor(float("inf"), device=dev)
        wall = time.perf_counter()
        for i in range(commands):
            starts[i].record()
            action = ctrl.command(x)
            ends[i].record()
            x = lq_step(x, action)
            min_d = torch.minimum(min_d, torch.linalg.norm(x - goal))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        launched = dict(FS.launches)
        lat = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        final_d = float(torch.linalg.norm(x - goal))
        check(action.shape == (NU,) and bool(torch.isfinite(ctrl.U).all()),
              f"{variant} main path gave a non-finite or misshapen action")
        return dict(median_ms=statistics.median(lat), p90_ms=lat[int(0.9 * len(lat))],
                    solves_per_s=commands / wall, min_dist=float(min_d),
                    final_dist=final_d, launches=launched, ctrl=ctrl, x=x, warned=warned,
                    commands=commands)

    main = {}
    paths = [(v, p, up) for v in FS.VARIANTS for p, up in (("fused", True), ("plain", False))]
    paths.append(("mppi", "rollout", "rollout"))  # the legacy kernel pair
    paths += [("mppi", "fused_terminal", True), ("mppi", "plain_terminal_state", False)]
    paths += [(v, "fused_iter3", True) for v in FS.VARIANTS]
    paths += [("mppi", "rollout_iter3", "rollout"), ("mppi", "plain_adaptive_iter3", True),
              ("mppi", "plain_stochastic", False)]
    paths += [("mppi", "fused_elites", True), ("mppi", "fused_elites_iter3", True),
              ("mppi", "plain_elites_no_artifacts", True), ("mppi", "rollout_elites", "rollout"),
              ("mppi", "plain_sampler_elites", True), ("smppi", "plain_sampler", True),
              ("kmppi", "plain_sampler", True), ("mppi", "fused_refine5", True)]
    for variant, path, use_pallas in paths:
        r = closed_loop(variant, use_pallas, path)
        main[variant, path] = r
        print(f"# main path [{variant} {path}] K={K} T={T}, {r['commands']} commands: median "
              f"{r['median_ms']:.4f} ms p90 {r['p90_ms']:.4f} ms (CUDA events) | "
              f"{r['solves_per_s']:.1f} solves/s (host clock) | min dist "
              f"{r['min_dist']:.3f} final dist {r['final_dist']:.3f} | launches "
              f"{r['launches']}")
        if (variant, path) == ("kmppi", "plain_sampler"):
            # KMPPI updates theta by each row's own support-point draw, also
            # for the rows the sampler wrote over after the interpolation
            # (the reference's _compute_perturbed_action_and_noise, JAX's
            # solve.py:1869-1876): when the ramps take the weight, theta
            # moves by draws that were never rolled out, and the loop drifts
            # in both packages.  It is held to finite actions and the rows.
            check(math.isfinite(r["final_dist"]), "the KMPPI sampler loop went non-finite")
            print(f"# [{variant} {path}] not held to the goal: the sampler's rows move "
                  f"theta by draws they replaced (the reference's KMPPI)")
        else:
            # bench.py:184's sanity check: reached the goal region and did not diverge
            check(r["min_dist"] < 1.0 and r["final_dist"] < 10.0,
                  f"{variant} {path} closed loop failed bench.py's sanity check")
        check((r["ctrl"].states is not None) == (path in ("plain_terminal_state",
                                                          "plain_stochastic")),
              f"{variant} {path}: the rollout states are kept only for terminal_state_cost "
              f"and M > 1")
        n = r["ctrl"].config.num_iterations * r["commands"]  # iterations in the loop
        if path.startswith("rollout"):
            expect = only(rollout=n, weighted_update=n)
        else:
            # kernel A merges its own partials: one launch an iteration
            expect = only(**{variant: n}) if r["ctrl"]._fns.fused else only()
        check(r["launches"] == expect,
              f"{variant} {path} path launched {r['launches']} for {r['commands']} "
              f"commands, expected {expect}")
        if path in PATH_WARNS:
            said = [m for m in r["warned"] if PATH_WARNS[path] in m]
            print(f"# [{variant} {path}] use_pallas=True took the plain path, warning: "
                  f"{said[0] if said else None!r}")
            check(bool(said), f"{variant} {path} with use_pallas=True did not warn")
        if r["ctrl"].config.num_elites:
            el = r["ctrl"]._state.elites
            print(f"# [{variant} {path}] stored elites {tuple(el.shape)}, finite "
                  f"{bool(torch.isfinite(el).all())}")
            check(tuple(el.shape) == (r["ctrl"].config.num_elites, T, NU)
                  and bool(torch.isfinite(el).all()),
                  f"{path}: the stored elites are misshapen or not finite")
        if path == "plain_stochastic":
            st = r["ctrl"].states
            differ = not torch.equal(st[0], st[1])
            # the flagship loops wander about the goal (sigma = I, lambda = 1):
            # their distance at the last command is a draw, so the goal check
            # is bench.py's, as for every flagship loop above
            print(f"# [{variant} {path}] states {tuple(st.shape)} | M slices differ {differ} | "
                  f"min dist {r['min_dist']:.4f}, final dist {r['final_dist']:.4f} (the "
                  f"deterministic plain loop's: {main['mppi', 'plain']['final_dist']:.4f})")
            check(tuple(st.shape) == (M_STOCH, K, T, NX) and differ,
                  "the stochastic loop's (M, K, T, nx) states are misshapen or identical in M")
    for (variant, path), r in main.items():
        # the refinement loop's some 2,400 kernels a command: 10 commands
        # keep the profiler's trace small
        breakdown(f"{variant} {path}", r["ctrl"], lq_step, r["x"],
                  n=10 if path == "fused_refine5" else 50)

    # the sampler loop's rows on one more command: [the null row, the two
    # ramps of this command's state, the last command's elites shifted], each
    # clamped to the bounds (none at the flagship), as JAX's
    # test_injection_rows_and_refresh
    r = main["mppi", "plain_sampler_elites"]
    c, x = r["ctrl"], r["x"]
    prev = c._state.elites.clone()
    c.command(x)
    lo, hi = c.u_min, c.u_max
    want = torch.cat([torch.zeros(1, T, NU, device=dev),
                      torch.clamp(Ramps().sample_trajectories(x, None), lo, hi),
                      torch.clamp(PS._shift_elites(prev, c.u_init), lo, hi)])
    rows_ok = torch.equal(c.perturbed_action[:5], want)
    print(f"# [mppi plain_sampler_elites] rows 0-4 are [null, ramp, ramp, elite, elite]: "
          f"{rows_ok}")
    check(rows_ok, "the sampler loop's leading rows are not [null, sampler rows, elites]")
    # SMPPI's rows are actions, clamped to the action bounds; KMPPI's the
    # full-horizon rows, clamped to the trajectory bounds
    for variant in ("smppi", "kmppi"):
        r = main[variant, "plain_sampler"]
        c, x = r["ctrl"], r["x"]
        c.command(x)
        lo, hi = ((c.action_min, c.action_max) if variant == "smppi" else (c.u_min, c.u_max))
        rows_ok = torch.equal(c.perturbed_action[:2],
                              torch.clamp(Ramps().sample_trajectories(x, None), lo, hi))
        print(f"# [{variant} plain_sampler] rows 0-1 are the clamped ramps: {rows_ok}")
        check(rows_ok, f"{variant}: the sampler's rows are not rows 0-1")

    # gradient refinement on JAX's small-K fixture (tests/test_extensions.py:
    # 603-622): K = 8, T = 8, sigma = 0.5 I, |u| <= 1, 10 commands from
    # [-3, -2], float64, 3 seeds; 20 descent steps must at least halve the
    # mean distance to the goal
    B64, G64 = B.double(), goal.double()

    def small_k(steps, seed):
        ctrl = MPPI(lambda s_, a: s_ + a @ B64.T, lambda s_, a: ((G64 - s_) ** 2).sum(-1),
                    nx=2, noise_sigma=0.5 * torch.eye(2, dtype=torch.float64, device=dev),
                    num_samples=8, horizon=8, lambda_=1.0, seed=seed,
                    u_max=torch.tensor([1.0, 1.0], dtype=torch.float64),
                    gradient_refinement_steps=steps, gradient_refinement_lr=0.1, device=dev)
        s_ = torch.tensor([-3.0, -2.0], dtype=torch.float64, device=dev)
        for _ in range(10):
            s_ = s_ + ctrl.command(s_) @ B64.T
        return float(torch.linalg.norm(G64 - s_))

    wall = time.perf_counter()
    base_d = [small_k(0, i) for i in range(3)]
    ref_d = [small_k(20, i) for i in range(3)]
    wall = time.perf_counter() - wall
    ratio = statistics.mean(ref_d) / statistics.mean(base_d)
    print(f"# small-K refinement fixture (K=8, T=8, 10 commands, float64, seeds 0-2): mean "
          f"distance {statistics.mean(base_d):.4f} unrefined {base_d}, "
          f"{statistics.mean(ref_d):.4f} with 20 steps {ref_d}: ratio {ratio:.4f} (limit 0.5) | "
          f"{wall:.1f} s")
    check(ratio < 0.5, f"gradient refinement did not halve the small-K distance: {ratio}")

    # the stochastic loop on one seed: two controllers give the same first ten
    # commands bit for bit (each step's generator is made from the seed)
    pair = [flagship_ctrl("mppi", False, "plain_stochastic", seed=7)[0] for _ in range(2)]
    xs = [torch.tensor([-3.0, -2.0], device=dev) for _ in pair]
    same = True
    for _ in range(10):
        acts = [c.command(x_) for c, x_ in zip(pair, xs)]
        same = same and torch.equal(acts[0], acts[1])
        xs = [lq_step(x_, a) for x_, a in zip(xs, acts)]
    print(f"# [mppi plain_stochastic] two controllers, seed 7: the first ten commands "
          f"identical {same}")
    check(same, "the seeded stochastic commands do not repeat bit for bit")
    del pair

    # the legacy route draws the plain path's noise: on one seed its step
    # agrees with the plain step up to the costs' summation order
    legacy_fns, plain_fns = main["mppi", "rollout"]["ctrl"]._fns, main["mppi", "plain"]["ctrl"]._fns
    params = main["mppi", "plain"]["ctrl"]._params
    for i in range(3):
        st = MPPIState(U=torch.randn(T, NU, generator=gen, device=dev) * 0.3, seed=1000 + i)
        x0 = torch.tensor([-3.0, -2.0], device=dev) + i
        s_l, _, art_l = legacy_fns.step(params, st, x0)
        s_p, _, art_p = plain_fns.step(params, st, x0)
        U0 = PS._shift_U(st.U, params.u_init)
        ok, c_err, u_err, w_tol = agree(art_l.cost_total, art_p.cost_total,
                                        (s_l.U - U0).reshape(-1), (s_p.U - U0).reshape(-1), 1.0)
        print(f"# legacy step vs plain step, seed {1000 + i}: cost err {c_err:.3e} | "
              f"update err {u_err:.3e} (tol {w_tol:.3e} of its largest element)"
              + ("" if ok else "  <-- FAIL"))
        check(ok, "the legacy route's step disagrees with the plain step")

    # the fused step with the terminal cost against the plain step's
    # arithmetic on the kernel's own perturbed actions (fused_artifacts) and
    # the same terminal cost, on one seed
    ctrl_t = MPPI(lq.dynamics, lq.running_cost, nx=NX, noise_sigma=torch.eye(NU, device=dev),
                  num_samples=K, horizon=T, lambda_=1.0, seed=42, use_pallas=True,
                  fused_artifacts=True, terminal_final_cost=term, device=dev)
    cfg_t, params = ctrl_t.config, ctrl_t._params
    st = MPPIState(U=torch.randn(T, NU, generator=gen, device=dev) * 0.3, seed=77)
    x0 = torch.tensor([-3.0, -2.0], device=dev)
    s_f, _, art_f = ctrl_t._fns.step(params, st, x0)
    U0 = PS._shift_U(st.U, params.u_init)
    noise2 = art_f.noise.reshape(K, -1)
    a_flat = (params.lambda_ * (U0 @ torch.linalg.inv(params.noise_sigma).T)).reshape(-1)
    cost_p = PS.rollout_costs(cfg_t, PS.wrap_dynamics(cfg_t, lq.dynamics),
                              PS.wrap_cost(cfg_t, lq.running_cost), x0, art_f.perturbed_action,
                              None, PS.wrap_final_cost(term))[0] + noise2 @ a_flat
    omega = PS.compute_weighting(cost_p, params.lambda_)[1]
    ok, c_err, u_err, w_tol = agree(art_f.cost_total, cost_p, (s_f.U - U0).reshape(-1),
                                    omega @ noise2, 1.0)
    print(f"# fused terminal step vs the plain step on its perturbed actions, seed 77: cost err "
          f"{c_err:.3e} | update err {u_err:.3e} (tol {w_tol:.3e} of its largest element)"
          + ("" if ok else "  <-- FAIL"))
    check(ok, "the fused step with a terminal cost disagrees with the plain step")

    # -- 4b. MPPI_Batched: examples/scenario_batch.py's problem -----------------
    stamp("4b")
    def batched_ctrl(N_, K_, T_, use_pallas, dynamics=None, **kw):
        return MPPI_Batched(dynamics or lq.dynamics, lq.running_cost, nx=NX,
                            noise_sigma=sigma_b, num_envs=N_, num_samples=K_, horizon=T_,
                            lambda_=1.0, u_min=-ub, u_max=ub, seed=0, use_pallas=use_pallas,
                            device=dev, **kw)

    def batched_starts(N_):
        g = torch.Generator(device=dev)
        g.manual_seed(42)
        return torch.rand(N_, NX, generator=g, device=dev) * 4 - 4  # uniform in [-4, 0]

    def batched_run(N_, K_, use_pallas, commands, **kw):
        ctrl = batched_ctrl(N_, K_, T, use_pallas, **kw)
        check(ctrl._fns.fused == bool(use_pallas),
              f"MPPI_Batched use_pallas={use_pallas!r} took the wrong route")
        x = batched_starts(N_)
        for _ in range(BATCH_WARMUP):
            x = lq.dynamics(x, ctrl.command(x))
        torch.cuda.synchronize()
        reset_launches()  # count the main path's launches only
        torch.cuda.reset_peak_memory_stats()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(commands)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(commands)]
        dists = []
        wall = time.perf_counter()
        for i in range(commands):
            starts[i].record()
            action = ctrl.command(x)
            ends[i].record()
            x = lq.dynamics(x, action)
            dists.append(torch.linalg.norm(goal - x, dim=-1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        lat = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        check(action.shape == (N_, NU) and bool(torch.isfinite(ctrl.U).all()),
              f"MPPI_Batched N={N_} gave a non-finite or misshapen action")
        dists = torch.stack(dists)
        return dict(median_ms=statistics.median(lat), p90_ms=lat[int(0.9 * len(lat))],
                    plant_solves_per_s=N_ * commands / wall, launches=dict(FS.launches),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30, ctrl=ctrl, x=x,
                    converged=int((dists.amin(dim=0) < 0.5).sum()),
                    settled=float(dists[-10:].mean()))

    batched = {}
    for N_, K_ in ((BATCH_N, BATCH_K), (BATCH_SMALL_N, BATCH_SMALL_K)):
        for path, use_pallas, n_cmd in (("operand", True, BATCH_COMMANDS),
                                        ("seed", "kernel_rng", BATCH_COMMANDS),
                                        ("plain", False, BATCH_PLAIN_COMMANDS)):
            r = batched_run(N_, K_, use_pallas, n_cmd)
            batched[N_, path] = r
            print(f"# main path [batched {path}] N={N_} K={K_} T={T}: command median "
                  f"{r['median_ms']:.4f} ms p90 {r['p90_ms']:.4f} ms (CUDA events, "
                  f"{n_cmd} commands) | {r['plant_solves_per_s']:.1f} plant-solves/s (host "
                  f"clock) | peak memory {r['peak_gib']:.2f} GiB | launches {r['launches']}")
            expect = only(batched=2 * n_cmd) if use_pallas else only()
            check(r["launches"] == expect,
                  f"batched {path} N={N_} launched {r['launches']}, expected {expect}")
            breakdown(f"batched {path} N={N_}", r["ctrl"], lq.dynamics, r["x"], n=20)
        # on one seed the operand step draws the plain step's noise
        ref = batched[N_, "plain"]["ctrl"]
        st = BatchedState(U=ref.U.clone(), seed=2024)
        x = batched_starts(N_)
        s_f, _, art_f = batched[N_, "operand"]["ctrl"]._fns.step(ref._params, st, x)
        s_p, _, art_p = ref._fns.step(ref._params, st, x)
        U0 = torch.roll(st.U, -1, dims=1)
        U0[:, -1] = ref._params.u_init
        ok, c_err, u_err, w_tol = agree(art_f.cost_total, art_p.cost_total,
                                        (s_f.U - U0).reshape(N_, -1).T,
                                        (s_p.U - U0).reshape(N_, -1).T, 1.0)
        print(f"# batched operand step vs plain step N={N_} K={K_}, one seed: cost err "
              f"{c_err:.3e} | update err {u_err:.3e} (tol {w_tol:.3e} of each plant's "
              f"largest element)" + ("" if ok else "  <-- FAIL"))
        check(ok, f"the batched operand step disagrees with the plain step at N={N_}")
        del s_f, s_p, art_f, art_p
        torch.cuda.empty_cache()

    # BATCH_ITERS iterations a command at the north-star width (twice the
    # launches), and stochastic dynamics on the plain path at N = 16; each
    # held to the scenario's goal check (phase 6): more than 90 % of the
    # plants come within 0.5 of the goal, and their mean distance over the
    # last 10 commands stays below 1.0
    for N_, K_, path, use_pallas, n_cmd, kw in (
            (BATCH_N, BATCH_K, "operand_iter2", True, BATCH_COMMANDS,
             dict(num_iterations=BATCH_ITERS)),
            (BATCH_N, BATCH_K, "seed_iter2", "kernel_rng", BATCH_COMMANDS,
             dict(num_iterations=BATCH_ITERS)),
            (BATCH_SMALL_N, BATCH_SMALL_K, "plain_stochastic", False, BATCH_PLAIN_COMMANDS,
             dict(dynamics=noisy_lq, stochastic_dynamics=True))):
        r = batched_run(N_, K_, use_pallas, n_cmd, **kw)
        batched[N_, path] = r
        print(f"# main path [batched {path}] N={N_} K={K_} T={T}: command median "
              f"{r['median_ms']:.4f} ms p90 {r['p90_ms']:.4f} ms (CUDA events, {n_cmd} "
              f"commands) | {r['plant_solves_per_s']:.1f} plant-solves/s (host clock) | peak "
              f"memory {r['peak_gib']:.2f} GiB | {r['converged']}/{N_} plants came within 0.5 "
              f"of the goal, mean distance over the last 10 commands {r['settled']:.4f} | "
              f"launches {r['launches']}")
        n_it = r["ctrl"].config.num_iterations
        expect = only(batched=2 * n_it * n_cmd) if use_pallas else only()
        check(r["launches"] == expect,
              f"batched {path} N={N_} launched {r['launches']}, expected {expect}")
        check(r["converged"] > 0.9 * N_ and r["settled"] < 1.0,
              f"batched {path} N={N_}: {r['converged']}/{N_} plants converged, settled at "
              f"{r['settled']}")
        breakdown(f"batched {path} N={N_}", r["ctrl"], lq.dynamics, r["x"], n=20)
        torch.cuda.empty_cache()
    op1 = batched[BATCH_N, "operand"]["launches"]["batched"]
    op2 = batched[BATCH_N, "operand_iter2"]["launches"]["batched"]
    print(f"# batched operand N={BATCH_N}: {op2} launches with num_iterations={BATCH_ITERS} "
          f"against {op1} with 1: ratio {op2 / max(op1, 1):.1f}")

    # the crossover: plain, operand and seed mode per command at N = 64, in
    # turns (plain, operand, seed, then seed, operand, plain) in this one call
    sweep = {}
    x64 = batched_starts(SWEEP_N)
    for K_ in SWEEP_KS:
        ctrls = {p: batched_ctrl(SWEEP_N, K_, T, up)
                 for p, up in (("plain", False), ("operand", "force"), ("seed", "kernel_rng"))}
        lat = {p: [] for p in ctrls}
        for order in (("plain", "operand", "seed"), ("seed", "operand", "plain")):
            for p in order:
                for _ in range(3):
                    ctrls[p].command(x64)
                torch.cuda.synchronize()
                ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(SWEEP_COMMANDS)]
                for a, b in ev:
                    a.record()
                    ctrls[p].command(x64)
                    b.record()
                torch.cuda.synchronize()
                lat[p] += [a.elapsed_time(b) for a, b in ev]
        sweep[K_] = {p: statistics.median(v) for p, v in lat.items()}
        print(f"# crossover sweep N={SWEEP_N} T={T} K={K_:5d}: median ms per command plain "
              f"{sweep[K_]['plain']:.4f} | operand {sweep[K_]['operand']:.4f} | seed "
              f"{sweep[K_]['seed']:.4f} (CUDA events, {2 * SWEEP_COMMANDS} commands each)")
    wins = [k for k in SWEEP_KS
            if all(sweep[k2]["operand"] < sweep[k2]["plain"] for k2 in SWEEP_KS if k2 >= k)]
    crossover = wins[0] if wins else None
    print(f"# crossover: the operand-mode kernel is faster than the plain path from K = "
          f"{crossover} on (of {list(SWEEP_KS)}); ops/solve._BATCHED_KERNEL_MIN_K = "
          f"{PS._BATCHED_KERNEL_MIN_K}" + ("" if crossover == PS._BATCHED_KERNEL_MIN_K
                                           else "  <-- differs (not a failure)"))

    def key_timing(name, solve, rest):
        """Seed mode with the Philox key by pointer (a (2,) int32 device
        tensor, as the commands pass it) against the key by value: the same
        results bit for bit, and the device times of CUDA graphs of 20 calls
        in turns (value, pointer, pointer, value).  Returns (pointer ms,
        value ms)."""
        key_dev = torch.tensor([1234, 5678], dtype=torch.int32, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(solve((1234, 5678), *rest),
                                                     solve(key_dev, *rest)))
        check(same, f"{name}: the key by pointer gives other results than by value")
        ms = {"value": [], "pointer": []}
        for mode in ("value", "pointer", "pointer", "value"):
            lead = (1234, 5678) if mode == "value" else key_dev
            ms[mode].append(graph_ms(lambda: solve(lead, *rest), 20))
        ptr, val = statistics.mean(ms["pointer"]), statistics.mean(ms["value"])
        print(f"# key by pointer [{name}]: results equal bit for bit {same} | device "
              f"{ptr:.6f} ms by pointer {ms['pointer']} against {val:.6f} ms by value "
              f"{ms['value']} (CUDA graphs of 20 calls, in turns): ratio {ptr / val:.4f} "
              f"(expected within 1.10)")
        return ptr, val

    # the kernels alone at the main paths' shapes and operands, at D = 300
    # (T = 100, nu = 3, full op) beside them, and kernel A's S sweep: each
    # variant's device time for S = 32, 64 and 128 at the flagship, at
    # K = 1,000 and at D = 300 (seed mode), against the rule's S
    timed, sweeps = {}, {}
    SHAPES = {"flagship": (lq, K, T, NU, NSP, 0.0), "K1000": (lq, 1000, T, NU, NSP, 0.0),
              "D300": (lq3, K, 100, 3, 50, 0.5)}
    for variant in FS.VARIANTS:
        for shape, (model, K_, T_, nu, nsp, rho) in SHAPES.items():
            cfg = MPPIConfig(nx=2, nu=nu, K=K_, T=T_, diag_sigma=not rho, noise_rho=rho,
                             num_support_pts=nsp if variant == "kmppi" else 0,
                             smppi=variant == "smppi")
            args = operands(variant, cfg, model, rho, 1.0, 0.0, inf,
                            3.0 if variant == "smppi" else inf, 1.0, 1.0, 1.0)
            tiled = {S: factories[variant](cfg, model, tile_k=S) for S in FS.TILES}
            sweep = {S: graph_ms(lambda f=f: f((1234, 5678), *args), 20)
                     for S, f in tiled.items()}
            rule = FS.tile_samples(K_, FS.sm_count())
            best = min(sweep, key=sweep.get)
            sweeps[variant, shape] = dict(ms=sweep, rule=rule, best=best)
            print(f"# S sweep [{variant} {shape} seed] K={K_} D={T_ * nu}: " + " | ".join(
                f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" (a CUDA graph of 20 calls) | "
                f"the rule's S={rule}: {sweep[rule] / sweep[best]:.3f} of the best (S={best}; "
                f"limit 1.1)")
            check(sweep[rule] <= 1.1 * sweep[best],
                  f"{variant} {shape}: the rule's S={rule} is more than 10 % slower than S={best}")
            if shape == "K1000":
                continue
            solve = factories[variant](cfg, model)
            R = (nsp if variant == "kmppi" else T_) * nu
            bits = torch.randint(-2**31, 2**31 - 1, (R, solve.bits_cols), dtype=torch.int32,
                                 generator=gen, device=dev)
            modes = (("seed", (1234, 5678)), ("bits", bits)) if shape == "flagship" else (
                ("seed", (1234, 5678)),)
            for mode, lead in modes:
                dev_ms = graph_ms(lambda: solve(lead, *args), 20)
                prof_ms, seen = device_ms(lambda: solve(lead, *args), 200,
                                          ("mppi_fused_partial",))
                call_ms = events_ms(lambda: solve(lead, *args), 500)
                plain_ms = events_ms(lambda: solve.plain(lead, *args), 50)
                ops, nbytes = fused_work(cfg, model, lead, args[0], args[3 if variant != "mppi"
                                                                         else 2],
                                         variant=variant)
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                t_ops = ops / H100_F32_PER_S * 1e3
                bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
                timed[variant, shape, mode] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by,
                                               prof_ms)
                print(f"# kernel alone [{variant} {shape} {mode}] K={K_} T={T_} S={solve.tile_k} "
                      f"tiles={solve.tiles}: device {dev_ms:.6f} ms (a CUDA graph of 20 calls) | "
                      f"profiler {prof_ms} ms ({seen} of 200 kernels) | per call "
                      f"{call_ms:.5f} ms (CUDA events, host wrapper included) | plain "
                      f"version {plain_ms:.5f} ms (CUDA events)")
                print(f"# bound [{variant} {shape} {mode}]: {nbytes} B -> {t_bytes:.3e} ms "
                      f"at 3.35 TB/s; {ops} operations -> {t_ops:.3e} ms at 67 TFLOP/s; "
                      f"bound by {bound_by}")
            if shape == "flagship":
                timed[variant, "key"] = key_timing(variant, solve, args)
                # with the final-state terminal cost, beside the time without it
                solve_t = factories[variant](cfg, model, terminal_final=term)
                t_ms = graph_ms(lambda: solve_t((1234, 5678), *args), 20)
                t_bound = bound(fused_work(cfg, model, (1234, 5678), args[0],
                                           args[3 if variant != "mppi" else 2], variant=variant,
                                           terminal=True))
                timed[variant, "terminal"] = (t_ms,) + t_bound
                if variant == "mppi":
                    # with ELITES elites (the perturbed set emitted, which
                    # the refresh reads) beside the same call without them
                    cfg_e = MPPIConfig(nx=2, nu=nu, K=K_, T=T_, diag_sigma=True,
                                       num_elites=ELITES)
                    solve_e = FS.make_transposed_fused_solve(cfg_e, model, emit_perturbed=True)
                    solve_emit = factories[variant](cfg, model, emit_perturbed=True)
                    el = torch.randn(ELITES, T_ * nu, generator=gen, device=dev)
                    e_ms = graph_ms(lambda: solve_e((1234, 5678), *args, el), 20)
                    emit_ms = graph_ms(lambda: solve_emit((1234, 5678), *args), 20)
                    e_bound = bound(fused_work(cfg_e, model, (1234, 5678), args[0], args[2],
                                               emit_perturbed=True, elites=el))
                    timed["mppi", "elites"] = (e_ms, emit_ms) + e_bound
                    print(f"# kernel alone [mppi flagship seed] with {ELITES} elites and the "
                          f"perturbed set emitted: device {e_ms:.6f} ms against {emit_ms:.6f} ms "
                          f"without the elites (ratio {e_ms / emit_ms:.4f}) and "
                          f"{timed[variant, shape, 'seed'][0]:.6f} ms without either (CUDA "
                          f"graphs of 20 calls) | bound {e_bound[0]:.3e} ms by {e_bound[1]}")
                print(f"# kernel alone [{variant} flagship seed] with the terminal cost: device "
                      f"{t_ms:.6f} ms (a CUDA graph of 20 calls) against {timed[variant, shape, 'seed'][0]:.6f}"
                      f" ms without: ratio {t_ms / timed[variant, shape, 'seed'][0]:.4f} | bound "
                      f"{t_bound[0]:.3e} ms by {t_bound[1]}")
    mppi_seed = timed["mppi", "flagship", "seed"][0]
    print(f"# MPPI kernel, seed mode, flagship: {mppi_seed:.5f} ms against the first port's "
          f"pair {FIRST_MPPI_SEED_MS} ms: ratio {mppi_seed / FIRST_MPPI_SEED_MS:.4f}")
    single_profiled = all(timed[v, "flagship", "seed"][5] is not None for v in FS.VARIANTS)

    # the batched kernel at the main paths' shapes and operands
    for N_, K_ in ((BATCH_N, BATCH_K), (BATCH_SMALL_N, BATCH_SMALL_K)):
        ctrl = batched[N_, "operand"]["ctrl"]
        D_ = T * NU
        x0T = batched[N_, "operand"]["x"].T
        aT = torch.einsum("ntu,vu->ntv", ctrl.U,
                          torch.linalg.inv(ctrl.noise_sigma)).reshape(N_, D_).T
        op = torch.full((D_,), math.sqrt(0.5), device=dev)
        rest = (x0T, ctrl.U.reshape(N_, D_).T, op, torch.zeros(D_, device=dev),
                torch.full((D_,), -1.0, device=dev), torch.full((D_,), 1.0, device=dev), aT,
                torch.tensor(1.0, device=dev))
        for mode in ("operand", "seed"):
            solve = FS.make_transposed_batched_solve(ctrl.config, N_, lq,
                                                     noise_operand=mode == "operand")
            lead = (torch.randn(D_, solve.K_pad, generator=gen, device=dev) * math.sqrt(0.5)
                    if mode == "operand" else (1234, 5678))
            dev_ms = graph_ms(lambda: solve(lead, *rest), 20)
            prof_ms, seen = device_ms(lambda: solve(lead, *rest), 20, BATCHED_NAMES)
            check(prof_ms is not None or not single_profiled,
                  f"the profiler saw no batched_partial time at N={N_} ({mode}) while it "
                  f"timed the single-plant pairs")
            call_ms = events_ms(lambda: solve(lead, *rest), 50)
            plain_ms = events_ms(lambda: solve.plain(lead, *rest), 3)
            work = fused_work(ctrl.config, lq, lead, x0T, op, variant="batched", plants=N_)
            bound_ms, bound_by = bound(work)
            timed["batched", N_, mode] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by,
                                          solve.plant_group, prof_ms)
            print(f"# kernel alone [batched {mode}] N={N_} K={K_} T={T} P={solve.plant_group} "
                  f"tiles={solve.tiles}: device {dev_ms:.6f} ms (a CUDA graph of 20 calls) | "
                  f"profiler {prof_ms} ms ({seen} of 40 kernels) | per call "
                  f"{call_ms:.5f} ms (CUDA events, host wrapper included) | plain version "
                  f"{plain_ms:.5f} ms | bound {bound_ms:.3e} ms by {bound_by}")
            if mode == "seed" and N_ == BATCH_N:
                timed["batched", "key"] = key_timing(f"batched N={N_}", solve, rest)
                # the earlier count took the shared draw once for every plant: N
                # times this count for one plant (the main path pairs no samples)
                one = fused_work(ctrl.config, lq, lead, x0T, op, variant="batched", plants=1)
                old_ms = bound((N_ * one[0], work[1]))[0]
                timed["batched_seed_bound_draw_per_plant"] = old_ms
                print(f"# bound [batched seed] N={N_}: {bound_ms:.4e} ms with the draw counted "
                      f"once a source column ({work[0]} operations) | {old_ms:.4e} ms with "
                      f"the draw counted once a plant ({N_ * one[0]} operations)")
            if N_ == BATCH_N and mode == "operand":
                # with the final-state terminal cost, beside the time without it
                solve_t = FS.make_transposed_batched_solve(ctrl.config, N_, lq, noise_operand=True,
                                                           terminal_final=term)
                t_ms = graph_ms(lambda: solve_t(lead, *rest), 20)
                t_bound = bound(fused_work(ctrl.config, lq, lead, x0T, op, variant="batched",
                                           plants=N_, terminal=True))
                timed["batched", "terminal"] = (t_ms,) + t_bound
                print(f"# kernel alone [batched operand] N={N_} with the terminal cost: device "
                      f"{t_ms:.6f} ms (a CUDA graph of 20 calls) against {dev_ms:.6f} ms without: "
                      f"ratio {t_ms / dev_ms:.4f} | bound {t_bound[0]:.3e} ms by {t_bound[1]}")
            # the P sweep: each plant group's device time in this mode
            sweep_ms = {}
            for P in PLANT_GROUPS:
                if P <= N_:
                    s_P = FS.make_transposed_batched_solve(ctrl.config, N_, lq,
                                                           noise_operand=mode == "operand",
                                                           group=P)
                    sweep_ms[P] = graph_ms(lambda: s_P(lead, *rest), 20)
            best = min(sweep_ms, key=sweep_ms.get)
            print(f"# P sweep [batched {mode}] N={N_} K={K_}: " + " | ".join(
                f"P={P} {v:.5f} ms" for P, v in sweep_ms.items()) + f" (a CUDA graph of 20 "
                f"calls, CUDA events) | the rule's P={solve.plant_group}: "
                f"{sweep_ms[solve.plant_group]:.5f} ms; best P={best}, "
                f"{sweep_ms[solve.plant_group] / sweep_ms[best]:.3f} of the rule's time")
        torch.cuda.empty_cache()
    op_ms, seed_ms = timed["batched", BATCH_N, "operand"][0], timed["batched", BATCH_N, "seed"][0]
    print(f"# batched kernel at N={BATCH_N} K={BATCH_K}: operand mode {op_ms:.5f} ms, seed "
          f"mode {seed_ms:.5f} ms: seed / operand {seed_ms / op_ms:.3f}")
    for N_, mode, key in ((BATCH_N, "operand", "batched_operand"),
                          (BATCH_N, "seed", "batched_seed"),
                          (BATCH_SMALL_N, "operand", "batched_small_operand")):
        ms = timed["batched", N_, mode][0]
        ref = BEFORE_MS[key]
        print(f"# batched pair [{mode}] N={N_}: {ms:.5f} ms against {ref} ms before: ratio "
              f"{ms / ref:.4f}")

    # the legacy route's kernels at the flagship shape
    x0_K = torch.tensor([-3.0, -2.0], device=dev)[None].expand(K, NX)
    u = torch.randn(K, T, NU, generator=gen, device=dev)
    rollout = LG.make_fused_rollout(MPPIConfig(nx=NX, nu=NU, K=K, T=T), lq)
    dev_ms = graph_ms(lambda: rollout(x0_K, u), 20)
    prof_ms = device_ms(lambda: rollout(x0_K, u), 200, ("fused_rollout",))[0]
    call_ms = events_ms(lambda: rollout(x0_K, u), 500)
    plain_ms = events_ms(lambda: rollout.plain(x0_K, u), 50)
    bound_ms, bound_by = bound(rollout_work(lq, x0_K, u))
    timed["rollout"] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by, None, prof_ms)
    cost = rollout(x0_K, u * 0.3) / 30  # costs of the size the main path weighs
    noise = torch.randn(K, T * NU, generator=gen, device=dev)
    lam1 = torch.tensor(1.0, device=dev)
    dev_wu = graph_ms(lambda: LG.fused_weighted_update(cost, noise, lam1), 20)
    prof_wu = device_ms(lambda: LG.fused_weighted_update(cost, noise, lam1), 200,
                        ("weighted_partial",))[0]
    call_wu = events_ms(lambda: LG.fused_weighted_update(cost, noise, lam1), 500)
    plain_wu = events_ms(lambda: LG.fused_weighted_update.plain(cost, noise, lam1), 200)
    # the yardstick: one PyTorch call for the same function (the update pert / s),
    # timed as the kernel is (a CUDA graph) and with its host time (events)
    lib_wu = graph_ms(lambda: torch.softmax(-cost / lam1, 0) @ noise, 20)
    timed["weighted_update_library_events"] = events_ms(
        lambda: torch.softmax(-cost / lam1, 0) @ noise, 500)
    bound_wu, by_wu = bound(weighted_update_work(K, T * NU))
    timed["weighted_update"] = (dev_wu, call_wu, plain_wu, bound_wu, by_wu, lib_wu, prof_wu)
    for name in ("rollout", "weighted_update"):
        d_ms, c_ms, p_ms, b_ms, b_by, l_ms, pr_ms = timed[name]
        print(f"# kernel alone [{name}] K={K} T={T}: device {d_ms:.6f} ms (a CUDA graph of 20 "
              f"calls) | profiler {pr_ms} ms | per call "
              f"{c_ms:.5f} ms (CUDA events, host wrapper included) | plain version {p_ms:.5f} "
              f"ms | library {l_ms} ms (a CUDA graph of 20 calls) | bound {b_ms:.3e} ms by "
              f"{b_by}")
    print(f"# library [torch.softmax(-cost / lam, 0) @ noise] K={K} D={T * NU}: "
          f"{lib_wu:.6f} ms (a CUDA graph of 20 calls) | "
          f"{timed['weighted_update_library_events']:.6f} ms (CUDA events, host included) | "
          f"the kernel's {dev_wu:.6f} ms is {dev_wu / lib_wu:.3f} of the graph time")
    # the weighted update's S sweep: 32, 64 and 128 samples a block at the
    # flagship and at D = 300, against the rule's S
    for shape, D_ in (("flagship", T * NU), ("D300", 300)):
        noise_s = noise if D_ == T * NU else torch.randn(K, D_, generator=gen, device=dev)
        sweep = {S: graph_ms(lambda f=LG.make_weighted_update(S): f(cost, noise_s, lam1), 20)
                 for S in FS.TILES}
        rule = FS.tile_samples(K, FS.sm_count())
        best = min(sweep, key=sweep.get)
        sweeps["weighted_update", shape] = dict(ms=sweep, rule=rule, best=best)
        print(f"# S sweep [weighted_update {shape}] K={K} D={D_}: " + " | ".join(
            f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" (a CUDA graph of 20 calls) | "
            f"the rule's S={rule}: {sweep[rule] / sweep[best]:.3f} of the best (S={best}; "
            f"limit 1.1)")
        check(sweep[rule] <= 1.1 * sweep[best],
              f"weighted_update {shape}: the rule's S={rule} is more than 10 % slower than "
              f"S={best}")
    # the rollout's S sweep: 32, 64 and 128 samples a block at the flagship and
    # at K = 1,000, against the rule's S
    for shape, K_ in (("flagship", K), ("K1000", 1000)):
        cfg_r = MPPIConfig(nx=NX, nu=NU, K=K_, T=T)
        sweep = {S: graph_ms(lambda f=LG.make_fused_rollout(cfg_r, lq, tile_k=S):
                             f(x0_K[:K_], u[:K_]), 20) for S in FS.TILES}
        rule = FS.tile_samples(K_, FS.sm_count())
        best = min(sweep, key=sweep.get)
        sweeps["rollout", shape] = dict(ms=sweep, rule=rule, best=best)
        print(f"# S sweep [rollout {shape}] K={K_} D={T * NU}: " + " | ".join(
            f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" (a CUDA graph of 20 calls) | "
            f"the rule's S={rule}: {sweep[rule] / sweep[best]:.3f} of the best (S={best}; "
            f"limit 1.1)")
        check(sweep[rule] <= 1.1 * sweep[best],
              f"rollout {shape}: the rule's S={rule} is more than 10 % slower than S={best}")
    d_ms, b_ms, b_by = timed["rollout"][0], timed["rollout"][3], timed["rollout"][4]
    print(f"# rollout at the flagship on {card}: {d_ms:.6f} ms (a CUDA graph of 20 calls) "
          f"against the parent's {BEFORE_MS['rollout']} ms: ratio {d_ms / BEFORE_MS['rollout']:.4f} "
          f"| bound {b_ms:.3e} ms by {b_by}: {d_ms / b_ms:.1f}x the bound")

    # -- 4c. the ops-level kernels' loops at the flagship ----------------------------
    stamp("4c")
    # No controller routes to them (as in JAX), so the loops are written out:
    # the round-1 solve, and JAX's "psampler" solve
    # (benchmarks/noise_experiments.py:139-147) built from port kernels only.
    # sigma = I, lambda = 1, no bounds, from [-3, -2] to the goal [2, 2].
    flag_cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
    lam1 = torch.tensor(1.0, device=dev)
    unbounded = (torch.full((NU,), -math.inf, device=dev), torch.full((NU,), math.inf, device=dev))
    LOOP_SEED = 7

    class OpsLoop:
        """A written-out closed loop: a fresh Philox key from the seed and a
        counter each command (or the given bits), U += update, act with
        U[0], shift in u_init = 0."""

        def __init__(self, bits_rows):
            self.U = torch.zeros(T, NU, device=dev)
            self.bits_rows = bits_rows
            self.counter = 0

        def lead(self, lead):
            if lead is None:
                lead = FS.key_to_seed((LOOP_SEED << 32) | self.counter)
                self.counter += 1
            return lead

        def advance(self, U):
            self.U = torch.roll(U, -1, 0)
            self.U[-1] = 0.0
            return U[0]

    class Round1Loop(OpsLoop):
        """``make_fused_solve`` with the caller's a_flat = λ·(U @ Σ⁻¹ᵀ) and
        U += delta / s."""

        def __init__(self):
            self.solve = RM.make_fused_solve(flag_cfg, lq)
            super().__init__(self.solve.K_pad)

        def command(self, x, lead=None, plain=False):
            a_flat = (lam1 * (self.U @ eye2)).reshape(-1)  # Σ⁻¹ᵀ = I
            fn = self.solve.plain if plain else self.solve
            delta, _, s, self.cost = fn(self.lead(lead), x, self.U, eye2,
                                        torch.zeros(NU, device=dev), *unbounded, a_flat, lam1)
            return self.advance(self.U + delta / s)

    class FrontEndLoop(OpsLoop):
        """The sampler, the legacy rollout on the scaled perturbed actions
        plus the action cost, the weighted update of perturbed − U, and
        U += pert / s: three launches a command."""

        def __init__(self):
            self.sample = RM.make_fused_sampler(flag_cfg)
            self.rollout = LG.make_fused_rollout(flag_cfg, lq)
            self.op, self.mu = torch.ones(T * NU, device=dev), torch.zeros(T * NU, device=dev)
            self.lo, self.hi = (b.repeat(T) for b in unbounded)
            super().__init__(self.sample.bits_rows)

        def command(self, x, lead=None, plain=False):
            sample, rollout, update = ((self.sample.plain, self.rollout.plain,
                                        LG.fused_weighted_update.plain) if plain else
                                       (self.sample, self.rollout, LG.fused_weighted_update))
            U2 = self.U.reshape(-1)
            a_flat = lam1 * U2  # λ·(U @ Σ⁻¹ᵀ) with Σ = I
            pert, pc = sample(self.lead(lead), U2, self.op, self.mu, self.lo, self.hi, a_flat)
            u_scaled = pert if flag_cfg.u_scale == 1.0 else pert * flag_cfg.u_scale
            self.cost = rollout(x[None].expand(K, NX), u_scaled.reshape(K, T, NU)) + pc
            upd, _, s = update(self.cost, pert - U2, lam1)
            return self.advance(self.U + (upd / s).reshape(T, NU))

    def ops_loop(ctrl):
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(WARMUP):
            x = lq_step(x, ctrl.command(x))
        torch.cuda.synchronize()
        reset_launches()  # count the loop's launches only
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(COMMANDS)]
        min_d = torch.tensor(float("inf"), device=dev)
        wall = time.perf_counter()
        for i in range(COMMANDS):
            starts[i].record()
            action = ctrl.command(x)
            ends[i].record()
            x = lq_step(x, action)
            min_d = torch.minimum(min_d, torch.linalg.norm(x - goal))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        lat = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        check(action.shape == (NU,) and bool(torch.isfinite(action).all()),
              "an ops-level loop gave a non-finite or misshapen action")
        return dict(median_ms=statistics.median(lat), p90_ms=lat[int(0.9 * len(lat))],
                    solves_per_s=COMMANDS / wall, min_dist=float(min_d),
                    final_dist=float(torch.linalg.norm(x - goal)), launches=dict(FS.launches),
                    ctrl=ctrl, x=x)

    ops_loops = {}
    for name, cls, expect in (("round1", Round1Loop, only(rowmajor=COMMANDS)),
                              ("sampler_front_end", FrontEndLoop,
                               only(sampler=COMMANDS, rollout=COMMANDS,
                                    weighted_update=COMMANDS))):
        r = ops_loop(cls())
        ops_loops[name] = r
        print(f"# main path [{name}] K={K} T={T}: command median {r['median_ms']:.4f} ms p90 "
              f"{r['p90_ms']:.4f} ms (CUDA events) | {r['solves_per_s']:.1f} solves/s (host "
              f"clock) | min dist {r['min_dist']:.3f} final dist {r['final_dist']:.3f} | "
              f"launches {r['launches']}")
        check(r["min_dist"] < 1.0 and r["final_dist"] < 10.0,
              f"{name} loop failed bench.py's sanity check")
        check(r["launches"] == expect,
              f"{name} loop launched {r['launches']} for {COMMANDS} commands, expected {expect}")
        breakdown(name, r["ctrl"], lq_step, r["x"])
    # one command of each loop on the same bits through the kernels and
    # through their plain versions
    x = torch.tensor([-1.0, 0.5], device=dev)
    for name, cls in (("round1", Round1Loop), ("sampler_front_end", FrontEndLoop)):
        ctrl_k, ctrl_p = cls(), cls()
        U0 = torch.randn(T, NU, generator=gen, device=dev) * 0.3
        ctrl_k.U, ctrl_p.U = U0.clone(), U0.clone()
        bits = torch.randint(-2**31, 2**31 - 1, (ctrl_k.bits_rows, T * NU), dtype=torch.int32,
                             generator=gen, device=dev)
        ctrl_k.command(x, bits)
        torch.cuda.synchronize()
        ctrl_p.command(x, bits, plain=True)
        # the updates, shifted by one step: U[:-1] after the command less U0[1:]
        new_k, new_p = ((c.U[:-1] - U0[1:]).reshape(-1) for c in (ctrl_k, ctrl_p))
        ok, c_err, u_err, w_tol = agree(ctrl_k.cost, ctrl_p.cost, new_k, new_p, 1.0)
        print(f"# {name} step, kernels vs plain versions on one set of bits: cost err "
              f"{c_err:.3e} | update err {u_err:.3e} (tol {w_tol:.3e} of its largest element)"
              + ("" if ok else "  <-- FAIL"))
        check(ok, f"the {name} step through the kernels disagrees with the plain versions")

    # the two kernels alone at the flagship: seed mode (the loops' mode) and
    # bits mode, with the loops' operands
    D = T * NU
    sample = RM.make_fused_sampler(flag_cfg)
    s_args = (torch.randn(D, generator=gen, device=dev) * 0.3, torch.ones(D, device=dev),
              torch.zeros(D, device=dev), *(b.repeat(T) for b in unbounded),
              torch.randn(D, generator=gen, device=dev))
    solve = RM.make_fused_solve(flag_cfg, lq)
    U = torch.randn(T, NU, generator=gen, device=dev) * 0.3
    r_args = (torch.tensor([-3.0, -2.0], device=dev), U, eye2, torch.zeros(NU, device=dev),
              *unbounded, (lam1 * U).reshape(-1), lam1)
    print(f"# sampler at the flagship: {sample.blocks} blocks of {sample.geometry['threads']} "
          f"threads ({sample.geometry['lanes']} lanes a row, {sample.geometry['rows']} rows a "
          f"block); {FS.sm_count()} SMs")
    for name, fn, args, rows, names in (
            ("sampler", sample, s_args, sample.bits_rows, ("fused_sampler",)),
            ("rowmajor", solve, r_args, solve.K_pad, ("mppi_fused_partial",))):
        for mode, lead in (("seed", (1234, 5678)),
                           ("bits", torch.randint(-2**31, 2**31 - 1, (rows, D), dtype=torch.int32,
                                                  generator=gen, device=dev))):
            dev_ms = graph_ms(lambda: fn(lead, *args), 20)
            prof_ms = device_ms(lambda: fn(lead, *args), 200, names)[0]
            call_ms = events_ms(lambda: fn(lead, *args), 500)
            plain_ms = events_ms(lambda: fn.plain(lead, *args), 50)
            work = (sampler_work(flag_cfg, sample, lead, s_args[1]) if name == "sampler" else
                    fused_work(flag_cfg, lq, lead, r_args[0], eye2, variant="rowmajor"))
            bound_ms, bound_by = bound(work)
            timed[name, mode] = (dev_ms, call_ms, plain_ms, bound_ms, bound_by, prof_ms)
            print(f"# kernel alone [{name} {mode}] K={K} T={T}: device {dev_ms:.6f} ms (a CUDA "
                  f"graph of 20 calls) | profiler {prof_ms} ms | "
                  f"per call {call_ms:.5f} ms (CUDA events, host wrapper included) | plain "
                  f"version {plain_ms:.5f} ms | bound {bound_ms:.3e} ms by {bound_by} "
                  f"({work[1]} B, {work[0]} operations)")
    # the sampler with antithetic pairs (one draw a pair) and with a full
    # operator at D = 300 (T = 100, nu = 3, noise_rho = 0.5), seed mode
    anti_cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True, antithetic=True)
    d300_cfg = MPPIConfig(nx=NX, nu=3, K=K, T=100, noise_rho=0.5)
    for name, cfg in (("antithetic", anti_cfg), ("D300_full_op", d300_cfg)):
        smp = RM.make_fused_sampler(cfg)
        D_ = cfg.T * cfg.nu
        op = sampler_op(cfg, eye2 if cfg.nu == NU else sig3)
        args = (torch.randn(D_, generator=gen, device=dev) * 0.3, op,
                torch.zeros(D_, device=dev), torch.full((D_,), -math.inf, device=dev),
                torch.full((D_,), math.inf, device=dev), torch.randn(D_, generator=gen, device=dev))
        dev_ms = graph_ms(lambda: smp((1234, 5678), *args), 20)
        plain_ms = events_ms(lambda: smp.plain((1234, 5678), *args), 20)
        work = sampler_work(cfg, smp, (1234, 5678), op)
        bound_ms, bound_by = bound(work)
        timed["sampler", name] = (dev_ms, None, plain_ms, bound_ms, bound_by, None)
        print(f"# kernel alone [sampler {name} seed] K={K} D={D_}: device {dev_ms:.6f} ms (a "
              f"CUDA graph of 20 calls; {smp.blocks} blocks of {smp.geometry['threads']} "
              f"threads) | plain version {plain_ms:.5f} ms | bound {bound_ms:.3e} ms by "
              f"{bound_by} ({work[1]} B, {work[0]} operations)")
    # the round-1 solve's S sweep at the flagship
    tiled = {S: RM.make_fused_solve(flag_cfg, lq, tile_k=S) for S in FS.TILES}
    sweep = {S: graph_ms(lambda f=f: f((1234, 5678), *r_args), 20) for S, f in tiled.items()}
    best = min(sweep, key=sweep.get)
    sweeps["rowmajor", "flagship"] = dict(ms=sweep, rule=solve.tile_k, best=best)
    print(f"# S sweep [rowmajor flagship seed] K={K} D={D}: " + " | ".join(
        f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" (a CUDA graph of 20 calls) | the "
        f"rule's S={solve.tile_k}: {sweep[solve.tile_k] / sweep[best]:.3f} of the best (S={best}; "
        f"limit 1.1)")
    check(sweep[solve.tile_k] <= 1.1 * sweep[best],
          f"rowmajor: the rule's S={solve.tile_k} is more than 10 % slower than S={best}")
    # every kernel against its time in the parent's run
    for name, ms in (("mppi", timed["mppi", "flagship", "seed"][0]),
                     ("smppi", timed["smppi", "flagship", "seed"][0]),
                     ("kmppi", timed["kmppi", "flagship", "seed"][0]),
                     ("rowmajor", timed["rowmajor", "seed"][0]),
                     ("mppi_D300", timed["mppi", "D300", "seed"][0]),
                     ("smppi_D300", timed["smppi", "D300", "seed"][0]),
                     ("kmppi_D300", timed["kmppi", "D300", "seed"][0]),
                     ("weighted_update", timed["weighted_update"][0]),
                     ("rollout", timed["rollout"][0]),
                     ("sampler", timed["sampler", "seed"][0]),
                     ("sampler_bits", timed["sampler", "bits"][0])):
        print(f"# {name}: {ms:.6f} ms against {BEFORE_MS[name]} ms before: ratio "
              f"{ms / BEFORE_MS[name]:.4f} (limit 1.1)")

    # -- 4d. run_mppi_jit: a CUDA graph of the loop step -------------------------
    stamp("4d")
    graph_report = graph_loops(dev, lq, goal)

    # -- 4e. learned dynamics: the residual MLP in the kernels ------------------
    stamp("4e")
    mlp = learned_dynamics(dev, gen)

    # -- 5. swing-up -------------------------------------------------------------
    stamp("5")
    reset_launches()
    ctrl = MPPI(pendulum_dynamics, pendulum_running_cost, nx=2,
                noise_sigma=torch.tensor([[10.0]], device=dev), num_samples=1000,
                horizon=15, lambda_=1.0, u_min=torch.tensor([-2.0]),
                u_max=torch.tensor([2.0]), use_pallas=True, device=dev)
    check(ctrl._fns.fused, "the pendulum did not route to the fused kernel")
    env = PendulumEnv(downward_start=True)
    run_mppi(ctrl, env, lambda dataset: None, iter=150, render=False)
    angle = abs(float(angle_normalize(env.state[0])))
    print(f"# swing-up: final |angle| {angle:.4f} after 150 steps, K=1000, T=15 | "
          f"launches {FS.launches['mppi']}")
    check(angle < 0.25, f"pendulum swing-up failed: final |angle| {angle}")
    check(FS.launches["mppi"] == 150, f"swing-up launched {FS.launches}, expected 150")

    # -- 6. closed loops through the kernels -------------------------------------
    stamp("6")
    # tests/test_mppi.py:744-771: K = 500, T = 15, sigma = I, 20 steps
    def lq_ctrl(cls, seed, **kw):
        c = cls(lq.dynamics, lq.running_cost, nx=2, noise_sigma=torch.eye(2, device=dev),
                num_samples=LOOP_K, horizon=15, lambda_=1.0, seed=seed, use_pallas=True,
                device=dev, **kw)
        check(c._fns.fused, f"{cls.__name__} LQ loop did not route to the fused kernel")
        return c

    reset_launches()
    dists = []
    for seed in (42, 43, 44):
        c = lq_ctrl(KMPPI, seed, num_support_pts=5, kernel=RBFKernel(2.0))
        x = torch.tensor([-3.0, -2.0], device=dev)
        for _ in range(20):
            x = lq_step(x, c.command(x))
        dists.append(float(torch.linalg.norm(x - goal)))
    c = lq_ctrl(SMPPI, 42, w_action_seq_cost=5.0)
    x = torch.tensor([-3.0, -2.0], device=dev)
    finite = True
    for _ in range(20):
        action = c.command(x)
        x = lq_step(x, action)
        finite = finite and bool(torch.isfinite(action).all() and torch.isfinite(x).all())
    finite = finite and bool(torch.isfinite(c.cost_total).all() and (c.cost_total >= 0).all())
    print(f"# LQ loops (K={LOOP_K}, T=15, 20 steps): KMPPI final dist {dists} mean "
          f"{sum(dists) / 3:.4f} | SMPPI finite {finite}, final dist "
          f"{float(torch.linalg.norm(x - goal)):.4f} | launches {FS.launches}")
    check(sum(dists) / 3 < 2.0, f"KMPPI LQ loop missed the goal: {dists}")
    check(finite, "SMPPI LQ loop went non-finite or gave a negative cost")
    check(FS.launches == only(smppi=20, kmppi=60), f"LQ loops launched {FS.launches}")

    # examples/smooth_mppi.py's comparison, without the terminal cost
    toy_common = dict(nx=2, noise_sigma=torch.eye(2, device=dev) * 0.2,
                      num_samples=LOOP_K, horizon=20, lambda_=1.0,
                      u_min=torch.tensor([-1.0, -1.0]), u_max=torch.tensor([1.0, 1.0]),
                      seed=42, use_pallas=True, device=dev)
    toy_ctrls = {
        "mppi": MPPI(toy.dynamics, toy.running_cost, **toy_common),
        "smppi": SMPPI(toy.dynamics, toy.running_cost, w_action_seq_cost=50.0, delta_t=1.0,
                       action_min=torch.tensor([-1.0, -1.0]),
                       action_max=torch.tensor([1.0, 1.0]), **toy_common),
        "kmppi": KMPPI(toy.dynamics, toy.running_cost, num_support_pts=5,
                       kernel=RBFKernel(2.0), **toy_common),
    }
    for name, c in toy_ctrls.items():
        check(c._fns.fused, f"toy2d {name} did not route to the fused kernel")
        reset_launches()
        x = toy.start.clone()
        total, actions = 0.0, []
        for _ in range(40):
            a = c.command(x)
            actions.append(a)
            total += float(toy.running_cost(x[None], a[None])[0])
            x = toy.dynamics(x[None], a[None])[0]
        acts = torch.stack(actions)
        smooth = float(torch.diff(acts, dim=0).abs().sum())
        in_bounds = bool(torch.isfinite(acts).all() and (acts.abs() <= 1.0).all())
        print(f"# toy2d [{name}] K={LOOP_K} T=20, 40 steps: accumulated cost {total:.2f} | "
              f"final dist {float(torch.linalg.norm(x - toy.goal)):.4f} | smoothness "
              f"{smooth:.3f} | actions finite and within +-1: {in_bounds} | launches "
              f"{FS.launches[name]}")
        check(in_bounds, f"toy2d {name}: actions non-finite or out of bounds")
        check(FS.launches[name] == 40, f"toy2d {name} launched {FS.launches}")

    # examples/scenario_batch.py's default loop through the kernel and on the
    # plain path, and the same loop at the north-star width through the
    # kernel.  A plant that reached the goal keeps moving about it (the
    # sampled update is noisy), so the share within 0.5 at the last step is
    # a draw, for the JAX package's own loop too, while every plant comes
    # within 0.5 during the loop (tests/test_torch_batched.py::
    # test_scenario_loop_settles_like_jax).  So a plant converged when it
    # came within 0.5 of the goal, and the plants' mean distance over the
    # last 10 steps must stay below 1.0.
    goal_b = torch.tensor([2.0, 2.0], device=dev)
    for N_, K_, T_, use_pallas in ((SCENARIO_N, SCENARIO_K, SCENARIO_T, "force"),
                                   (SCENARIO_N, SCENARIO_K, SCENARIO_T, False),
                                   (BATCH_N, BATCH_K, T, True)):
        reset_launches()
        c = batched_ctrl(N_, K_, T_, use_pallas)
        x = batched_starts(N_)
        dists = []
        for _ in range(SCENARIO_STEPS):
            x = lq.dynamics(x, c.command(x))
            dists.append(torch.linalg.norm(goal_b - x, dim=-1))
        dists = torch.stack(dists)
        converged = int((dists.amin(dim=0) < 0.5).sum())
        settled = float(dists[-10:].mean())
        print(f"# scenario loop N={N_} K={K_} T={T_} use_pallas={use_pallas!r}, "
              f"{SCENARIO_STEPS} steps: {converged}/{N_} plants came within 0.5 of the goal | "
              f"mean distance over the last 10 steps {settled:.4f} | at the last step "
              f"{int((dists[-1] < 0.5).sum())}/{N_} within 0.5, mean {float(dists[-1].mean()):.4f}"
              f" max {float(dists[-1].max()):.4f} | launches {FS.launches['batched']}")
        check(converged > 0.9 * N_ and settled < 1.0, f"scenario loop N={N_} "
              f"{use_pallas!r}: {converged}/{N_} plants converged, settled at {settled}")
        expect = only(batched=2 * SCENARIO_STEPS) if use_pallas else only()
        check(FS.launches == expect, f"scenario loop launched {FS.launches}, expected {expect}")

    # -- 8. the utilities: deploy artifacts, checkpoints, timer -----------------
    stamp("8")
    deployment(dev, lq, goal, mlp["params"])

    # -- 9. sharding -------------------------------------------------------------
    stamp("9")
    shard = sharding(dev, lq)

    # -- 10. the tuners ----------------------------------------------------------
    stamp("10")
    tuning(dev)

    # -- 11. the dynamics bridge: the user's own callables in the kernels --------
    stamp("11")
    gen_report = generated_models(dev, gen_plan, lq)

    # -- 12. the examples --------------------------------------------------------
    stamp("12")
    example_report = example_phase(dev, gen_plan, lq)

    # -- 7. the kernels line and the last line ---------------------------------
    stamp("7")
    sources = {"mppi": ("fused_mppi MPPI (mppi_fused_partial<..., kMPPI>, merged in the kernel)",
                        "pytorch_mppi_tpu/ops/pallas_rollout.py:512"),
               "smppi": ("fused_mppi SMPPI (mppi_fused_partial<..., kSMPPI>, merged in the "
                         "kernel)", "pytorch_mppi_tpu/ops/pallas_rollout.py:755"),
               "kmppi": ("fused_mppi KMPPI (mppi_fused_partial<..., kKMPPI>, merged in the "
                         "kernel)", "pytorch_mppi_tpu/ops/pallas_rollout.py:940")}

    def sweep_ms(key):
        return {str(S): v for S, v in sweeps[key]["ms"].items()}

    kernels = []
    for variant in FS.VARIANTS:
        dev_ms, call_ms, plain_ms, bound_ms, bound_by, prof_ms = timed[variant, "flagship", "seed"]
        g_ms = timed[variant, "D300", "seed"]
        b_ms = timed[variant, "flagship", "bits"]
        kernels.append({
            "name": sources[variant][0],
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": sources[variant][1],
            "launches": main[variant, "fused"]["launches"][variant],
            "max_abs_err": max_update_err[variant],
            # device time a call, replayed from a CUDA graph; the profiler's,
            # which may miss kernels, beside it
            "ms": dev_ms,
            "ms_source": "cuda_graph",
            "ms_profiler": prof_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "ms_bits_mode": b_ms[0],
            "ms_D300": g_ms[0],
            "bound_ms_D300": g_ms[3],
            "tile_k": sweeps[variant, "flagship"]["rule"],
            "ms_by_tile_k": sweep_ms((variant, "flagship")),
            "ms_by_tile_k_K1000": sweep_ms((variant, "K1000")),
            "ms_by_tile_k_D300": sweep_ms((variant, "D300")),
            "ms_terminal": timed[variant, "terminal"][0],
            "bound_ms_terminal": timed[variant, "terminal"][1],
            "launches_terminal_loop": (main[variant, "fused_terminal"]["launches"][variant]
                                       if variant == "mppi" else None),
            "launches_iter3_loop": main[variant, "fused_iter3"]["launches"][variant],
            # the commands pass the key by pointer (a CUDA graph of a command
            # reads it at each replay); "ms" above is by value, as before
            "ms_key_by_pointer": timed[variant, "key"][0],
            "ms_key_by_value": timed[variant, "key"][1],
            "launches_graph_loop": graph_report["routes"][f"{variant} fused"]["launches"][variant],
        })
    # kernel A with the elites operand (the elite columns of the TPU kernel)
    e_ms, emit_ms, e_bound, e_by = timed["mppi", "elites"]
    kernels[0].update(ms_elites=e_ms, ms_emit_perturbed=emit_ms, bound_ms_elites=e_bound,
                      bound_by_elites=e_by,
                      launches_elites_loop=main["mppi", "fused_elites"]["launches"]["mppi"],
                      launches_elites_iter3_loop=main["mppi", "fused_elites_iter3"][
                          "launches"]["mppi"],
                      launches_refine_loop=main["mppi", "fused_refine5"]["launches"]["mppi"])
    d_ms, c_ms, p_ms, b_ms, b_by, group, pr_ms = timed["batched", BATCH_N, "operand"]
    s_ms = timed["batched", BATCH_N, "seed"]
    small = timed["batched", BATCH_SMALL_N, "operand"]
    kernels.append({
        "name": "fused_mppi batched (batched_partial<Model, N, kGlobal> + flash_merge)",
        "route": "cuda",
        "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
        "replaces": "pytorch_mppi_tpu/ops/pallas_rollout.py:1118",
        "launches": batched[BATCH_N, "operand"]["launches"]["batched"],
        "max_abs_err": max_update_err["batched"],
        "ms": d_ms,
        "ms_source": "cuda_graph",
        "ms_profiler": pr_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "plant_group": group,
        "ms_seed_mode": s_ms[0],
        "bound_ms_seed_mode": s_ms[3],
        "bound_ms_seed_mode_draw_per_plant": timed["batched_seed_bound_draw_per_plant"],
        f"ms_N{BATCH_SMALL_N}_K{BATCH_SMALL_K}": small[0],
        "ms_terminal": timed["batched", "terminal"][0],
        "bound_ms_terminal": timed["batched", "terminal"][1],
        "launches_iter2_loop": batched[BATCH_N, "operand_iter2"]["launches"]["batched"],
        "ms_seed_mode_key_by_pointer": timed["batched", "key"][0],
        "ms_seed_mode_key_by_value": timed["batched", "key"][1],
        "launches_graph_loop_seed": graph_report["routes"]["batched seed"]["launches"]["batched"],
    })
    for name, line, main_key in (("rollout", 75, ("mppi", "rollout")),
                                 ("weighted_update", 172, ("mppi", "rollout"))):
        d_ms, c_ms, p_ms, b_ms, b_by, l_ms, pr_ms = timed[name]
        kernels.append({
            "name": {"rollout": "fused_rollout (rows staged in shared memory)",
                     "weighted_update": "weighted_partial (merged in the kernel)"}[name],
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": main[main_key]["launches"][name],
            "max_abs_err": max_update_err[name],
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "ms_profiler": pr_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": l_ms,
            "launches_iter3_loop": main["mppi", "rollout_iter3"]["launches"][name],
        })
    kernels[-2].update(tile_k=sweeps["rollout", "flagship"]["rule"],
                       ms_by_tile_k=sweep_ms(("rollout", "flagship")),
                       ms_by_tile_k_K1000=sweep_ms(("rollout", "K1000")))
    kernels[-1].update(library_ms_events=timed["weighted_update_library_events"],
                       tile_k=sweeps["weighted_update", "flagship"]["rule"],
                       ms_by_tile_k=sweep_ms(("weighted_update", "flagship")),
                       ms_by_tile_k_D300=sweep_ms(("weighted_update", "D300")))
    # no single PyTorch call samples, clamps and costs in one pass, or
    # computes an MPPI iteration: library_ms is null
    for name, label, line, loop in (
            ("sampler", "fused_sampler (fused_sampler_op<TR> for a full op)", 1350,
             "sampler_front_end"),
            ("rowmajor", "fused_mppi round-1 (mppi_fused_partial<..., kMPPI> rowmajor, merged in "
             "the kernel)", 1527, "round1")):
        d_ms, c_ms, p_ms, b_ms, b_by, pr_ms = timed[name, "seed"]
        bits_ms = timed[name, "bits"]
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": ops_loops[loop]["launches"][name],
            "max_abs_err": max_update_err[name],
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "ms_profiler": pr_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "ms_bits_mode": bits_ms[0],
            "bound_ms_bits_mode": bits_ms[3],
        })
        if name == "rowmajor":
            kernels[-1].update(tile_k=sweeps["rowmajor", "flagship"]["rule"],
                               ms_by_tile_k=sweep_ms(("rowmajor", "flagship")))
        else:
            kernels[-1].update(ms_antithetic=timed["sampler", "antithetic"][0],
                               bound_ms_antithetic=timed["sampler", "antithetic"][3],
                               ms_D300_full_op=timed["sampler", "D300_full_op"][0],
                               bound_ms_D300_full_op=timed["sampler", "D300_full_op"][3],
                               blocks=sample.blocks)
    # the residual MLP's instantiations (phase 4e): kernel A's variants and
    # the legacy rollout, launched by fused_kernel_demo's main path
    for key, label, line, loop in (
            ("mppi", "fused_mppi MPPI, residual MLP (mppi_fused_partial<ResidualMLP, 2, ..., "
             "kMPPI>, merged in the kernel)", 512, ("mppi", "fused")),
            ("smppi", "fused_mppi SMPPI, residual MLP (mppi_fused_partial<ResidualMLP, 2, ..., "
             "kSMPPI>)", 755, ("smppi", "fused")),
            ("kmppi", "fused_mppi KMPPI, residual MLP (mppi_fused_partial<ResidualMLP, 2, ..., "
             "kKMPPI>)", 940, ("kmppi", "fused")),
            ("rollout", "fused_rollout, residual MLP (fused_rollout<ResidualMLP, 2>)", 75,
             ("mppi", "rollout"))):
        d_ms, p_ms, b_ms, b_by = mlp["timed"][key]
        cases = [c for k, c in mlp["cases"].items() if (k if isinstance(k, str) else k[0]) == key]
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": mlp["loops"][loop]["launches"][key],
            "max_abs_err": mlp["max_err"][key],
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "samples_beyond_tolerance": sum(c["beyond"] for c in cases),
            "samples_at_the_wrap": sum(c["at_wrap"] for c in cases),
        })
        if key == "mppi":
            kernels[-1]["launches_graph_loop"] = mlp["loops"]["graph", "fused"]["launches"]["mppi"]
    # phase 9: kernel A with the null gate set against the static null row,
    # split over 8 shards (launches and merge), the largest error of a
    # merged split against the whole launch, and the launches of the
    # sharded main paths (rank 0 of the 2-rank world; the 1-rank NCCL world)
    sk, world = shard["kernels"], shard["world"][0]["routes"]
    for row, variant in zip(kernels, FS.VARIANTS):
        row.update(
            ms_gate_set=sk["ms"][variant, "gate"], ms_static_null=sk["ms"][variant, "whole"],
            ms_8_shards_merged=sk["ms"][variant, "shards"],
            max_abs_err_sharded=max(e["update"] for k, e in sk["errors"].items()
                                    if k[0] == variant),
            launches_sharded_gloo_rank0=world[f"{variant} fused"]["launches"][variant])
    kernels[0]["launches_sharded_nccl"] = shard["nccl"]["sharded"]["launches"]["mppi"]
    kernels[3]["launches_sharded_gloo_rank0"] = world["batched operand"]["launches"]["batched"]
    kernels += generated_kernel_rows(gen_report, gen_plan["build_s"])
    kernels.append(example_kernel_row(example_report))
    kernels[-1]["build_s"] = gen_plan["build_s"].get("lq batched")
    print(f"# chip_smoke total: {time.perf_counter() - START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
