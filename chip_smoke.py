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
4. main paths: 40 closed-loop commands (``COMMANDS``) of ``MPPI``, ``SMPPI`` and
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
   (the plain path, with the warning; ``SHORT_COMMANDS``), and plain ``MPPI``
   with M = 4 stochastic rollouts (``SHORT_COMMANDS``), the variance cost and
   CVaR on a noisy plant model
   (the (4, K, T, nx) states, their M slices differ, the loop comes within
   1.0 of the goal, and two controllers on one seed give the same first ten
   commands bit for bit); elite reuse (``num_elites = 4``) on the fused
   path with ``fused_artifacts`` (one launch a command, and three with
   ``num_iterations = 3``), asked for the kernel without ``fused_artifacts``
   (the plain path, the warning naming the flag) and on the legacy route;
   plain ``MPPI`` with a ``SpecificActionSampler`` of two ramps, the null
   row and two elites asked for the kernel (the plain path; rows 0-4 are
   [null, ramps, shifted elites]), 40 commands (``SHORT_COMMANDS``) each of
   ``SMPPI`` and ``KMPPI`` with the sampler, 30 fused commands with five steps of
   gradient refinement, and the refinement on JAX's small-K fixture (the
   mean distance at least halved); then
   ``MPPI_Batched`` on ``examples/scenario_batch.py``'s problem at N = 1,024,
   K = 16,384, T = 30 and at N = 16, K = 10,240: operand mode, seed mode and
   the plain path, the launch counts and the fused step held to the plain
   step on one seed; with ``num_iterations = 2`` at N = 1,024 in operand and
   seed mode (twice the launches) and with stochastic dynamics on the plain
   path at N = 16, each held to the scenario's goal check; the crossover
   sweep of the batched kernel (N = 64,
   K = 256 to 10,240); the ops-level kernels' loops at the flagship, 300
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
   JAX sizes (retraining through ``dynamics_params``, the plain path); the
   batched pair with the model (``batched_partial<ResidualMLP, 2, ...>``)
   against its plain version at N = 16, K = 10,240 in bits and seed mode
   and at N = 256, K = 4,096 in operand mode (the same tolerance and
   count), alone at the main path's shape, and on ``MPPI_Batched``'s main
   path (64 pendulums from angles pi ± 0.5, K = 10,000, 150 commands with
   one pair a command and no warning, at least 90 % ending with |angle| <
   0.5; its graph loop bit for bit); the N = 8 instantiations with a
   learned car's network ([9, 32, 32, 7], nx = 7, nu = 2, seeded random
   weights) against their plain versions (kernel A's three variants and
   the rollout at K = 10,000, the batched pair at N = 16), timed beside the
   nx = 2 model's, and 10 commands (``CAR_COMMANDS``) of each of its five routes with exact
   launch counts; and the trained network passed untagged, traced by the
   dynamics bridge into kernel A and the batched pair (their libraries
   built in phase 2), against their plain versions and timed beside the
   named instantiations in turns; then learned dynamics of any width
   (``wide_dynamics``): ``ResidualMLPBlock``, whose layers a block's threads
   compute together (on the tensor cores in 3xTF32), with each kernel's
   registers, spill stores and blocks an SM from the build logs, forced onto
   the trained [3, 32, 32, 2] and the car's [9, 32, 32, 7] networks in
   kernel A's three variants (bits and seed mode), the legacy rollout and
   the batched pair (bits, seed and operand mode), each cost within
   ``F64_FACTOR`` of the float32 plain version's error against a float64
   rollout (a sample at the angle's wrap excused), beside ``ResidualMLP``
   and timed with it in turns; a
   learned quadrotor's [16, 256, 256, 12] (nx = 12, nu = 4, beyond the
   per-thread bounds) at K = 10,000, T = 30 in kernel A's three variants
   and the rollout and at N = 16, K = 10,240 in the batched pair, and an
   untagged ``nn.Sequential`` of MBPO's shape, [16, 200, 200, 200, 200, 12]
   with SiLU, traced into dense layers (its two libraries built in phase
   2), in kernel A and the batched pair, each against its plain version on
   the kernel's draws with each cost's error against a float64 rollout
   within ``F64_FACTOR`` times the float32 plain version's, timed beside
   its two bounds (float32, and its dense layers on the tensor cores), its
   plain version and its time before the redesign (the rollout within 1.1x
   of it); 10 commands of each route on the
   quadrotor (MPPI, SMPPI, KMPPI fused, the legacy route, ``MPPI_Batched``)
   and of MPPI and ``MPPI_Batched`` on the MBPO network (no plain-path
   warning), each as its own plant, with exact ``*_block`` launch counts,
   a ``run_mppi_jit`` graph loop of the quadrotor's fused MPPI bit for
   bit against the eager loop, and a [16, 2048, 12] network in groups of 8
   samples (half an m16 tile) in kernel A, the batched pair and the
   rollout against their plain versions; then a TD-MPC world model
   (``world_model``, phase 4f); then the dynamics bridge's last refusals
   (``wide_programs``, phase 4g): a 16-agent planar swarm (nx = 64, nu =
   32, pairwise collision costs, no dense layer: a block program without
   layers), its five kernels built in one library, in kernel A's three
   variants and the rollout at K = 10,000, T = 30 and the batched pair at
   N = 16, K = 10,240; a program of the tracer's last primitives
   (``erfinv``, ``nextafter``, the shifts, ``cummax``, ``cummin``,
   ``logcumsumexp``, interior padding); the named ``linear_quadratic`` at
   nx = 64 (the trace of its callables); the flagship's named model beside
   a traced terminal cost with dense layers; the quadrotor's
   ``ResidualMLPBlock`` in the round-1 solve; the named toy2d at nx =
   64; and the swarm near ``MAX_OPS`` (38 agents, 15,124 operations a step,
   its library's functions in parts, a build of its own) in kernel A at T =
   10; each against its plain
   version and a float64 rollout, timed beside its bound with its
   registers and spills, then 10 swarm commands of ``MPPI(...,
   use_pallas=True)`` with exactly 10 ``generated_mppi_block`` launches
   against the plain route;
5. swing-up: the pendulum with ``use_pallas=True``, 150 steps;
6. closed loops through the kernels: the ``tests/test_mppi.py`` LQ problem
   (KMPPI reaches the goal, SMPPI stays finite), the toy2d comparison of
   ``examples/smooth_mppi.py`` (MPPI, SMPPI, KMPPI), and
   ``examples/scenario_batch.py``'s loops (N = 16 and N = 1,024: more than
   90 % of the plants end within 0.5 of the goal);
8. the utilities (``deployment``): the deploy artifact of fused MPPI (also
   with four elites and the terminal cost), SMPPI and KMPPI at the
   flagship, of MPPI's legacy route, of MPPI on the learned model and of
   ``MPPI_Batched`` in seed mode at N = 1,024, K = 16,384; with phase 11's
   traced models in the kernels, of fused MPPI with the traced terminal
   cost at the flagship, of ``MPPI_Batched`` in seed mode at N = 1,024, K =
   16,384 on ``scenario_batch``'s plant and of the legacy route on the
   step-dependent plant; and of fused MPPI with gradient refinement. Each
   is loaded in a fresh process that imports only the package and replays
   20 commands bit for bit against the live controller, with the launch
   counters read there and the artifact's command median beside the live
   one; a second fresh process with an empty kernel cache builds the traced
   fused artifact's library from its program alone and replays it too; a
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
13. JAX's real-chip lane (``tpu_lane``, ``tpu_tests/``): one case of
   ``TPU_LANE_CASES`` for each of its tests that no earlier phase holds
   (71 of 74; ``docs/PORT_TESTS.md`` maps them all), with JAX's fixture,
   seed, route and check: the behavioural contracts at K = 128, T = 8 on
   the plain route (``change_horizon``, stochastic rollouts, ``run_mppi_jit``
   as a CUDA graph, ...), the variants, the card against the CPU on one
   draw, a controller placed on the CPU that never touches the card,
   elites, the kernels at JAX's shapes against the plain path's
   arithmetic, the 1-rank NCCL world's meshes, the card's Philox, bfloat16,
   the quality floors at K = 500, T = 15, a deploy round trip and adaptive
   covariance; each case's launches counted (none on the plain route), one
   line a case;
7. the ``kernels`` line (eight kernels, the residual MLP's ten
   instantiations with each build part's ``nvcc`` seconds and the traced
   network's times beside them, the block models' seven rows, the world
   model's six, phase 4g's ten, the generated models' eight and phase
   12's generated batched pair), the
   card line, then the last line
   ``{"ok": true, "device": ...}``.
"""
import atexit
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
# on a slow host (a run at those depths took 1,135 s of the 1,200 s there),
# then from 500 to 300 to give back the time phase 8's traced artifacts take
# (a run of 861 s at 500, about 1,145 s at a slow host's 1.33x), then to 200
# for phase 4e's batched and nx = 7 MLP checks and the traced network's two
# libraries (a run of 869 s at 300, about 1,156 s at 1.33x), then to 150 for
# phase 4e's wide models and their two libraries (a run of 1,103.5 s at 200 on
# a host 1.5x slower in every phase than the one before), then to 100 so that
# the whole run stays under the limit on a host SLOW_HOST times slower (a run
# of 756.5 s at 150, phases 4 and 4d 110.7 and 170.9 s of it), then to 70 (and
# SHORT_COMMANDS with it) for phase 4f's world model and its six libraries,
# then to 50 (and SHORT_COMMANDS with it, REFINE_COMMANDS to 40, below it) for
# phase 8's stochastic artifacts and phase 10e (a run at 70 took 1,085.7 s on
# a host with a 353.7 s build phase), then to 40 (SHORT_COMMANDS with it,
# REFINE_COMMANDS to 30) for breakdowns of 10 commands in place of 3
COMMANDS = 40
REFINE_COMMANDS = 30
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
H100_TF32_PER_S = 495e12  # TF32 on the tensor cores, dense, H100 SXM data sheet
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
# the time limit this script runs under, and the slowdown of the slowest
# host seen against a typical one (a run of 1,076.0 s against 756.5 s, and
# build phases of 310.6 s against 197.8 s): the total times SLOW_HOST must
# stay under the limit
TIME_LIMIT_S, SLOW_HOST = 1200, 1.65
# the block models' kernels at phase 4e's shapes before their redesign for
# Hopper (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): the quadrotor's kernel A
# (three variants), batched pair and rollout, the MBPO network's kernel A and
# batched pair
BLOCK_BEFORE_MS = {("quad", "mppi"): 7.652802, ("quad", "smppi"): 7.897862,
                   ("quad", "kmppi"): 7.587165, ("quad", "batched"): 285.254248,
                   ("quad", "rollout"): 12.790965, ("mbpo", "mppi"): 18.045525,
                   ("mbpo", "batched"): 296.280444}
ROLLOUT_BLOCK_BEFORE_MS = BLOCK_BEFORE_MS["quad", "rollout"]
# the final-state terminal cost of the terminal cases and loops: w_state
# |x_T - goal|^2 + w_action |u_T|^2 toward the flagship's goal
TERMINAL_W = (1.0, 0.1)
PLANT_GROUPS = (1, 2, 4, 8, 16, 32)  # the P sweep of the batched kernel
REPEATS = 50  # calls in a row of one merging kernel: its merge counter resets
BATCHED_NAMES = ("batched_partial", "flash_merge")
ITERS, BATCH_ITERS = 3, 2  # num_iterations of the single-plant and batched iteration loops
ELITES = 4  # num_elites of the elite loops
REFINE_STEPS = 5  # gradient_refinement_steps of the refinement loop
SHORT_COMMANDS = 40  # the refinement loop's and SMPPI's and KMPPI's sampler loops' commands
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
# the residual MLP in the batched pair (phase 4e): against its plain version
# at N = 16, K = 10,240 (bits and seed mode) and N = 256, K = 4,096 (operand
# mode); the batched main path, MLP_MAIN_N pendulums from angles spread over
# pi ± 0.5, MLP_COMMANDS commands, of which at least MLP_MAIN_FRACTION must
# end with |angle| < 0.5
MLP_BATCH_N, MLP_BATCH_K = 16, 10_240
MLP_WIDE_N, MLP_WIDE_K = 256, 4096
MLP_MAIN_N, MLP_MAIN_FRACTION = 64, 0.9
# the residual MLP at nx = 7 (phase 4e): a learned car's network, [9, 32, 32,
# 7] (nu = 2, the heading, dimension 2, wrapped; the quadratic cost toward
# CAR_GOAL), with seeded random weights whose last layer is scaled by
# CAR_STEP (a learned model's step is small); CAR_COMMANDS commands of each
# route on the model as its own plant count its N = 8 instantiations'
# launches
CAR_SIZES, CAR_NX, CAR_NU, CAR_STEP = [9, 32, 32, 7], 7, 2, 0.1
CAR_GOAL = (1.0, -1.0, 3.0, 0.5, 1.5, -0.5, 0.25)
CAR_X0 = (0.5, -0.3, 2.9, 0.1, 1.0, -0.2, 0.4)
# (cut from 30 to 10 with the wide models' loops, whose batched commands
# take 0.3 s each)
CAR_COMMANDS = 10
# learned dynamics of any width (phase 4e, wide_dynamics): a learned
# quadrotor, nx = 12, nu = 4 (position, velocity, attitude and body rates;
# the four rotor commands), [16, 256, 256, 12] tanh with seeded random
# weights, the last layer scaled by QUAD_STEP, the quadratic cost toward
# QUAD_GOAL (a hover point), beyond the per-thread model's bounds, so on
# ResidualMLPBlock; a user's own nn.Sequential of MBPO's shape (Janner et
# al., NeurIPS 2019: four hidden layers of 200 SiLU units) on (state,
# action), a residual on the same plant, traced untagged into dense layers;
# their kernels against the plain versions on the kernel's draws, each
# cost's error against a float64 rollout of the same actions within
# F64_FACTOR times the float32 plain version's (the kernel sums each unit
# in input order, 256 products, the plain version's products in blocks:
# its rounding grows with the sum's length, up to sqrt(256) / sqrt(32) =
# 2.8 times a blocked sum's for random signs; the factor leaves room for
# the sums' tails), then CAR_COMMANDS closed-loop commands of every route
# on the model as its own plant
QUAD_SIZES, QUAD_NX, QUAD_NU, QUAD_STEP = [16, 256, 256, 12], 12, 4, 0.1
QUAD_GOAL = (1.0, -1.0, 2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
QUAD_X0 = (0.0, 0.0, 1.0, 0.2, -0.1, 0.0, 0.05, -0.05, 0.1, 0.0, 0.0, 0.0)
MBPO_SIZES = [16, 200, 200, 200, 200, 12]
F64_FACTOR = 8
WIDE_CALLS = 5  # calls in the CUDA graph that times the wide batched pairs
# phase 4e (iv): a residual MLP whose hidden layer is too wide for 16
# samples' activations in shared memory, so that the block kernels take
# groups of 8 (half an m16 tile)
HALF_TILE_SIZES = [16, 2048, 12]
# phase 4f (world_model): a TD-MPC world model (Hansen, Wang & Su, ICML 2022;
# github.com/nicklashansen/tdmpc, cfgs/default.yaml: latent_dim 50, mlp_dim
# 512, horizon 5, num_samples 512, iterations 6; src/algorithm/helper.py's
# mlp and q, tdmpc.py's TOLD) for the DMControl humanoid's 21 actions, its
# weights seeded (uniform within 1/sqrt(fan-in), nn.Linear's scale): the
# latent dynamics mlp [71, 512, 512, 50] (ELU), the running cost -gamma^t
# r(z', u) with the reward mlp [71, 512, 512, 1], the terminal cost -gamma^T
# min(Q1, Q2)(z_T, u_T), each q [71, 512 (LayerNorm, Tanh), 512 (ELU), 1];
# TD-MPC's planner sizes: sigma 0.25, actions in [-1, 1], lambda 0.5 (its
# temperature); the batched pair at TD_BATCH_N agents; kernel A once more at
# the DMControl dog's 38 actions (nu beyond 32); TD_COMMANDS commands of the
# closed loop in the latent space, TD_SHORT of every other route
TD_NX, TD_NU, TD_H, TD_K, TD_T, TD_ITERS = 50, 21, 512, 512, 5, 6
TD_GAMMA, TD_LAMBDA, TD_SIGMA = 0.99, 0.5, 0.25
TD_DOG_NU, TD_BATCH_N, TD_COMMANDS, TD_SHORT = 38, 16, 20, 5
# phase 4g (wide_programs): a planar swarm, a user's elementwise multi-body
# dynamics with pairwise collision costs (SWARM_AGENTS double integrators: nx
# their positions and velocities, nu their accelerations, SWARM_DT a step,
# actions within ±SWARM_U), sampled as bench.py's flagship (K = 10,000, T =
# 30, sigma I, lambda 1), its batched pair at BATCH_SMALL_N swarms of
# BATCH_SMALL_K samples, SWARM_COMMANDS closed-loop commands of the main path;
# the program of the tracer's last primitives at STEP4_NX, STEP4_NU
SWARM_AGENTS, SWARM_DT, SWARM_U, SWARM_COMMANDS = 16, 0.05, 2.0, 10
SWARM_NX, SWARM_NU = 4 * SWARM_AGENTS, 2 * SWARM_AGENTS
# ROADMAP Queue 2a's named toy2d beyond 32 states runs in phase 4g at nx =
# SWARM_NX, nu = SWARM_NU (toy64_model), and its program near MAX_OPS: the swarm
# at MAX_AGENTS agents (nx = 152, nu = 76, 15,124 scalar operations a step),
# kernel A at K = 10,000, T = MAX_T, its library a build of its own beside the
# others, its longest functions in parts of at most batch_last.CHUNK statements;
# MAX_BUILD_S the most seconds of nvcc that library may take
MAX_AGENTS, MAX_T, MAX_BUILD_S = 38, 10, 300
STEP4_NX, STEP4_NU = 8, 4
# the deployment phase (8): commands each artifact replays in a fresh process
# against the live controller, commands timed for the medians (after a
# warm-up), and the commands a restored checkpoint continues for
DEPLOY_COMMANDS, DEPLOY_TIMED, DEPLOY_WARMUP, CKPT_COMMANDS = 20, 200, 10, 10
# the refinement artifact's steps, and the timed commands of the artifacts
# whose commands run some hundreds of kernels (refinement, the plain path of
# stochastic dynamics): an export traces the refiner's backward pass through
# T steps (about 10 s a step count on a host core at M = 1, 40 s at M = 4)
DEPLOY_REFINE_STEPS, DEPLOY_REFINE_TIMED = 1, 20
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
# phase 10e: the generations with stochastic toy2d dynamics (N(0, TUNE_NOISE²)
# a step from each step's generator), without and with TUNE_REFINE_STEPS of
# gradient refinement, each held to the loop over the candidates TUNE_LOOPED,
# the first and the last, so that a fault of index or stride over the
# population shows (a candidate's streams are its own, so a subset checks
# those candidates; the whole loop of phase 10a takes 10-14 s, and a command
# with refinement about 90 ms on the host)
TUNE_NOISE, TUNE_REFINE_STEPS = 0.05, 1
TUNE_LOOPED = (0, TUNE_POP - 1)
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
# phase 13 (tpu_lane): JAX's real-chip lane, tpu_tests/, on the card, with
# its fixtures: the plant B, GOAL and START of tpu_tests/test_tpu_behavior.py
# (x' = x + u Bᵀ, cost |GOAL - x'|²), _ctrl's K = 128, T = 8, lambda 1 and
# seed 42, test_tpu_quality.py's K = 500, T = 15 over 20 steps; one case for
# each lane test that no earlier phase holds, named in docs/PORT_TESTS.md
LANE_B, LANE_GOAL, LANE_START = ((1.0, 0.0), (0.0, -1.0)), (2.0, 2.0), (-3.0, -2.0)
LANE_K, LANE_T, LANE_SEED = 128, 8, 42
QUALITY_K, QUALITY_T, QUALITY_STEPS = 500, 15, 20
TPU_LANE_CASES = (
    # tpu_tests/test_tpu_behavior.py::TestCore
    "action_shape_dtype", "cost_decreases_over_steps", "seeded_determinism_on_chip",
    "bounds_enforced", "symmetric_bound_completion", "terminal_cost_and_lazy_storage",
    "step_dependent_dynamics", "noise_abs_cost", "sample_null_action", "u_per_command",
    "rollout_samples_var_cost", "get_rollouts", "change_horizon_both_ways",
    "reset_resamples", "batch_state_input", "omega_sums_to_one", "scalar_sigma_1d_control",
    "u_scale_unscaled_storage", "shift_semantics", "num_iterations_on_chip",
    "run_mppi_jit_one_dispatch",
    # ::TestVariantsOnChip
    "smppi", "kmppi", "batched", "gradient_refinement_composes_with_fused_kernel",
    # ::TestCrossBackend
    "solve_matches_cpu_f32", "cpu_placed_controller_with_use_pallas",
    "cpu_placed_batched_controller_stays_on_cpu", "weighting_matches_cpu",
    # ::TestEliteReuseOnChip
    "elites_close_loop_on_chip", "use_pallas_with_elites_falls_back_without_artifacts",
    "use_pallas_with_elites_and_artifacts_stays_fused",
    # tpu_tests/test_tpu_pallas.py::TestCompiledKernels and ::TestTerminalFinalOnChip
    "pallas_rollout_matches_scan_compiled", "transposed_fused_closed_loop",
    "fused_artifacts_surface", "fused_artifacts_smppi_kmppi", "transposed_smppi_closed_loop",
    "transposed_kmppi_closed_loop", "transposed_batched_closed_loop",
    "batched_noise_operand_compiled", "sharded_fused_solve_one_device_mesh",
    "sharded_fused_null_and_artifacts_one_device_mesh",
    "sharded_batched_fused_one_device_mesh", "population_evaluator_with_fused_controller",
    "transposed_solve_compiled_pregen_bits", "transposed_solve_mlp_dynamics_compiled",
    "fused_sampler_compiled", "fused_solve_compiled_pregen_bits",
    "fused_solve_card_philox", "flash_weighting_matches_plain", "fused_rollout_compiled",
    "terminal_final_compiled_pregen_bits_parity", "terminal_final_routing_and_closed_loop",
    # tpu_tests/test_tpu_prng.py::TestRbg (the card's Philox) and ::TestBf16
    "card_philox_controller_converges", "card_philox_deterministic_same_seed",
    "card_philox_normal_moments", "bf16_sampling_finite", "bf16_controller_solve",
    "antithetic_on_chip", "philox_matches_cpu", "diag_fast_path_matches_matmul_path",
    # tpu_tests/test_tpu_quality.py::TestQualityFloors
    "mppi_final_distance", "kmppi_final_distance", "more_samples_beat_fewer",
    "works_for_short_and_long_horizons", "loop_bit_determinism",
    "bounds_hold_over_full_loop", "antithetic_quality", "noise_rho_quality",
    # tpu_tests/test_tpu_deploy.py
    "artifact_roundtrip_matches_live", "adaptive_solve_compiles_and_improves_plan",
)
# the lane's mesh cases, run in a 1-rank world of this process
LANE_MESH_CASES = ("sharded_fused_solve_one_device_mesh",
                   "sharded_fused_null_and_artifacts_one_device_mesh",
                   "sharded_batched_fused_one_device_mesh")
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
    for i in range(jobs["warmup"] + job.get("timed", jobs["timed"])):
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


# a serving host with a cold kernel cache (phase 8): it loads the traced fused
# artifact with _build.BUILD_DIR pointed at an empty directory of its own, so
# nvcc builds the generated library from the artifact's program alone, and
# replays the live controller's commands
COLD_CHILD = r"""
import json, shutil, sys, tempfile, time
from pathlib import Path
import numpy as np
import torch
from pytorch_mppi_tpu_torch.ops import _build
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.utils import deploy

job = json.load(open(sys.argv[1]))
_build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="cold-kernels-", dir=job["scratch"]))
start = time.perf_counter()
solver = deploy.load_solver(job["path"])
xs = torch.from_numpy(np.load(job["states"])).to(solver.device)
for name in FS.launches:
    FS.launches[name] = 0
acts = [solver.command(x) for x in xs]
if solver.device.type == "cuda":
    torch.cuda.synchronize()
np.save(job["actions"], torch.stack(acts).cpu().numpy())
report = dict(launches=dict(FS.launches), wall_s=time.perf_counter() - start,
              build_s={str(k.id): k.build_seconds for k in solver.kernels},
              built=sorted(p.name for p in _build.BUILD_DIR.iterdir()))
shutil.rmtree(_build.BUILD_DIR)
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
    if getattr(model, "program", None) is not None:
        # a generated model: scale, scalar nodes, dense layers (two a
        # multiply-add, one a bias), sum
        from pytorch_mppi_tpu_torch.ops.batch_last import _count_ops, dense_ops

        return (nu + _count_ops(model.program, model.outputs)
                + dense_ops(model.program, model.outputs) + 1)
    if model.name == "pendulum":  # scale 1, step 12, cost 9, sum 1
        return nu + 12 + 9 + 1
    if model.name in ("residual_mlp", "residual_mlp_block"):
        # scale; each layer's n_in * n_out fused multiply-adds and n_out bias
        # additions, tanh on the hidden units; the wrap (fmodf, compare, add,
        # two sums) on the way in and out, sin and cos of an encoded
        # dimension, the clip, the residual; the cost (pendulum 9, or a
        # difference and a multiply-add a state); the sum
        from pytorch_mppi_tpu_torch.ops.kernel_models import mlp_layout

        head = mlp_layout(model)
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
    constants (a traced one's dense layers, two operations a multiply-add
    and one a bias, once a sample).  An (E, D) ``elites`` operand is read once; its rows take the
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
        from pytorch_mppi_tpu_torch.ops.batch_last import _count_ops, dense_ops

        per_sample += (_count_ops(terminal.program, [terminal.output])
                       + dense_ops(terminal.program, [terminal.output]) + 1)
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


def _dense_macs(model):
    """The multiply-adds of a block model's dense layers a step (a traced
    model's dynamics and running cost: its ``outputs``), which its kernels
    run on the tensor cores (``block_dense`` in fused_mppi.cu); of a traced
    terminal cost's, once a sample; 0 for a per-sample model, whose step
    runs in float32 on the SM's cores.  ``_per_step`` and ``fused_work``
    count them too, as two float32 operations each."""
    if getattr(model, "output", None) is not None and getattr(model, "program", None):
        return sum(n_in * n_out for *_, n_in, n_out
                   in model.program.dense_layers([model.output]))
    if getattr(model, "program", None) is not None:
        return sum(n_in * n_out for *_, n_in, n_out in model.program.dense_layers(model.outputs))
    if model.name == "residual_mlp_block":
        from pytorch_mppi_tpu_torch.ops.kernel_models import mlp_layout

        w = mlp_layout(model)["widths"]
        return sum(a * b for a, b in zip(w, w[1:]))
    return 0


def tc_bound(work, macs):
    """The least time (ms) of a block model's kernel, and what bounds it:
    its ``macs`` dense multiply-adds on the tensor cores in 3xTF32 (three
    TF32 products of two flops each a multiply-add, at H100_TF32_PER_S),
    beside its other operations in float32 (``work``'s operations less two
    a multiply-add) and its bytes, whichever takes longest (the tensor
    cores and the float32 cores work at once)."""
    ops, nbytes = work
    return max((nbytes / H100_BYTES_PER_S * 1e3, "bytes"),
               ((ops - 2 * macs) / H100_F32_PER_S * 1e3, "operations"),
               (6 * macs / H100_TF32_PER_S * 1e3, "operations"))


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


def events_ms(fn, iters, warmup=3):
    """Mean time per call on the card's timeline, between two CUDA events,
    after ``warmup`` calls (none for a plain version just called, whose
    calls take seconds)."""
    for _ in range(warmup):
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


def captured(fn, iters):
    """A CUDA graph of ``iters`` calls of ``fn``, warmed up and replayed once."""
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
    return graph


def replay_ms(graph, iters, replays=1):
    """Device time per call of a graph of ``iters`` calls, replayed
    ``replays`` times back to back between two CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * replays)


def graph_ms(fn, iters):
    """Device time per call of ``fn`` replayed from a CUDA graph of ``iters``
    calls, between two CUDA events: no host time between the launches."""
    return replay_ms(captured(fn, iters), iters)


# the S sweeps' readings: three round trips over the S values, each reading
# as many back-to-back replays of a graph of 20 calls as fill SWEEP_WINDOW_MS
# of device time, and the median of the six.  A mean of one round trip of
# single replays let the rollout at K = 1,000 (about 3.5 µs a call) read
# S = 32 more than 10 % slower than S = 64 in one run and 7 % faster in
# another (NVIDIA H100 80GB HBM3, 700 W)
SWEEP_ROUNDS, SWEEP_WINDOW_MS = 3, 2.0
SWEEP_NOTE = (f"CUDA graphs of 20 calls replayed for {SWEEP_WINDOW_MS} ms a reading, in turns, "
              f"median of {2 * SWEEP_ROUNDS}")


def in_turns(fns, iters=20, rounds=1, window_ms=0.0):
    """Each callable's device time a call from a CUDA graph of ``iters``
    calls, read ``rounds`` times in turns forward then backward, and the
    median of the readings: one reading of a kernel of a few µs moves by
    more than the 10 % the S sweeps allow (the rollout at K = 1,000 once
    read 0.004138 ms at S = 32 on an H100 80GB HBM3 at 700 W, in a run where
    every S read 15-29 % above the run before).  Each graph is captured
    once; a reading replays it back to back until ``window_ms`` of device
    time is filled (at least once)."""
    graphs = {k: captured(fn, iters) for k, fn in fns.items()}
    replays = {k: max(1, math.ceil(window_ms / replay_ms(g, iters) / iters))
               for k, g in graphs.items()}
    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k in [*fns, *reversed(fns)]:
            ms[k].append(replay_ms(graphs[k], iters, replays[k]))
    del graphs
    return {k: statistics.median(v) for k, v in ms.items()}


def sweep_turns(fns):
    """``in_turns`` as the S sweeps read it (``SWEEP_NOTE``)."""
    return in_turns(fns, rounds=SWEEP_ROUNDS, window_ms=SWEEP_WINDOW_MS)


# commands a breakdown profiles, after one it does not (cut from 50 to keep
# the run inside its time, which gave back 82.6 s of phase 4, then from 25 for
# phase 4f's world model, then from 15 to 10 for phase 8's stochastic
# artifacts and phase 10e; COMMANDS and SHORT_COMMANDS paid for the rest)
BREAKDOWN_COMMANDS = 10


def breakdown(name, ctrl, step, x, n=BREAKDOWN_COMMANDS):
    """Where a command's time goes: device kernels per command from the
    profiler, and the device's idle share of the host-clock window, over
    ``n`` commands after one unprofiled command; and the seconds the
    breakdown took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    took = time.perf_counter()
    x = step(x, ctrl.command(x))
    torch.cuda.synchronize()
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
              for e in top) + f" | took {time.perf_counter() - took:.1f} s")


class Captured(logging.Handler):
    """The port's log records from ``level`` on while it is attached (the
    routing warnings; with ``logging.INFO`` the routing's info too)."""

    def __init__(self, level=logging.WARNING):
        super().__init__(level)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logger = logging.getLogger("pytorch_mppi_tpu_torch")
        self.before = logger.level
        if logger.getEffectiveLevel() > self.level:
            logger.setLevel(self.level)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logger = logging.getLogger("pytorch_mppi_tpu_torch")
        logger.removeHandler(self)
        logger.setLevel(self.before)


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
    stack, spills, compile_ms}``, and where it calls functions that are
    not inlined (a generated program's ``__noinline__`` parts, whose
    properties follow the kernel's), the largest stack frame and spill
    stores among them, ``part_stack`` and ``part_spills``."""
    out, cur, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(name=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and props == cur["name"]:
            cur.update(stack=int(m.group(1)), spills=int(m.group(2)))
        elif m:
            cur["part_stack"] = max(cur.get("part_stack", 0), int(m.group(1)))
            cur["part_spills"] = max(cur.get("part_spills", 0), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"Compile time = ([\d.]+) ms", line)
        if m:
            cur["compile_ms"] = float(m.group(1))
    return out


def wrap_edge(model, perturbed, x0T, idx, T_, nu, u_scale=1.0):
    """Of the samples ``idx``, those whose plain rollout over their (D, K)
    ``perturbed`` actions came within WRAP_EDGE of ±π (a wrapped state
    dimension of the residual MLP) at some step: a sample there may take
    the other branch of the wrap in the kernel, its state then differing
    by 2π; and each sample's least distance."""
    from pytorch_mppi_tpu_torch.ops.kernel_models import mlp_layout

    dims = list(mlp_layout(model)["wrap"])
    st = x0T.T[idx]
    dist = torch.full((idx.numel(),), math.inf, device=st.device)
    for t in range(T_ if dims else 0):
        st = model.dynamics(st, perturbed[t * nu:(t + 1) * nu, idx].T * u_scale)
        dist = torch.minimum(dist, (math.pi - st[:, dims].abs()).amin(dim=1))
    return idx[dist < WRAP_EDGE], dist


def batched_mlp_agree(model, solve, lead, rest, T_, nu):
    """The batched pair with a residual MLP against its plain version on the
    same inputs, under the MLP's tolerance: a sample of a plant beyond it
    is excused only where its plain rollout came within WRAP_EDGE of the
    wrap (the plant's perturbed actions rebuilt as the plain version draws
    them); m, s and delta/s as ``agree``.  Returns ``(ok, cost error,
    update error, samples beyond, of them at the wrap)``."""
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    x0T, U2T, op, mu, lo, hi, aT, lam = rest
    dk, msk, ck = solve(lead, *rest)
    torch.cuda.synchronize()
    dp, msp, cp = solve.plain(lead, *rest)
    N_, K_ = cp.shape
    beyond = (ck - cp).abs() > MLP_ATOL + MLP_RTOL * cp.abs()
    excused = torch.zeros_like(beyond)
    if bool(beyond.any()):
        noise = (lead[:, :K_] if solve.noise_operand else
                 FS._noise(lead, T_ * nu, K_, solve.pair_block, bool(solve.spec.antithetic), op,
                           mu, x0T.device))
        for n in beyond.any(dim=1).nonzero().flatten().tolist():
            pert = torch.clamp(U2T[:, n, None] + noise, lo[:, None], hi[:, None])
            edge, _ = wrap_edge(model, pert, x0T[:, n, None].expand(-1, K_),
                                beyond[n].nonzero().flatten(), T_, nu)
            excused[n, edge] = True
    ok, c_err, u_err, _ = agree(ck, cp, dk / msk[1], dp / msp[1], float(lam), msk[0], msp[0],
                                msk[1], msp[1], rtol=MLP_RTOL, atol=MLP_ATOL, excused=excused)
    ok = ok and all(bool(torch.isfinite(v).all()) for v in (dk, msk, ck))
    return ok, c_err, u_err, int(beyond.sum()), int(excused.sum())


def learned_car_params(dev):
    """The car's weights: ``CAR_SIZES`` seeded (``mlp_init``), the last layer
    scaled by ``CAR_STEP``."""
    from pytorch_mppi_tpu_torch.models import mlp_init

    params = mlp_init(CAR_SIZES, torch.Generator().manual_seed(19), torch.float32, dev)
    W, b = params[-1]
    params[-1] = (W * CAR_STEP, b * CAR_STEP)
    return params


def learned_car(dev):
    """Phase 4e's residual MLP at nx = 7: ``CAR_SIZES`` with seeded random
    weights (``learned_car_params``), the heading (dimension 2) wrapped, the
    quadratic cost toward ``CAR_GOAL``."""
    from pytorch_mppi_tpu_torch.ops.kernel_models import residual_mlp_model

    return residual_mlp_model(learned_car_params(dev), CAR_NX, CAR_NU, angle_wrap_dims=(2,),
                              cost="quadratic", goal=CAR_GOAL)


def untagged(model):
    """A kernel model's plain functions as the user's own callables, which
    carry no kernel model: the dynamics bridge traces them."""
    return (lambda s, u: model.dynamics(s, u), lambda s, u: model.running_cost(s, u))


def learned_dynamics(dev, gen):
    """Phase 4e: the residual MLP in the kernels (``examples/
    fused_kernel_demo.py``'s problem): its ``ResidualMLP`` instantiations
    against their plain versions, the kernels alone, the main path, a
    ``run_mppi_jit`` graph loop and ``pendulum_approximate``; the batched
    pair with the model against its plain version, alone and on
    ``MPPI_Batched``'s main path with its graph loop; the N = 8
    instantiations with a learned car's network (``learned_car``) against
    their plain versions, alone and in short loops; and the trained network
    passed untagged, traced by the dynamics bridge into kernel A and the
    batched pair, beside the named instantiations.  Returns the rows for the
    ``kernels`` line and PERF.md."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel, run_mppi_jit
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.examples import fused_kernel_demo as FKD
    from pytorch_mppi_tpu_torch.examples import pendulum_approximate
    from pytorch_mppi_tpu_torch.models import angle_normalize, pendulum_dynamics
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import solve as PS

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    report = {"cases": {}, "timed": {}, "loops": {}, "max_err": {},
              "car": {"cases": {}, "timed": {}, "loops": {}, "max_err": {}}}
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the plain versions' float32 products must not run in TF32")
    # the instantiations' registers, spills and stack (their activations
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
    car = learned_car(dev)
    report["params"] = params  # for the deployment phase
    print(f"# learned model [3, 32, 32, 2]: loss {loss:.5f} after 300 full-batch epochs on 8,192 "
          f"transitions, {time.perf_counter() - wall:.1f} s on the card")
    check(math.isfinite(loss) and loss < 0.1, f"the learned model did not train: loss {loss}")

    K_, T_ = MLP_K, MLP_T
    nsp = T_ // 2
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}

    def config(variant, nx=2, nu=1):
        return MPPIConfig(nx=nx, nu=nu, K=K_, T=T_, diag_sigma=True,
                          num_support_pts=nsp if variant == "kmppi" else 0,
                          smppi=variant == "smppi")

    shapes = {"residual_mlp": (model, 2, 1, [math.pi, 1.0], math.sqrt(10.0), report),
              "car [9, 32, 32, 7]": (car, CAR_NX, CAR_NU, list(CAR_X0), 1.0, report["car"])}
    ops_of = {label: mlp_operands(dev, gen, nx, nu, x0, sig)
              for label, (_, nx, nu, x0, sig, _) in shapes.items()}

    # kernel A's three variants against their plain versions at the demo's
    # shape, bits and seed mode, with the perturbed actions emitted; the
    # legacy rollout on clamped actions of the demo's scale
    print(f"# kernel vs plain [residual MLP]: cost rtol {MLP_RTOL} atol {MLP_ATOL} (the MLP's own: "
          f"30 steps through the network carry the matrix products' summation order), a sample "
          f"beyond it excused only where its plain rollout came within {WRAP_EDGE} of the wrap at "
          f"±pi; m, s and delta/s as the other cases (agree)")
    for label, (m, nx, nu, x0, sigma, out) in shapes.items():
        x0T, operands = ops_of[label]
        D = T_ * nu
        out["max_err"].update(dict.fromkeys(FS.VARIANTS + ("rollout",), 0.0))
        for variant in FS.VARIANTS:
            cfg = config(variant, nx, nu)
            R = nsp * nu if variant == "kmppi" else D
            solve = factories[variant](cfg, m, emit_perturbed=True)
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
                edge, dist = wrap_edge(m, pp, x0T, beyond, T_, nu)
                excused = torch.zeros(K_, dtype=torch.bool, device=dev)
                excused[edge] = True
                ok, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                                rtol=MLP_RTOL, atol=MLP_ATOL, excused=excused)
                ok = ok and all(bool(torch.isfinite(v).all()) for v in out_k)
                p_err = float((pk - pp).abs().max())
                ok = ok and bool(((pk - pp).abs() <= 1e-6 + 1e-5 * pp.abs()).all())
                within = (ck - cp).abs()
                within[beyond] = 0.0
                print(f"# {mode:4s} {variant:5s} {label} K={K_} D={D} S={solve.tile_k}: cost err "
                      f"{c_err:.3e} (within tolerance {float(within.max()):.3e}) | samples beyond "
                      f"tolerance {beyond.numel()}, at the wrap {edge.numel()} (least distances "
                      f"{[round(float(v), 8) for v in dist[:5]]}) | m err {abs(float(mk - mp)):.3e}"
                      f" | s rel {abs(float(sk / sp - 1)):.3e} (tol {w_tol:.3e}) | delta/s err "
                      f"{u_err:.3e} | perturbed err {p_err:.3e}" + ("" if ok else "  <-- FAIL"))
                check(ok, f"the residual-MLP kernel disagrees with its plain version: "
                      f"{label}/{mode}/{variant}")
                out["max_err"][variant] = max(out["max_err"][variant], u_err)
                out["cases"][variant, mode] = dict(beyond=beyond.numel(), at_wrap=edge.numel(),
                                                   cost_err=c_err, update_err=u_err)
        rollout = LG.make_fused_rollout(MPPIConfig(nx=nx, nu=nu, K=K_, T=T_), m)
        x0_K = torch.tensor(x0, device=dev)[None].expand(K_, nx)
        u = torch.clamp(torch.randn(K_, T_, nu, generator=gen, device=dev) * sigma, -2, 2)
        ck = rollout(x0_K, u)
        torch.cuda.synchronize()
        cp = rollout.plain(x0_K, u)
        beyond = ((ck - cp).abs() > MLP_ATOL + MLP_RTOL * cp.abs()).nonzero().flatten()
        edge, dist = wrap_edge(m, u.reshape(K_, D).T, x0T, beyond, T_, nu)
        r_err = float((ck - cp).abs().max())
        ok = bool(torch.isfinite(ck).all()) and edge.numel() == beyond.numel()
        print(f"# rollout {label} K={K_} D={D}: cost err {r_err:.3e} | samples beyond tolerance "
              f"{beyond.numel()}, at the wrap {edge.numel()}" + ("" if ok else "  <-- FAIL"))
        check(ok, f"the residual-MLP rollout disagrees with its plain version: {label}")
        out["max_err"]["rollout"] = r_err
        out["cases"]["rollout"] = dict(beyond=beyond.numel(), at_wrap=edge.numel(),
                                       cost_err=r_err)
        out["rollout_args"] = (rollout, x0_K, u)

    # the batched pair (batched_partial<ResidualMLP, N, kGlobal> + flash_merge)
    # against its plain version: the trained model at N = 16, K = 10,240 in
    # bits and seed mode and at N = 256, K = 4,096 in operand mode, the car
    # at N = 16 in bits and seed mode; one pair a call
    def lead_of(solve, mode, D, sigma):
        if mode == "bits":
            return torch.randint(-2**31, 2**31 - 1, (D, solve.bits_cols), dtype=torch.int32,
                                 generator=gen, device=dev)
        if mode == "seed":
            return tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen,
                                                       device=dev))
        return torch.randn(D, solve.K_pad, generator=gen, device=dev) * sigma

    spreads = {"residual_mlp": (0.5, 1.0), "car [9, 32, 32, 7]": (0.2,) * CAR_NX}
    batched_cases = [("residual_mlp", "bits", MLP_BATCH_N, MLP_BATCH_K),
                     ("residual_mlp", "seed", MLP_BATCH_N, MLP_BATCH_K),
                     ("residual_mlp", "operand", MLP_WIDE_N, MLP_WIDE_K),
                     ("car [9, 32, 32, 7]", "bits", MLP_BATCH_N, MLP_BATCH_K),
                     ("car [9, 32, 32, 7]", "seed", MLP_BATCH_N, MLP_BATCH_K)]
    for label, mode, N_, Kb in batched_cases:
        m, nx, nu, x0, sigma, out = shapes[label]
        cfg = MPPIConfig(nx=nx, nu=nu, K=Kb, T=T_, diag_sigma=True)
        solve = FS.make_transposed_batched_solve(cfg, N_, m, noise_operand=mode == "operand")
        rest = mlp_batched_rest(dev, gen, nx, nu, N_, x0, spreads[label], sigma)
        lead = lead_of(solve, mode, T_ * nu, sigma)
        reset_launches()
        ok, c_err, u_err, n_beyond, n_wrap = batched_mlp_agree(m, solve, lead, rest, T_, nu)
        pairs = dict(FS.launches)
        ok = ok and n_beyond == n_wrap and pairs == {k: 2 * (k == "batched") for k in pairs}
        print(f"# {mode:7s} batched {label} N={N_} K={Kb} D={T_ * nu} P={solve.plant_group} "
              f"tiles={solve.tiles}: cost err {c_err:.3e} | samples beyond tolerance {n_beyond}, "
              f"at the wrap {n_wrap} | delta/s err {u_err:.3e} | launches "
              f"{ {k: v for k, v in pairs.items() if v} }" + ("" if ok else "  <-- FAIL"))
        check(ok, f"the residual-MLP batched pair disagrees with its plain version: "
              f"{label}/{mode}")
        out["max_err"]["batched"] = max(out["max_err"].get("batched", 0.0), u_err)
        out["cases"]["batched", mode] = dict(beyond=n_beyond, at_wrap=n_wrap, cost_err=c_err,
                                             update_err=u_err)

    # the kernels alone (seed mode; the batched pair also at the main path's
    # shape in operand mode), a CUDA graph of 20 calls, beside the plain
    # version and the bound; the car's beside the trained model's
    key = (0x2468ACE0, 0x13579BDF)
    for label, (m, nx, nu, x0, sigma, out) in shapes.items():
        x0T, operands = ops_of[label]
        beside = "" if out is report else " | the nx = 2 model's {:.6f} ms"
        for variant in FS.VARIANTS:
            cfg = config(variant, nx, nu)
            solve = factories[variant](cfg, m)
            args = operands[variant]
            dev_ms = graph_ms(lambda: solve(key, *args), 20)
            plain_ms = events_ms(lambda: solve.plain(key, *args), 5)
            op = args[3] if variant != "mppi" else args[2]
            bound_ms, bound_by = bound(fused_work(cfg, m, key, x0T, op, variant=variant))
            out["timed"][variant] = (dev_ms, plain_ms, bound_ms, bound_by)
            print(f"# kernel alone [{variant} {label}] K={K_} T={T_} S={solve.tile_k}: device "
                  f"{dev_ms:.6f} ms (a CUDA graph of 20 calls) | plain version {plain_ms:.5f} ms | "
                  f"bound {bound_ms:.3e} ms by {bound_by}: {dev_ms / bound_ms:.1f}x | the linear "
                  f"model's flagship call before: {BEFORE_MS[variant]} ms"
                  + beside.format(report["timed"].get(variant, (math.nan,))[0]))
        rollout, x0_K, u = out["rollout_args"]
        dev_ms = graph_ms(lambda: rollout(x0_K, u), 20)
        plain_ms = events_ms(lambda: rollout.plain(x0_K, u), 5)
        bound_ms, bound_by = bound(rollout_work(m, x0_K, u))
        out["timed"]["rollout"] = (dev_ms, plain_ms, bound_ms, bound_by)
        print(f"# kernel alone [rollout {label}] K={K_} T={T_}: device {dev_ms:.6f} ms (a CUDA "
              f"graph of 20 calls) | plain version {plain_ms:.5f} ms | bound {bound_ms:.3e} ms by "
              f"{bound_by}: {dev_ms / bound_ms:.1f}x"
              + beside.format(report["timed"].get("rollout", (math.nan,))[0]))
        timed_batched = [("seed", MLP_BATCH_N, MLP_BATCH_K, "batched_N16_seed")]
        if out is report:
            timed_batched.insert(0, ("operand", MLP_MAIN_N, K_, "batched"))
        for mode, N_, Kb, name in timed_batched:
            cfg = MPPIConfig(nx=nx, nu=nu, K=Kb, T=T_, diag_sigma=True)
            solve = FS.make_transposed_batched_solve(cfg, N_, m, noise_operand=mode == "operand")
            rest = mlp_batched_rest(dev, gen, nx, nu, N_, x0, spreads[label], sigma)
            lead = lead_of(solve, mode, T_ * nu, sigma)
            dev_ms = graph_ms(lambda: solve(lead, *rest), 20)
            plain_ms = events_ms(lambda: solve.plain(lead, *rest), 3)
            bound_ms, bound_by = bound(fused_work(cfg, m, lead, rest[0], rest[2],
                                                  variant="batched", plants=N_))
            out["timed"][name] = (dev_ms, plain_ms, bound_ms, bound_by)
            print(f"# kernel alone [batched {label}] {mode} N={N_} K={Kb} T={T_} "
                  f"P={solve.plant_group}: device {dev_ms:.6f} ms (a CUDA graph of 20 calls) | "
                  f"plain version {plain_ms:.5f} ms | bound {bound_ms:.3e} ms by {bound_by}: "
                  f"{dev_ms / bound_ms:.1f}x"
                  + beside.format(report["timed"].get(name, (math.nan,))[0]))
        out.pop("rollout_args")

    # the traced MLP: the trained network's functions passed untagged, traced
    # by the dynamics bridge (its libraries built in phase 2 from a network of
    # the same shape: the header holds no weights), into kernel A (MPPI, seed
    # mode) and the batched pair (N = 16, K = 10,240, seed mode), against
    # their plain versions (the traced program's evaluator) and timed beside
    # the named instantiations in turns
    report["traced"] = {}
    try:
        traced = BL.kernel_model(config("mppi"), *untagged(model))
    except BL.UnsupportedPrimitive as e:
        traced = None
        report["traced"]["refused"] = str(e)
        print(f"# traced MLP: the tracer refuses the untagged network ({e}); the named "
              f"instantiations only")
    if traced is not None:
        x0T, operands = ops_of["residual_mlp"]
        cfg_b = MPPIConfig(nx=2, nu=1, K=MLP_BATCH_K, T=T_, diag_sigma=True)
        rest_b = mlp_batched_rest(dev, gen, 2, 1, MLP_BATCH_N, [math.pi, 1.0],
                                  spreads["residual_mlp"],
                              math.sqrt(10.0))
        pairs = {"mppi": (FS.make_transposed_fused_solve(config("mppi"), traced),
                          FS.make_transposed_fused_solve(config("mppi"), model),
                          operands["mppi"], "generated_mppi", 1, config("mppi"), "mppi", 1),
                 "batched": (FS.make_transposed_batched_solve(cfg_b, MLP_BATCH_N, traced),
                             FS.make_transposed_batched_solve(cfg_b, MLP_BATCH_N, model),
                             rest_b, "generated_batched", 2, cfg_b, "batched", MLP_BATCH_N)}
        for name, (t_solve, n_solve, args, counter, per_call, cfg, variant, N_) in pairs.items():
            reset_launches()
            if name == "mppi":
                dk, mk, sk, ck = t_solve(key, *args)
                torch.cuda.synchronize()
                launched = dict(FS.launches)
                dp, mp, sp, cp = t_solve.plain(key, *args)
                emitted = FS.make_transposed_fused_solve(config("mppi"), model,
                                                         emit_perturbed=True)
                pp = emitted.plain(key, *args)[4]  # the same draw: the wrap-edge rebuild
                beyond = ((ck - cp).abs() > MLP_ATOL + MLP_RTOL * cp.abs()).nonzero().flatten()
                edge, _ = wrap_edge(model, pp, x0T, beyond, T_, 1)
                excused = torch.zeros(K_, dtype=torch.bool, device=dev)
                excused[edge] = True
                ok, c_err, u_err, _ = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                            rtol=MLP_RTOL, atol=MLP_ATOL, excused=excused)
                n_beyond, n_wrap = beyond.numel(), edge.numel()
            else:
                ok, c_err, u_err, n_beyond, n_wrap = batched_mlp_agree(model, t_solve, key, args,
                                                                       T_, 1)
                launched = dict(FS.launches)
            expect = {k: per_call * (k == counter) for k in launched}
            ok = ok and n_beyond == n_wrap and launched == expect
            times = {"traced": [], "named": []}
            for which in ("named", "traced", "traced", "named"):
                f = t_solve if which == "traced" else n_solve
                times[which].append(graph_ms(lambda f=f: f(key, *args), 20))
            plain_ms = events_ms(lambda: t_solve.plain(key, *args), 1)  # about 1 s a call
            bound_ms, bound_by = bound(fused_work(cfg, traced, key, args[0], args[2],
                                                  variant=variant, plants=N_))
            t_ms, n_ms = statistics.mean(times["traced"]), statistics.mean(times["named"])
            report["traced"][name] = dict(ms=t_ms, named_ms=n_ms, ms_turns=times,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by, launches=launched[counter],
                                          max_abs_err=u_err, beyond=n_beyond, at_wrap=n_wrap)
            print(f"# traced MLP [{name}] seed K={cfg.K}" + (f" N={N_}" if N_ > 1 else "")
                  + f": {BL._count_ops(traced.program, traced.outputs)} scalar operations a "
                  f"step | cost err {c_err:.3e}, samples beyond tolerance {n_beyond}, at the wrap "
                  f"{n_wrap} | delta/s err {u_err:.3e} | launches "
                  f"{ {k: v for k, v in launched.items() if v} } | device {t_ms:.6f} ms against "
                  f"the named ResidualMLP's {n_ms:.6f} ms ({t_ms / n_ms:.3f}x; turns named, "
                  f"traced, traced, named: {[round(v, 6) for v in times['named'][:1]]}, "
                  f"{[round(v, 6) for v in times['traced']]}, "
                  f"{[round(v, 6) for v in times['named'][1:]]}) | plain version "
                  f"{plain_ms:.5f} ms | bound {bound_ms:.3e} ms by {bound_by}"
                  + ("" if ok else "  <-- FAIL"))
            check(ok, f"the traced MLP [{name}] disagrees with its plain version or launched "
                  f"{launched}")

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

    # the batched main path: MPPI_Batched on the model (use_pallas=True, the
    # operand mode at this K), MLP_MAIN_N pendulums from angles spread over
    # pi ± 0.5, one warm-up command then MLP_COMMANDS on the true plant, one
    # pair a command and no other launch, no warning when it is built, CUDA
    # events around each command
    def batched_planner(seed=42):
        return MPPI_Batched(model.dynamics, model.running_cost, 2,
                            torch.eye(1, device=dev) * 10.0, num_envs=MLP_MAIN_N,
                            num_samples=K_, horizon=T_, lambda_=1.0, u_min=torch.tensor(-2.0),
                            u_max=torch.tensor(2.0), seed=seed, use_pallas=True, device=dev)

    g_start = torch.Generator(device=dev)
    g_start.manual_seed(64)
    x_start = torch.stack([math.pi + torch.linspace(-0.5, 0.5, MLP_MAIN_N, device=dev),
                           torch.rand(MLP_MAIN_N, generator=g_start, device=dev) * 2 - 1], dim=1)
    with Captured() as warned:
        ctrl = batched_planner()
    check(ctrl._fns.fused and not warned.messages, f"MPPI_Batched with the residual MLP did not "
          f"take the batched kernel without a warning: fused {ctrl._fns.fused}, warnings "
          f"{warned.messages}")
    x = x_start
    reset_launches()
    ctrl.command(x)  # builds and warms up
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(MLP_COMMANDS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(MLP_COMMANDS)]
    wall = time.perf_counter()
    for i in range(MLP_COMMANDS):
        starts[i].record()
        a = ctrl.command(x)
        ends[i].record()
        x = pendulum_dynamics(x, a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    launched = dict(FS.launches)
    expect = {k: 2 * (MLP_COMMANDS + 1) * (k == "batched") for k in launched}
    angles = angle_normalize(x[:, 0]).abs()
    frac = float((angles < 0.5).float().mean())
    lat = sorted(b.elapsed_time(e) for b, e in zip(starts, ends))
    med, p90 = statistics.median(lat), lat[int(0.9 * len(lat))]
    print(f"# main path [residual MLP batched operand] N={MLP_MAIN_N} K={K_} T={T_}, "
          f"{MLP_COMMANDS} commands from angles pi ± 0.5 after one warm-up command: median "
          f"{med:.4f} ms p90 {p90:.4f} ms a command (CUDA events) | "
          f"{MLP_MAIN_N * MLP_COMMANDS / wall:.1f} plant-solves/s (host clock) | plants with "
          f"|angle| < 0.5 at the end {frac:.3f} (limit {MLP_MAIN_FRACTION}; largest |angle| "
          f"{float(angles.max()):.4f}) | launches { {k: v for k, v in launched.items() if v} }")
    check(launched == expect, f"residual MLP batched launched {launched}, expected {expect}")
    check(bool(torch.isfinite(x).all()) and frac >= MLP_MAIN_FRACTION,
          f"residual MLP batched: {frac:.3f} of the plants end with |angle| < 0.5")
    breakdown("residual MLP batched operand", ctrl, pendulum_dynamics, x, n=20)
    report["loops"]["batched", "fused"] = dict(launches=launched, median_ms=med, p90_ms=p90,
                                               fraction=frac,
                                               plant_solves_per_s=MLP_MAIN_N * MLP_COMMANDS / wall)
    del ctrl

    # run_mppi_jit with the model: the graph loop equal to the eager loop bit
    # for bit over GRAPH_STEPS steps, with exact launch counts; MPPI fused and
    # plain, and MPPI_Batched's pair
    graph_routes = (("fused", lambda: planner("mppi", True, 7), dict(mppi=1), torch.tensor(
                        [math.pi, 1.0], device=dev), pend_step),
                    ("plain", lambda: planner("mppi", False, 7), {}, torch.tensor(
                        [math.pi, 1.0], device=dev), pend_step),
                    ("batched", lambda: batched_planner(7), dict(batched=2), x_start,
                     pendulum_dynamics))
    for path, build, per_command, x0, plant in graph_routes:
        c_graph, c_eager = build(), build()
        reset_launches()
        states, actions, total = run_mppi_jit(c_graph, plant, x0, GRAPH_STEPS)
        torch.cuda.synchronize()
        launched = dict(FS.launches)
        cost = PS.wrap_cost(c_eager.config, c_eager.running_cost)
        batched_ = path == "batched"
        x, acc, xs, acts = x0, torch.zeros(MLP_MAIN_N if batched_ else (), device=dev), [], []
        for _ in range(GRAPH_STEPS):
            a = c_eager.command(x)
            x = plant(x, a)
            acc = acc + (cost(x, a, 0) if batched_ else cost(x[None], a[None], 0)[0])
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

    # the car's routes (its N = 8 instantiations): CAR_COMMANDS commands of
    # MPPI, SMPPI and KMPPI fused, MPPI's legacy route and MPPI_Batched's
    # pair (N = 16, seed mode) on the model as its own plant, exact launch
    # counts, finite actions, the distance to the goal printed
    lim = torch.full((CAR_NU,), 2.0)
    car_routes = [
        ("mppi", "fused", MPPI, True, {}, dict(mppi=1)),
        ("mppi", "rollout", MPPI, "rollout", {}, dict(rollout=1, weighted_update=1)),
        ("smppi", "fused", SMPPI, True, dict(w_action_seq_cost=1.0, delta_t=1.0,
                                             action_min=-lim, action_max=lim), dict(smppi=1)),
        ("kmppi", "fused", KMPPI, True, dict(num_support_pts=nsp, kernel=RBFKernel(2.0)),
         dict(kmppi=1)),
        ("batched", "fused", MPPI_Batched, "kernel_rng", dict(num_envs=MLP_BATCH_N),
         dict(batched=2)),
    ]
    goal = torch.tensor(CAR_GOAL, device=dev)
    for variant, path, cls, use_pallas, kw, per_command in car_routes:
        ctrl = cls(car.dynamics, car.running_cost, CAR_NX, torch.eye(CAR_NU, device=dev),
                   num_samples=K_, horizon=T_, lambda_=1.0, u_min=-lim, u_max=lim, seed=42,
                   use_pallas=use_pallas, device=dev, **kw)
        check(ctrl._fns.fused, f"car {variant} {path} took the plain path")
        batched_ = variant == "batched"
        x = torch.tensor(CAR_X0, device=dev)
        if batched_:
            x = x[None] + 0.2 * (torch.rand(MLP_BATCH_N, CAR_NX, generator=gen, device=dev) * 2
                                 - 1)
        start = (x - goal).norm(dim=-1).max()
        reset_launches()
        for _ in range(CAR_COMMANDS):
            a = ctrl.command(x)
            x = car.dynamics(x, a) if batched_ else car.dynamics(x[None], a[None])[0]
        torch.cuda.synchronize()
        launched = dict(FS.launches)
        expect = {k: CAR_COMMANDS * per_command.get(k, 0) for k in launched}
        print(f"# car loop [{variant} {path}] K={K_} T={T_}, {CAR_COMMANDS} commands on the model "
              f"as its plant: distance to the goal {float(start):.3f} -> "
              f"{float((x - goal).norm(dim=-1).max()):.3f} (largest) | launches "
              f"{ {k: v for k, v in launched.items() if v} }")
        check(launched == expect, f"car {variant} {path} launched {launched}, expected {expect}")
        check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(ctrl.U).all()),
              f"car {variant} {path}: non-finite states or actions")
        report["car"]["loops"][variant, path] = dict(launches=launched)
        del ctrl

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


def mlp_operands(dev, gen, nx, nu, x0, sigma):
    """Kernel A's operands for each variant at phase 4e's shape, K = MLP_K,
    T = MLP_T: every sample from ``x0``, a nominal U of scale 0.5, the
    action cost lambda U sigma^-2 (lambda = 1), the drawn rows' and the
    actions' bounds ±2."""
    from pytorch_mppi_tpu_torch import RBFKernel
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    K_, T_ = MLP_K, MLP_T
    nsp = T_ // 2
    D, R_k = T_ * nu, nsp * nu
    x0T = torch.tensor(x0, device=dev)[:, None].expand(nx, K_)
    full = lambda v, n=D: torch.full((n,), v, device=dev)  # noqa: E731
    lam, one = torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)
    U2 = torch.randn(D, generator=gen, device=dev) * 0.5
    a_flat = (U2 / sigma ** 2).contiguous()
    interp, _ = interpolation_operators(RBFKernel(2.0), T_, nsp, torch.float32, device=dev)
    Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
    return x0T, {
        "mppi": (x0T, U2, full(sigma), full(0.0), full(-2.0), full(2.0), a_flat, lam),
        "smppi": (x0T, U2, torch.randn(D, generator=gen, device=dev) * 0.5, full(sigma),
                  full(0.0), full(-2.0), full(2.0), full(-2.0), full(2.0), a_flat, lam, one, one),
        "kmppi": (x0T, U2, torch.randn(R_k, generator=gen, device=dev) * 0.5, full(sigma, R_k),
                  full(0.0, R_k), full(-2.0, R_k), full(2.0, R_k), full(-2.0), full(2.0), a_flat,
                  Wt, lam),
    }


def mlp_batched_rest(dev, gen, nx, nu, N_, x0, spread, sigma):
    """The batched operands at T = MLP_T: the plants from ``x0`` ± ``spread``
    (uniform; one value, or one a state dimension), a nominal U of scale 0.5
    each, the action cost lambda U sigma^-2, the bounds ±2."""
    D = MLP_T * nu
    spread = torch.as_tensor(spread, dtype=torch.float32, device=dev)
    x0T = torch.tensor(x0, device=dev)[:, None] + (spread[:, None] if spread.ndim else spread) * (
        torch.rand(nx, N_, generator=gen, device=dev) * 2 - 1)
    U2T = (torch.randn(N_, D, generator=gen, device=dev) * 0.5).T
    vec = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
    return (x0T, U2T, vec(sigma), vec(0.0), vec(-2.0), vec(2.0), U2T / sigma ** 2,
            torch.tensor(1.0, device=dev))


def f64_agree(model, c_k, c_p, pert, x0T, T_, nu, wrap=False, terminal=None):
    """The kernel's costs ``c_k`` and the plain version's ``c_p`` against a
    float64 reference on the plain version's (D, K) actions ``pert`` from
    the (nx, K) ``x0T``: the plain cost with its float32 rollout replaced by
    a float64 one of the same model.  ``(ok, kernel's error, plain's
    error, limit, excused)``: ok where the kernel's largest error is within
    the limit, F64_FACTOR times the plain version's (and never below 1e-6 of
    the largest cost: the float32 rounding of the totals, whose sums kernel and
    plain version take in other orders).  Where ``wrap`` (a residual MLP that
    wraps a state dimension), a sample beyond the limit is excused (the
    ``excused`` mask) where its plain rollout came within WRAP_EDGE of ±π
    (``wrap_edge``): the kernel may take the other branch of the wrap there,
    its state then differing by 2π.  A ``terminal`` cost (on the final state
    and the last action) is in both rollouts."""
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops.kernel_models import mlp_layout

    r32 = FS._rollout_total(model, pert, x0T, T_, nu, 1.0, terminal)
    r64 = FS._rollout_total(model, pert.double(), x0T.double(), T_, nu, 1.0, terminal)
    ref = c_p.double() - r32.double() + r64
    err = (c_k.double() - ref).abs()
    e_p = float((c_p.double() - ref).abs().max())
    limit = F64_FACTOR * max(e_p, 1e-6 * float(ref.abs().max()))
    excused = torch.zeros_like(err, dtype=torch.bool)
    beyond = (err > limit).nonzero().flatten()
    if wrap and beyond.numel() and mlp_layout(model)["wrap"]:
        edge, _ = wrap_edge(model, pert, x0T, beyond, T_, nu)
        excused[edge] = True
    e_k = float(err.masked_fill(excused, 0.0).max())
    return bool(torch.isfinite(c_k).all()) and e_k <= limit, e_k, e_p, limit, excused


def batched_pert(solve, lead, rest, T_, nu, K_):
    """The batched pair's (D, N·K) perturbed actions as its plain version
    draws them (each plant's clamp of U + the shared noise), and the plants'
    (nx, N·K) initial states, for ``f64_agree``."""
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    x0b, U2T, op, mu, lo, hi = rest[:6]
    noise = (lead[:, :K_] if solve.noise_operand else
             FS._noise(lead, T_ * nu, K_, solve.pair_block, bool(solve.spec.antithetic), op, mu,
                       x0b.device))
    pert = torch.clamp(U2T.T[:, :, None] + noise[None], lo[None, :, None], hi[None, :, None])
    pert = pert.permute(1, 0, 2).reshape(T_ * nu, -1)
    return pert, x0b[:, :, None].expand(-1, -1, K_).reshape(x0b.shape[0], -1)


def block_ptxas(plan, labels=("mbpo mppi", "mbpo batched"), named=True):
    """The block models' kernels in the build logs (``-Xptxas -v``): each
    ``ResidualMLPBlock`` instantiation of the named library (where
    ``named``) and the generated kernels of the builds ``labels`` (the MBPO
    network's kernel A and batched pair), with its registers, spill stores
    and the blocks an SM its registers allow (four warps a block; registers
    allocated eight a thread)."""
    from pytorch_mppi_tpu_torch.ops import _build

    logs = [_build.library_path().with_suffix(".log")] if named else []
    for label in labels:
        _, kernel, variant, _ = plan["builds"][label]
        logs.append(_build.generated_path(kernel.header(), variant_mask(variant))
                    .with_suffix(".log"))
    out = []
    for log in logs:
        for e in ptxas_entries(log.read_text()) if log.is_file() else []:
            if "ResidualMLPBlock" in e["name"] or "Generated" in e["name"]:
                regs = -(-e.get("registers", 255) // 8) * 8
                e["blocks_by_registers"] = 65536 // (regs * 128)
                e["log"] = log.name
                out.append(e)
    return out


def wide_dynamics(dev, gen, params, car, plan):
    """Phase 4e, learned dynamics of any width: the block kernels'
    registers, spill stores (none) and blocks an SM (``block_ptxas``); (i)
    ``ResidualMLPBlock`` forced onto the per-thread model's networks (the
    trained demo's [3, 32, 32, 2], the car's [9, 32, 32, 7]) against its
    plain version (``f64_agree``, the wrap's samples excused) in kernel A's
    three variants (bits and seed mode), the batched pair (bits, seed,
    operand) and the legacy rollout, beside ``ResidualMLP`` and timed with
    it in turns; (ii) the quadrotor's ``QUAD_SIZES`` on ``ResidualMLPBlock``
    against its plain version (``f64_agree``) at K = 10,000, T = 30 in
    kernel A's three variants and the rollout and at N = 16, K = 10,240 in
    the batched pair, each timed beside its two bounds (``bound``,
    ``tc_bound``) and its plain version, then CAR_COMMANDS
    commands of each route with exact block launch counts; (iii) the
    untagged ``MBPO_SIZES`` network, traced into dense layers (its
    libraries built in phase 2), in kernel A (MPPI) and the batched pair
    against the program's evaluator, timed, and CAR_COMMANDS commands of
    MPPI and ``MPPI_Batched`` on it with no plain-path warning; (iv)
    ``HALF_TILE_SIZES``, too wide for 16 samples' activations, in groups of
    8 (half an m16 tile) in kernel A, the batched pair and the rollout
    against their plain versions (``f64_agree``).  Returns the rows'
    numbers."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel, run_mppi_jit
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import mlp_init
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops.kernel_models import activation_ld, residual_mlp_model

    phase_start = time.perf_counter()
    K_, T_ = MLP_K, MLP_T
    nsp = T_ // 2
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    def launched():
        return {k: v for k, v in FS.launches.items() if v}

    def config(variant, nx, nu):
        return MPPIConfig(nx=nx, nu=nu, K=K_, T=T_, diag_sigma=True,
                          num_support_pts=nsp if variant == "kmppi" else 0,
                          smppi=variant == "smppi")

    def bits_or_key(mode, R, cols):
        if mode == "bits":
            return torch.randint(-2**31, 2**31 - 1, (R, cols), dtype=torch.int32, generator=gen,
                                 device=dev)
        return tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))

    report = {"agree": {}, "turns": {}, "quad": {"timed": {}, "err": {}, "loops": {}},
              "mbpo": {"timed": {}, "err": {}, "loops": {}}}

    # the block kernels' registers, spill stores and blocks an SM
    report["ptxas"] = block_ptxas(plan)
    for e in report["ptxas"]:
        print(f"# ptxas [{e['name']}]: {e.get('registers')} registers, {e.get('spills')} bytes "
              f"spill stores, {e.get('stack')} bytes stack frame, "
              f"{e['blocks_by_registers']} blocks an SM by registers")
    check(report["ptxas"] and all(e.get("spills") == 0 for e in report["ptxas"]),
          "a block model's kernel spills (or none was found in the build logs)")

    # (i) ResidualMLPBlock forced onto the per-thread networks.  Its dense
    # layers run on the tensor cores (3xTF32), whose sums take another order
    # and rounding than ResidualMLP's chain of fmaf: each cost is held to a
    # float64 rollout within F64_FACTOR of the float32 plain version's error
    # (f64_agree; a sample at the wrap excused), m, s and delta/s as agree;
    # the per-thread kernel's costs printed beside them, and both timed in turns
    nets = {"demo [3, 32, 32, 2]": (params, 2, 1, dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,)),
                                    [math.pi, 1.0], math.sqrt(10.0), (0.5, 1.0)),
            "car [9, 32, 32, 7]": (None, CAR_NX, CAR_NU, None, list(CAR_X0), 1.0,
                                   (0.2,) * CAR_NX)}
    for label, (w, nx, nu, kw, x0, sigma, spread) in nets.items():
        if w is None:  # the car: its model's own weights and flags
            per_thread = car
            block = residual_mlp_model(learned_car_params(dev), nx, nu, angle_wrap_dims=(2,),
                                       cost="quadratic", goal=CAR_GOAL, block=True)
        else:
            per_thread = residual_mlp_model(w, nx, nu, **kw)
            block = residual_mlp_model(w, nx, nu, block=True, **kw)
        check(per_thread.model_id == 3 and block.model_id == 4, f"{label}: the wrong models")
        x0T, ops = mlp_operands(dev, gen, nx, nu, x0, sigma)
        agree_all = True
        for variant in FS.VARIANTS:
            cfg = config(variant, nx, nu)
            s_p = factories[variant](cfg, per_thread, emit_perturbed=True)
            s_b = factories[variant](cfg, block, emit_perturbed=True)
            for mode in ("bits", "seed"):
                lead = bits_or_key(mode, s_b.spec.R, s_b.bits_cols)
                reset_launches()
                dk, mk, sk, ck, _ = s_b(lead, *ops[variant])
                torch.cuda.synchronize()
                n_b = launched()
                c_t = s_p(lead, *ops[variant])[3]
                dp, mp, sp, cp, pp = s_b.plain(lead, *ops[variant])
                ok, e_k, e_p, lim, exc = f64_agree(block, ck, cp, pp, x0T, T_, nu, wrap=True)
                ok2, c_err, u_err, _ = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                             rtol=0.0, atol=(F64_FACTOR + 1) * max(e_p, 1e-6),
                                             excused=exc)
                ok = ok and ok2 and n_b == {f"{variant}_block": 1}
                agree_all = agree_all and ok
                print(f"# block vs per-thread [{label} {variant} {mode}] K={K_} T={T_} "
                      f"S={s_b.tile_k} group {s_b.act_rows} tiles {s_b.tiles}: cost error against "
                      f"float64 block {e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}; at the wrap "
                      f"{int(exc.sum())}) | block against plain {c_err:.3e}, against "
                      f"ResidualMLP {float((ck - c_t).abs().max()):.3e} | delta/s err "
                      f"{u_err:.3e} | launches {n_b}" + ("" if ok else "  <-- FAIL"))
                check(ok, f"the block MLP disagrees with its plain version: "
                      f"{label}/{variant}/{mode}")
            key = bits_or_key("seed", 0, 0)
            turns = in_turns({"per-thread": lambda: s_p(key, *ops[variant]),
                              "block": lambda: s_b(key, *ops[variant])})
            report["turns"][label, variant] = turns
            print(f"# block vs per-thread [{label} {variant}] seed, in turns (CUDA graph of 20 "
                  f"calls): ResidualMLP {turns['per-thread']:.6f} ms | ResidualMLPBlock "
                  f"{turns['block']:.6f} ms ({turns['block'] / turns['per-thread']:.3f}x)")
        r_cfg = MPPIConfig(nx=nx, nu=nu, K=K_, T=T_)
        r_p, r_b = LG.make_fused_rollout(r_cfg, per_thread), LG.make_fused_rollout(r_cfg, block)
        x0_K = torch.tensor(x0, device=dev)[None].expand(K_, nx)
        u = torch.clamp(torch.randn(K_, T_, nu, generator=gen, device=dev) * sigma, -2, 2)
        reset_launches()
        c_b = r_b(x0_K, u)
        torch.cuda.synchronize()
        n_b = launched()
        c_pl = r_b.plain(x0_K, u)
        ok, e_k, e_p, lim, exc = f64_agree(block, c_b, c_pl, u.reshape(K_, -1).T,
                                           x0_K.T.contiguous(), T_, nu, wrap=True)
        ok = ok and n_b == {"rollout_block": 1}
        agree_all = agree_all and ok
        turns = in_turns({"per-thread": lambda: r_p(x0_K, u), "block": lambda: r_b(x0_K, u)})
        report["turns"][label, "rollout"] = turns
        print(f"# block vs per-thread [{label} rollout] K={K_}: cost error against float64 block "
              f"{e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}; at the wrap {int(exc.sum())}) | "
              f"against ResidualMLP {float((c_b - r_p(x0_K, u)).abs().max()):.3e} | launches "
              f"{n_b} | in turns: ResidualMLP {turns['per-thread']:.6f} ms, ResidualMLPBlock "
              f"{turns['block']:.6f} ms ({turns['block'] / turns['per-thread']:.3f}x)"
              + ("" if ok else "  <-- FAIL"))
        check(ok, f"the block MLP's rollout disagrees with its plain version: {label}")
        b_cfg = MPPIConfig(nx=nx, nu=nu, K=MLP_BATCH_K, T=T_, diag_sigma=True)
        for mode in ("bits", "seed", "operand"):
            operand = mode == "operand"
            b_p = FS.make_transposed_batched_solve(b_cfg, MLP_BATCH_N, per_thread,
                                                   noise_operand=operand)
            b_b = FS.make_transposed_batched_solve(b_cfg, MLP_BATCH_N, block, noise_operand=operand)
            rest = mlp_batched_rest(dev, gen, nx, nu, MLP_BATCH_N, x0, spread, sigma)
            lead = (torch.randn(T_ * nu, b_b.K_pad, generator=gen, device=dev) * sigma if operand
                    else bits_or_key(mode, T_ * nu, b_b.bits_cols))
            reset_launches()
            dk, msk, ck = b_b(lead, *rest)
            torch.cuda.synchronize()
            n_b = launched()
            c_t = b_p(lead, *rest)[2]
            dp, msp, cp = b_b.plain(lead, *rest)
            pert, x0_all = batched_pert(b_b, lead, rest, T_, nu, MLP_BATCH_K)
            ok, e_k, e_p, lim, exc = f64_agree(block, ck.reshape(-1), cp.reshape(-1), pert,
                                               x0_all, T_, nu, wrap=True)
            ok2, c_err, u_err, _ = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0], msp[0],
                                         msk[1], msp[1], rtol=0.0,
                                         atol=(F64_FACTOR + 1) * max(e_p, 1e-6),
                                         excused=exc.reshape(ck.shape))
            ok = ok and ok2 and n_b == {"batched_block": 2}
            agree_all = agree_all and ok
            print(f"# block vs per-thread [{label} batched {mode}] N={MLP_BATCH_N} "
                  f"K={MLP_BATCH_K} P={b_b.plant_group} group {b_b.act_rows} tiles {b_b.tiles}: "
                  f"cost error against float64 block {e_k:.3e}, plain {e_p:.3e} (limit "
                  f"{lim:.3e}; at the wrap {int(exc.sum())}) | against ResidualMLP "
                  f"{float((ck - c_t).abs().max()):.3e} | delta/s err {u_err:.3e} | launches "
                  f"{n_b}" + ("" if ok else "  <-- FAIL"))
            check(ok, f"the block MLP's batched pair disagrees with its plain version: "
                  f"{label}/{mode}")
            if mode == "seed":
                turns = in_turns({"per-thread": lambda: b_p(lead, *rest),
                                  "block": lambda: b_b(lead, *rest)})
                report["turns"][label, "batched"] = turns
                print(f"# block vs per-thread [{label} batched seed] in turns: ResidualMLP "
                      f"{turns['per-thread']:.6f} ms, ResidualMLPBlock {turns['block']:.6f} ms "
                      f"({turns['block'] / turns['per-thread']:.3f}x)")
        report["agree"][label] = agree_all

    # (ii) the quadrotor on ResidualMLPBlock against its plain version
    qp = mlp_init(QUAD_SIZES, torch.Generator().manual_seed(29), torch.float32, dev)
    Wq, bq = qp[-1]
    qp[-1] = (Wq * QUAD_STEP, bq * QUAD_STEP)
    quad = residual_mlp_model(qp, QUAD_NX, QUAD_NU, cost="quadratic", goal=QUAD_GOAL)
    check(quad.model_id == 4 and activation_ld(quad) == 256, "the quadrotor is not a block model")
    mbpo = plan["models"]["mbpo"]
    print(f"# kernel vs plain [wide models]: each cost's error against a float64 rollout of the "
          f"same actions within {F64_FACTOR}x the float32 plain version's (f64_agree); m, s and "
          f"delta/s as the other cases (agree), the costs at that error")
    for label, m, out, variants in (("quadrotor " + str(QUAD_SIZES), quad, report["quad"],
                                     FS.VARIANTS),
                                    ("MBPO " + str(MBPO_SIZES), mbpo, report["mbpo"], ("mppi",))):
        net = "quad" if m is quad else "mbpo"
        x0T, ops = mlp_operands(dev, gen, QUAD_NX, QUAD_NU, list(QUAD_X0), 1.0)
        for variant in variants:
            cfg = config(variant, QUAD_NX, QUAD_NU)
            solve = factories[variant](cfg, m, emit_perturbed=True)
            name = f"{variant}_block" if m is quad else f"generated_{variant}_block"
            for mode in ("bits", "seed"):
                lead = bits_or_key(mode, solve.spec.R, solve.bits_cols)
                reset_launches()
                dk, mk, sk, ck, pk = solve(lead, *ops[variant])
                torch.cuda.synchronize()
                n_k = launched()
                dp, mp, sp, cp, pp = solve.plain(lead, *ops[variant])
                ok, e_k, e_p, lim_f64, _ = f64_agree(m, ck, cp, pp, x0T, T_, QUAD_NU)
                ok2, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                                 rtol=0.0, atol=(F64_FACTOR + 1) * max(e_p, 1e-6))
                ok = ok and ok2 and n_k == {name: 1}
                out["err"][variant, mode] = dict(kernel_f64=e_k, plain_f64=e_p, update=u_err)
                print(f"# wide [{label} {variant} {mode}] K={K_} T={T_} S={solve.tile_k} group "
                      f"{solve.act_rows} tiles {solve.tiles}: cost error against float64 kernel "
                      f"{e_k:.3e}, plain {e_p:.3e} ({e_k / max(e_p, 1e-30):.2f}x; limit "
                      f"{lim_f64:.3e}) | kernel against plain {c_err:.3e} | delta/s err "
                      f"{u_err:.3e} (tol {w_tol:.3e}) | launches {n_k}" + ("" if ok else "  <-- FAIL"))
                check(ok, f"the wide model's kernel disagrees with its plain version: "
                      f"{label}/{variant}/{mode}")
            key = bits_or_key("seed", 0, 0)
            args = ops[variant]
            dev_ms = graph_ms(lambda: solve(key, *args), 20)
            plain_ms = events_ms(lambda: solve.plain(key, *args), 1)  # MBPO's: 1.6 s a call
            op = args[3] if variant != "mppi" else args[2]
            work = fused_work(cfg, m, key, x0T, op, variant=variant)
            f32_ms, _ = bound(work)
            bound_ms, bound_by = tc_bound(work, K_ * T_ * _dense_macs(m))
            out["timed"][variant] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
            smem = FS.launch_geometry(solve.spec)["block_smem"]
            print(f"# kernel alone [{variant} {label}] K={K_} T={T_} S={solve.tile_k}: device "
                  f"{dev_ms:.6f} ms (a CUDA graph of 20 calls; {FS.blocks_per_sm(smem)} blocks "
                  f"an SM by its {smem} bytes of shared memory) | plain version {plain_ms:.5f} ms "
                  f"| bound {bound_ms:.6f} ms by {bound_by} with the dense layers on the tensor "
                  f"cores (3xTF32): {dev_ms / bound_ms:.1f}x | float32 bound {f32_ms:.6f} ms: "
                  f"{dev_ms / f32_ms:.1f}x | before the redesign (recorded, PERF.md) "
                  f"{BLOCK_BEFORE_MS[net, variant]} ms | {card_line()}")
        if m is quad:
            r = LG.make_fused_rollout(MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=K_, T=T_), m)
            x0_K = torch.tensor(QUAD_X0, device=dev)[None].expand(K_, QUAD_NX)
            u = torch.clamp(torch.randn(K_, T_, QUAD_NU, generator=gen, device=dev), -2, 2)
            reset_launches()
            ck = r(x0_K, u)
            torch.cuda.synchronize()
            n_k = launched()
            cp = r.plain(x0_K, u)
            ok, e_k, e_p, lim_f64, _ = f64_agree(m, ck, cp, u.reshape(K_, -1).T, x0T, T_,
                                                 QUAD_NU)
            ok = ok and n_k == {"rollout_block": 1}
            out["err"]["rollout"] = dict(kernel_f64=e_k, plain_f64=e_p)
            dev_ms = graph_ms(lambda: r(x0_K, u), 20)
            plain_ms = events_ms(lambda: r.plain(x0_K, u), 1)
            work = rollout_work(m, x0_K, u)
            f32_ms, _ = bound(work)
            bound_ms, bound_by = tc_bound(work, K_ * T_ * _dense_macs(m))
            out["timed"]["rollout"] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
            print(f"# wide [{label} rollout] K={K_}: cost error against float64 kernel {e_k:.3e}, "
                  f"plain {e_p:.3e} (limit {lim_f64:.3e}) | launches {n_k} | device "
                  f"{dev_ms:.6f} ms ({dev_ms / ROLLOUT_BLOCK_BEFORE_MS:.3f} of its "
                  f"{ROLLOUT_BLOCK_BEFORE_MS} ms before the redesign) | plain version "
                  f"{plain_ms:.5f} ms | bound "
                  f"{bound_ms:.6f} ms by {bound_by} (tensor cores): {dev_ms / bound_ms:.1f}x | "
                  f"float32 bound {f32_ms:.6f} ms: {dev_ms / f32_ms:.1f}x"
                  + ("" if ok else "  <-- FAIL"))
            check(ok, f"the wide model's rollout disagrees with its plain version: {label}")
            check(dev_ms <= 1.1 * ROLLOUT_BLOCK_BEFORE_MS,
                  f"the block rollout took {dev_ms:.3f} ms, more than 1.1x its "
                  f"{ROLLOUT_BLOCK_BEFORE_MS} ms before the redesign")
        b_cfg = MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=MLP_BATCH_K, T=T_, diag_sigma=True)
        solve = FS.make_transposed_batched_solve(b_cfg, MLP_BATCH_N, m)
        rest = mlp_batched_rest(dev, gen, QUAD_NX, QUAD_NU, MLP_BATCH_N, list(QUAD_X0), 0.2, 1.0)
        name = "batched_block" if m is quad else "generated_batched_block"
        for mode in ("seed",):  # the batched routes' mode; kernel A takes bits too
            lead = bits_or_key(mode, T_ * QUAD_NU, solve.bits_cols)
            reset_launches()
            dk, msk, ck = solve(lead, *rest)
            torch.cuda.synchronize()
            n_k = launched()
            dp, msp, cp = solve.plain(lead, *rest)
            pert, x0_all = batched_pert(solve, lead, rest, T_, QUAD_NU, MLP_BATCH_K)
            ok, e_k, e_p, lim_f64, _ = f64_agree(m, ck.reshape(-1), cp.reshape(-1), pert, x0_all,
                                                 T_, QUAD_NU)
            ok2, c_err, u_err, _ = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0], msp[0],
                                         msk[1], msp[1], rtol=0.0,
                                         atol=(F64_FACTOR + 1) * max(e_p, 1e-6))
            ok = ok and ok2 and n_k == {name: 2}
            out["err"]["batched", mode] = dict(kernel_f64=e_k, plain_f64=e_p, update=u_err)
            print(f"# wide [{label} batched {mode}] N={MLP_BATCH_N} K={MLP_BATCH_K} "
                  f"P={solve.plant_group} group {solve.act_rows} tiles {solve.tiles}: cost error "
                  f"against float64 kernel {e_k:.3e}, plain {e_p:.3e} (limit {lim_f64:.3e}) | "
                  f"delta/s err {u_err:.3e} | launches {n_k}"
                  + ("" if ok else "  <-- FAIL"))
            check(ok, f"the wide model's batched pair disagrees with its plain version: "
                  f"{label}/{mode}")
        # a call takes about 0.3 s (measured on one H100): a graph of WIDE_CALLS
        key = bits_or_key("seed", 0, 0)
        dev_ms = graph_ms(lambda: solve(key, *rest), WIDE_CALLS)
        plain_ms = events_ms(lambda: solve.plain(key, *rest), 1)
        work = fused_work(b_cfg, m, key, rest[0], rest[2], variant="batched", plants=MLP_BATCH_N)
        f32_ms, _ = bound(work)
        bound_ms, bound_by = tc_bound(work, MLP_BATCH_N * MLP_BATCH_K * T_ * _dense_macs(m))
        out["timed"]["batched"] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
        smem = FS.launch_geometry(solve.spec)["block_smem"]
        print(f"# kernel alone [batched {label}] seed N={MLP_BATCH_N} K={MLP_BATCH_K}: device "
              f"{dev_ms:.6f} ms (a CUDA graph of {WIDE_CALLS} calls; {FS.blocks_per_sm(smem)} "
              f"blocks an SM by its {smem} bytes of shared memory) | plain version "
              f"{plain_ms:.5f} ms | "
              f"bound {bound_ms:.6f} ms by {bound_by} with the dense layers on the tensor cores "
              f"(3xTF32): {dev_ms / bound_ms:.1f}x | float32 bound {f32_ms:.6f} ms: "
              f"{dev_ms / f32_ms:.1f}x | before the redesign (recorded, PERF.md) "
              f"{BLOCK_BEFORE_MS[net, 'batched']} ms | {card_line()}")

    # the closed loops: CAR_COMMANDS commands of each route on the model as
    # its own plant, exact block launch counts, finite actions; the MBPO
    # network's controllers built from the untagged callables, with no
    # plain-path warning
    lim = torch.full((QUAD_NU,), 2.0)
    routes = [
        ("quad", "mppi", "fused", MPPI, True, {}, dict(mppi_block=1)),
        ("quad", "mppi", "rollout", MPPI, "rollout", {},
         dict(rollout_block=1, weighted_update=1)),
        ("quad", "smppi", "fused", SMPPI, True, dict(w_action_seq_cost=1.0, delta_t=1.0,
                                                     action_min=-lim, action_max=lim),
         dict(smppi_block=1)),
        ("quad", "kmppi", "fused", KMPPI, True, dict(num_support_pts=nsp, kernel=RBFKernel(2.0)),
         dict(kmppi_block=1)),
        ("quad", "batched", "fused", MPPI_Batched, "kernel_rng", dict(num_envs=MLP_BATCH_N),
         dict(batched_block=2)),
        ("mbpo", "mppi", "fused", MPPI, True, {}, dict(generated_mppi_block=1)),
        ("mbpo", "batched", "fused", MPPI_Batched, "kernel_rng", dict(num_envs=MLP_BATCH_N),
         dict(generated_batched_block=2)),
    ]
    goal = torch.tensor(QUAD_GOAL, device=dev)
    for which, variant, path, cls, use_pallas, kw, per_command in routes:
        dyn, cost = ((quad.dynamics, quad.running_cost) if which == "quad"
                     else plan["fns"]["mbpo"])
        with Captured() as warned:
            ctrl = cls(dyn, cost, QUAD_NX, torch.eye(QUAD_NU, device=dev), num_samples=K_,
                       horizon=T_, lambda_=1.0, u_min=-lim, u_max=lim, seed=42,
                       use_pallas=use_pallas, device=dev, **kw)
        fallback = [m for m in warned.messages if "plain torch path" in m]
        check(ctrl._fns.fused and not fallback, f"{which} {variant} {path} took the plain path: "
              f"{warned.messages}")
        batched_ = variant == "batched"
        x = torch.tensor(QUAD_X0, device=dev)
        if batched_:
            x = x[None] + 0.2 * (torch.rand(MLP_BATCH_N, QUAD_NX, generator=gen, device=dev) * 2
                                 - 1)
        start = (x - goal).norm(dim=-1).max()
        step = quad.dynamics if which == "quad" else plan["models"]["mbpo"].dynamics
        reset_launches()
        wall = time.perf_counter()
        with torch.no_grad():
            for _ in range(CAR_COMMANDS):
                a = ctrl.command(x)
                check(bool(torch.isfinite(a).all()), f"{which} {variant} {path}: a non-finite action")
                x = step(x, a) if batched_ else step(x[None], a[None])[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        n = dict(FS.launches)
        expect = {k: CAR_COMMANDS * per_command.get(k, 0) for k in n}
        out = report["quad" if which == "quad" else "mbpo"]
        out["loops"][variant, path] = dict(launches=n, ms_per_command=wall / CAR_COMMANDS * 1e3)
        print(f"# wide loop [{which} {variant} {path}] K={K_} T={T_}, {CAR_COMMANDS} commands on "
              f"the model as its plant: distance to the goal {float(start):.3f} -> "
              f"{float((x - goal).norm(dim=-1).max()):.3f} (largest) | "
              f"{wall / CAR_COMMANDS * 1e3:.3f} ms a command (host clock) | launches "
              f"{ {k: v for k, v in n.items() if v} }")
        check(n == expect, f"{which} {variant} {path} launched {n}, expected {expect}")
        check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(ctrl.U).all()),
              f"{which} {variant} {path}: non-finite states or actions")
        del ctrl

    # run_mppi_jit's CUDA graph of the loop step captures the block kernel:
    # GRAPH_STEPS steps bit for bit against the eager loop, one launch a step
    def quad_mppi():
        return MPPI(quad.dynamics, quad.running_cost, QUAD_NX, torch.eye(QUAD_NU, device=dev),
                    num_samples=K_, horizon=T_, lambda_=1.0, u_min=-lim, u_max=lim, seed=7,
                    use_pallas=True, device=dev)

    def quad_plant(x, a):
        return quad.dynamics(x[None], a[None])[0]

    c_graph, c_eager = quad_mppi(), quad_mppi()
    x0 = torch.tensor(QUAD_X0, device=dev)
    reset_launches()
    states, actions, _ = run_mppi_jit(c_graph, quad_plant, x0, GRAPH_STEPS)
    torch.cuda.synchronize()
    n = launched()
    x, acts = x0, []
    for _ in range(GRAPH_STEPS):
        acts.append(c_eager.command(x))
        x = quad_plant(x, acts[-1])
    torch.cuda.synchronize()
    same = torch.equal(actions, torch.stack(acts)) and torch.equal(c_graph.U, c_eager.U)
    print(f"# graph loop [quadrotor mppi fused] {GRAPH_STEPS} steps: equal to the eager loop bit "
          f"for bit {same} | launches {n}")
    check(same and n == {"mppi_block": GRAPH_STEPS}, f"graph loop [quadrotor]: equal {same}, "
          f"launches {n}")
    report["quad"]["loops"]["graph", "fused"] = dict(equal=same, launches=n)

    # (iv) a layer too wide for a whole m16 tile of 16 samples' activations:
    # groups of DENSE_ROWS = 8 (half a tile, the other half zeros) in kernel
    # A, the batched pair and the rollout, each against its plain version
    # (f64_agree) with exact launch counts
    hp = mlp_init(HALF_TILE_SIZES, torch.Generator().manual_seed(31), torch.float32, dev)
    Wh, bh = hp[-1]
    hp[-1] = (Wh * QUAD_STEP, bh * QUAD_STEP)
    half = residual_mlp_model(hp, QUAD_NX, QUAD_NU, cost="quadratic", goal=QUAD_GOAL)
    solve = FS.make_transposed_fused_solve(config("mppi", QUAD_NX, QUAD_NU), half,
                                           emit_perturbed=True)
    b_solve = FS.make_transposed_batched_solve(
        MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=MLP_BATCH_K, T=T_, diag_sigma=True), 2, half)
    r = LG.make_fused_rollout(MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=K_, T=T_), half)
    groups = (solve.act_rows, b_solve.act_rows,
              LG.rollout_act_rows(T_, QUAD_NU, solve.tile_k, activation_ld(half), QUAD_NX))
    x0T, ops = mlp_operands(dev, gen, QUAD_NX, QUAD_NU, list(QUAD_X0), 1.0)
    lead = bits_or_key("seed", 0, 0)
    reset_launches()
    dk, mk, sk, ck, _ = solve(lead, *ops["mppi"])
    torch.cuda.synchronize()
    n_k = launched()
    dp, mp, sp, cp, pp = solve.plain(lead, *ops["mppi"])
    ok_a, e_a, e_ap, lim_a, _ = f64_agree(half, ck, cp, pp, x0T, T_, QUAD_NU)
    ok2, _, u_err, _ = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp, rtol=0.0,
                             atol=(F64_FACTOR + 1) * max(e_ap, 1e-6))
    ok_a = ok_a and ok2 and n_k == {"mppi_block": 1}
    rest = mlp_batched_rest(dev, gen, QUAD_NX, QUAD_NU, 2, list(QUAD_X0), 0.2, 1.0)
    reset_launches()
    dk, msk, cbk = b_solve(lead, *rest)
    torch.cuda.synchronize()
    n_b = launched()
    dp, msp, cbp = b_solve.plain(lead, *rest)
    pert, x0_all = batched_pert(b_solve, lead, rest, T_, QUAD_NU, MLP_BATCH_K)
    ok_b, e_b, e_bp, lim_b, _ = f64_agree(half, cbk.reshape(-1), cbp.reshape(-1), pert, x0_all,
                                          T_, QUAD_NU)
    ok2, _, ub_err, _ = agree(cbk, cbp, dk / msk[1], dp / msp[1], 1.0, msk[0], msp[0], msk[1],
                              msp[1], rtol=0.0, atol=(F64_FACTOR + 1) * max(e_bp, 1e-6))
    ok_b = ok_b and ok2 and n_b == {"batched_block": 2}
    x0_K = torch.tensor(QUAD_X0, device=dev)[None].expand(K_, QUAD_NX)
    u = torch.clamp(torch.randn(K_, T_, QUAD_NU, generator=gen, device=dev), -2, 2)
    reset_launches()
    crk = r(x0_K, u)
    torch.cuda.synchronize()
    n_r = launched()
    ok_r, e_r, e_rp, lim_r, _ = f64_agree(half, crk, r.plain(x0_K, u), u.reshape(K_, -1).T, x0T,
                                          T_, QUAD_NU)
    ok_r = ok_r and n_r == {"rollout_block": 1}
    ok = ok_a and ok_b and ok_r and groups == (8, 8, 8)
    report["half_tile"] = dict(groups=groups, kernel_a=e_a, batched=e_b, rollout=e_r, ok=ok)
    print(f"# half tile [{HALF_TILE_SIZES}] groups (kernel A, batched, rollout) {groups}: cost "
          f"error against float64, kernel A {e_a:.3e} (plain {e_ap:.3e}, limit {lim_a:.3e}; "
          f"delta/s err {u_err:.3e}; launches {n_k}) | batched N=2 K={MLP_BATCH_K} {e_b:.3e} "
          f"(plain {e_bp:.3e}, limit {lim_b:.3e}; delta/s err {ub_err:.3e}; launches {n_b}) | "
          f"rollout {e_r:.3e} (plain {e_rp:.3e}, limit {lim_r:.3e}; launches {n_r})"
          + ("" if ok else "  <-- FAIL"))
    check(ok, f"the half-tile groups of {HALF_TILE_SIZES} disagree with their plain versions or "
          f"took other groups: {groups}")
    report["seconds"] = time.perf_counter() - phase_start
    print(f"# phase 4e, wide dynamics: {report['seconds']:.1f} s")
    return report


def deployment(dev, lq, goal, mlp_params, plan):
    """Phase 8: the utilities on the card.

    * the deploy artifact: fused MPPI (also with 4 elites and the terminal
      cost), SMPPI and KMPPI at the flagship, MPPI on the legacy route,
      MPPI on ``fused_kernel_demo``'s learned model and ``MPPI_Batched`` in
      seed mode at N = 1,024, K = 16,384; with the user's own code in the
      kernels (phase 11's callables, whose generated libraries phase 2
      built): fused MPPI at the flagship with its traced terminal cost,
      ``MPPI_Batched`` in seed mode at N = 1,024, K = 16,384 on
      ``scenario_batch``'s plant and the legacy route on the step-dependent
      plant; and fused MPPI on the named model with gradient refinement;
      with stochastic dynamics, which take the plain path (no kernel, as in
      JAX), MPPI at the flagship with M = 4 rollouts of ``torch.randn`` from
      each step's generator, and SMPPI at the flagship with step-dependent
      dynamics that draw with ``Tensor.normal_``, and MPPI at the flagship
      with a Bernoulli-gated impulse, a state-scaled normal
      (``torch.bernoulli(p)``, ``torch.normal(0, std)``: draws with tensor
      arguments, fed as their base draws; whether torch's own ops draw the
      same on the card is printed) and exponential noise on a drawn
      permutation (``Tensor.exponential_``, ``torch.randperm``): the programs take the
      draws as inputs (the bytes fed a command printed; refinement on
      stochastic dynamics, whose export traces its backward pass for about
      50 s at M = 4, is phase 10e's and the CPU tests');
      Each is exported after three commands and loaded in a fresh process
      (``SERVE_CHILD``) that replays DEPLOY_COMMANDS commands on the live
      controller's states: the actions bit for bit the live controller's,
      the launch counters read in the child (the generated ones move by
      exactly the launches expected, no other); the artifact's command
      median against the live one, and the export's seconds;
    * a serving host with a cold kernel cache (``COLD_CHILD``), started in
      the background as soon as the traced fused artifact exists and
      joined at the end: it builds the generated library from the
      artifact's program alone and replays the same commands bit for bit;
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

    phase_start = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "deploy"
    out_dir.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parent
    child_env = {**os.environ, "PYTHONPATH": str(root)}
    report = {"artifacts": {}}

    def reset_launches():
        torch.cuda.synchronize()
        for name in FS.launches:
            FS.launches[name] = 0

    def only(**counts):
        return {name: counts.get(name, 0) for name in FS.launches}

    def flagship(cls=MPPI, seed=42, fns=(lq.dynamics, lq.running_cost), **kw):
        return cls(*fns, nx=NX, noise_sigma=torch.eye(NU, device=dev),
                   num_samples=K, horizon=T, lambda_=1.0, seed=seed, device=dev, **kw)

    def lq_plant(x, a):
        return lq.dynamics(x, a)

    def pendulum_plant(x, a):
        return pendulum_dynamics(x[None], a[None])[0]

    def noisy_lq(s_, a, rng):
        """The flagship's plant plus N(0, STOCH_SCALE²) a step, drawn from the
        step's generator (stochastic_dynamics)."""
        return lq.dynamics(s_, a) + STOCH_SCALE * torch.randn(
            s_.shape, generator=rng, device=s_.device, dtype=s_.dtype)

    def noisy_lq_step(s_, a, t, rng):
        """The same drawn in place with ``Tensor.normal_``, its scale
        growing with the step (step_dependent_dynamics)."""
        return lq.dynamics(s_, a) + STOCH_SCALE * (1.0 + 0.02 * t) * torch.empty_like(
            s_).normal_(generator=rng)

    def gated_lq(s_, a, rng):
        """The flagship's plant plus an impulse of STOCH_SCALE gated by a
        Bernoulli draw whose probability the state sets, a normal of
        state-scaled deviation (draws with tensor arguments,
        ``torch.bernoulli(p)`` and ``torch.normal(0, std)``, fed as their
        base draws), and exponential noise on a drawn permutation of the
        state (``Tensor.exponential_``, ``torch.randperm``, replayed as
        themselves)."""
        gate = torch.bernoulli(torch.sigmoid(s_).clamp(0.1, 0.9), generator=rng)
        std = STOCH_SCALE * (1.0 + 0.1 * s_.abs())
        e = torch.empty_like(s_).exponential_(4.0, generator=rng)
        perm = torch.randperm(s_.shape[-1], generator=rng, device=s_.device)
        return (lq.dynamics(s_, a) + STOCH_SCALE * gate + torch.normal(0.0, std, generator=rng)
                + STOCH_SCALE * torch.index_select(e, -1, perm))

    def lq_cost_step(s_, a, t):
        return lq.running_cost(s_, a)

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
    fns = plan["fns"]  # phase 11's callables, untagged: their kernels are generated
    cold_name = "generated mppi fused, traced terminal"
    paths = {  # name: (controller, plant, start, launches of one command)
        cold_name: (lambda: flagship(fns=fns["lq"], use_pallas=True,
                                     terminal_final_cost=fns["terminal"]),
                    lq_plant, flag_x0, dict(generated_mppi=1)),
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
        f"generated batched seed N={BATCH_N}": (
            lambda: MPPI_Batched(*fns["lq"], nx=NX, noise_sigma=sigma_b, num_envs=BATCH_N,
                                 num_samples=BATCH_K, horizon=T, lambda_=1.0, u_min=-ub,
                                 u_max=ub, seed=0, use_pallas="kernel_rng", device=dev),
            lq_plant, batch_x0, dict(generated_batched=2)),
        "generated rollout, step-dependent": (
            lambda: flagship(fns=fns["step"], use_pallas="rollout",
                             step_dependent_dynamics=True),
            lq_plant, flag_x0, dict(generated_rollout=1, weighted_update=1)),
        "mppi fused, refinement": (
            lambda: flagship(use_pallas=True, gradient_refinement_steps=DEPLOY_REFINE_STEPS),
            lq_plant, flag_x0, dict(mppi=1)),
        # stochastic dynamics: the plain path, whose commands launch no kernel
        f"mppi plain, stochastic M={M_STOCH}": (
            lambda: flagship(fns=(noisy_lq, lq.running_cost), use_pallas=True,
                             stochastic_dynamics=True, rollout_samples=M_STOCH,
                             rollout_var_cost=0.1),
            lq_plant, flag_x0, {}),
        "smppi plain, stochastic, step-dependent": (
            lambda: flagship(SMPPI, fns=(noisy_lq_step, lq_cost_step), stochastic_dynamics=True,
                             step_dependent_dynamics=True, w_action_seq_cost=1.0, delta_t=1.0,
                             action_min=torch.tensor([-3.0, -3.0]),
                             action_max=torch.tensor([3.0, 3.0])),
            lq_plant, flag_x0, {}),
        "mppi plain, stochastic, bernoulli(p), normal(0, std), exponential_, randperm": (
            lambda: flagship(fns=(gated_lq, lq.running_cost), stochastic_dynamics=True),
            lq_plant, flag_x0, {}),
    }
    # whether torch's own draws with tensor arguments consume a CUDA generator
    # as the base draws the port defines them by (ops/solve._based): printed
    p_ = torch.rand(4096, device=dev)

    def g5():
        return torch.Generator(device=dev).manual_seed(5)

    own = [torch.bernoulli(p_, generator=g5()), torch.normal(0.0, p_, generator=g5())]
    base = [(torch.rand(4096, device=dev, generator=g5()) < p_).float(),
            p_ * torch.randn(4096, device=dev, generator=g5())]
    print(f"# deploy: torch's own draws on the card equal their base draws: bernoulli(p) "
          f"{torch.equal(own[0], base[0])}, normal(0, std) {torch.equal(own[1], base[1])} (the "
          f"port draws the base draws in both the live and the served command)")
    cold = None
    jobs = {"artifacts": [], "warmup": DEPLOY_WARMUP, "timed": DEPLOY_TIMED, "device": str(dev)}
    live = {}
    for i, (name, (build, plant, x, per_command)) in enumerate(paths.items()):
        ctrl = build()
        check(ctrl._fns.fused == bool(per_command), f"deploy [{name}] did not take "
              f"{'a kernel route' if per_command else 'the plain path'}")
        for _ in range(3):
            x = plant(x, ctrl.command(x))
        path = out_dir / f"artifact{i}.npz"
        wall = time.perf_counter()
        solver = deploy.export_solver(ctrl, str(path))
        export_s = time.perf_counter() - wall
        # the bytes a command feeds the programs (keys or noise, and the
        # draws of stochastic dynamics)
        fed_bytes = sum(z.numel() * z.element_size() for z in solver.feeds())
        del solver
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
        slow = ctrl.config.gradient_refinement_steps or ctrl.config.stochastic_dynamics
        timed = DEPLOY_REFINE_TIMED if slow else DEPLOY_TIMED
        if name == cold_name:  # the cold-cache host builds beside the rest of the phase
            cold_job = out_dir / "cold_job.json"
            cold_job.write_text(json.dumps(dict(
                path=str(path), states=str(out_dir / f"states{i}.npy"),
                actions=str(out_dir / "cold_actions.npy"), scratch=str(out_dir))))
            cold_log = open(out_dir / "cold.log", "w")
            cold_start = time.perf_counter()
            cold = subprocess.Popen([sys.executable, "-c", COLD_CHILD, str(cold_job),
                                     str(out_dir / "cold.json")], cwd=root, env=child_env,
                                    stdout=cold_log, stderr=subprocess.STDOUT, text=True)
            atexit.register(lambda: cold.poll() is None and cold.kill())
        live[name] = dict(actions=torch.stack(acts).cpu().numpy(), expect=expect,
                          median_ms=median_command_ms(ctrl, xs[-1], n=timed),
                          export_s=export_s, mbytes=path.stat().st_size / 2**20,
                          fed_bytes=fed_bytes)
        jobs["artifacts"].append(dict(name=name, path=str(path), timed=timed,
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
    wall = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(job_file), str(result_file)],
                           cwd=root, env=child_env, capture_output=True, text=True, timeout=600)
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
              f"| export {row['export_s']:.2f} s, {row['mbytes']:.3f} MiB | fed "
              f"{row['fed_bytes']} bytes a command")
        check(same, f"deploy [{name}]: the artifact's actions differ from the live controller's")
        check(child_row["launches"] == row["expect"],
              f"deploy [{name}]: the child launched {child_row['launches']}, expected "
              f"{row['expect']}")
        report["artifacts"][name] = dict(child_row, live_median_ms=row["median_ms"],
                                         export_s=row["export_s"], mbytes=row["mbytes"],
                                         fed_bytes=row["fed_bytes"])
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

    # the cold-cache serving host, joined
    cold_rc = cold.wait(timeout=600)
    cold_log.close()
    cold_out = (out_dir / "cold.log").read_text()
    check(cold_rc == 0 and "SERVED OK" in cold_out,
          f"the cold-cache serving process failed: {cold_out[-3000:]}")
    cold_rep = json.loads((out_dir / "cold.json").read_text())
    same = np.array_equal(np.load(out_dir / "cold_actions.npy"), live[cold_name]["actions"])
    nvcc_s = [s for v in cold_rep["build_s"].values() for s in v.values()]
    libs = [f for f in cold_rep["built"] if f.endswith(".so")]
    print(f"# deploy cold cache [{cold_name}]: a fresh process with an empty kernel cache "
          f"built {libs} from the artifact's program in {nvcc_s} s of nvcc; "
          f"{DEPLOY_COMMANDS} commands bit for bit the live controller's: {same} | launches "
          f"{ {k: v for k, v in cold_rep['launches'].items() if v} } | its wall "
          f"{cold_rep['wall_s']:.1f} s (load, build, commands), joined "
          f"{time.perf_counter() - cold_start:.1f} s after its start")
    check(same, "deploy cold cache: the actions differ from the live controller's")
    check(cold_rep["launches"] == live[cold_name]["expect"],
          f"deploy cold cache: launched {cold_rep['launches']}")
    check(len(nvcc_s) == 1 and len(libs) == 1 and all(
        f.startswith("generated-") for f in cold_rep["built"]),
          f"deploy cold cache: expected one generated library built, got {cold_rep}")
    report["cold"] = dict(cold_rep, same=same, nvcc_s=nvcc_s[0] if nvcc_s else None)
    report["phase_s"] = time.perf_counter() - phase_start
    print(f"# phase 8 (deployment): {report['phase_s']:.1f} s")
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
       GRAD_RATIO of the first; the ms an Adam step;
    e. stochastic dynamics and gradient refinement (``tuning_drawing``).
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
    # -- e. stochastic dynamics and gradient refinement --------------------------
    report["drawing"] = tuning_drawing(dev, env, cands, clock, launched, reset)
    report["seconds"] = time.perf_counter() - t0
    print(f"# phase 10 took {report['seconds']:.1f} s")
    print("# tuning " + json.dumps(report))
    return report


def tuning_drawing(dev, env, cands, clock, launched, reset):
    """Phase 10e: what the population evaluator refused before, at phase
    10a's sizes and candidates.

    * one generation with stochastic toy2d dynamics (``torch.randn`` from
      each step's generator; the evaluator feeds each stream its draws, a
      plan recorded once on a live command) and one with TUNE_REFINE_STEPS
      of gradient refinement on them too (``torch.func.grad`` under the
      vmap; its descent fed the draws of the ``refine_seed`` streams), each
      held to the loop of live ``step_no_shift`` calls (``torch.autograd.
      grad`` in the refinement) on the same state seeds for the candidates
      TUNE_LOOPED (the first and the last), within TUNE_RTOL; no kernel
      launched;
    * one ``GradientOpt`` step with TUNE_REFINE_STEPS of refinement on
      phase 10d's problem: the gradient goes through the refinement's
      descent, and the cost it reaches is finite and below its start.

    Each prints its seconds and its peak device memory above what was held
    before it (the fed draws of the stochastic generation are TUNE_POP x
    TUNE_M x TUNE_R x TUNE_T x TUNE_K x 2 floats)."""
    from pytorch_mppi_tpu_torch import MPPI, autotune

    f32 = dict(dtype=torch.float32, device=dev)
    report = {}

    def noisy_toy(s_, a, rng):
        return env.dynamics(s_, a) + TUNE_NOISE * torch.randn(
            s_.shape, generator=rng, device=s_.device, dtype=s_.dtype)

    def peaked(fn):
        """``clock(fn)`` and the peak device memory in MiB above what was
        held before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        secs, out = clock(fn)
        return secs, out, (torch.cuda.max_memory_allocated() - held) / 2**20

    for name, steps in (("stochastic", 0), ("refinement", TUNE_REFINE_STEPS)):
        mppi = MPPI(noisy_toy, env.running_cost, 2,
                    noise_sigma=torch.diag(torch.tensor([5.0, 5.0], **f32)),
                    num_samples=TUNE_K, horizon=TUNE_T, u_max=torch.tensor([2.0, 2.0], **f32),
                    lambda_=1.0, seed=1, stochastic_dynamics=True,
                    gradient_refinement_steps=steps, device=dev)
        ev = autotune.PopulationEvaluator(mppi, env.start, num_refinement_steps=TUNE_R,
                                          num_trajectories=TUNE_M, seed=3)
        seeds = autotune.PopulationEvaluator(mppi, env.start, seed=3)._stream_seeds(
            TUNE_POP * TUNE_M)
        reset()
        secs, res, peak_mib = peaked(lambda: ev(cands))
        check(not launched(), f"phase 10e [{name}]: the generation launched {launched()}")
        fns, score = ev._planning_fns(), ev._default_cost_fn()
        draws = sum(z.numel() * z.element_size()
                    for z in ev._draws(fns, seeds[:1], mppi._state.counter)) * TUNE_POP * TUNE_M

        def loop():
            costs = []
            for p in TUNE_LOOPED:
                cand = cands[p]
                params = mppi._params._replace(
                    noise_sigma=torch.diag(cand["sigma"]), noise_mu=cand["mu"],
                    lambda_=torch.tensor(cand["lambda"], **f32))
                per = []
                for m in range(TUNE_M):
                    state = mppi._state._replace(seed=seeds[p * TUNE_M + m])
                    for _ in range(TUNE_R):
                        state, _, _ = fns.step_no_shift(params, state, env.start)
                    per.append(score(fns.get_rollouts(params, env.start, state.U)[0], state.U))
                costs.append(torch.stack(per).mean())
            return torch.stack(costs)

        loop_s, loop_costs = clock(loop)
        got = res.costs[list(TUNE_LOOPED)]
        rel = float(((got - loop_costs).abs() / loop_costs.abs()).max())
        finite = bool(torch.isfinite(res.costs).all()) and tuple(res.costs.shape) == (TUNE_POP,)
        check(finite and rel <= TUNE_RTOL,
              f"phase 10e [{name}]: the vmapped generation against the loop: {rel:.3g} "
              f"relative (limit {TUNE_RTOL}), finite and shaped {finite}")
        report[name] = dict(vmapped_s=secs, loop_s=loop_s, looped=list(TUNE_LOOPED), max_rel=rel,
                            peak_mib=peak_mib, fed_mib=draws / 2**20)
        print(f"# tuning {name} generation ({TUNE_POP} candidates x {TUNE_M} streams x "
              f"{TUNE_R} refinements, K={TUNE_K} T={TUNE_T}"
              + (f", {TUNE_REFINE_STEPS} refinement steps" if name == "refinement" else "")
              + f"): vmapped {secs:.4f} s, peak {peak_mib:.1f} MiB above what was held before "
              f"it, fed {draws / 2**20:.1f} MiB; the loop over candidates "
              f"{list(TUNE_LOOPED)} {loop_s:.4f} s, max relative difference {rel:.3g}, 0 launches")
        del mppi, ev, res

    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], **f32)
    goal = torch.tensor([2.0, 2.0], **f32)
    ctrl = MPPI(lambda s, a: s + a @ B.T, lambda s, a: ((goal - s) ** 2).sum(dim=-1), 2,
                noise_sigma=torch.eye(2, **f32) * 0.05, num_samples=GRAD_K, horizon=GRAD_T,
                lambda_=20.0, seed=0, gradient_refinement_steps=TUNE_REFINE_STEPS, device=dev)
    ev = autotune.PopulationEvaluator(ctrl, torch.tensor([-3.0, -2.0], **f32),
                                      num_refinement_steps=GRAD_R, num_trajectories=GRAD_M,
                                      seed=1)
    tuner = autotune.Autotune([autotune.SigmaParameter(ctrl), autotune.LambdaParameter(ctrl)],
                              evaluate_fn=lambda: ev([{}]),
                              optimizer=autotune.GradientOpt(lr=0.2,
                                                             steps_per_iteration=GRAD_ADAM),
                              population_evaluate_fn=ev)
    c0 = autotune.mean_cost(ev([{}]).costs)
    secs, res, peak_mib = peaked(tuner.optimize_step)
    cost = autotune.mean_cost(res.costs)
    check(math.isfinite(cost) and cost < c0,
          f"phase 10e: GradientOpt with refinement reached {cost} from {c0}")
    report["gradient"] = dict(first=c0, cost=cost, step_s=secs, adam_ms=1e3 * secs / GRAD_ADAM,
                              peak_mib=peak_mib)
    print(f"# tuning GradientOpt with {TUNE_REFINE_STEPS} refinement steps: first {c0:.4f}, "
          f"after one optimize_step of {GRAD_ADAM} Adam updates {cost:.4f} "
          f"({cost / c0:.4f} of it); {secs:.4f} s ({1e3 * secs / GRAD_ADAM:.3f} ms an Adam "
          f"step, its scoring included), peak {peak_mib:.1f} MiB above what was held before it")
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
        mbpo=mbpo_callables(dev),
        lq=(lambda s, u: s + u @ B.T, lambda s, u: ((goal - s) ** 2).sum(-1)),
        pendulum=(lambda s, u: pendulum_dynamics(s, u), lambda s, u: pendulum_running_cost(s, u)),
        step=(lambda s, u, t: s + u @ B.T * (1.0 + 0.01 * t),
              lambda s, u, t: ((goal - s) ** 2).sum(-1) * (1.0 + 0.005 * t)),
        terminal=lambda s, u: (w * (s - goal) ** 2).sum(-1) + 0.2 * (u ** 2).sum(-1))


def mbpo_callables(dev):
    """Phase 4e's untagged network: an ``nn.Sequential`` of ``MBPO_SIZES``
    (Linear layers with SiLU between them; seeded weights of scale
    1/sqrt(fan-in), the last layer's scaled by QUAD_STEP) on (state,
    action), a residual model of the quadrotor's plant, with the quadratic
    cost toward QUAD_GOAL."""
    g = torch.Generator().manual_seed(23)
    layers = []
    for a, b in zip(MBPO_SIZES[:-1], MBPO_SIZES[1:]):
        lin = torch.nn.Linear(a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(b, a, generator=g) / math.sqrt(a))
            lin.bias.copy_(torch.randn(b, generator=g) * 0.1)
        layers += [lin, torch.nn.SiLU()]
    net = torch.nn.Sequential(*layers[:-1]).to(dev)
    with torch.no_grad():
        net[-1].weight.mul_(QUAD_STEP)
        net[-1].bias.mul_(QUAD_STEP)
    goal = torch.tensor(QUAD_GOAL, device=dev)
    return (lambda s, u: s + net(torch.cat([s, u], dim=-1)),
            lambda s, u: ((goal - s) ** 2).sum(-1))


def tdmpc_callables(dev, nu=TD_NU, seed=47):
    """Phase 4f's world model, untagged: TD-MPC's ``mlp`` (Linear, ELU,
    Linear, ELU, Linear) for the latent dynamics and the reward, and its
    two ``q`` networks (Linear, LayerNorm, Tanh, Linear, ELU, Linear), on
    (z, u), weights seeded from ``seed``, on ``dev``.  Returns (dynamics(z,
    u, t), running_cost(z, u, t), terminal_final_cost(z, u)); the running
    cost discounts the reward by gamma^t, written exp(t log gamma) (t a 0-d
    tensor in the trace, an int on the plain path), and the terminal cost
    values the last latent with the last action (TD-MPC feeds its policy's
    action there)."""
    g = torch.Generator().manual_seed(seed)
    n_in = TD_NX + nu

    def linear(a, b):
        lin = torch.nn.Linear(a, b)
        k = 1.0 / math.sqrt(a)
        with torch.no_grad():
            lin.weight.copy_(torch.rand(b, a, generator=g) * 2 * k - k)
            lin.bias.copy_(torch.rand(b, generator=g) * 2 * k - k)
        return lin

    def mlp(out):
        return torch.nn.Sequential(linear(n_in, TD_H), torch.nn.ELU(), linear(TD_H, TD_H),
                                   torch.nn.ELU(), linear(TD_H, out)).to(dev)

    def q():
        return torch.nn.Sequential(linear(n_in, TD_H), torch.nn.LayerNorm(TD_H), torch.nn.Tanh(),
                                   linear(TD_H, TD_H), torch.nn.ELU(), linear(TD_H, 1)).to(dev)

    dyn_net, rew_net, q1, q2 = mlp(TD_NX), mlp(1), q(), q()
    log_gamma = math.log(TD_GAMMA)

    def dynamics(z, u, t):
        return dyn_net(torch.cat([z, u], dim=-1))

    def running_cost(z, u, t):
        discount = torch.exp(torch.as_tensor(t, device=z.device) * log_gamma)
        return -discount * rew_net(torch.cat([z, u], dim=-1))[..., 0]

    def terminal_cost(z, u):
        zu = torch.cat([z, u], dim=-1)
        return -(TD_GAMMA ** TD_T) * torch.minimum(q1(zu), q2(zu))[..., 0]

    return dynamics, running_cost, terminal_cost


def tdmpc_plan(dev):
    """Phase 4f's traced models and the libraries phase 2 builds for them:
    the humanoid's world model with its terminal cost (kernel A's three
    variants and the batched pair) and without (the legacy rollout, which
    takes none), and the dog's (kernel A).  Returns (callables, models,
    plan of label -> (kernel, variant))."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    fns, models, plan = {}, {}, {}
    for name, nu in (("tdmpc", TD_NU), ("dog", TD_DOG_NU)):
        start = time.perf_counter()
        fns[name] = tdmpc_callables(dev, nu)
        cfg = MPPIConfig(nx=TD_NX, nu=nu, K=TD_K, T=TD_T, step_dependent_dynamics=True)
        model = BL.kernel_model(cfg, *fns[name][:2])
        terminal = BL.kernel_terminal(cfg, fns[name][2])
        models[name] = (model, terminal)
        kernel = BL.generated_kernel(model, terminal)
        print(f"# traced world model [{name}] nx={TD_NX} nu={nu}: "
              f"{time.perf_counter() - start:.1f} s to trace; dense layers (dynamics, running "
              f"cost; terminal cost) {_dense_layer_shapes(model, terminal)}; "
              f"{BL._count_ops(model.program, model.outputs)} scalar operations a step; "
              f"activation rows of {BL.kernel_act_ld(model, terminal)} floats; header "
              f"{len(kernel.header())} characters")
        if name == "dog":
            plan["dog mppi"] = (kernel, FS.MPPI)
            continue
        plan.update({f"tdmpc {v}": (kernel, getattr(FS, v.upper()))
                     for v in ("mppi", "smppi", "kmppi", "batched")})
        plan["tdmpc rollout"] = (BL.generated_kernel(model, None), FS.ROLLOUT)
    return fns, models, plan


def _dense_layer_shapes(model, terminal):
    prog, outs = model.program, model.outputs
    shapes = lambda p, o: [(a, b) for *_, a, b in p.dense_layers(o)]  # noqa: E731
    return (shapes(prog, outs[:model.nx]), shapes(prog, outs[model.nx:]),
            shapes(terminal.program, [terminal.output]))


def variant_mask(variant):
    """The ``FUSED_MPPI_GENERATED`` mask of a build's variant, or of a
    tuple of variants built into one library."""
    return sum(1 << v for v in variant) if isinstance(variant, tuple) else 1 << variant


def start_builds(plan):
    """Each (kernel, variant) of ``plan`` built in a thread of its own (one
    ``nvcc`` each; a tuple of variants into one library): label ->
    (thread, kernel, variant, result)."""
    builds = {}
    for label, (kernel, variant) in plan.items():
        result = {}

        def run(kernel=kernel, variant=variant, result=result):
            start = time.perf_counter()
            try:
                if isinstance(variant, tuple):
                    kernel.library(variant[0], variant[1:])
                else:
                    kernel.library(variant)
            except BaseException as e:  # reported, with nvcc's output, after the join
                result["error"] = e
            result["wall_s"] = time.perf_counter() - start

        thread = threading.Thread(target=run, name=f"nvcc {label}")
        thread.start()
        builds[label] = (thread, kernel, variant, result)
    return builds


def td_operands(dev, gen, nu, x0):
    """Kernel A's operands for each variant at phase 4f's shape (K = TD_K,
    T = TD_T): every sample from the latent ``x0``, a nominal U of scale
    0.3, sigma TD_SIGMA, the drawn rows' and the actions' bounds [-1, 1],
    the action cost lambda U sigma^-2, lambda TD_LAMBDA."""
    from pytorch_mppi_tpu_torch import RBFKernel
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    nsp = TD_T // 2
    D, R_k = TD_T * nu, nsp * nu
    x0T = x0[:, None].expand(TD_NX, TD_K)
    full = lambda v, n=D: torch.full((n,), v, device=dev)  # noqa: E731
    lam, one = torch.tensor(TD_LAMBDA, device=dev), torch.tensor(1.0, device=dev)
    U2 = torch.randn(D, generator=gen, device=dev) * 0.3
    a_flat = (TD_LAMBDA * U2 / TD_SIGMA ** 2).contiguous()
    interp, _ = interpolation_operators(RBFKernel(2.0), TD_T, nsp, torch.float32, device=dev)
    Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
    return x0T, {
        "mppi": (x0T, U2, full(TD_SIGMA), full(0.0), full(-1.0), full(1.0), a_flat, lam),
        "smppi": (x0T, U2, torch.randn(D, generator=gen, device=dev) * 0.3, full(TD_SIGMA),
                  full(0.0), full(-1.0), full(1.0), full(-1.0), full(1.0), a_flat, lam, one, one),
        "kmppi": (x0T, U2, torch.randn(R_k, generator=gen, device=dev) * 0.3,
                  full(TD_SIGMA, R_k), full(0.0, R_k), full(-1.0, R_k), full(1.0, R_k),
                  full(-1.0), full(1.0), a_flat, Wt, lam),
    }


def world_model(dev, gen, plan):
    """Phase 4f, a TD-MPC world model in the kernels (``TD_*``; traced in
    phase 2, ``tdmpc_plan``, its libraries built there): its kernels'
    registers, spill stores (none) and blocks an SM (``block_ptxas``) and
    each library's ``nvcc`` seconds; kernel A's three variants with the
    terminal cost, the batched pair (``TD_BATCH_N`` agents) and the legacy
    rollout (no terminal cost) against their plain versions in bits mode,
    each cost's error against a float64 rollout within ``F64_FACTOR`` of
    the float32 plain version's (``f64_agree``, its limit ``lim``), and so
    each cost within lim + the plain version's error of the plain version's,
    m, s and delta/s as ``agree``; kernel A again at the dog's ``TD_DOG_NU`` actions; each
    kernel's device time (a CUDA graph of 20 calls) beside its bounds
    (``bound``, ``tc_bound``) and its plain version; then the main path,
    ``TD_COMMANDS`` closed-loop commands of MPPI (``TD_ITERS`` iterations a
    command, the world model as the plant, in the latent space) with the
    launch counters showing kernel A's block kernel and no plain path,
    against the plain route's median, and ``TD_SHORT`` commands of every
    other route with exact launch counts.  Returns the rows' numbers."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI, MPPI_Batched, RBFKernel
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG

    phase_start = time.perf_counter()
    fns, models = plan["tdmpc_fns"], plan["tdmpc_models"]
    factories = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}
    report = {"timed": {}, "err": {}, "loops": {}, "build_s": {}}

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    def launched():
        return {k: v for k, v in FS.launches.items() if v}

    def mark(what):
        print(f"# phase 4f: {what} done at {time.perf_counter() - phase_start:.1f} s")

    def bits(R, cols):
        return torch.randint(-2**31, 2**31 - 1, (R, cols), dtype=torch.int32, generator=gen,
                             device=dev)

    def seed():
        return tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))

    report["ptxas"] = block_ptxas(plan, [k for k in plan["builds"] if k.split()[0] in
                                         ("tdmpc", "dog")], named=False)
    for e in report["ptxas"]:
        print(f"# ptxas [{e['log']}: {e['name']}]: {e.get('registers')} registers, "
              f"{e.get('spills')} bytes spill stores, {e.get('stack')} bytes stack frame, "
              f"{e['blocks_by_registers']} blocks an SM by registers")
    check(report["ptxas"] and all(e.get("spills") == 0 for e in report["ptxas"]),
          "a world model's kernel spills (or none was found in the build logs)")
    report["ptxas_of"] = {}
    for label, (_, kernel, variant, _) in plan["builds"].items():
        if label.split()[0] in ("tdmpc", "dog"):
            report["build_s"][label] = plan["build_s"].get(label)
            log = _build.generated_path(kernel.header(), variant_mask(variant)).with_suffix(
                ".log").name
            entries = [e for e in report["ptxas"] if e["log"] == log]
            if entries:  # the kernel's instantiations, tiles in shared and in global memory
                report["ptxas_of"][label] = dict(
                    registers=max(e.get("registers", 0) for e in entries),
                    spills=max(e.get("spills", 0) for e in entries),
                    blocks_by_registers=min(e["blocks_by_registers"] for e in entries))
    print(f"# world model libraries, nvcc seconds: {report['build_s']}")

    def check_kernel_a(variant, name, nu):
        model, terminal = models[name]
        cfg = MPPIConfig(nx=TD_NX, nu=nu, K=TD_K, T=TD_T, diag_sigma=True,
                         step_dependent_dynamics=True, smppi=variant == "smppi",
                         num_support_pts=TD_T // 2 if variant == "kmppi" else 0)
        solve = factories[variant](cfg, model, emit_perturbed=True, terminal_final=fns[name][2])
        x0 = torch.randn(TD_NX, generator=gen, device=dev) * 0.5
        x0T, ops = td_operands(dev, gen, nu, x0)
        lead, out = bits(solve.spec.R, solve.bits_cols), []
        reset_launches()
        dk, mk, sk, ck, _ = solve(lead, *ops[variant])
        torch.cuda.synchronize()
        n_k = launched()
        plain_ms = events_ms(lambda: out.append(solve.plain(lead, *ops[variant])), 1, warmup=0)
        dp, mp, sp, cp, pp = out.pop()
        ok, e_k, e_p, lim, _ = f64_agree(model, ck, cp, pp, x0T, TD_T, nu, terminal=terminal)
        ok2, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, TD_LAMBDA, mk, mp, sk, sp,
                                         rtol=0.0, atol=lim + e_p)
        ok = ok and ok2 and n_k == {f"generated_{variant}_block": 1}
        key = f"{variant}" if name == "tdmpc" else f"{variant} {name}"
        report["err"][key] = dict(kernel_f64=e_k, plain_f64=e_p, update=u_err)
        print(f"# world model [{name} {variant} bits] nx={TD_NX} nu={nu} K={TD_K} T={TD_T} "
              f"S={solve.tile_k} group {solve.act_rows} tiles {solve.tiles}: cost error against "
              f"float64 kernel {e_k:.3e}, plain {e_p:.3e} ({e_k / max(e_p, 1e-30):.2f}x; limit "
              f"{lim:.3e}) | kernel against plain {c_err:.3e} | delta/s err {u_err:.3e} (tol "
              f"{w_tol:.3e}) | launches {n_k}" + ("" if ok else "  <-- FAIL"))
        check(ok, f"the world model's kernel A disagrees with its plain version: {name}/{variant}")
        k = seed()
        args = ops[variant]
        dev_ms = graph_ms(lambda: solve(k, *args), 20)
        op = args[3] if variant != "mppi" else args[2]
        work = fused_work(cfg, model, k, x0T, op, variant=variant, terminal=terminal)
        f32_ms, _ = bound(work)
        macs = TD_K * (TD_T * _dense_macs(model) + _dense_macs(terminal))
        bound_ms, bound_by = tc_bound(work, macs)
        smem = FS.launch_geometry(solve.spec)["block_smem"]
        report["timed"][key] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
        print(f"# kernel alone [{variant} world model {name}] K={TD_K} T={TD_T} seed: device "
              f"{dev_ms:.6f} ms (a CUDA graph of 20 calls; {-(-TD_K // solve.tile_k)} blocks, "
              f"{FS.blocks_per_sm(smem)} an SM by its {smem} bytes of shared memory) | plain "
              f"version {plain_ms:.5f} ms | bound {bound_ms:.6f} ms by {bound_by} with the dense "
              f"layers on the tensor cores (3xTF32, {macs} multiply-adds): "
              f"{dev_ms / bound_ms:.1f}x | float32 bound {f32_ms:.6f} ms: {dev_ms / f32_ms:.1f}x "
              f"| {card_line()}")
        mark(f"kernel A {name} {variant}")

    print(f"# kernel vs plain [world model]: each cost's error against a float64 rollout of the "
          f"same actions (its terminal cost too) within {F64_FACTOR}x the float32 plain "
          f"version's (f64_agree); m, s and delta/s as the other cases (agree)")
    for variant in FS.VARIANTS:
        check_kernel_a(variant, "tdmpc", TD_NU)
    check_kernel_a("mppi", "dog", TD_DOG_NU)

    # the batched pair: TD_BATCH_N agents, each its own latent
    model, terminal = models["tdmpc"]
    D = TD_T * TD_NU
    b_cfg = MPPIConfig(nx=TD_NX, nu=TD_NU, K=TD_K, T=TD_T, diag_sigma=True,
                       step_dependent_dynamics=True)
    solve = FS.make_transposed_batched_solve(b_cfg, TD_BATCH_N, model,
                                             terminal_final=fns["tdmpc"][2])
    vec = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
    U2T = (torch.randn(TD_BATCH_N, D, generator=gen, device=dev) * 0.3).T
    rest = (torch.randn(TD_NX, TD_BATCH_N, generator=gen, device=dev) * 0.5, U2T, vec(TD_SIGMA),
            vec(0.0), vec(-1.0), vec(1.0), TD_LAMBDA * U2T / TD_SIGMA ** 2,
            torch.tensor(TD_LAMBDA, device=dev))
    lead, out = bits(D, solve.bits_cols), []
    reset_launches()
    dk, msk, ck = solve(lead, *rest)
    torch.cuda.synchronize()
    n_k = launched()
    plain_ms = events_ms(lambda: out.append(solve.plain(lead, *rest)), 1, warmup=0)
    dp, msp, cp = out.pop()
    pert, x0_all = batched_pert(solve, lead, rest, TD_T, TD_NU, TD_K)
    ok, e_k, e_p, lim, _ = f64_agree(model, ck.reshape(-1), cp.reshape(-1), pert, x0_all, TD_T,
                                     TD_NU, terminal=terminal)
    ok2, c_err, u_err, _ = agree(ck, cp, dk / msk[1], dp / msp[1], TD_LAMBDA, msk[0], msp[0],
                                 msk[1], msp[1], rtol=0.0, atol=lim + e_p)
    ok = ok and ok2 and n_k == {"generated_batched_block": 2}
    report["err"]["batched"] = dict(kernel_f64=e_k, plain_f64=e_p, update=u_err)
    print(f"# world model [batched bits] N={TD_BATCH_N} K={TD_K} P={solve.plant_group} group "
          f"{solve.act_rows} tiles {solve.tiles}: cost error against float64 kernel {e_k:.3e}, "
          f"plain {e_p:.3e} (limit {lim:.3e}) | kernel against plain {c_err:.3e} | delta/s err "
          f"{u_err:.3e} | launches {n_k}" + ("" if ok else "  <-- FAIL"))
    check(ok, "the world model's batched pair disagrees with its plain version")
    mark("the batched pair's check")
    k = seed()
    dev_ms = graph_ms(lambda: solve(k, *rest), 20)
    work = fused_work(b_cfg, model, k, rest[0], rest[2], variant="batched", plants=TD_BATCH_N,
                      terminal=terminal)
    f32_ms, _ = bound(work)
    bound_ms, bound_by = tc_bound(work, TD_BATCH_N * TD_K * (TD_T * _dense_macs(model)
                                                             + _dense_macs(terminal)))
    report["timed"]["batched"] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
    print(f"# kernel alone [batched world model] N={TD_BATCH_N} K={TD_K} seed: device "
          f"{dev_ms:.6f} ms (a CUDA graph of 20 calls) | plain version {plain_ms:.5f} ms | bound "
          f"{bound_ms:.6f} ms by {bound_by} (tensor cores): {dev_ms / bound_ms:.1f}x | float32 "
          f"bound {f32_ms:.6f} ms: {dev_ms / f32_ms:.1f}x | {card_line()}")

    # the legacy rollout: the dynamics' and the reward's layers, no terminal cost
    r = LG.make_fused_rollout(MPPIConfig(nx=TD_NX, nu=TD_NU, K=TD_K, T=TD_T,
                                         step_dependent_dynamics=True), model)
    x0 = torch.randn(TD_NX, generator=gen, device=dev) * 0.5
    x0_K = x0[None].expand(TD_K, TD_NX)
    u = torch.clamp(torch.randn(TD_K, TD_T, TD_NU, generator=gen, device=dev) * TD_SIGMA, -1, 1)
    reset_launches()
    ck = r(x0_K, u)
    torch.cuda.synchronize()
    n_k = launched()
    out = []
    plain_ms = events_ms(lambda: out.append(r.plain(x0_K, u)), 1, warmup=0)
    cp = out.pop()
    ok, e_k, e_p, lim, _ = f64_agree(model, ck, cp, u.reshape(TD_K, -1).T, x0_K.T.contiguous(),
                                     TD_T, TD_NU)
    ok = ok and n_k == {"generated_rollout_block": 1}
    report["err"]["rollout"] = dict(kernel_f64=e_k, plain_f64=e_p)
    dev_ms = graph_ms(lambda: r(x0_K, u), 20)
    work = rollout_work(model, x0_K, u)
    f32_ms, _ = bound(work)
    bound_ms, bound_by = tc_bound(work, TD_K * TD_T * _dense_macs(model))
    report["timed"]["rollout"] = (dev_ms, plain_ms, bound_ms, bound_by, f32_ms)
    print(f"# world model [rollout] K={TD_K} T={TD_T}: cost error against float64 kernel "
          f"{e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}) | launches {n_k} | device "
          f"{dev_ms:.6f} ms | plain version {plain_ms:.5f} ms | bound {bound_ms:.6f} ms by "
          f"{bound_by} (tensor cores): {dev_ms / bound_ms:.1f}x | float32 bound {f32_ms:.6f} ms"
          + ("" if ok else "  <-- FAIL"))
    check(ok, "the world model's rollout disagrees with its plain version")
    mark("the rollout")

    # the main path: MPPI planning in the latent space, the world model the plant
    dyn, _, term = fns["tdmpc"]

    def plant(z, a):
        with torch.no_grad():
            return dyn(z, a, 0)

    def controller(cls, use_pallas, nu=TD_NU, fn=None, **kw):
        d, c, t = fn or fns["tdmpc"]
        built = time.perf_counter()
        with Captured() as warned:
            ctrl = cls(d, c, TD_NX, TD_SIGMA ** 2 * torch.eye(nu, device=dev),
                       num_samples=TD_K, horizon=TD_T, lambda_=TD_LAMBDA,
                       u_min=-torch.ones(nu, device=dev), u_max=torch.ones(nu, device=dev),
                       num_iterations=TD_ITERS, step_dependent_dynamics=True, seed=3,
                       use_pallas=use_pallas, device=dev, **kw)
        print(f"# phase 4f: {cls.__name__}(use_pallas={use_pallas!r}) built in "
              f"{time.perf_counter() - built:.1f} s (its trace)")
        return ctrl, warned.messages

    def loop(ctrl, z, commands, batched=False, step=plant):
        """``commands`` commands from latent z, the plant ``step``;
        (per-command host ms, final z)."""
        times = []
        with torch.no_grad():
            for _ in range(commands):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = ctrl.command(z)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 1.0,
                      "a world-model command is not finite or out of its bounds")
                z = step(z, a) if batched else step(z[None], a[None])[0]
        return times, z

    z0 = torch.randn(TD_NX, generator=gen, device=dev) * 0.5
    fused, warned = controller(MPPI, True, terminal_final_cost=term)
    check(fused._fns.fused and not [m for m in warned if "plain torch path" in m],
          f"the world model's MPPI took the plain path: {warned}")
    reset_launches()
    times, z = loop(fused, z0, TD_COMMANDS)
    n = launched()
    plain, warned = controller(MPPI, False, terminal_final_cost=term)
    plain_times, z_p = loop(plain, z0, TD_COMMANDS)
    med, p_med = statistics.median(times), statistics.median(plain_times)
    report["loops"]["mppi", "fused"] = dict(launches=n, median_ms=med, plain_median_ms=p_med,
                                            times_ms=times)
    print(f"# world model main path [MPPI, {TD_ITERS} iterations a command] {TD_COMMANDS} "
          f"commands in the latent space: command median {med:.4f} ms (p90 "
          f"{sorted(times)[int(0.9 * len(times))]:.4f}) against the plain route's "
          f"{p_med:.4f} ms ({p_med / med:.2f}x) | launches {n} | |z| {float(z0.norm()):.3f} -> "
          f"{float(z.norm()):.3f} (plain route {float(z_p.norm()):.3f}) | {card_line()}")
    check(n == {"generated_mppi_block": TD_COMMANDS * TD_ITERS},
          f"the world model's main path launched {n}, expected generated_mppi_block "
          f"{TD_COMMANDS * TD_ITERS} and nothing else")
    del fused, plain
    mark("the main path")

    # every other route: TD_SHORT commands each, exact launch counts
    dlim = torch.ones(TD_NU, device=dev)
    routes = [
        ("smppi", SMPPI, True, dict(terminal_final_cost=term, w_action_seq_cost=0.1, delta_t=1.0,
                                    action_min=-dlim, action_max=dlim),
         dict(generated_smppi_block=TD_ITERS)),
        ("kmppi", KMPPI, True, dict(terminal_final_cost=term, num_support_pts=TD_T // 2,
                                    kernel=RBFKernel(2.0)), dict(generated_kmppi_block=TD_ITERS)),
        ("batched", MPPI_Batched, "kernel_rng", dict(terminal_final_cost=term,
                                                     num_envs=TD_BATCH_N),
         dict(generated_batched_block=2 * TD_ITERS)),
        ("rollout", MPPI, "rollout", {},
         dict(generated_rollout_block=TD_ITERS, weighted_update=TD_ITERS)),
        ("dog", MPPI, True, dict(terminal_final_cost=fns["dog"][2]),
         dict(generated_mppi_block=TD_ITERS)),
    ]
    for name, cls, use_pallas, kw, per_command in routes:
        nu = TD_DOG_NU if name == "dog" else TD_NU
        ctrl, warned = controller(cls, use_pallas, nu, fns["dog"] if name == "dog" else None,
                                  **kw)
        check(ctrl._fns.fused and not [m for m in warned if "plain torch path" in m],
              f"the world model's {name} route took the plain path: {warned}")
        zs = z0[None] + 0.3 * torch.randn(TD_BATCH_N, TD_NX, generator=gen, device=dev)
        step = plant
        if name == "dog":  # the dog's own latent dynamics
            def step(z, a, d_dyn=fns["dog"][0]):
                with torch.no_grad():
                    return d_dyn(z, a, 0)
        reset_launches()
        times, _ = loop(ctrl, zs if name == "batched" else z0, TD_SHORT, name == "batched", step)
        n = launched()
        expect = {k: TD_SHORT * v for k, v in per_command.items()}
        report["loops"][name] = dict(launches=n, median_ms=statistics.median(times))
        print(f"# world model loop [{name}] {TD_SHORT} commands: median "
              f"{statistics.median(times):.4f} ms a command (host clock) | launches {n}")
        check(n == expect, f"the world model's {name} route launched {n}, expected {expect}")
        del ctrl
        mark(f"the {name} loop")
    report["seconds"] = time.perf_counter() - phase_start
    print(f"# phase 4f, the world model: {report['seconds']:.1f} s")
    return report


def world_kernel_rows(report):
    """Phase 7's rows for the world model (phase 4f): the generated block
    kernels of TD-MPC's networks, each with its numbers."""
    rows = []
    insts = {"mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>", 512, "mppi"),
             "smppi": ("mppi_fused_partial<Generated, 32, ..., kSMPPI>", 755, "smppi"),
             "kmppi": ("mppi_fused_partial<Generated, 32, ..., kKMPPI>", 940, "kmppi"),
             "batched": ("batched_partial<Generated, 32, kGlobal> + flash_merge", 1118, "batched"),
             "rollout": ("fused_rollout<Generated, 32>", 75, "rollout"),
             "mppi dog": ("mppi_fused_partial<Generated, 32, ..., kMPPI>", 512, "mppi")}
    for key, (inst, line, variant) in insts.items():
        d_ms, p_ms, b_ms, b_by, f32_ms = report["timed"][key]
        loop = report["loops"]["mppi", "fused"] if key == "mppi" else report["loops"][
            "dog" if key == "mppi dog" else key]
        nu = TD_DOG_NU if key == "mppi dog" else TD_NU
        label = "dog mppi" if key == "mppi dog" else f"tdmpc {variant}"
        rows.append({
            "name": f"fused_mppi {key}, TD-MPC world model nx={TD_NX} nu={nu} ({inst}, "
                    f"Generated::kBlock)",
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": loop["launches"].get(f"generated_{variant}_block", 0),
            "max_abs_err": report["err"][key]["kernel_f64"],
            "max_abs_err_plain_f32": report["err"][key]["plain_f64"],
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_ms_float32": f32_ms,
            "library_ms": None,
            "build_s": report["build_s"].get(label),
            **report["ptxas_of"].get(label, {}),
        })
    rows[0].update(command_median_ms=report["loops"]["mppi", "fused"]["median_ms"],
                   plain_command_median_ms=report["loops"]["mppi", "fused"]["plain_median_ms"])
    return rows


def swarm_callables(dev, agents=SWARM_AGENTS):
    """Phase 4g's swarm as a user writes it in torch, untagged: ``agents``
    planar double integrators, the state their positions then their
    velocities, the actions their accelerations (``SWARM_DT`` a step); the
    running cost |p - goal|² + 0.1 |v|² + the pairwise collision cost
    Σ_{i<j} exp(-|p_i - p_j|² / 0.25), with ``view``, broadcasting and a
    constant upper-triangle mask, no matrix product (so the tracer makes no
    dense layer).  The goals are seeded in [-2, 2]²."""
    g = torch.Generator().manual_seed(31)
    goal = (torch.rand(agents, 2, generator=g) * 4 - 2).to(dev)
    mask = torch.triu(torch.ones(agents, agents), 1).to(dev)
    half = 2 * agents

    def dynamics(s, u):
        p, v = s[:, :half].view(-1, agents, 2), s[:, half:].view(-1, agents, 2)
        v2 = v + u.view(-1, agents, 2) * SWARM_DT
        p2 = p + v2 * SWARM_DT
        return torch.cat([p2.reshape(-1, half), v2.reshape(-1, half)], dim=-1)

    def cost(s, u):
        p, v = s[:, :half].view(-1, agents, 2), s[:, half:].view(-1, agents, 2)
        d = p[:, :, None, :] - p[:, None, :, :]
        near = (torch.exp(-(d ** 2).sum(-1) / 0.25) * mask).sum((-1, -2))
        return ((p - goal) ** 2).sum((-1, -2)) + 0.1 * (v ** 2).sum((-1, -2)) + near

    return dynamics, cost


def step4_callables(dev):
    """Phase 4g's program of the tracer's last primitives: a linear plant
    (nx = STEP4_NX, nu = STEP4_NU, B seeded) whose running cost, beside
    |goal - x|², reads erfinv, nextafter, both integer shifts, cummax,
    cummin, logcumsumexp and interior padding (``out[:, ::2] = x``)."""
    g = torch.Generator().manual_seed(37)
    nx, nu = STEP4_NX, STEP4_NU
    B = (torch.randn(nx, nu, generator=g) * 0.3).to(dev)
    goal = torch.linspace(-1.0, 1.0, nx).to(dev)

    def dynamics(s, u):
        return s + u @ B.T

    def cost(s, u):
        e = torch.erfinv(torch.tanh(0.5 * s)).sum(-1)
        n = (torch.nextafter(s, torch.zeros_like(s)) - s).sum(-1) * 1e6
        i = (torch.floor(s * 4).long() << 2) + (torch.floor(u[:, :1] * 8).long() >> 1)
        c = torch.cummax(s, 1).values.sum(-1) - torch.cummin(s, 1).values.sum(-1)
        lc = torch.logcumsumexp(u, 1)[:, nu - 1]
        pad = s.new_zeros(s.shape[0], 2 * nx - 1)
        pad[:, ::2] = s
        return ((goal - s) ** 2).sum(-1) + 0.01 * (e + n + 1e-2 * i.to(s.dtype).sum(-1) + c
                                                     + lc + (pad ** 2).sum(-1))

    return dynamics, cost


def dense_terminal(dev):
    """Phase 4g's traced terminal cost with dense layers, on (x_T, u_T)
    of the flagship's nx = nu = 2: tanh(tanh([x, u] W1) W2) summed, W1 (4,
    200) and W2 (200, 200) seeded."""
    g = torch.Generator().manual_seed(41)
    W1 = (torch.randn(4, 200, generator=g) * 0.5).to(dev)
    W2 = (torch.randn(200, 200, generator=g) * 0.07).to(dev)

    def terminal(s, a):
        return torch.tanh(torch.tanh(torch.cat([s, a], -1) @ W1) @ W2).sum(-1)

    return terminal


def toy64_model(dev):
    """Phase 4g's named toy2d beyond 32 states (``kernel_models.
    toy2d_model``, the JAX package's ``models/toy2d.py`` task at nx =
    SWARM_NX, nu = SWARM_NU): x' = x + u Bᵀ, cost |goal - x'|² + 0.1 |u|² +
    2 exp(-(c - x')ᵀ Q_h (c - x')), with B seeded, the goal in [-1, 1],
    the hill's centre at 0 and Q_h = 0.2 I."""
    from pytorch_mppi_tpu_torch.ops.kernel_models import toy2d_model

    g = torch.Generator().manual_seed(53)
    B = (torch.randn(SWARM_NX, SWARM_NU, generator=g) * 0.2).to(dev)
    goal = (torch.rand(SWARM_NX, generator=g) * 2 - 1).to(dev)
    center, Qh = torch.zeros(SWARM_NX, device=dev), 0.2 * torch.eye(SWARM_NX, device=dev)

    def dynamics(s, a):
        return s + a @ B.T

    def cost(s, a):
        dc = center - s
        return (((goal - s) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)
                + 2.0 * torch.exp(-(dc @ Qh * dc).sum(-1)))

    return toy2d_model(dynamics, cost, B, goal, 0.1, Qh, center, 2.0)


def wide_plan(dev):
    """Phase 4g's traced models and the libraries phase 2 builds for them
    (``start_builds``, behind the named library): the swarm's kernel A
    variants, batched pair and rollout in one library (one ``nvcc``); the
    step-4 program's kernel A; the trace of the named ``linear_quadratic``
    at nx = SWARM_NX, nu = SWARM_NU; the flagship's named model beside the
    traced dense terminal cost.  Returns (callables, models, plan)."""
    from pytorch_mppi_tpu_torch import linear_quadratic
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import batch_last as BL
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    fns, models, plan = {}, {}, {}
    start = time.perf_counter()
    fns["swarm"] = swarm_callables(dev)
    cfg = MPPIConfig(nx=SWARM_NX, nu=SWARM_NU, K=K, T=T)
    models["swarm"] = BL.kernel_model(cfg, *fns["swarm"])
    swarm = BL.generated_kernel(models["swarm"], None)
    plan["swarm all"] = (swarm, (FS.MPPI, FS.SMPPI, FS.KMPPI, FS.BATCHED, FS.ROLLOUT))
    print(f"# traced swarm [{SWARM_AGENTS} agents] nx={SWARM_NX} nu={SWARM_NU}: "
          f"{time.perf_counter() - start:.1f} s to trace; "
          f"{BL._count_ops(models['swarm'].program, models['swarm'].outputs)} scalar operations "
          f"a step, {len(models['swarm'].program.dense_layers(models['swarm'].outputs))} dense "
          f"layers; header {len(swarm.header())} characters")
    fns["step4"] = step4_callables(dev)
    models["step4"] = BL.kernel_model(MPPIConfig(nx=STEP4_NX, nu=STEP4_NU, K=K, T=T),
                                      *fns["step4"])
    plan["step4 mppi"] = (BL.generated_kernel(models["step4"], None), FS.MPPI)
    g = torch.Generator().manual_seed(43)
    lq64 = linear_quadratic((torch.randn(SWARM_NX, SWARM_NU, generator=g) * 0.2).to(dev),
                            (torch.rand(SWARM_NX, generator=g) * 2 - 1).to(dev))
    models["lq64 named"] = lq64
    models["lq64"] = BL.kernel_device_model(cfg, lq64)
    plan["lq64 mppi"] = (BL.generated_kernel(models["lq64"], None), FS.MPPI)
    flag = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
    B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], device=dev)
    lq = linear_quadratic(B, torch.tensor([2.0, 2.0], device=dev))
    fns["dense terminal"] = dense_terminal(dev)
    terminal = BL.kernel_terminal(flag, fns["dense terminal"])
    models["dense terminal"] = (BL.kernel_device_model(flag, lq, terminal), terminal, lq)
    plan["dense terminal mppi"] = (BL.generated_kernel(models["dense terminal"][0], terminal),
                                   FS.MPPI)
    models["toy64 named"] = toy64_model(dev)
    models["toy64"] = BL.kernel_device_model(cfg, models["toy64 named"])
    plan["toy64 mppi"] = (BL.generated_kernel(models["toy64"], None), FS.MPPI)
    start = time.perf_counter()
    fns["swarm max"] = swarm_callables(dev, MAX_AGENTS)
    models["swarm max"] = BL.kernel_model(
        MPPIConfig(nx=4 * MAX_AGENTS, nu=2 * MAX_AGENTS, K=K, T=MAX_T), *fns["swarm max"])
    near = BL.generated_kernel(models["swarm max"], None)
    plan["swarm max mppi"] = (near, FS.MPPI)
    print(f"# traced swarm near MAX_OPS [{MAX_AGENTS} agents] nx={4 * MAX_AGENTS} "
          f"nu={2 * MAX_AGENTS}: {time.perf_counter() - start:.1f} s to trace; "
          f"{BL._count_ops(models['swarm max'].program, models['swarm max'].outputs)} scalar "
          f"operations a step (the bound MAX_OPS {BL.MAX_OPS}); header {len(near.header())} "
          f"characters, {near.header().count('__noinline__')} functions in parts of at most "
          f"{BL.CHUNK} statements")
    return fns, models, plan


def swarm_x0(gen, dev, n=None, agents=SWARM_AGENTS):
    """Swarm states: positions uniform in [-2, 2]², velocities N(0, 0.3²);
    (4 agents,), or (n, 4 agents)."""
    shape = (n or 1, agents * 2)
    p = torch.rand(shape, generator=gen, device=dev) * 4 - 2
    v = torch.randn(shape, generator=gen, device=dev) * 0.3
    x = torch.cat([p, v], dim=-1)
    return x if n else x[0]


def rowmajor_pert(solve, bits, U, chol, mu, lo, hi):
    """The round-1 solve's (D, K) perturbed actions as its plain version
    draws them, for ``f64_agree``."""
    from pytorch_mppi_tpu_torch.ops import rowmajor as RM

    T_, nu = U.shape
    K_ = solve.spec.K
    z = RM._normals(bits, torch.arange(K_, device=bits.device), T_ * nu, (solve.K_pad, T_ * nu))
    pert = U.reshape(-1) + (z.reshape(K_, T_, nu) @ chol.T + mu).reshape(K_, -1)
    return torch.clamp(pert, lo.repeat(T_), hi.repeat(T_)).T.contiguous()


def wide_programs(dev, gen, plan):
    """Phase 4g, the dynamics bridge's last refusals lifted (traced in phase
    2, ``wide_plan``, the libraries built there): each new library's
    kernels' registers, spill stores and stack (``block_ptxas``) and its
    ``nvcc`` seconds; the swarm (``SWARM_*``, a per-sample program beyond
    32 states: a block program without layers) through kernel A's three
    variants and the legacy rollout at K = 10,000, T = 30 and the batched
    pair at N = BATCH_SMALL_N, K = BATCH_SMALL_K; the step-4 program's
    kernel A; the named ``linear_quadratic`` at nx = SWARM_NX (the trace of
    its callables); the flagship's named model beside a traced terminal
    cost with dense layers; the round-1 solve (``ops/rowmajor.py``) of the
    quadrotor's ``ResidualMLPBlock``; and the named toy2d at nx = SWARM_NX
    (``toy64_model``): each against its plain version in
    bits mode, each cost's error against a float64 rollout within
    ``F64_FACTOR`` of the float32 plain version's (``f64_agree``), m, s and
    delta/s as ``agree``, the launch counted; each timed from a CUDA graph
    of 20 calls beside its bound (``fused_work``, ``bound``; ``tc_bound``
    for dense layers) and its plain version; then ``SWARM_COMMANDS``
    closed-loop swarm commands of ``MPPI(..., use_pallas=True)`` with the
    launch counters showing the swarm's kernel A, against the plain
    route's.  Returns the rows' numbers."""
    from pytorch_mppi_tpu_torch import MPPI
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.models import mlp_init
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import rowmajor as RM
    from pytorch_mppi_tpu_torch.ops.kernel_models import residual_mlp_model

    phase_start = time.perf_counter()
    fns, models = plan["wide_fns"], plan["wide_models"]
    report = {"timed": {}, "err": {}, "launches": {}, "build_s": {}, "ptxas_of": {}}
    labels = [k for k in plan["builds"]
              if k.split()[0] in ("swarm", "step4", "lq64", "dense", "toy64")]

    def reset_launches():
        for name in FS.launches:
            FS.launches[name] = 0

    def launched():
        return {k: v for k, v in FS.launches.items() if v}

    def mark(what):
        print(f"# phase 4g: {what} done at {time.perf_counter() - phase_start:.1f} s")

    def bits(R, cols):
        return torch.randint(-2**31, 2**31 - 1, (R, cols), dtype=torch.int32, generator=gen,
                             device=dev)

    def seed():
        return tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))

    ptxas = block_ptxas(plan, labels, named=False)
    for label in labels:
        _, kernel, variant, _ = plan["builds"][label]
        report["build_s"][label] = plan["build_s"].get(label)
        log = _build.generated_path(kernel.header(), variant_mask(variant)).with_suffix(
            ".log").name
        for e in (e for e in ptxas if e["log"] == log):
            parts = (f", its parts up to {e['part_spills']} bytes spill stores and "
                     f"{e['part_stack']} bytes stack frame" if "part_stack" in e else "")
            print(f"# ptxas [{label}: {e['name']}]: {e.get('registers')} registers, "
                  f"{e.get('spills')} bytes spill stores, {e.get('stack')} bytes stack frame"
                  f"{parts}, {e['blocks_by_registers']} blocks an SM by registers")
        entries = [e for e in ptxas if e["log"] == log]
        check(entries, f"no generated kernel of [{label}] in its build log {log}")
        if entries:
            report["ptxas_of"][label] = dict(
                registers=max(e.get("registers", 0) for e in entries),
                spills=max(e.get("spills", 0) for e in entries),
                stack=max(e.get("stack", 0) for e in entries),
                blocks_by_registers=min(e["blocks_by_registers"] for e in entries))
            if any("part_stack" in e for e in entries):  # the functions the kernels call
                report["ptxas_of"][label].update(
                    part_spills=max(e.get("part_spills", 0) for e in entries),
                    part_stack=max(e.get("part_stack", 0) for e in entries))
    print(f"# phase 4g libraries, nvcc seconds: {report['build_s']} | registers and spill "
          f"stores (the largest of each library's kernels): {report['ptxas_of']}")

    def kernel_a(key, *args, **kw):
        wide_kernel_a(dev, gen, report, key, *args, **kw)
        mark(key)

    print(f"# kernel vs plain [phase 4g]: each cost's error against a float64 rollout of the "
          f"same actions within {F64_FACTOR}x the float32 plain version's (f64_agree); m, s and "
          f"delta/s as the other cases (agree)")
    swarm = models["swarm"]
    for variant in FS.VARIANTS:
        kernel_a(f"swarm {variant}", variant, fns["swarm"], SWARM_NX, SWARM_NU,
                 x0=swarm_x0(gen, dev), expect={f"generated_{variant}_block": 1})
    kernel_a("step4 mppi", "mppi", fns["step4"], STEP4_NX, STEP4_NU,
             x0=torch.randn(STEP4_NX, generator=gen, device=dev) * 0.5,
             expect={"generated_mppi": 1})
    kernel_a("lq64 mppi", "mppi", models["lq64 named"], SWARM_NX, SWARM_NU,
             x0=torch.rand(SWARM_NX, generator=gen, device=dev) * 2 - 1,
             expect={"generated_mppi_block": 1})
    model_t, terminal, lq = models["dense terminal"]
    kernel_a("dense terminal mppi", "mppi", lq, NX, NU, terminal=terminal,
             terminal_fn=fns["dense terminal"], x0=torch.tensor([-3.0, -2.0], device=dev),
             expect={"generated_mppi_block": 1})
    # ROADMAP Queue 2a: the named toy2d beyond 32 states, and the program near
    # MAX_OPS, whose library (in parts) built beside the others
    kernel_a("toy64 mppi", "mppi", models["toy64 named"], SWARM_NX, SWARM_NU,
             x0=torch.rand(SWARM_NX, generator=gen, device=dev) * 2 - 1,
             expect={"generated_mppi_block": 1})
    max_s = report["build_s"].get("swarm max mppi")
    print(f"# swarm near MAX_OPS [{MAX_AGENTS} agents]: its kernel A library took {max_s} s of "
          f"nvcc (the most allowed {MAX_BUILD_S} s) | {card_line()}")
    check(max_s is not None and max_s <= MAX_BUILD_S,
          f"the swarm near MAX_OPS took {max_s} s of nvcc, more than {MAX_BUILD_S}")
    kernel_a("swarm max mppi", "mppi", fns["swarm max"], 4 * MAX_AGENTS, 2 * MAX_AGENTS,
             x0=swarm_x0(gen, dev, agents=MAX_AGENTS), expect={"generated_mppi_block": 1},
             T=MAX_T)

    # the swarm's batched pair: BATCH_SMALL_N swarms, each its own state
    D = T * SWARM_NU
    b_cfg = MPPIConfig(nx=SWARM_NX, nu=SWARM_NU, K=BATCH_SMALL_K, T=T, diag_sigma=True)
    solve = FS.make_transposed_batched_solve(b_cfg, BATCH_SMALL_N, fns["swarm"])
    vec = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
    U2T = (torch.randn(BATCH_SMALL_N, D, generator=gen, device=dev) * 0.3).T
    rest = (swarm_x0(gen, dev, BATCH_SMALL_N).T.contiguous(), U2T, vec(1.0), vec(0.0),
            vec(-SWARM_U), vec(SWARM_U), U2T.contiguous(), torch.tensor(1.0, device=dev))
    lead, out = bits(D, solve.bits_cols), []
    reset_launches()
    dk, msk, ck = solve(lead, *rest)
    torch.cuda.synchronize()
    n_k = launched()
    plain_ms = events_ms(lambda: out.append(solve.plain(lead, *rest)), 1, warmup=0)
    dp, msp, cp = out.pop()
    pert, x0_all = batched_pert(solve, lead, rest, T, SWARM_NU, BATCH_SMALL_K)
    ok, e_k, e_p, lim, _ = f64_agree(solve.model, ck.reshape(-1), cp.reshape(-1), pert, x0_all,
                                     T, SWARM_NU)
    ok2, c_err, u_err, _ = agree(ck, cp, dk / msk[1], dp / msp[1], 1.0, msk[0], msp[0], msk[1],
                                 msp[1], rtol=0.0, atol=lim + e_p)
    ok = ok and ok2 and n_k == {"generated_batched_block": 2}
    report["err"]["swarm batched"] = dict(kernel_f64=e_k, plain_f64=e_p, kernel_plain=c_err,
                                          update=u_err)
    report["launches"]["swarm batched"] = n_k
    print(f"# wide [swarm batched bits] N={BATCH_SMALL_N} K={BATCH_SMALL_K} P="
          f"{solve.plant_group} group {solve.act_rows} tiles {solve.tiles}: cost error against "
          f"float64 kernel {e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}) | kernel against plain "
          f"{c_err:.3e} | delta/s err {u_err:.3e} | launches {n_k}" + ("" if ok else "  <-- FAIL"))
    check(ok, "the swarm's batched pair disagrees with its plain version")
    k = seed()
    dev_ms = graph_ms(lambda: solve(k, *rest), 20)
    work = fused_work(b_cfg, solve.model, k, rest[0], rest[2], variant="batched",
                      plants=BATCH_SMALL_N)
    bound_ms, bound_by = bound(work)
    report["timed"]["swarm batched"] = (dev_ms, plain_ms, bound_ms, bound_by)
    print(f"# kernel alone [swarm batched] N={BATCH_SMALL_N} K={BATCH_SMALL_K} seed: device "
          f"{dev_ms:.6f} ms (a CUDA graph of 20 calls) | plain version {plain_ms:.5f} ms | bound "
          f"{bound_ms:.6f} ms by {bound_by}: {dev_ms / bound_ms:.1f}x | {card_line()}")
    mark("swarm batched")

    # the swarm's legacy rollout
    r = LG.make_fused_rollout(MPPIConfig(nx=SWARM_NX, nu=SWARM_NU, K=K, T=T), fns["swarm"])
    x0_K = swarm_x0(gen, dev, K)
    u = torch.clamp(torch.randn(K, T, SWARM_NU, generator=gen, device=dev), -SWARM_U, SWARM_U)
    reset_launches()
    ck = r(x0_K, u)
    torch.cuda.synchronize()
    n_k = launched()
    out = []
    plain_ms = events_ms(lambda: out.append(r.plain(x0_K, u)), 1, warmup=0)
    cp = out.pop()
    ok, e_k, e_p, lim, _ = f64_agree(swarm, ck, cp, u.reshape(K, -1).T, x0_K.T.contiguous(), T,
                                     SWARM_NU)
    ok = ok and n_k == {"generated_rollout_block": 1}
    report["err"]["swarm rollout"] = dict(kernel_f64=e_k, plain_f64=e_p,
                                          kernel_plain=float((ck - cp).abs().max()))
    report["launches"]["swarm rollout"] = n_k
    dev_ms = graph_ms(lambda: r(x0_K, u), 20)
    bound_ms, bound_by = bound(rollout_work(swarm, x0_K, u))
    report["timed"]["swarm rollout"] = (dev_ms, plain_ms, bound_ms, bound_by)
    print(f"# wide [swarm rollout] K={K} T={T}: cost error against float64 kernel {e_k:.3e}, "
          f"plain {e_p:.3e} (limit {lim:.3e}) | launches {n_k} | device {dev_ms:.6f} ms | plain "
          f"version {plain_ms:.5f} ms | bound {bound_ms:.6f} ms by {bound_by}: "
          f"{dev_ms / bound_ms:.1f}x | {card_line()}" + ("" if ok else "  <-- FAIL"))
    check(ok, "the swarm's rollout disagrees with its plain version")
    mark("swarm rollout")

    # the round-1 solve of the quadrotor's ResidualMLPBlock (phase 4e's network)
    qp = mlp_init(QUAD_SIZES, torch.Generator().manual_seed(29), torch.float32, dev)
    Wq, bq = qp[-1]
    qp[-1] = (Wq * QUAD_STEP, bq * QUAD_STEP)
    quad = residual_mlp_model(qp, QUAD_NX, QUAD_NU, cost="quadratic", goal=QUAD_GOAL)
    solve = RM.make_fused_solve(MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=K, T=T), quad)
    x0 = torch.tensor(QUAD_X0, device=dev)
    U = torch.randn(T, QUAD_NU, generator=gen, device=dev) * 0.1
    chol, mu = 0.5 * torch.eye(QUAD_NU, device=dev), torch.zeros(QUAD_NU, device=dev)
    lo, hi = -torch.ones(QUAD_NU, device=dev), torch.ones(QUAD_NU, device=dev)
    a_flat, lam = (U / 0.25).reshape(-1).contiguous(), torch.tensor(1.0, device=dev)
    args = (x0, U, chol, mu, lo, hi, a_flat, lam)
    lead = torch.randint(-2**31, 2**31 - 1, (solve.K_pad, T * QUAD_NU), dtype=torch.int32,
                         generator=gen, device=dev)
    reset_launches()
    dk, mk, sk, ck = solve(lead, *args)
    torch.cuda.synchronize()
    n_k = launched()
    out = []
    plain_ms = events_ms(lambda: out.append(solve.plain(lead, *args)), 1, warmup=0)
    dp, mp, sp, cp = out.pop()
    pert = rowmajor_pert(solve, lead, U, chol, mu, lo, hi)
    x0T = x0[:, None].expand(QUAD_NX, K)
    ok, e_k, e_p, lim, _ = f64_agree(quad, ck, cp, pert, x0T, T, QUAD_NU)
    ok2, c_err, u_err, w_tol = agree(ck, cp, (dk / sk).reshape(-1), (dp / sp).reshape(-1), 1.0,
                                     mk, mp, sk, sp, rtol=0.0, atol=lim + e_p)
    ok = ok and ok2 and n_k == {"rowmajor": 1}
    report["err"]["quad rowmajor"] = dict(kernel_f64=e_k, plain_f64=e_p, kernel_plain=c_err,
                                          update=u_err)
    report["launches"]["quad rowmajor"] = n_k
    print(f"# wide [quadrotor round-1 solve bits] {QUAD_SIZES} K={K} T={T} S={solve.tile_k} "
          f"group {solve.act_rows} tiles {solve.tiles}: cost error against float64 kernel "
          f"{e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}) | kernel against plain {c_err:.3e} | "
          f"delta/s err {u_err:.3e} (tol {w_tol:.3e}) | launches {n_k}"
          + ("" if ok else "  <-- FAIL"))
    check(ok, "the quadrotor's round-1 solve disagrees with its plain version")
    k = seed()
    dev_ms = graph_ms(lambda: solve(k, *args), 20)
    work = fused_work(MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=K, T=T), quad, k, x0, chol,
                      variant="rowmajor")
    bound_ms, bound_by = tc_bound(work, K * T * _dense_macs(quad))
    report["timed"]["quad rowmajor"] = (dev_ms, plain_ms, bound_ms, bound_by)
    print(f"# kernel alone [quadrotor round-1 solve] K={K} T={T} seed: device {dev_ms:.6f} ms "
          f"(a CUDA graph of 20 calls) | plain version {plain_ms:.5f} ms | bound {bound_ms:.6f} "
          f"ms by {bound_by} (tensor cores): {dev_ms / bound_ms:.1f}x | {card_line()}")
    mark("quadrotor round-1 solve")

    # the main path: SWARM_COMMANDS closed-loop swarm commands, fused and plain
    dyn, cost = fns["swarm"]
    lim_u = SWARM_U * torch.ones(SWARM_NU, device=dev)

    def loop(use_pallas):
        built = time.perf_counter()
        with Captured() as warned:
            ctrl = MPPI(dyn, cost, SWARM_NX, torch.eye(SWARM_NU, device=dev), num_samples=K,
                        horizon=T, lambda_=1.0, u_min=-lim_u, u_max=lim_u, seed=5,
                        use_pallas=use_pallas, device=dev)
        build_s = time.perf_counter() - built
        check(ctrl._fns.fused == use_pallas and not [m for m in warned.messages
                                                     if "plain torch path" in m],
              f"the swarm's MPPI(use_pallas={use_pallas}) routed wrong: {warned.messages}")
        x = swarm_x0(torch.Generator(device=dev).manual_seed(7), dev)
        times = []
        reset_launches()
        with torch.no_grad():
            for _ in range(SWARM_COMMANDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = ctrl.command(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(a).all()) and float(a.abs().max()) <= SWARM_U,
                      "a swarm command is not finite or out of its bounds")
                x = dyn(x[None], a[None])[0]
        return times, launched(), build_s, swarm_cost_at(x)

    def swarm_cost_at(x):
        return float(cost(x[None], torch.zeros(1, SWARM_NU, device=dev))[0])

    # the swarm left alone for as many steps: its drift, which the commands must beat
    x = swarm_x0(torch.Generator(device=dev).manual_seed(7), dev)
    c0 = swarm_cost_at(x)
    with torch.no_grad():
        for _ in range(SWARM_COMMANDS):
            x = dyn(x[None], torch.zeros(1, SWARM_NU, device=dev))[0]
    c_drift = swarm_cost_at(x)
    times, n, build_s, c1 = loop(True)
    p_times, p_n, _, p_c1 = loop(False)
    med, p_med = statistics.median(times), statistics.median(p_times)
    report["loop"] = dict(launches=n, median_ms=med, plain_median_ms=p_med, times_ms=times,
                          plain_launches=p_n, build_s=build_s)
    print(f"# swarm main path [MPPI, {SWARM_AGENTS} agents, nx={SWARM_NX} nu={SWARM_NU}] "
          f"{SWARM_COMMANDS} commands at K={K} T={T}: command median {med:.4f} ms fused, "
          f"{p_med:.4f} ms plain ({p_med / med:.2f}x) | launches {n} (plain route {p_n}) | "
          f"running cost {c0:.3f} -> {c1:.3f} (plain route {p_c1:.3f}; no action "
          f"{c_drift:.3f}) | controller built in "
          f"{build_s:.1f} s (its trace) | {card_line()}")
    check(n == {"generated_mppi_block": SWARM_COMMANDS},
          f"the swarm's main path launched {n}, expected generated_mppi_block {SWARM_COMMANDS}")
    check(not p_n, f"the swarm's plain route launched {p_n}")
    check(c1 < c_drift, f"the swarm's fused loop ends at running cost {c1}, no better than "
          f"no action's {c_drift}")
    report["seconds"] = time.perf_counter() - phase_start
    print(f"# phase 4g, the dynamics bridge's last refusals: {report['seconds']:.1f} s")
    return report


def wide_kernel_a(dev, gen, report, key, variant, model, nx, nu, terminal=None,
                  terminal_fn=None, x0=None, expect=None, T=T):
    """Phase 4g's kernel A case: ``variant`` with ``model`` at K samples and
    T steps from ``x0`` against its plain version in bits mode (``f64_agree``
    and ``agree``, the launches ``expect``), then timed in seed mode beside
    its bound; the numbers go to ``report`` under ``key``."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    def bits(R, cols):
        return torch.randint(-2**31, 2**31 - 1, (R, cols), dtype=torch.int32, generator=gen,
                             device=dev)

    cfg = MPPIConfig(nx=nx, nu=nu, K=K, T=T, diag_sigma=True, smppi=variant == "smppi",
                     num_support_pts=NSP if variant == "kmppi" else 0)
    make = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
            "kmppi": FS.make_transposed_kmppi_solve}[variant]
    solve = make(cfg, model, emit_perturbed=True, terminal_final=terminal_fn)
    x0T = x0[:, None].expand(nx, K)
    ops = wide_operands(dev, gen, variant, nx, nu, x0T, T)
    lead, out = bits(solve.spec.R, solve.bits_cols), []
    for name in FS.launches:
        FS.launches[name] = 0
    dk, mk, sk, ck, _ = solve(lead, *ops)
    torch.cuda.synchronize()
    n_k = {k: v for k, v in FS.launches.items() if v}
    plain_ms = events_ms(lambda: out.append(solve.plain(lead, *ops)), 1, warmup=0)
    dp, mp, sp, cp, pp = out.pop()
    ok, e_k, e_p, lim, _ = f64_agree(solve.model, ck, cp, pp, x0T, T, nu, terminal=terminal)
    ok2, c_err, u_err, w_tol = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp,
                                     rtol=0.0, atol=lim + e_p)
    ok = ok and ok2 and n_k == expect
    report["err"][key] = dict(kernel_f64=e_k, plain_f64=e_p, kernel_plain=c_err,
                              update=u_err)
    report["launches"][key] = n_k
    print(f"# wide [{key} bits] nx={nx} nu={nu} K={K} T={T} S={solve.tile_k} group "
          f"{solve.act_rows} act_ld {solve.spec.act_ld} tiles {solve.tiles}: cost error "
          f"against float64 kernel {e_k:.3e}, plain {e_p:.3e} (limit {lim:.3e}) | kernel "
          f"against plain {c_err:.3e} | delta/s err {u_err:.3e} (tol {w_tol:.3e}) | "
          f"launches {n_k}" + ("" if ok else "  <-- FAIL"))
    check(ok, f"phase 4g's kernel A disagrees with its plain version: {key}")
    k = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    dev_ms = graph_ms(lambda: solve(k, *ops), 20)
    op = ops[3] if variant != "mppi" else ops[2]
    work = fused_work(cfg, solve.model, k, x0T, op, variant=variant, terminal=terminal)
    f32_ms, f32_by = bound(work)
    macs = K * (T * _dense_macs(solve.model) + (_dense_macs(terminal) if terminal else 0))
    bound_ms, bound_by = tc_bound(work, macs) if macs else (f32_ms, f32_by)
    report["timed"][key] = (dev_ms, plain_ms, bound_ms, bound_by)
    print(f"# kernel alone [{key}] K={K} T={T} seed: device {dev_ms:.6f} ms (a CUDA graph "
          f"of 20 calls) | plain version {plain_ms:.5f} ms ({plain_ms / dev_ms:.1f}x) | "
          f"bound {bound_ms:.6f} ms by {bound_by}: {dev_ms / bound_ms:.1f}x | {card_line()}")


def wide_operands(dev, gen, variant, nx, nu, x0T, T=T):
    """Kernel A's operands for ``variant`` at phase 4g's shapes (K, T):
    a nominal U of scale 0.3, sigma I, the drawn rows' and the actions'
    bounds ±SWARM_U, the action cost lambda U sigma^-2, lambda 1."""
    from pytorch_mppi_tpu_torch import RBFKernel
    from pytorch_mppi_tpu_torch.ops.kernels import interpolation_operators

    D, R_k = T * nu, NSP * nu
    full = lambda v, n=D: torch.full((n,), v, device=dev)  # noqa: E731
    lam, one = torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)
    U2 = torch.randn(D, generator=gen, device=dev) * 0.3
    a_flat = U2.contiguous()
    if variant == "mppi":
        return (x0T, U2, full(1.0), full(0.0), full(-SWARM_U), full(SWARM_U), a_flat, lam)
    if variant == "smppi":
        return (x0T, U2, torch.randn(D, generator=gen, device=dev) * 0.3, full(1.0), full(0.0),
                full(-SWARM_U), full(SWARM_U), full(-SWARM_U), full(SWARM_U), a_flat, lam, one,
                torch.tensor(SWARM_DT * 10, device=dev))
    interp, _ = interpolation_operators(RBFKernel(2.0), T, NSP, torch.float32, device=dev)
    Wt = torch.kron(interp, torch.eye(nu, device=dev)).contiguous()
    return (x0T, U2, torch.randn(R_k, generator=gen, device=dev) * 0.3, full(1.0, R_k),
            full(0.0, R_k), full(-SWARM_U, R_k), full(SWARM_U, R_k), full(-SWARM_U),
            full(SWARM_U), a_flat, Wt, lam)


def wide_program_rows(report):
    """Phase 7's rows for phase 4g: the swarm's five kernels, the step-4
    program's kernel A, the named ``linear_quadratic`` at nx = SWARM_NX, the
    dense terminal cost beside the named flagship model, the quadrotor's
    round-1 solve and the named toy2d at nx = SWARM_NX, each with its
    numbers."""
    rows = []
    insts = {
        "swarm mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>, Generated::kPerSample",
                       512, "generated_mppi_block", "swarm all"),
        "swarm smppi": ("mppi_fused_partial<Generated, 32, ..., kSMPPI>, Generated::kPerSample",
                        755, "generated_smppi_block", "swarm all"),
        "swarm kmppi": ("mppi_fused_partial<Generated, 32, ..., kKMPPI>, Generated::kPerSample",
                        940, "generated_kmppi_block", "swarm all"),
        "swarm batched": ("batched_partial<Generated, 32, kGlobal> + flash_merge, "
                          "Generated::kPerSample", 1118, "generated_batched_block", "swarm all"),
        "swarm rollout": ("fused_rollout<Generated, 32>, Generated::kPerSample", 75,
                          "generated_rollout_block", "swarm all"),
        "step4 mppi": ("mppi_fused_partial<Generated, N, ..., kMPPI>", 512, "generated_mppi",
                       "step4 mppi"),
        "lq64 mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>, Generated::kBlock", 512,
                      "generated_mppi_block", "lq64 mppi"),
        "dense terminal mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>, "
                                "Generated::kBlockTerminal", 512, "generated_mppi_block",
                                "dense terminal mppi"),
        "quad rowmajor": ("mppi_fused_partial<ResidualMLPBlock, 32, ..., kMPPI>, rowmajor", 1695,
                          "rowmajor", None),
        "toy64 mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>, Generated::kBlock", 512,
                       "generated_mppi_block", "toy64 mppi"),
        "swarm max mppi": ("mppi_fused_partial<Generated, 32, ..., kMPPI>, Generated::kPerSample,"
                           " its functions in parts", 512, "generated_mppi_block",
                           "swarm max mppi"),
    }
    what = {"swarm": f"the swarm, {SWARM_AGENTS} agents, nx={SWARM_NX} nu={SWARM_NU}",
            "step4": f"the step-4 primitives' program, nx={STEP4_NX} nu={STEP4_NU}",
            "lq64": f"named linear_quadratic traced, nx={SWARM_NX} nu={SWARM_NU}",
            "dense": "named linear_quadratic beside a traced terminal cost with dense layers",
            "quad": f"round-1 solve, block residual MLP: the quadrotor {QUAD_SIZES}",
            "toy64": f"named toy2d traced, nx={SWARM_NX} nu={SWARM_NU}",
            "swarm max": f"the swarm near MAX_OPS, {MAX_AGENTS} agents, nx={4 * MAX_AGENTS} "
                         f"nu={2 * MAX_AGENTS}, T={MAX_T}"}
    for key, (inst, line, count, label) in insts.items():
        d_ms, p_ms, b_ms, b_by = report["timed"][key]
        launches = (report["loop"]["launches"].get(count, 0) if key == "swarm mppi"
                    else report["launches"][key].get(count, 0))
        rows.append({
            "name": f"fused_mppi {key}, {what.get(key[:9], what[key.split()[0]])} ({inst})",
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": launches,
            "launches_on": "main path" if key == "swarm mppi" else "check",
            "max_abs_err": report["err"][key]["kernel_plain"],
            "max_abs_err_f64": report["err"][key]["kernel_f64"],
            "max_abs_err_plain_f64": report["err"][key]["plain_f64"],
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "build_s": report["build_s"].get(label) if label else None,
            **(report["ptxas_of"].get(label, {}) if label else {}),
        })
    rows[0].update(command_median_ms=report["loop"]["median_ms"],
                   plain_command_median_ms=report["loop"]["plain_median_ms"])
    return rows


def generated_builds(dev):
    """Trace phase 11's models (and phase 4e's and 4f's) and start each
    generated library's build (one ``nvcc`` a model and variant, in a
    thread), to run beside the named library's build.  Returns the plan:
    the callables, the traced models and ``builds``, label -> (thread,
    kernel, variant, result)."""
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
    plan = {}
    # phase 4e's traced MLP: fused_kernel_demo's network with random weights
    # (the header holds no weights, so the trained model's trace reuses it)
    from pytorch_mppi_tpu_torch.examples import fused_kernel_demo as FKD
    from pytorch_mppi_tpu_torch.models import mlp_init

    mlp = FKD.kernel_model(mlp_init(FKD.SIZES, torch.Generator().manual_seed(1), torch.float32,
                                    dev))
    try:
        models["mlp"] = BL.kernel_model(MPPIConfig(nx=2, nu=1, K=MLP_K, T=MLP_T), *untagged(mlp))
        mlp_kernel = BL.generated_kernel(models["mlp"], None)
        plan.update({"mlp mppi": (mlp_kernel, FS.MPPI), "mlp batched": (mlp_kernel, FS.BATCHED)})
        print(f"# traced MLP {FKD.SIZES}: {BL._count_ops(models['mlp'].program, models['mlp'].outputs)} "
              f"scalar operations a step (the bound MAX_OPS {BL.MAX_OPS}), header "
              f"{len(mlp_kernel.header())} characters")
    except BL.UnsupportedPrimitive as e:
        print(f"# traced MLP {FKD.SIZES}: the tracer refuses it: {e}")
    # phase 4e's MBPO-shape network, beyond MAX_OPS: dense layers
    start = time.perf_counter()
    models["mbpo"] = BL.kernel_model(MPPIConfig(nx=QUAD_NX, nu=QUAD_NU, K=MLP_K, T=MLP_T),
                                     *fns["mbpo"])
    mbpo = BL.generated_kernel(models["mbpo"], None)
    plan.update({"mbpo mppi": (mbpo, FS.MPPI), "mbpo batched": (mbpo, FS.BATCHED)})
    print(f"# traced MBPO network {MBPO_SIZES}: {time.perf_counter() - start:.1f} s to trace, "
          f"{len(models['mbpo'].program.dense_layers(models['mbpo'].outputs))} dense layers of "
          f"{BL.dense_ops(models['mbpo'].program, models['mbpo'].outputs)} operations and "
          f"{BL._count_ops(models['mbpo'].program, models['mbpo'].outputs)} scalar operations a "
          f"step (the bound MAX_OPS {BL.MAX_OPS} counts the scalar ones), header "
          f"{len(mbpo.header())} characters, activation rows of "
          f"{models['mbpo'].activation_ld()} floats")
    plan.update({"lq mppi": (BL.generated_kernel(models["lq"], None), FS.MPPI),
            "pendulum mppi": (BL.generated_kernel(models["pendulum"], None), FS.MPPI),
            "step mppi": (step, FS.MPPI), "step smppi": (step, FS.SMPPI),
            "step kmppi": (step, FS.KMPPI), "step rollout": (step, FS.ROLLOUT),
            "step batched": (step, FS.BATCHED),
            # phase 12's: scenario_batch's plant is the flagship lambdas' program,
            # so its batched library is this one (the same header)
            "lq batched": (BL.generated_kernel(models["lq"], None), FS.BATCHED),
            "terminal mppi": (BL.generated_kernel(models["lq"], models["terminal"]), FS.MPPI)})
    # phase 13's MLP dynamics (tpu_tests/test_tpu_pallas.py:448-479)
    models["lane mlp"] = BL.kernel_model(MPPIConfig(nx=2, nu=2, K=256, T=5),
                                         *lane_mlp_callables(dev))
    plan["lane mlp mppi"] = (BL.generated_kernel(models["lane mlp"], None), FS.MPPI)
    # phase 4f's world models (the humanoid's and the dog's)
    td_fns, td_models, td_plan = tdmpc_plan(dev)
    plan.update(td_plan)
    # phase 4g's swarm, step-4 program, wide named model and dense terminal
    wide_fns, wide_models, w_plan = wide_plan(dev)
    plan.update(w_plan)
    return dict(fns=fns, models=models, builds=start_builds(plan), tdmpc_fns=td_fns,
                tdmpc_models=td_models, wide_fns=wide_fns, wide_models=wide_models)


def join_generated_builds(plan):
    """Wait for phase 11's builds; fail with nvcc's output on the first that
    failed; print each build's seconds."""
    secs = {}
    for label, (thread, kernel, variant, result) in plan["builds"].items():
        thread.join()
        if "error" in result:
            fail(f"generated library [{label}] did not build: {result['error']}")
        secs[label] = kernel.build_seconds.get(variant[0] if isinstance(variant, tuple)
                                               else variant)
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
        before = set(BL._KERNELS)
        stats = {}
        reset()
        converged, N = scenario_batch.main(["--pod-scale", "--pallas"] + extra, device=dev,
                                           stats=stats)
        torch.cuda.synchronize()
        launched = {k: v for k, v in FS.launches.items() if v}
        # the example's trace names phase 2's kernel (the same program and
        # constants, so the same id) or a new one of the same header
        new = [k for i, k in BL._KERNELS.items() if i not in before]
        reused = all(not k.build_seconds and _build_path_of(k.model) == lib for k in new)
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


def wide_kernel_rows(report, build_parts, gen_build_s):
    """Phase 7's rows for the block models (phase 4e, ``wide_dynamics``):
    ``ResidualMLPBlock``'s instantiations with the quadrotor's numbers (its
    loops' launches, its kernels' times; the forced [3, 32, 32, 2] and [9,
    32, 32, 7] networks' times in turns beside ``ResidualMLP``'s), and the
    MBPO network's dense-node generated kernel A and batched pair."""
    rows = []
    quad, mbpo, turns = report["quad"], report["mbpo"], report["turns"]
    loop_of = {"rollout": ("mppi", "rollout")}
    for key, line, inst in (
            ("mppi", 512, "mppi_fused_partial<ResidualMLPBlock, 32, ..., kMPPI>"),
            ("smppi", 755, "mppi_fused_partial<ResidualMLPBlock, 32, ..., kSMPPI>"),
            ("kmppi", 940, "mppi_fused_partial<ResidualMLPBlock, 32, ..., kKMPPI>"),
            ("rollout", 75, "fused_rollout<ResidualMLPBlock, 32>"),
            ("batched", 1118, "batched_partial<ResidualMLPBlock, 32, kGlobal> + flash_merge")):
        d_ms, p_ms, b_ms, b_by, f32_ms = quad["timed"][key]
        errs = [e for k, e in quad["err"].items() if (k if isinstance(k, str) else k[0]) == key]
        row = {
            "name": f"fused_mppi {key}, block residual MLP: the quadrotor {QUAD_SIZES} ({inst})",
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": quad["loops"][loop_of.get(key, (key, "fused"))]["launches"][
                f"{key}_block"],
            "max_abs_err": max(e["kernel_f64"] for e in errs),
            "max_abs_err_plain_f32": max(e["plain_f64"] for e in errs),
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_ms_float32": f32_ms,
            "library_ms": None,
            "nvcc_s": build_parts.get(18 if key == "batched" else 17),
        }
        for label, short in (("demo [3, 32, 32, 2]", "demo"), ("car [9, 32, 32, 7]", "car")):
            t = turns.get((label, key))
            if t is not None:
                row[f"ms_{short}_block"] = t["block"]
                row[f"ms_{short}_per_thread"] = t["per-thread"]
        row["forced_networks_agree_f64"] = all(report["agree"].values())
        rows.append(row)
    for key, line, inst, count in (
            ("mppi", 512, "mppi_fused_partial<Generated, 12, ..., kMPPI>", "generated_mppi_block"),
            ("batched", 1118, "batched_partial<Generated, 12, kGlobal> + flash_merge",
             "generated_batched_block")):
        d_ms, p_ms, b_ms, b_by, f32_ms = mbpo["timed"][key]
        errs = [e for k, e in mbpo["err"].items() if (k if isinstance(k, str) else k[0]) == key]
        rows.append({
            "name": f"fused_mppi {key}, generated model with dense layers: an untagged "
                    f"nn.Sequential {MBPO_SIZES} SiLU ({inst}, Generated::kBlock)",
            "route": "cuda",
            "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
            "model_source": "pytorch_mppi_tpu_torch/ops/batch_last.py",
            "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
            "launches": mbpo["loops"][key, "fused"]["launches"][count],
            "max_abs_err": max(e["kernel_f64"] for e in errs),
            "max_abs_err_plain_f32": max(e["plain_f64"] for e in errs),
            "ms": d_ms,
            "ms_source": "cuda_graph",
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_ms_float32": f32_ms,
            "library_ms": None,
            "build_s": gen_build_s.get(f"mbpo {key}"),
        })
    return rows


def lane_mlp_callables(dev):
    """Phase 13's MLP dynamics (``tpu_tests/test_tpu_pallas.py:448-479``),
    untagged: s + tanh([s, a] W1 + b1) W2 with W1 (4, 32), b1 (32,) and W2
    (32, 2) drawn as JAX's test draws them (numpy's RandomState(0)), and the
    lane's cost |GOAL - x'|².  Phase 2 builds its kernel A library."""
    import numpy as np

    rs = np.random.RandomState(0)
    W1, b1, W2 = (torch.tensor(w, dtype=torch.float32, device=dev)
                  for w in (rs.randn(4, 32) * 0.3, rs.randn(32) * 0.1, rs.randn(32, 2) * 0.3))
    goal = torch.tensor(LANE_GOAL, device=dev)

    def dynamics(s, a):
        return s + torch.tanh(torch.cat([s, a], -1) @ W1 + b1) @ W2

    def cost(s, a):
        return ((goal - s) ** 2).sum(-1)

    return dynamics, cost


def tpu_lane(dev, plan):
    """Phase 13: JAX's real-chip lane (``tpu_tests/``) on the card, one case
    of ``TPU_LANE_CASES`` for each lane test that no earlier phase holds,
    each with JAX's fixture, seed, route and check (``docs/PORT_TESTS.md``
    maps the 74 tests).  A case runs the default (plain) route unless JAX's
    test asks for ``use_pallas``; then the named ``linear_quadratic`` of
    the same plant takes the kernels, and the bridge's traced callables
    where JAX's test traces them (the MLP dynamics and the terminal cost,
    whose libraries phase 2 built).  Each case's launches are counted: a
    plain case launches none, a kernel case exactly its route's.  Where the
    card is held against the CPU, both take one draw (the plain path's
    noise fed to both, or the kernels' Philox bits), since a card's
    generator and the CPU's draw different numbers from one seed.  The mesh
    cases run in a 1-rank world of this process (NCCL on the card).  No
    library is built here.  Prints one line a case; returns the cases'
    seconds and compared numbers."""
    import numpy as np
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch import (
        KMPPI,
        MPPI,
        SMPPI,
        MPPI_Batched,
        RBFKernel,
        autotune,
        linear_quadratic,
        run_mppi_jit,
    )
    from pytorch_mppi_tpu_torch.config import BatchedState, MPPIConfig, MPPIParams
    from pytorch_mppi_tpu_torch.ops import _build
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops import rowmajor as RM
    from pytorch_mppi_tpu_torch.ops import solve as PS
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh
    from pytorch_mppi_tpu_torch.utils import deploy

    phase_start = time.perf_counter()
    f32, bf16, cpu = torch.float32, torch.bfloat16, torch.device("cpu")
    out_dir = Path(__file__).resolve().parent / "build" / "lane"
    out_dir.mkdir(parents=True, exist_ok=True)
    libraries = sorted(_build.BUILD_DIR.glob("*.so")) if _build.BUILD_DIR.is_dir() else []
    B = torch.tensor(LANE_B, device=dev)
    GOAL = torch.tensor(LANE_GOAL, device=dev)
    START = torch.tensor(LANE_START, device=dev)
    eye = torch.eye(2, device=dev)
    ones2 = torch.ones(2, device=dev)

    def plant(device):
        """The lane's dyn and cost on ``device``."""
        Bd, Gd = B.to(device), GOAL.to(device)
        return (lambda s, a: s + a @ Bd.T), (lambda s, a: ((Gd - s) ** 2).sum(-1))

    dyn, cost = plant(dev)
    lq = linear_quadratic(B, GOAL)  # the same functions, tagged: the named kernel model
    gen_dyn, gen_cost = plan["fns"]["lq"]  # the same functions, untagged (phase 11's trace)
    gen_terminal = plan["fns"]["terminal"]  # JAX's _fterm: (3, 1) weights and 0.2 |u|²

    def ctrl_(cls=MPPI, **kw):
        """JAX's ``_ctrl``: the plain functions, or with ``use_pallas`` the
        named model of the same plant."""
        base = dict(num_samples=LANE_K, horizon=LANE_T, lambda_=1.0, seed=LANE_SEED, device=dev)
        base.update(kw)
        fns = (lq.dynamics, lq.running_cost) if base.get("use_pallas") else (dyn, cost)
        return cls(*fns, 2, torch.eye(2, device=base["device"]), **base)

    def dist_to_goal(x):
        return float(torch.linalg.norm(GOAL - x))

    def loop(ctrl, steps, x=START):
        for _ in range(steps):
            x = dyn(x, ctrl.command(x))
        return x

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def bits(shape, seed):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, generator=gen(seed),
                             device=dev)

    def close(a, b, rtol, atol):
        """JAX's assert_allclose, and the largest difference."""
        a, b = a.double().cpu(), b.double().cpu()
        return bool(((a - b).abs() <= atol + rtol * b.abs()).all()), float((a - b).abs().max())

    def rowset(t):
        f = t.reshape(t.shape[0], -1).cpu().numpy()
        return f[np.lexsort(f.T[::-1])]

    def params_(dtype=f32, device=dev):
        z = torch.zeros(2, dtype=dtype, device=device)
        return MPPIParams(noise_mu=z, noise_sigma=torch.eye(2, dtype=dtype, device=device),
                          lambda_=torch.tensor(1.0, dtype=dtype, device=device),
                          u_min=z - math.inf, u_max=z + math.inf, u_init=z)

    def fed_solve(ctrl, x, draws):
        """One command's body with ``draws`` in place of its noise stream."""
        fns = ctrl._fns
        with fns.streams.fed(ctrl.d, draws):
            _, action, art = fns.body(ctrl._params, ctrl._state, x, None, None, True)
        return action, art

    def name_of(solve, kernel):
        return FS.launch_name(solve.spec.model_id, kernel)

    cases = {}

    def case(fn):
        cases[fn.__name__] = fn
        return fn

    # -- tpu_tests/test_tpu_behavior.py::TestCore ----------------------------------
    @case
    def action_shape_dtype():
        a = ctrl_().command(START)
        check(a.shape == (2,) and a.dtype == f32 and a.device.type == dev.type,
              f"action {tuple(a.shape)} {a.dtype} on {a.device}")
        return f"action {tuple(a.shape)} {a.dtype} on {a.device}", {}

    @case
    def cost_decreases_over_steps():
        zero = torch.zeros(1, 2, device=dev)
        first = float(cost(START[None], zero)[0])
        last = float(cost(loop(ctrl_(num_samples=256, horizon=10), 8)[None], zero)[0])
        check(last < first, f"cost {first} -> {last}")
        return f"cost {first:.4f} -> {last:.4f} over 8 steps", {}

    @case
    def seeded_determinism_on_chip():
        a1, a2 = ctrl_().command(START), ctrl_().command(START)
        check(torch.equal(a1, a2), f"two controllers on one seed: {a1} and {a2}")
        return "two controllers on seed 42 bit for bit", {}

    @case
    def bounds_enforced():
        c = ctrl_(u_min=-0.5 * ones2, u_max=0.5 * ones2)
        worst = 0.0
        for _ in range(3):
            a = c.command(START)
            worst = max(worst, float(a.abs().max()), float(c.perturbed_action.abs().max()))
        check(worst <= 0.5 + 1e-6, f"|action| or |perturbed| {worst} beyond 0.5")
        return f"largest |action|, |perturbed| {worst:.6f} (bound 0.5)", {}

    @case
    def symmetric_bound_completion():
        c = ctrl_(u_max=0.75)
        ok, _ = close(c.u_min, torch.tensor([-0.75, -0.75]), 1e-7, 0)
        check(ok, f"u_min {c.u_min}")
        return f"u_min {c.u_min.tolist()}", {}

    @case
    def terminal_cost_and_lazy_storage():
        plain = ctrl_()
        plain.command(START)
        term = ctrl_(terminal_state_cost=lambda st, ac: 10.0 * (
            (GOAL - st[..., -1, :]) ** 2).sum(-1))
        term.command(START)
        check(plain.states is None and term.states is not None and term.states.shape[0] == 1,
              "lazy storage or the terminal cost's states")
        return f"states None without the terminal cost, {tuple(term.states.shape)} with it", {}

    @case
    def step_dependent_dynamics():
        c = MPPI(lambda s, a, t: s + a @ B.T * (1.0 + 0.0 * t), lambda s, a, t: cost(s, a), 2,
                 eye, num_samples=LANE_K, horizon=LANE_T, seed=LANE_SEED,
                 step_dependent_dynamics=True, device=dev)
        a = c.command(START)
        check(bool(torch.isfinite(a).all()), f"step-dependent action {a}")
        return f"action {a.tolist()}", {}

    @case
    def noise_abs_cost():
        a = ctrl_(noise_abs_cost=True).command(START)
        check(bool(torch.isfinite(a).all()), f"action {a}")
        return f"action {a.tolist()}", {}

    @case
    def sample_null_action():
        c = ctrl_(sample_null_action=True)
        c.command(START)
        check(bool((c.perturbed_action[0] == 0).all()), "sample 0 is not the null action")
        return "perturbed_action[0] all 0", {}

    @case
    def u_per_command():
        a = ctrl_(u_per_command=3).command(START)
        check(a.shape == (3, 2), f"shape {tuple(a.shape)}")
        return f"action {tuple(a.shape)}", {}

    @case
    def rollout_samples_var_cost():
        # JAX builds this controller and never commands it (its dynamics take no key)
        ctrl_(rollout_samples=3, rollout_var_cost=0.1, stochastic_dynamics=True)
        c = MPPI(lambda s, a, rng: dyn(s, a) + 0.01 * torch.randn(s.shape, generator=rng,
                                                                  device=s.device),
                 cost, 2, eye, num_samples=64, horizon=6, seed=LANE_SEED, rollout_samples=3,
                 rollout_var_cost=0.1, stochastic_dynamics=True, device=dev)
        a = c.command(START)
        check(bool(torch.isfinite(a).all()) and c.states.shape[0] == 3,
              f"action {a}, states {tuple(c.states.shape)}")
        return f"states {tuple(c.states.shape)}, action finite", {}

    @case
    def get_rollouts():
        c = ctrl_()
        c.command(START)
        r = c.get_rollouts(START, num_rollouts=5)
        check(r.shape == (5, LANE_T, 2) and bool(torch.isfinite(r).all()), f"{tuple(r.shape)}")
        return f"rollouts {tuple(r.shape)}", {}

    @case
    def change_horizon_both_ways():
        c = ctrl_(horizon=8)
        c.command(START)
        shapes = []
        for T_ in (12, 5):
            c.change_horizon(T_)
            shapes.append(tuple(c.U.shape))
            a = c.command(START)
            check(c.U.shape == (T_, 2) and bool(torch.isfinite(a).all()),
                  f"horizon {T_}: U {tuple(c.U.shape)}, action {a}")
        return f"U {shapes[0]} then {shapes[1]}, commands finite", {}

    @case
    def reset_resamples():
        c = ctrl_()
        U1 = c.U.clone()
        c.reset()
        check(not torch.allclose(U1, c.U), "reset kept U")
        return f"U moved by {float((U1 - c.U).abs().max()):.4f}", {}

    @case
    def batch_state_input():
        a = ctrl_(num_samples=64).command(START.expand(64, 2))
        check(a.shape == (2,), f"shape {tuple(a.shape)}")
        return f"(64, 2) state -> action {tuple(a.shape)}", {}

    @case
    def omega_sums_to_one():
        c = ctrl_()
        c.command(START)
        s = float(c.omega.sum())
        check(abs(s - 1.0) <= 1e-5 and c.cost_total.shape == (LANE_K,), f"sum {s}")
        return f"sum(omega) - 1 = {s - 1.0:.3e} (limit 1e-5)", {}

    @case
    def scalar_sigma_1d_control():
        c = MPPI(lambda s, a: s + torch.nn.functional.pad(a, (0, 1)), cost, 2,
                 torch.tensor(0.5, device=dev), num_samples=64, horizon=6, seed=LANE_SEED,
                 device=dev)
        a = c.command(START)
        check(a.shape == (1,), f"shape {tuple(a.shape)}")
        return f"action {tuple(a.shape)}", {}

    @case
    def u_scale_unscaled_storage():
        c = ctrl_(u_scale=2.0, u_max=0.5)
        c.command(START)
        m = float(c.U.abs().max())
        check(m <= 0.5 + 1e-6, f"|U| {m}")
        return f"largest |U| {m:.6f} (bound 0.5)", {}

    @case
    def shift_semantics():
        c = ctrl_()
        c.command(START)
        a = c.command(START, shift_nominal_trajectory=False)
        c.shift_nominal_trajectory()
        check(bool(torch.isfinite(a).all()) and torch.equal(c.U[-1], c.u_init),
              f"U[-1] {c.U[-1]} after the shift")
        return "no-shift command finite, U[-1] = u_init after the shift", {}

    @case
    def num_iterations_on_chip():
        a = ctrl_(num_iterations=3).command(START)
        check(bool(torch.isfinite(a).all()), f"action {a}")
        return f"action {a.tolist()}", {}

    @case
    def run_mppi_jit_one_dispatch():
        c = ctrl_(num_samples=64, horizon=6)
        states, actions, total = run_mppi_jit(c, dyn, START, steps=10)
        loop_kind = type(next(iter(c._runner_cache.values()))).__name__
        check(states.shape == (11, 2) and actions.shape == (10, 2)
              and math.isfinite(float(total)) and (dev.type == "cpu" or loop_kind == "_GraphLoop"),
              f"{tuple(states.shape)} {tuple(actions.shape)} {loop_kind}")
        return f"states {tuple(states.shape)}, actions {tuple(actions.shape)}, total " \
               f"{float(total):.4f} ({loop_kind})", {}

    # -- ::TestVariantsOnChip ------------------------------------------------------
    @case
    def smppi():
        c = ctrl_(SMPPI, u_min=-ones2, u_max=ones2, action_min=-ones2, action_max=ones2,
                  w_action_seq_cost=2.0)
        x = loop(c, 5)
        check(bool(torch.isfinite(x).all()), f"state {x}")
        return f"state after 5 steps {x.tolist()}", {}

    @case
    def kmppi():
        c = ctrl_(KMPPI, num_support_pts=4)
        x = loop(c, 5)
        check(bool(torch.isfinite(x).all()) and c.theta.shape == (4, 2),
              f"state {x}, theta {tuple(c.theta.shape)}")
        return f"state after 5 steps {x.tolist()}, theta {tuple(c.theta.shape)}", {}

    @case
    def batched():
        c = MPPI_Batched(dyn, cost, 2, eye, num_envs=4, num_samples=64, horizon=6,
                         seed=LANE_SEED, device=dev)
        a = c.command(torch.stack([START, START * 0.5, -START, START * 2.0]))
        check(a.shape == (4, 2) and not torch.allclose(a[0], a[2]), f"actions {a}")
        return f"actions {tuple(a.shape)}, plants 0 and 2 differ by " \
               f"{float((a[0] - a[2]).abs().max()):.4f}", {}

    @case
    def gradient_refinement_composes_with_fused_kernel():
        def run(steps):
            c = ctrl_(num_samples=16, horizon=8, u_max=ones2, use_pallas=True,
                      gradient_refinement_steps=steps, gradient_refinement_lr=0.1)
            check(c._fns.fused, "K = 16 with use_pallas did not take kernel A")
            return dist_to_goal(loop(c, 10)), c

        d_base, _ = run(0)
        d_ref, c = run(20)
        u_max = float(c.U.abs().max())
        check(math.isfinite(d_ref) and d_ref < d_base + 1e-6 and u_max <= 1.0 + 1e-5,
              f"refined {d_ref}, unrefined {d_base}, |U| {u_max}")
        # kernel A at K = 16, below one block of 32: its phantom samples are
        # masked (pallas_rollout.py:445), against its plain version on the same bits
        cfg = MPPIConfig(nx=2, nu=2, K=16, T=8, diag_sigma=True)
        solve = FS.make_transposed_fused_solve(cfg, lq)
        D = 16
        ops = (START[:, None].expand(2, 16), torch.zeros(D, device=dev), torch.ones(D, device=dev),
               torch.zeros(D, device=dev), -torch.ones(D, device=dev), torch.ones(D, device=dev),
               torch.zeros(D, device=dev), torch.tensor(1.0, device=dev))
        lead = bits((solve.spec.R, solve.bits_cols), 16)
        dk, mk, sk, ck = solve(lead, *ops)
        dp, mp, sp, cp = solve.plain(lead, *ops)
        ok, c_err, u_err, _ = agree(ck, cp, dk / sk, dp / sp, 1.0, mk, mp, sk, sp)
        check(ok and ck.shape == (16,), f"K = 16 kernel A against its plain version: cost "
              f"{c_err}, update {u_err}")
        return f"refined {d_ref:.4f} <= unrefined {d_base:.4f}, |U| {u_max:.4f}; K = 16 " \
               f"against plain: cost {c_err:.2e}, delta/s {u_err:.2e}", {"mppi": 21}

    # -- ::TestCrossBackend ----------------------------------------------------------
    @case
    def solve_matches_cpu_f32():
        dyn_c, cost_c = plant(cpu)
        c_dev = ctrl_(num_samples=64, horizon=6, prng_impl=None)
        c_cpu = MPPI(dyn_c, cost_c, 2, torch.eye(2), num_samples=64, horizon=6, lambda_=1.0,
                     seed=LANE_SEED, prng_impl=None, device=cpu)
        st = c_cpu._state
        check(torch.equal(c_dev.U.cpu(), c_cpu.U), "the two controllers' U differ")
        draws = c_cpu._fns.streams.feeds(st.seed, st.counter, cpu)
        a_dev, _ = fed_solve(c_dev, START, [d.to(dev) for d in draws])
        a_cpu, _ = fed_solve(c_cpu, START.cpu(), draws)
        ok, err = close(a_dev, a_cpu, 5e-3, 5e-4)
        check(ok, f"card {a_dev} against CPU {a_cpu}")
        return f"card against CPU on one draw: action difference {err:.3e} (rtol 5e-3, " \
               f"atol 5e-4)", {}

    @case
    def cpu_placed_controller_with_use_pallas():
        """The port's ``use_pallas`` on CPU tensors runs the kernels' plain
        versions: nothing may reach the card."""
        lq_c = linear_quadratic(B.cpu(), GOAL.cpu())
        allocs = torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)
        c = MPPI(lq_c.dynamics, lq_c.running_cost, 2, torch.eye(2), num_samples=2048, horizon=5,
                 seed=3, device="cpu", use_pallas=True)
        a = c.command(torch.zeros(2))
        b = MPPI_Batched(lq_c.dynamics, lq_c.running_cost, 2, torch.eye(2), num_envs=2,
                         num_samples=2048, horizon=5, seed=3, device="cpu", use_pallas=True)
        actions = b.command(torch.zeros(2, 2))
        tensors = [a, actions, c.U, c.cost_total, b.U, b.cost_total, *c._params, *b._params]
        on = {t.device.type for t in tensors}
        after = torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)
        check(on == {"cpu"} and c._fns.fused and b._fns.fused and after == allocs,
              f"devices {on}, routes {c._fns.fused} {b._fns.fused}, card allocations "
              f"{after - allocs}")
        return f"MPPI and MPPI_Batched: outputs, state and parameters on {on}, the kernels' " \
               f"plain versions, {after - allocs} card allocations", {}

    @case
    def cpu_placed_batched_controller_stays_on_cpu():
        dyn_c, cost_c = plant(cpu)
        c = MPPI_Batched(dyn_c, cost_c, 2, torch.eye(2), num_envs=2, num_samples=32, horizon=4,
                         seed=LANE_SEED, device="cpu")
        on = {t.device.type for t in c._params}
        a = c.command(torch.zeros(2, 2))
        check(on == {"cpu"} and a.device.type == "cpu" and c.prng_impl is None,
              f"parameters on {on}, action on {a.device}, prng_impl {c.prng_impl}")
        return f"parameters and action on the CPU, prng_impl {c.prng_impl}", {}

    @case
    def weighting_matches_cpu():
        c = torch.linspace(0.0, 30.0, 512, device=dev)
        om_dev = PS.compute_weighting(c, torch.tensor(1.0, device=dev), -1)[1]
        om_cpu = PS.compute_weighting(c.cpu(), torch.tensor(1.0), -1)[1]
        ok, err = close(om_dev, om_cpu, 1e-5, 1e-7)
        check(ok, f"omega on the card against the CPU: {err}")
        return f"omega difference {err:.3e} (rtol 1e-5, atol 1e-7)", {}

    # -- ::TestEliteReuseOnChip ------------------------------------------------------
    def elite_rows_ok(c):
        idx = torch.argsort(c.cost_total)[:4]
        return np.array_equal(rowset(c.perturbed_action[idx]), rowset(c._state.elites))

    @case
    def elites_close_loop_on_chip():
        c = ctrl_(num_samples=64, num_elites=4, u_min=-ones2, u_max=ones2)
        d = dist_to_goal(loop(c, 15))
        check(d < 1.0 and elite_rows_ok(c), f"distance {d}, elites the top-4 rows "
              f"{elite_rows_ok(c)}")
        return f"distance {d:.4f} (limit 1.0), elites the 4 best rows", {}

    @case
    def use_pallas_with_elites_falls_back_without_artifacts():
        with Captured() as warned:
            c = ctrl_(num_samples=64, num_elites=2, use_pallas=True)
        a = c.command(START)
        check(not c._fns.fused and any("fused_artifacts" in m for m in warned.messages)
              and bool(torch.isfinite(a).all()) and c.noise is not None
              and c.perturbed_action is not None and c._state.elites.shape == (2, 8, 2),
              f"route {c._fns.fused}, warnings {warned.messages}")
        return "the plain path with the fused_artifacts warning, artifacts kept, elites " \
               f"{tuple(c._state.elites.shape)}", {}

    @case
    def use_pallas_with_elites_and_artifacts_stays_fused():
        with Captured(logging.INFO) as logged:
            c = ctrl_(num_samples=64, num_elites=4, use_pallas=True, fused_artifacts=True,
                      u_min=-ones2, u_max=ones2)
        check(c._fns.fused and any("fused CUDA kernel" in m for m in logged.messages),
              f"route {c._fns.fused}: {logged.messages}")
        x = loop(c, 15)
        d = dist_to_goal(x)
        check(d < 1.0 and elite_rows_ok(c), f"distance {d}")
        expected = torch.clamp(PS._shift_elites(c._state.elites, c._params.u_init), -1.0, 1.0)
        c.command(x)
        ok, err = close(c.perturbed_action[:4], expected, 1e-6, 1e-7)
        check(ok, f"the shifted elites in rows 0-3: {err}")
        return f"distance {d:.4f} (limit 1.0), elites the 4 best rows, shifted elites in " \
               f"rows 0-3 within {err:.1e}", {"mppi": 16}

    # -- tpu_tests/test_tpu_pallas.py ------------------------------------------------
    @case
    def pallas_rollout_matches_scan_compiled():
        kw = dict(num_samples=256, horizon=8, lambda_=1.0, seed=3)
        c_ref = ctrl_(**kw)
        c_pal = ctrl_(use_pallas="rollout", **kw)
        check(c_pal._fns.fused, "use_pallas='rollout' did not take the legacy kernels")
        worst = 0.0
        for _ in range(3):
            a1, a2 = c_ref.command(START), c_pal.command(START)
            ok, err = close(a2, a1, 5e-3, 5e-4)
            check(ok, f"legacy route {a2} against plain {a1}")
            worst = max(worst, err)
            c_pal.U = c_ref.U
        ok, w_err = close(c_pal.omega, c_ref.omega, 1e-3, 1e-6)
        check(ok, f"omega {w_err}")
        return f"actions within {worst:.2e} (rtol 5e-3, atol 5e-4), omega {w_err:.2e}", \
            {"rollout": 3, "weighted_update": 3}

    def fused_loop(ctrl, steps, limit):
        check(ctrl._fns.fused, "use_pallas=True did not take the kernel")
        d = dist_to_goal(loop(ctrl, steps))
        check(d < limit, f"distance {d} (limit {limit})")
        return d

    @case
    def transposed_fused_closed_loop():
        kw = dict(num_samples=512, horizon=10, seed=3, u_max=ones2, use_pallas=True)
        c = ctrl_(**kw)
        d = fused_loop(c, 12, 1.0)
        check(c.noise is None and c.perturbed_action is None
              and abs(float(c.omega.sum()) - 1) <= 1e-4 and bool(torch.isfinite(c.cost_total).all()),
              "artifacts or weights")
        a2, a3 = ctrl_(**kw).command(START), ctrl_(**kw).command(START)
        check(torch.equal(a2, a3), "two fused controllers on one seed differ")
        return f"distance {d:.4f} (limit 1.0), sum(omega) {float(c.omega.sum()):.6f}, one " \
               f"seed bit for bit", {"mppi": 14}

    @case
    def fused_artifacts_surface():
        kw = dict(num_samples=512, horizon=8, seed=3, u_max=ones2, use_pallas=True)
        c = ctrl_(fused_artifacts=True, **kw)
        a = c.command(START)
        pa, nz = c.perturbed_action, c.noise
        check(pa.shape == (512, 8, 2) and nz.shape == (512, 8, 2)
              and float(pa.abs().max()) <= 1.0 + 1e-6, "the artifacts' shapes or bounds")
        U_sol = pa - nz
        ok1, e1 = close(U_sol, U_sol[:1].expand_as(U_sol), 1e-5, 1e-6)
        rc = PS.rollout_costs(c.config, PS.wrap_dynamics(c.config, dyn),
                              PS.wrap_cost(c.config, cost), START, pa)[0]
        pc = torch.einsum("ktu,tu->k", nz, U_sol[0])
        ok2, e2 = close(c.cost_total, rc + pc, 2e-4, 2e-3)
        c2 = ctrl_(**kw)
        ok3, e3 = close(c2.command(START), a, 1e-5, 1e-6)
        check(ok1 and ok2 and ok3 and c2.noise is None,
              f"one nominal {e1}, re-rolled costs {e2}, without the artifacts {e3}")
        return f"one nominal within {e1:.1e}, re-rolled costs within {e2:.2e} (rtol 2e-4, " \
               f"atol 2e-3), the command without artifacts within {e3:.1e}", {"mppi": 2}

    @case
    def fused_artifacts_smppi_kmppi():
        kw = dict(num_samples=256, horizon=8, seed=3, u_max=0.5 * ones2, use_pallas=True,
                  fused_artifacts=True)
        sm = ctrl_(SMPPI, delta_t=0.8, action_max=ones2, **kw)
        sm.command(START)
        check(sm.perturbed_action is not None and sm.noise is not None
              and float(sm.perturbed_action.abs().max()) <= 1.0 + 1e-6, "SMPPI's artifacts")
        rec = (sm.perturbed_action - 0.8 * sm.noise).reshape(256, -1)
        ok1, e1 = close(rec, rec[:1].expand_as(rec), 1e-5, 1e-5)
        km = ctrl_(KMPPI, num_support_pts=4, kernel=RBFKernel(sigma=2.0), **kw)
        km.command(START)
        pa = km.perturbed_action
        check(pa is not None and km.noise is not None and pa.shape == (256, 8, 2)
              and float(pa.abs().max()) <= 0.5 + 1e-6, "KMPPI's artifacts")
        U_sol = pa - km.noise
        ok2, e2 = close(U_sol, U_sol[:1].expand_as(U_sol), 1e-5, 1e-6)
        check(ok1 and ok2, f"SMPPI's shared sequence {e1}, KMPPI's {e2}")
        return f"SMPPI's action sequence shared within {e1:.1e}, KMPPI's nominal within " \
               f"{e2:.1e}", {"smppi": 1, "kmppi": 1}

    @case
    def transposed_smppi_closed_loop():
        c = ctrl_(SMPPI, num_samples=512, horizon=10, seed=3, u_max=0.5 * ones2,
                  action_max=ones2, delta_t=0.8, w_action_seq_cost=2.0, use_pallas=True)
        x = START
        for _ in range(15):
            a = c.command(x)
            x = dyn(x, a)
        d = dist_to_goal(x)
        check(d < 1.2 and c.noise is None and abs(float(c.omega.sum()) - 1) <= 1e-4
              and float(a.abs().max()) <= 1.0 + 1e-5, f"distance {d}")
        return f"distance {d:.4f} (limit 1.2), last |action| {float(a.abs().max()):.4f}", \
            {"smppi": 15}

    @case
    def transposed_kmppi_closed_loop():
        c = ctrl_(KMPPI, num_samples=512, horizon=10, seed=3, u_max=ones2, num_support_pts=5,
                  kernel=RBFKernel(sigma=2.0), use_pallas=True)
        d = fused_loop(c, 15, 1.2)
        check(c.noise is None and bool(torch.isfinite(c.theta).all()), "KMPPI's theta")
        return f"distance {d:.4f} (limit 1.2)", {"kmppi": 15}

    @case
    def transposed_batched_closed_loop():
        def make(n):
            return MPPI_Batched(lq.dynamics, lq.running_cost, 2, eye, num_envs=n,
                                num_samples=512, horizon=10, seed=3, u_max=ones2,
                                use_pallas="force", device=dev)

        c = make(4)
        x = torch.tensor([[-3.0, -2.0], [-1.0, 1.0], [4.0, 4.0], [0.0, -3.0]], device=dev)
        d0 = torch.linalg.norm(x - GOAL, dim=-1)
        for _ in range(12):
            x = dyn(x, c.command(x))
        d1 = torch.linalg.norm(x - GOAL, dim=-1)
        w = c.omega.sum(dim=1)
        c2 = make(2)
        c2.U = c2.U[0].expand_as(c2.U).clone()
        a = c2.command(torch.tensor([[1.0, -1.0], [1.0, -1.0]], device=dev))
        check(c._fns.fused and bool((d1 < d0 + 0.3).all()) and float(d1.max()) < 1.5
              and bool(((w - 1).abs() <= 1e-4).all()) and torch.equal(a[0], a[1]),
              f"distances {d0.tolist()} -> {d1.tolist()}, identical plants {a.tolist()}")
        return f"largest distance {float(d1.max()):.4f} (limit 1.5), identical plants bit " \
               f"for bit", {"batched": 26}

    @case
    def batched_noise_operand_compiled():
        N, K_, T_ = 3, 256, 6
        D = T_ * 2
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_, diag_sigma=True)
        solve_bits = FS.make_transposed_batched_solve(cfg, N, lq)
        solve_op = FS.make_transposed_batched_solve(cfg, N, lq, noise_operand=True)
        lead = bits((D, K_), 3)
        U = torch.randn(N, T_, 2, generator=gen(5), device=dev) * 0.1
        x0 = torch.tensor([[-3.0, -2.0], [1.0, 1.0], [0.5, -0.5]], device=dev)
        scale = torch.full((D,), 0.8, device=dev)
        vec = lambda v: torch.full((D,), v, device=dev)  # noqa: E731
        lam = torch.tensor(1.0, device=dev)
        args = (x0.T.contiguous(), U.reshape(N, D).T.contiguous(), scale, vec(0.0), vec(-1.0),
                vec(1.0), (lam * U.reshape(N, D) / 0.64).T.contiguous(), lam)
        delta_b, ms_b, ct_b = solve_bits(lead, *args)
        delta_o, ms_o, ct_o = solve_op(FS.bits_to_normal(lead) * scale[:, None], *args)
        oks = [close(ct_o, ct_b, 2e-4, 2e-3), close(delta_o, delta_b, 2e-3, 1e-4),
               close(ms_o, ms_b, 2e-4, 0.0)]
        check(all(ok for ok, _ in oks), f"operand against bits mode: {oks}")
        # through the step: the plain path's draw fed to the operand kernel
        params = MPPIParams(noise_mu=vec(0.0)[:2], noise_sigma=eye * 0.64, lambda_=lam,
                            u_min=-ones2, u_max=ones2, u_init=torch.zeros(2, device=dev))
        fns = PS.make_batched_step(cfg, N, lq.dynamics, lq.running_cost,
                                   transposed_solve_override=solve_op)
        state = BatchedState(U=PS.sample_noise(gen(3), (N, T_), params, f32), seed=3)
        x, d0 = x0, torch.linalg.norm(x0 - GOAL, dim=-1)
        for _ in range(12):
            state, a, art = fns.step(params, state, x)
            x = dyn(x, a)
        d1 = torch.linalg.norm(x - GOAL, dim=-1)
        w = art.omega.sum(dim=1)
        check(bool((d1 < d0).all()) and float(d1.max()) < 1.5
              and bool(((w - 1).abs() <= 1e-4).all()), f"distances {d0.tolist()} -> {d1.tolist()}")
        return f"operand against bits mode: costs {oks[0][1]:.2e}, delta {oks[1][1]:.2e}, m " \
               f"and s {oks[2][1]:.2e}; the step's loop: largest distance {float(d1.max()):.4f} " \
               f"(limit 1.5)", {"batched": 28}

    @case
    def sharded_fused_solve_one_device_mesh():
        c = ctrl_(num_samples=512, horizon=10, seed=3, mesh=make_mesh((1,), ("k",), device=str(dev)),
                  sample_axis="k", use_pallas=True, u_max=ones2)
        d = fused_loop(c, 12, 1.0)
        check(c.noise is None, "the sharded fused route stored the noise")
        return f"distance {d:.4f} (limit 1.0)", {"mppi": 12}

    @case
    def sharded_fused_null_and_artifacts_one_device_mesh():
        c = ctrl_(num_samples=512, horizon=8, seed=3, mesh=make_mesh((1,), ("k",), device=str(dev)),
                  sample_axis="k", use_pallas=True, fused_artifacts=True,
                  sample_null_action=True, u_max=ones2)
        d = fused_loop(c, 10, 1.2)
        pa = c.perturbed_action
        zero_rows = (pa.reshape(512, -1).abs() < 1e-12).all(dim=1)
        check(pa.shape == (512, 8, 2) and c.noise is not None and bool((pa[0] == 0).all())
              and int(zero_rows.sum()) == 1 and float(pa.abs().max()) <= 1.0 + 1e-6,
              f"null rows {int(zero_rows.sum())}")
        return f"distance {d:.4f} (limit 1.2), row 0 the only null row", {"mppi": 10}

    @case
    def sharded_batched_fused_one_device_mesh():
        c = MPPI_Batched(lq.dynamics, lq.running_cost, 2, eye, num_envs=4, num_samples=2048,
                         horizon=8, seed=3, mesh=make_mesh((1,), ("data",), device=str(dev)),
                         env_axis="data", use_pallas=True, u_max=ones2, device=dev)
        x = torch.tensor([[-3.0, -2.0], [-1.0, 1.0], [3.0, 3.0], [0.0, -2.0]], device=dev)
        d0 = float(torch.linalg.norm(x - GOAL, dim=-1).max())
        for _ in range(10):
            x = dyn(x, c.command(x))
        d1 = float(torch.linalg.norm(x - GOAL, dim=-1).max())
        check(c._fns.fused and d1 < d0 and bool(torch.isfinite(c.cost_total).all()),
              f"largest distance {d0} -> {d1}")
        return f"largest distance {d0:.4f} -> {d1:.4f}", {"batched": 20}

    @case
    def population_evaluator_with_fused_controller():
        c = ctrl_(num_samples=2048, horizon=8, seed=1, u_max=2 * ones2, use_pallas=True)
        ev = autotune.PopulationEvaluator(c, START, num_refinement_steps=2, num_trajectories=1)
        res = ev([{"sigma": torch.tensor([1.0, 1.0])}, {"sigma": torch.tensor([4.0, 4.0])},
                  {"lambda": 0.5}])
        costs = res.costs
        c.command(START)
        check(costs.shape == (3,) and bool(torch.isfinite(costs).all()) and c.noise is None
              and c.use_pallas is True and c._fns.fused, f"costs {costs}")
        return f"costs {[round(float(v), 3) for v in costs]}, the command still fused", \
            {"mppi": 1}

    def pregen_reference(cfg, fns, x0, lead, U2, lo, hi, a_flat, lam, terminal=None):
        """JAX's plain reference of the transposed solve on injected bits:
        (costs, the weights' update)."""
        K_, T_, nu = cfg.K, cfg.T, cfg.nu
        noise = FS.bits_to_normal(lead[:, :K_]).T
        pert = torch.clamp(U2[None] + noise, lo, hi)
        noise = pert - U2[None]
        rc = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, fns[0]), PS.wrap_cost(cfg, fns[1]), x0,
                              pert.reshape(K_, T_, nu),
                              terminal_final_cost=None if terminal is None
                              else PS.wrap_final_cost(terminal))[0]
        ct = rc + noise @ a_flat
        return ct, PS.compute_weighting(ct, lam)[1] @ noise

    @case
    def transposed_solve_compiled_pregen_bits():
        K_, T_ = 256, 6
        D = 2 * T_
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_, diag_sigma=True)
        solve = FS.make_transposed_fused_solve(cfg, lq)
        lead = bits((solve.spec.R, solve.bits_cols), 3)
        U2 = torch.randn(D, generator=gen(5), device=dev) * 0.1
        one, lam = torch.ones(D, device=dev), torch.tensor(0.9, device=dev)
        x0 = torch.tensor([-1.0, 0.5], device=dev)
        delta, _, s, ct = solve(lead, x0[:, None].expand(2, K_), U2, one, 0 * one, -one, one,
                                U2 * lam, lam)
        ct_ref, upd_ref = pregen_reference(cfg, (dyn, cost), x0, lead, U2, -one, one, U2 * lam,
                                           lam)
        (ok1, e1), (ok2, e2) = close(ct, ct_ref, 2e-4, 2e-3), close(delta / s, upd_ref, 2e-3, 1e-4)
        check(ok1 and ok2, f"costs {e1}, update {e2}")
        return f"costs within {e1:.2e} (rtol 2e-4, atol 2e-3), delta/s {e2:.2e} (rtol 2e-3, " \
               f"atol 1e-4)", {"mppi": 1}

    @case
    def transposed_solve_mlp_dynamics_compiled():
        K_, T_ = 256, 5
        D = 2 * T_
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_, diag_sigma=True)
        mlp = lane_mlp_callables(dev)
        solve = FS.make_transposed_fused_solve(cfg, mlp)
        lead = bits((solve.spec.R, solve.bits_cols), 7)
        one, zero = torch.ones(D, device=dev), torch.zeros(D, device=dev)
        lam = torch.tensor(1.0, device=dev)
        x0 = torch.tensor([-1.0, 0.5], device=dev)
        ct = solve(lead, x0[:, None].expand(2, K_), zero, one, zero, -2 * one, 2 * one, zero,
                   lam)[3]
        ct_ref, _ = pregen_reference(cfg, mlp, x0, lead, zero, -2 * one, 2 * one, zero, lam)
        ok, err = close(ct, ct_ref, 1e-3, 5e-3)
        check(ok, f"costs {err}")
        return f"the traced MLP's costs within {err:.2e} (rtol 1e-3, atol 5e-3)", \
            {name_of(solve, "mppi"): 1}

    @case
    def fused_sampler_compiled():
        K_, T_ = 1024, 6
        D = 2 * T_
        sampler = RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=K_, T=T_, diag_sigma=True))
        lead = bits((sampler.bits_rows, D), 3)
        U2 = torch.randn(D, generator=gen(4), device=dev) * 0.2
        one = torch.ones(D, device=dev)
        pert, pc = sampler(lead, U2, one, 0 * one, -one, one, U2)
        pert_ref = torch.clamp(U2[None] + FS.bits_to_normal(lead[:K_]), -1.0, 1.0)
        (ok1, e1), (ok2, e2) = (close(pert, pert_ref, 1e-5, 1e-6),
                                close(pc, (pert_ref - U2[None]) @ U2, 1e-4, 1e-4))
        z = sampler(FS.key_to_seed(11), 0 * U2, one, 0 * one, -10 * one, 10 * one, 0 * U2)[0]
        mean, std = float(z.double().mean()), float(z.double().std())
        check(ok1 and ok2 and abs(mean) < 0.02 and abs(std - 1.0) < 0.02,
              f"perturbed {e1}, cost {e2}, moments {mean} {std}")
        return f"bits: perturbed within {e1:.1e}, cost {e2:.1e}; Philox draws mean {mean:.4f} " \
               f"std {std:.4f} (limits 0.02)", {"sampler": 2}

    @case
    def fused_solve_compiled_pregen_bits():
        K_, T_ = 256, 6
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_)
        solve = RM.make_fused_solve(cfg, lq)
        lead = bits((solve.K_pad, 2 * T_), 0)
        U = torch.randn(T_, 2, generator=gen(1), device=dev) * 0.1
        lo, hi, mu = -ones2, ones2, torch.zeros(2, device=dev)
        lam = torch.tensor(0.7, device=dev)
        x0 = torch.tensor([-1.0, 0.5], device=dev)
        delta, _, s, ct = solve(lead, x0, U, eye, mu, lo, hi, (lam * U).reshape(-1), lam)
        pert = torch.clamp(U[None] + FS.bits_to_normal(lead[:K_]).reshape(K_, T_, 2), lo, hi)
        noise = pert - U[None]
        rc = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, dyn), PS.wrap_cost(cfg, cost), x0,
                              pert)[0]
        ct_ref = rc + (U[None] * (lam * noise)).sum(dim=(1, 2))
        delta_ref = torch.einsum("k,ktn->tn", PS.compute_weighting(ct_ref, lam)[1], noise)
        (ok1, e1), (ok2, e2) = close(ct, ct_ref, 2e-4, 2e-3), close(delta / s, delta_ref, 2e-3,
                                                                     1e-4)
        check(ok1 and ok2, f"costs {e1}, update {e2}")
        return f"costs within {e1:.2e} (rtol 2e-4, atol 2e-3), delta/s {e2:.2e}", \
            {"rowmajor": 1}

    @case
    def fused_solve_card_philox():
        K_, T_ = 512, 6
        solve = RM.make_fused_solve(MPPIConfig(nx=2, nu=2, K=K_, T=T_), lq)
        U, mu = torch.zeros(T_, 2, device=dev), torch.zeros(2, device=dev)
        inf = torch.full((2,), math.inf, device=dev)
        args = (torch.tensor([-1.0, 0.5], device=dev), U, eye, mu, -inf, inf,
                torch.zeros(2 * T_, device=dev), torch.tensor(1.0, device=dev))
        _, _, s, ct = solve(FS.key_to_seed(9), *args)
        ct2 = solve(FS.key_to_seed(10), *args)[3]
        check(bool(torch.isfinite(ct).all()) and float(s) > 0 and not torch.allclose(ct, ct2),
              "the Philox solve's costs")
        return f"costs finite, s {float(s):.4f} > 0, two keys' costs differ", {"rowmajor": 2}

    @case
    def flash_weighting_matches_plain():
        K_, D = 1024, 60
        ct = torch.rand(K_, generator=gen(11), device=dev) * 50.0
        noise = torch.randn(K_, D, generator=gen(12), device=dev)
        lam = torch.tensor(1.3, device=dev)
        pert, m, s = LG.fused_weighted_update(ct, noise, lam)
        om = PS.compute_weighting(ct, lam)[1]
        (ok1, e1), (ok2, e2) = (close(pert / s, om @ noise, 2e-3, 1e-3),
                                close(FS.weighting_from_stats(ct, lam, m, s)[1], om, 1e-4, 1e-7))
        check(ok1 and ok2, f"update {e1}, weights {e2}")
        return f"update within {e1:.2e} (rtol 2e-3, atol 1e-3), weights {e2:.2e}", \
            {"weighted_update": 1}

    @case
    def fused_rollout_compiled():
        K_, T_ = 256, 8
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_)
        x0 = torch.tensor([-1.0, 0.5], device=dev)
        acts = torch.randn(K_, T_, 2, generator=gen(2), device=dev)
        got = LG.make_fused_rollout(cfg, lq)(x0.expand(K_, 2), acts)
        want = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, dyn), PS.wrap_cost(cfg, cost), x0,
                                acts)[0]
        ok, err = close(got, want, 2e-4, 2e-3)
        check(ok, f"costs {err}")
        return f"costs within {err:.2e} (rtol 2e-4, atol 2e-3)", {"rollout": 1}

    @case
    def terminal_final_compiled_pregen_bits_parity():
        K_, T_ = 256, 6
        D = 2 * T_
        cfg = MPPIConfig(nx=2, nu=2, K=K_, T=T_, diag_sigma=True)
        solve = FS.make_transposed_fused_solve(cfg, (gen_dyn, gen_cost),
                                               terminal_final=gen_terminal)
        lead = bits((solve.spec.R, solve.bits_cols), 3)
        U2 = torch.randn(D, generator=gen(5), device=dev) * 0.1
        one, lam = torch.ones(D, device=dev), torch.tensor(0.9, device=dev)
        x0 = torch.tensor([-1.0, 0.5], device=dev)
        ct = solve(lead, x0[:, None].expand(2, K_), U2, one, 0 * one, -one, one, U2 * lam,
                   lam)[3]
        ct_ref, _ = pregen_reference(cfg, (gen_dyn, gen_cost), x0, lead, U2, -one, one,
                                     U2 * lam, lam, terminal=gen_terminal)
        ok, err = close(ct, ct_ref, 2e-4, 2e-3)
        check(ok, f"costs {err}")
        return f"costs with the traced terminal cost within {err:.2e} (rtol 2e-4, atol 2e-3)", \
            {name_of(solve, "mppi"): 1}

    @case
    def terminal_final_routing_and_closed_loop():
        kw = dict(num_samples=512, horizon=10, lambda_=1.0, seed=3, u_max=ones2,
                  use_pallas=True, device=dev)
        with Captured(logging.INFO) as logged:
            c_fin = MPPI(gen_dyn, gen_cost, 2, eye, terminal_final_cost=gen_terminal, **kw)
        with Captured() as warned:
            MPPI(gen_dyn, gen_cost, 2, eye, terminal_state_cost=lambda st, ac: gen_terminal(
                st[..., -1, :], ac[..., -1, :]), **kw)
        check(c_fin._fns.fused and any("fused CUDA kernel" in m for m in logged.messages)
              and any("terminal_state_cost" in m and "plain torch path" in m
                      for m in warned.messages), f"routes: {logged.messages} {warned.messages}")
        d = fused_loop(c_fin, 12, 1.0)
        check(c_fin.states is None, "the fused route stored the states")
        return f"the kernel with the traced terminal cost, the plain path with " \
               f"terminal_state_cost (warned); distance {d:.4f} (limit 1.0)", \
            {"generated_mppi": 12}

    # -- tpu_tests/test_tpu_prng.py ---------------------------------------------------
    @case
    def card_philox_controller_converges():
        d = dist_to_goal(loop(ctrl_(num_samples=256, horizon=10), 12))
        check(d < 2.0, f"distance {d}")
        return f"distance {d:.4f} (limit 2.0)", {}

    @case
    def card_philox_deterministic_same_seed():
        def act():
            return ctrl_(num_samples=128, horizon=6, seed=5).command(ones2)

        a1, a2 = act(), act()
        check(torch.equal(a1, a2), f"{a1} and {a2}")
        return "seed 5 twice bit for bit", {}

    @case
    def card_philox_normal_moments():
        z = PS.sample_noise_flat(gen(0), 4096, 15, params_(), f32).double()
        mean, std = float(z.mean()), float(z.std())
        check(abs(mean) < 0.02 and abs(std - 1.0) < 0.02, f"moments {mean} {std}")
        return f"mean {mean:.5f}, std {std:.5f} (limits 0.02)", {}

    @case
    def bf16_sampling_finite():
        z = PS.sample_noise_flat(gen(0), 1024, 10, params_(bf16), bf16)
        zf = z.float()
        std = float(zf.std())
        check(z.dtype == bf16 and bool(torch.isfinite(zf).all()) and abs(std - 1.0) < 0.05,
              f"{z.dtype}, std {std}")
        return f"bfloat16 draws, std {std:.4f} (limit 0.05)", {}

    @case
    def bf16_controller_solve():
        B16, G16 = B.to(bf16), GOAL.to(bf16)
        dyn16 = lambda s, a: s + a @ B16.T  # noqa: E731
        cost16 = lambda s, a: ((G16 - s) ** 2).sum(-1)  # noqa: E731
        kw = dict(num_samples=256, horizon=8, lambda_=1.0, seed=0, device=dev)
        c = MPPI(dyn16, cost16, 2, torch.eye(2, dtype=bf16, device=dev), **kw)
        s = START.to(bf16)
        a = c.command(s)
        af = a.float()
        check(a.dtype == bf16 and bool(torch.isfinite(af).all()) and float(af[0]) > 0,
              f"action {a}")
        # a resized and reset bfloat16 controller keeps its dtype
        c.change_horizon(12)
        a12 = c.command(s)
        c.reset()
        check(c.U.dtype == bf16 and a12.dtype == bf16 and c.U.shape == (12, 2),
              f"after change_horizon and reset: U {c.U.dtype}, action {a12.dtype}")
        # use_pallas: the kernels take float32 only, so the plain path with the warning
        with Captured() as warned:
            cp = MPPI(dyn16, cost16, 2, torch.eye(2, dtype=bf16, device=dev),
                      use_pallas=True, **kw)
        ap = cp.command(s)
        check(not cp._fns.fused and any("non-float32" in m for m in warned.messages)
              and ap.dtype == bf16 and torch.equal(ap, a), f"use_pallas route "
              f"{cp._fns.fused}: {warned.messages}")
        return f"action {af.tolist()} (first > 0), bfloat16 after change_horizon and reset; " \
               f"use_pallas: the plain path with the warning, the same action", {}

    @case
    def antithetic_on_chip():
        z = PS.sample_noise_flat(gen(1), 256, 10, params_(), f32, antithetic=True)
        check(torch.equal(z[:128], -z[128:]), "the halves do not mirror")
        return "rows 0-127 the negatives of rows 128-255, exactly", {}

    @case
    def philox_matches_cpu():
        key = FS.key_to_seed(PS.iteration_seed(123, 0))
        cols = torch.arange(64)
        b_dev, b_cpu = FS.philox_bits(key, cols.to(dev), 10), FS.philox_bits(key, cols, 10)
        z_dev, z_cpu = FS.bits_to_normal(b_dev), FS.bits_to_normal(b_cpu)
        ok, err = close(z_dev, z_cpu, 0.0, 2e-4)
        check(torch.equal(b_dev.cpu(), b_cpu) and ok, f"bits equal {torch.equal(b_dev.cpu(), b_cpu)}, "
              f"normals {err}")
        return f"Philox bits bit for bit, normals within {err:.2e} (atol 2e-4)", {}

    @case
    def diag_fast_path_matches_matmul_path():
        z_diag = PS.sample_noise_flat(gen(9), 128, 6, params_(), f32, diag_sigma=True)
        z_mat = PS.sample_noise_flat(gen(9), 128, 6, params_(), f32, diag_sigma=False)
        ok, err = close(z_diag, z_mat, 0.0, 2e-2)
        check(ok, f"diagonal against matmul path {err}")
        return f"diagonal against matmul path {err:.3e} (atol 2e-2; TF32 off)", {}

    # -- tpu_tests/test_tpu_quality.py::TestQualityFloors -----------------------------
    def run_loop(c, steps=QUALITY_STEPS):
        s, accum = START, 0.0
        for _ in range(steps):
            a = c.command(s)
            s = dyn(s, a)
            accum += float(cost(s[None], a[None])[0])
        return accum, dist_to_goal(s), s

    def quality(cls=MPPI, **kw):
        return ctrl_(cls, **{"num_samples": QUALITY_K, "horizon": QUALITY_T, **kw})

    def floors(runs, what):
        dists = [r[1] for r in runs]
        mean_d, mean_c = statistics.mean(dists), statistics.mean(r[0] for r in runs)
        check(mean_d < 2.0 and max(dists) < 3.0 and mean_c < 200.0,
              f"{what}: distances {dists}, mean cost {mean_c}")
        return f"distances {[round(d, 4) for d in dists]}, mean {mean_d:.4f} (limit 2.0), " \
               f"largest (limit 3.0); mean accumulated cost {mean_c:.2f} (limit 200)", {}

    @case
    def mppi_final_distance():
        return floors([run_loop(quality(seed=s)) for s in (0, 1, 2)], "MPPI")

    @case
    def kmppi_final_distance():
        return floors([run_loop(quality(KMPPI, seed=s)) for s in (0, 1, 2)], "KMPPI")

    @case
    def more_samples_beat_fewer():
        hi = run_loop(quality(seed=3, num_samples=500))[0]
        lo = run_loop(quality(seed=3, num_samples=50))[0]
        check(hi < lo * 1.5, f"accumulated cost {hi} at K = 500, {lo} at K = 50")
        return f"accumulated cost {hi:.2f} at K = 500 < 1.5 x {lo:.2f} at K = 50", {}

    @case
    def works_for_short_and_long_horizons():
        dists = [run_loop(quality(seed=1, horizon=T_))[1] for T_ in (5, 15)]
        check(max(dists) < 2.5, f"distances {dists}")
        return f"distances {[round(d, 4) for d in dists]} at T = 5, 15 (limit 2.5)", {}

    @case
    def loop_bit_determinism():
        r1, r2 = run_loop(quality(seed=7), 10), run_loop(quality(seed=7), 10)
        check(torch.equal(r1[2], r2[2]) and r1[0] == r2[0], f"{r1} and {r2}")
        return f"two 10-step loops bit for bit (accumulated cost {r1[0]!r})", {}

    @case
    def bounds_hold_over_full_loop():
        c = quality(seed=2, u_min=-0.8 * ones2, u_max=0.8 * ones2)
        s, worst = START, 0.0
        for _ in range(QUALITY_STEPS):
            a = c.command(s)
            worst = max(worst, float(a.abs().max()))
            s = dyn(s, a)
        check(worst <= 0.8 + 1e-6, f"|action| {worst}")
        return f"largest |action| {worst:.6f} (bound 0.8)", {}

    @case
    def antithetic_quality():
        dists = [run_loop(quality(seed=s, antithetic_sampling=True))[1] for s in (4, 5, 6)]
        check(statistics.mean(dists) < 2.0, f"distances {dists}")
        return f"distances {[round(d, 4) for d in dists]}, mean " \
               f"{statistics.mean(dists):.4f} (limit 2.0)", {}

    @case
    def noise_rho_quality():
        dists = [run_loop(quality(seed=s, noise_rho=0.3))[1] for s in (0, 1, 2)]
        check(statistics.mean(dists) < 2.0, f"distances {dists}")
        return f"distances {[round(d, 4) for d in dists]}, mean " \
               f"{statistics.mean(dists):.4f} (limit 2.0)", {}

    # -- tpu_tests/test_tpu_deploy.py --------------------------------------------------
    @case
    def artifact_roundtrip_matches_live():
        c = ctrl_(seed=3)
        path = out_dir / "lane_solver.npz"
        deploy.export_solver(c, str(path))
        solver = deploy.load_solver(str(path))
        s = START
        for _ in range(3):
            a_live, a_served = c.command(s), solver.command(s)
            check(torch.equal(a_live, a_served), f"served {a_served} against live {a_live}")
            s = dyn(s, a_live)
        check(solver.device.type == dev.type, f"the artifact serves on {solver.device}")
        return f"3 commands bit for bit, served on {solver.device}", {}

    @case
    def adaptive_solve_compiles_and_improves_plan():
        kw = dict(num_samples=256, horizon=10, lambda_=1.0, seed=11, num_iterations=5,
                  u_max=0.6 * ones2, device=dev)

        def best_plan(**extra):
            c = MPPI(dyn, cost, 2, 25.0 * eye, **kw, **extra)
            loop(c, 10)
            return float(c.cost_total.min())

        fixed = best_plan()
        adapt = best_plan(adaptive_covariance=True, adaptive_cov_lr=0.8)
        check(math.isfinite(adapt) and adapt < fixed / 1.5, f"adapted {adapt}, fixed {fixed}")
        return f"best plan {adapt:.4f} adapted < {fixed:.4f} / 1.5 fixed", {}

    check(tuple(cases) == TPU_LANE_CASES, "phase 13's cases and TPU_LANE_CASES differ: "
          f"{sorted(set(cases) ^ set(TPU_LANE_CASES))}")
    report = {"cases": {}}
    world = None
    try:
        for name in TPU_LANE_CASES:
            if name in LANE_MESH_CASES and world is None:
                init = out_dir / "lane_world.init"
                init.unlink(missing_ok=True)
                initialize_multihost(f"file://{init}", 1, 0, device=str(dev))
                world = dist.get_backend()
            for k in FS.launches:
                FS.launches[k] = 0
            t0 = time.perf_counter()
            text, expect = cases[name]()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = {k: v for k, v in FS.launches.items() if v}
            print(f"# lane [{name}] passed in {secs:.2f} s | {text} | launches {got or 'none'}")
            check(got == expect, f"lane case {name} launched {got}, expected {expect}")
            report["cases"][name] = dict(seconds=secs, compared=text, launches=got)
    finally:
        if world is not None:
            dist.destroy_process_group()
    check(world in ("nccl", None) or dev.type == "cpu", f"the lane's 1-rank world took {world}")
    built = sorted(_build.BUILD_DIR.glob("*.so")) if _build.BUILD_DIR.is_dir() else []
    check(built == libraries, f"phase 13 built {sorted(set(built) - set(libraries))}")
    report["seconds"] = time.perf_counter() - phase_start
    print(f"# phase 13, JAX's chip lane: {len(report['cases'])} cases passed in "
          f"{report['seconds']:.1f} s (the 1-rank world: {world}) | {card_line()}")
    return report


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
    # the named library's build starts first, then the traced models' (their
    # traces, about 20 s on the host, run while it compiles)
    named = {}
    named_build = threading.Thread(target=lambda: named.update(built=_build.build()),
                                   name="nvcc named")
    named_build.start()
    gen_plan = generated_builds(dev)  # phase 11's libraries, beside the named one
    named_build.join()
    if "built" not in named:
        fail("the named library did not build (the nvcc thread's error is above)")
    built = named["built"]
    build_parts = {}  # each part's nvcc seconds, where this run built the library
    if built is None:
        print(f"# build: {_build.library_path().name} already built")
    else:
        secs, log, part_s = built
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        log_path = _build.library_path().with_suffix(".log")
        log_path.write_text(log)
        print(f"# build {_build.SOURCE.name} ({_build.PARTS} parts in parallel): {secs:.1f} s "
              f"({secs / BEFORE_BUILD_S:.3f} of the parent's {BEFORE_BUILD_S} s on another call) | "
              f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers | "
              f"spill stores in {sum(b > 0 for b in spills)}, up to {max(spills, default=0)} "
              f"bytes | nvcc -Xptxas -v output in {log_path}")
        print("# build parts (nvcc seconds from the start, all together): " + " | ".join(
            f"{k}: {v:.1f}" for k, v in enumerate(part_s)))
        build_parts = dict(enumerate(part_s))
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
                  n=10 if path == "fused_refine5" else BREAKDOWN_COMMANDS)

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
            sweep = sweep_turns({S: lambda f=f: f((1234, 5678), *args) for S, f in tiled.items()})
            rule = FS.tile_samples(K_, FS.sm_count())
            best = min(sweep, key=sweep.get)
            sweeps[variant, shape] = dict(ms=sweep, rule=rule, best=best)
            print(f"# S sweep [{variant} {shape} seed] K={K_} D={T_ * nu}: " + " | ".join(
                f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" ({SWEEP_NOTE}) | "
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
        sweep = sweep_turns({S: lambda f=LG.make_weighted_update(S): f(cost, noise_s, lam1)
                          for S in FS.TILES})
        rule = FS.tile_samples(K, FS.sm_count())
        best = min(sweep, key=sweep.get)
        sweeps["weighted_update", shape] = dict(ms=sweep, rule=rule, best=best)
        print(f"# S sweep [weighted_update {shape}] K={K} D={D_}: " + " | ".join(
            f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" ({SWEEP_NOTE}) | "
            f"the rule's S={rule}: {sweep[rule] / sweep[best]:.3f} of the best (S={best}; "
            f"limit 1.1)")
        check(sweep[rule] <= 1.1 * sweep[best],
              f"weighted_update {shape}: the rule's S={rule} is more than 10 % slower than "
              f"S={best}")
    # the rollout's S sweep: 32, 64 and 128 samples a block at the flagship and
    # at K = 1,000, against the rule's S
    for shape, K_ in (("flagship", K), ("K1000", 1000)):
        cfg_r = MPPIConfig(nx=NX, nu=NU, K=K_, T=T)
        sweep = sweep_turns({S: lambda f=LG.make_fused_rollout(cfg_r, lq, tile_k=S):
                          f(x0_K[:K_], u[:K_]) for S in FS.TILES})
        rule = FS.tile_samples(K_, FS.sm_count())
        best = min(sweep, key=sweep.get)
        sweeps["rollout", shape] = dict(ms=sweep, rule=rule, best=best)
        print(f"# S sweep [rollout {shape}] K={K_} D={T * NU}: " + " | ".join(
            f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" ({SWEEP_NOTE}) | "
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
    sweep = sweep_turns({S: lambda f=f: f((1234, 5678), *r_args) for S, f in tiled.items()})
    best = min(sweep, key=sweep.get)
    sweeps["rowmajor", "flagship"] = dict(ms=sweep, rule=solve.tile_k, best=best)
    print(f"# S sweep [rowmajor flagship seed] K={K} D={D}: " + " | ".join(
        f"S={S} {v:.6f} ms" for S, v in sweep.items()) + f" ({SWEEP_NOTE}) | the "
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
    wide = wide_dynamics(dev, gen, mlp["params"], learned_car(dev), gen_plan)

    # -- 4f. a TD-MPC world model in the kernels ----------------------------------
    stamp("4f")
    world = world_model(dev, gen, gen_plan)

    # -- 4g. the dynamics bridge's last refusals ---------------------------------
    stamp("4g")
    wide_programs_report = wide_programs(dev, gen, gen_plan)

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
    deploy_report = deployment(dev, lq, goal, mlp["params"], gen_plan)

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

    # -- 13. JAX's real-chip lane, tpu_tests/ --------------------------------------
    stamp("13")
    tpu_lane(dev, gen_plan)

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
    # the residual MLP's instantiations (phase 4e): kernel A's variants, the
    # legacy rollout and the batched pair at N = 2, launched by
    # fused_kernel_demo's main paths (the batched one at N = 64), and at
    # N = 8 with the car's network, launched by its short loops; each with
    # its build part's nvcc seconds where this run built the library
    for n, rep, part_a, part_b, loop_of in (
            (2, mlp, 13, 15, lambda k: {"rollout": ("mppi", "rollout"),
                                        "batched": ("batched", "fused")}.get(k, (k, "fused"))),
            (8, mlp["car"], 14, 16, lambda k: {"rollout": ("mppi", "rollout")}.get(
                k, (k, "fused")))):
        model_name = "residual MLP" if n == 2 else "residual MLP nx = 7, nu = 2"
        for key, label, line in (
                ("mppi", f"fused_mppi MPPI, {model_name} (mppi_fused_partial<ResidualMLP, {n}, ..., "
                 f"kMPPI>, merged in the kernel)", 512),
                ("smppi", f"fused_mppi SMPPI, {model_name} (mppi_fused_partial<ResidualMLP, {n}, "
                 f"..., kSMPPI>)", 755),
                ("kmppi", f"fused_mppi KMPPI, {model_name} (mppi_fused_partial<ResidualMLP, {n}, "
                 f"..., kKMPPI>)", 940),
                ("rollout", f"fused_rollout, {model_name} (fused_rollout<ResidualMLP, {n}>)", 75),
                ("batched", f"fused_mppi batched, {model_name} (batched_partial<ResidualMLP, {n}, "
                 f"kGlobal> + flash_merge)", 1118)):
            d_ms, p_ms, b_ms, b_by = rep["timed"][key if key != "batched" or n == 2
                                                  else "batched_N16_seed"]
            cases = [c for k, c in rep["cases"].items()
                     if (k if isinstance(k, str) else k[0]) == key]
            kernels.append({
                "name": label,
                "route": "cuda",
                "source": "pytorch_mppi_tpu_torch/csrc/fused_mppi.cu",
                "replaces": f"pytorch_mppi_tpu/ops/pallas_rollout.py:{line}",
                "launches": rep["loops"][loop_of(key)]["launches"][key],
                "max_abs_err": rep["max_err"][key],
                "ms": d_ms,
                "ms_source": "cuda_graph",
                "plain_ms": p_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                "samples_beyond_tolerance": sum(c["beyond"] for c in cases),
                "samples_at_the_wrap": sum(c["at_wrap"] for c in cases),
                "nvcc_s": build_parts.get(part_b if key == "batched" else part_a),
            })
            if n == 2 and key in ("mppi", "batched"):
                kernels[-1]["launches_graph_loop"] = mlp["loops"]["graph", key if key == "batched"
                                                                  else "fused"]["launches"][key]
                traced = mlp["traced"].get(key)
                if traced is not None:  # the same network traced by the dynamics bridge
                    kernels[-1].update(
                        ms_traced=traced["ms"], ms_named_beside_traced=traced["named_ms"],
                        plain_ms_traced=traced["plain_ms"], bound_ms_traced=traced["bound_ms"],
                        launches_traced_check=traced["launches"],
                        nvcc_s_traced=gen_plan["build_s"].get(f"mlp {key}"))
            if n == 2 and key == "batched":
                kernels[-1].update(ms_N16_seed=rep["timed"]["batched_N16_seed"][0],
                                   bound_ms_N16_seed=rep["timed"]["batched_N16_seed"][2])
    kernels += wide_kernel_rows(wide, build_parts, gen_plan["build_s"])
    kernels += world_kernel_rows(world)
    kernels += wide_program_rows(wide_programs_report)
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
    # the launches of phase 8's served artifacts whose kernels run the user's
    # code (and refinement's kernel A), counted in the fresh process
    served = {k: v["launches"] for k, v in deploy_report["artifacts"].items()}
    by_name = {row["name"].split(" (")[0]: row for row in kernels}
    kernels[0]["launches_served_refinement"] = served["mppi fused, refinement"]["mppi"]
    by_name["weighted_partial"]["launches_served_generated_rollout"] = served[
        "generated rollout, step-dependent"]["weighted_update"]
    by_name["fused_rollout, generated step-dependent model"]["launches_served"] = served[
        "generated rollout, step-dependent"]["generated_rollout"]
    terminal_row = by_name["fused_mppi MPPI, generated model and traced terminal cost"]
    terminal_row.update(
        launches_served=served["generated mppi fused, traced terminal"]["generated_mppi"],
        launches_served_cold_cache=deploy_report["cold"]["launches"]["generated_mppi"],
        build_s_cold_cache=deploy_report["cold"]["nvcc_s"])
    kernels[-1]["launches_served_seed_mode"] = served[
        f"generated batched seed N={BATCH_N}"]["generated_batched"]
    total = time.perf_counter() - START
    print(f"# chip_smoke total: {total:.1f} s; on a host {SLOW_HOST}x slower in every phase "
          f"about {SLOW_HOST * total:.1f} s, of the {TIME_LIMIT_S} s limit")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
