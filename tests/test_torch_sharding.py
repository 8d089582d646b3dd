"""The port's sharding (``pytorch_mppi_tpu_torch.parallel``) against JAX's
on its 8-virtual-device mesh.

Ports ``tests/test_sharding.py`` (all seven tests),
``tests/test_extensions.py:1496-1512`` and the sharded cases of
``tests/test_pallas_transposed.py`` (the sharded fused solve, the SMPPI and
KMPPI variants with the null gate and artifacts, the gate's arity, the null
action with artifacts, the env-sharded batched solve in bits and operand
mode), and holds the gated plain versions against JAX's
``null_dynamic_gate=True`` kernels.

The port's side runs in Gloo worlds of CPU processes (2, 4 and 8 ranks),
each started once per module by the ``worlds`` fixture with a
``file://`` rendezvous: this file run as a script is the worker
(``python tests/test_torch_sharding.py WORLD RANK INIT_FILE OUT_DIR``),
which runs every case of its world on every rank and saves each rank's
results.  The tests compute JAX's side in the pytest process meanwhile,
then read them.  The kernels run their plain versions there (CPU tensors),
JAX's in Pallas interpret mode, on the same int32 bits made from a seed
with numpy.  The controllers draw the same normals on both sides: every
draw of a shape returns one block made from a seed with numpy
(:func:`normals`), so JAX's jitted steps, which trace their draw once, and
the port's steps see the same noise at every command.

Tolerances: the port's sharded plain path against its unsharded one is
bit for bit (``assert_array_equal``, as JAX's ``test_mesh_sharding_
invariance``); against JAX in float64, JAX's own rtol 1e-12 (actions) and
1e-9 (costs) of ``test_sharding.py``; the sharded kernels against the
unsharded ones, JAX's of ``test_pallas_transposed.py:630-642`` (costs rtol
1e-6, m 1e-7, s 1e-5, delta/s rtol 1e-4 atol 1e-7; the variants' 1e-5 and
1e-3), and the port's plain versions against JAX's interpret-mode kernels,
``test_torch_fused_solve.py``'s (costs rtol 2e-5 atol 1e-5, delta/s rtol
2e-4 atol 2e-6, emitted actions rtol 1e-5 atol 1e-6).
"""
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLDS = (2, 4, 8)
B_NP = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL_NP = np.array([2.0, 2.0])
SEED = 42
# the kernels' problem (tests/test_pallas_transposed.py)
KS, T, NU, NX = 1024, 6, 2, 2
D = T * NU
NSP = 4
DP = NSP * NU
KB, NB = 256, 16  # the batched solve's K and N

CPU_COST_TOL = dict(rtol=2e-5, atol=1e-5)
CPU_UPDATE_TOL = dict(rtol=2e-4, atol=2e-6)
EMIT_TOL = dict(rtol=1e-5, atol=1e-6)


def normals(shape):
    """The one block of N(0, 1) draws of ``shape``, on either side."""
    shape = tuple(int(s) for s in shape)
    seed = 1 + sum((i + 1) * 7919 * s for i, s in enumerate(shape)) % 100_003
    return np.random.RandomState(seed).randn(*shape)


def rand_bits(rs, shape):
    return rs.randint(-(2**31), 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def kernel_inputs():
    """The sharded kernels' inputs (``test_pallas_transposed.py:596-800``),
    made from seeds with numpy."""
    rs = np.random.RandomState(3)
    f = np.float32
    ones, onep = np.ones(D, f), np.ones(DP, f)
    U2 = (rs.randn(D) * 0.1).astype(f)
    return dict(
        bits=rand_bits(rs, (D, KS)), bits_k=rand_bits(rs, (DP, KS)),
        bits_b=rand_bits(rs, (D, KB)), U2=U2,
        as2=(rs.randn(D) * 0.2).astype(f), th2=(rs.randn(DP) * 0.2).astype(f),
        scale=np.full(D, 0.8, f), zero=np.zeros(D, f), lo=-ones, hi=ones, onep=onep,
        a_flat=U2 * f(0.7), lam=f(1.0), x0=np.array([-3.0, -2.0], f),
        x0s=np.array([-1.0, -1.0], f),
        Ub=(rs.randn(NB, T, NU) * 0.1).astype(f),
        x0b=rs.uniform(-2.0, 2.0, (NB, NX)).astype(f),
        noiseT=(rs.randn(D, KB) * 0.8).astype(f))


def _smppi_args(x):
    f = np.float32
    ones = np.ones(D, f)
    return (x["U2"], x["as2"], 0.8 * ones, 0 * ones, -2 * ones, 2 * ones, -ones, ones,
            x["a_flat"], f(1.0), f(5.0), f(0.5))


def _kmppi_args(x, Wt):
    f = np.float32
    ones, onep = np.ones(D, f), np.ones(DP, f)
    return (x["U2"], x["th2"], 0.9 * onep, 0 * onep, -onep, onep, -ones, ones, x["a_flat"],
            Wt, f(0.9))


def _mppi_args(x):
    return (x["U2"], x["scale"], x["zero"], x["lo"], x["hi"], x["a_flat"], x["lam"])


def _batched_args(x):
    f = np.float32
    ones = np.ones(D, f)
    a2 = (x["Ub"] / f(0.64)).reshape(NB, D)
    return (x["x0b"].T.copy(), x["Ub"].reshape(NB, D).T.copy(), 0.8 * ones, 0 * ones,
            -ones, ones, a2.T.copy(), x["lam"])


# ---------------------------------------------------------------------------
# The port's side: the cases each world runs on every rank
# ---------------------------------------------------------------------------


class _Injected:
    """The port's steps draw :func:`normals` while it is entered."""

    def __enter__(self):
        from pytorch_mppi_tpu_torch.ops import solve as PS

        self.PS, self.was = PS, PS.standard_normal
        PS.standard_normal = lambda gen, shape, dtype, device: torch.tensor(
            normals(shape), dtype=dtype, device=device)

    def __exit__(self, *exc):
        self.PS.standard_normal = self.was


def _lin(dtype):
    B, G = torch.tensor(B_NP, dtype=dtype), torch.tensor(GOAL_NP, dtype=dtype)
    return (lambda s, a: s + a @ B.T), (lambda s, a: ((G - s) ** 2).sum(-1))


def _np(t):
    return t.detach().cpu().numpy()


def _commands(ctrl, state, n, step=None):
    out = []
    for _ in range(n):
        a = ctrl.command(state)
        out.append(_np(a))
        if step is not None:
            state = step(state, a)
    return np.stack(out), state


def case_k_match(mesh):
    """test_sharding.py::TestShardedMPPI::test_k_sharded_matches_single_device."""
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    state = torch.tensor([-3.0, -2.0], dtype=torch.float64)
    kw = dict(num_samples=512, horizon=10, lambda_=1.0, seed=SEED, device="cpu")
    with _Injected():
        ref = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), **kw)
        sh = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64),
                  mesh=mesh((8,), ("k",)), **kw)
        a_ref, _ = _commands(ref, state, 3)
        a_sh, _ = _commands(sh, state, 3)
    return dict(a_ref=a_ref, a_sh=a_sh, c_ref=_np(ref.cost_total), c_sh=_np(sh.cost_total))


def case_k_closed_loop(mesh):
    """test_k_sharded_closed_loop, on the port's own noise stream."""
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    kw = dict(num_samples=512, horizon=15, lambda_=1.0, seed=SEED, device="cpu")
    sh = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), mesh=mesh((8,), ("k",)), **kw)
    ref = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), **kw)
    step = lambda s, a: dyn(s[None], a[None])[0]
    x0 = torch.tensor([-3.0, -2.0], dtype=torch.float64)
    a_sh, s_sh = _commands(sh, x0, 20, step)
    a_ref, _ = _commands(ref, x0, 20, step)
    return dict(a_sh=a_sh, a_ref=a_ref, final=_np(s_sh))


def _batched(mesh=None, N=16, K=128, seed=SEED, **kw):
    from pytorch_mppi_tpu_torch import MPPI_Batched

    dyn, cost = _lin(torch.float64)
    return MPPI_Batched(dyn, cost, 2, torch.eye(2, dtype=torch.float64), num_envs=N,
                        num_samples=K, horizon=10, lambda_=1.0, seed=seed, device="cpu",
                        mesh=mesh, **kw)


def case_env_match(mesh):
    """TestShardedBatched::test_env_sharded_matches_single_device."""
    states = torch.tensor(np.random.RandomState(SEED).randn(16, 2))
    with _Injected():
        ref, sh = _batched(), _batched(mesh((8,), ("data",)))
        a_ref, _ = _commands(ref, states, 3)
        a_sh, _ = _commands(sh, states, 3)
    return dict(a_ref=a_ref, a_sh=a_sh, c_ref=_np(ref.cost_total), c_sh=_np(sh.cost_total),
                U_sh=_np(sh.U))


def case_2d(mesh):
    """test_2d_mesh_env_and_sample_sharded: plants over "data", samples over
    "k"."""
    states = torch.tensor(np.random.RandomState(SEED).randn(8, 2))
    with _Injected():
        ref = _batched(N=8, K=64)
        sh = _batched(mesh((2, 4), ("data", "k")), N=8, K=64, env_axis="data",
                      sample_axis="k")
        a_ref, _ = _commands(ref, states, 1)
        a_sh, _ = _commands(sh, states, 1)
    return dict(a_ref=a_ref, a_sh=a_sh, c_ref=_np(ref.cost_total), c_sh=_np(sh.cost_total))


def case_progress(mesh):
    """test_sharded_progress_toward_goal on a (4, 2) mesh, the port's own
    noise."""
    dyn, _ = _lin(torch.float64)
    sh = _batched(mesh((4, 2), ("data", "k")), N=8, K=256, env_axis="data", sample_axis="k")
    ref = _batched(N=8, K=256)
    states = torch.tensor(np.random.RandomState(SEED).randn(8, 2) * 3)
    goal = torch.tensor(GOAL_NP)
    a_sh, s_sh = _commands(sh, states, 10, dyn)
    a_ref, _ = _commands(ref, states, 10, dyn)
    return dict(initial=_np(torch.linalg.norm(states - goal, dim=-1)),
                final=_np(torch.linalg.norm(s_sh - goal, dim=-1)), a_sh=a_sh, a_ref=a_ref)


def _mesh_shape_action(mesh_or_none):
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    with _Injected():
        ctrl = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), num_samples=256,
                    horizon=10, lambda_=1.0, seed=SEED, device="cpu", mesh=mesh_or_none)
        return _np(ctrl.command(torch.tensor([1.0, -1.0], dtype=torch.float64)))


def case_mesh_shapes(mesh):
    """TestDeterminismAcrossMeshShapes: this world's "k" mesh, and none."""
    from torch.distributed import get_world_size

    return dict(a_mesh=_mesh_shape_action(mesh((get_world_size(),), ("k",))),
                a_none=_mesh_shape_action(None))


def case_antithetic(mesh):
    """test_antithetic_sharded_matches_single_device on 4 ranks."""
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    kw = dict(num_samples=64, horizon=6, lambda_=1.0, seed=11, antithetic_sampling=True,
              device="cpu")
    state = torch.tensor([-2.0, 1.0], dtype=torch.float64)
    with _Injected():
        ref = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), **kw)
        sh = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64),
                  mesh=mesh((4,), ("k",)), sample_axis="k", **kw)
        a_ref, _ = _commands(ref, state, 3)
        a_sh, _ = _commands(sh, state, 3)
    return dict(a_ref=a_ref, a_sh=a_sh)


TERM_GOAL = np.array([1.5, -0.5])


def _fterm(s, a):
    g = torch.as_tensor(TERM_GOAL, dtype=s.dtype)
    return 10.0 * ((s - g) ** 2).sum(-1) + 0.1 * (a ** 2).sum(-1)


def case_terminal(mesh):
    """test_extensions.py::test_mesh_sharding_invariance on 4 ranks."""
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    kw = dict(num_samples=64, horizon=6, lambda_=1.0, seed=3, device="cpu",
              u_min=-torch.ones(2, dtype=torch.float64),
              u_max=torch.ones(2, dtype=torch.float64), terminal_final_cost=_fterm)
    x = torch.tensor([-2.0, 1.0], dtype=torch.float64)
    with _Injected():
        plain = MPPI(dyn, cost, 2, 0.5 * torch.eye(2, dtype=torch.float64), **kw)
        sharded = MPPI(dyn, cost, 2, 0.5 * torch.eye(2, dtype=torch.float64),
                       mesh=mesh((4,), ("k",)), **kw)
        return dict(a_ref=_np(plain.command(x)), a_sh=_np(sharded.command(x)))


def case_uneven(mesh):
    """Plants and samples that do not divide over the ranks: the plain path
    pads the last rank's share (N = 10, K = 50 over 4 ranks)."""
    from pytorch_mppi_tpu_torch import MPPI

    dyn, cost = _lin(torch.float64)
    states = torch.tensor(np.random.RandomState(1).randn(10, 2))
    kw = dict(num_samples=50, horizon=5, lambda_=1.0, seed=5, device="cpu",
              sample_null_action=True)
    sh = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), mesh=mesh((4,), ("k",)), **kw)
    ref = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), **kw)
    x = torch.tensor([-1.0, 0.5], dtype=torch.float64)
    return dict(b_ref=_np(_batched(N=10, K=50).command(states)),
                b_sh=_np(_batched(mesh((4,), ("data",)), N=10, K=50).command(states)),
                a_ref=_np(ref.command(x)), a_sh=_np(sh.command(x)),
                c_ref=_np(ref.cost_total), c_sh=_np(sh.cost_total))


def case_stochastic(mesh):
    """Stochastic dynamics on a mesh: their draws span the whole batch they
    are given, so every rank rolls out every plant on all samples and the
    sharded commands equal the unsharded ones bit for bit (``MPPI_Batched``
    over "data", over "data" and "k", and ``MPPI`` over "k")."""
    from pytorch_mppi_tpu_torch import MPPI

    B = torch.tensor(B_NP)
    _, cost = _lin(torch.float64)

    def noisy(s, a, rng):
        return s + a @ B.T + 0.1 * torch.randn(s.shape, generator=rng, dtype=s.dtype)

    states = torch.tensor(np.random.RandomState(SEED).randn(6, 2))
    kw = dict(num_envs=6, num_samples=32, horizon=5, lambda_=1.0, seed=SEED, device="cpu",
              stochastic_dynamics=True)
    out = {}
    for tag, m, axes in (("data", mesh((2,), ("data",)), {}),
                         ("data_k", mesh((1, 2), ("data", "k")),
                          dict(env_axis="data", sample_axis="k"))):
        from pytorch_mppi_tpu_torch import MPPI_Batched

        ref = MPPI_Batched(noisy, cost, 2, torch.eye(2, dtype=torch.float64), **kw)
        sh = MPPI_Batched(noisy, cost, 2, torch.eye(2, dtype=torch.float64), mesh=m,
                          **axes, **kw)
        out[f"{tag}_ref"], _ = _commands(ref, states, 3)
        out[f"{tag}_sh"], _ = _commands(sh, states, 3)
        out[f"{tag}_c_ref"], out[f"{tag}_c_sh"] = _np(ref.cost_total), _np(sh.cost_total)
    one = dict(num_samples=32, horizon=5, lambda_=1.0, seed=SEED, device="cpu",
               stochastic_dynamics=True)
    x = torch.tensor([-3.0, -2.0], dtype=torch.float64)
    ref = MPPI(noisy, cost, 2, torch.eye(2, dtype=torch.float64), **one)
    sh = MPPI(noisy, cost, 2, torch.eye(2, dtype=torch.float64), mesh=mesh((2,), ("k",)), **one)
    out["k_ref"], _ = _commands(ref, x, 3)
    out["k_sh"], _ = _commands(sh, x, 3)
    out["k_c_ref"], out["k_c_sh"] = _np(ref.cost_total), _np(sh.cost_total)
    return out


def _kernel_model():
    from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

    return linear_quadratic(torch.tensor(B_NP), torch.tensor(GOAL_NP))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def case_kernels(mesh, Wt):
    """The sharded fused solves of test_pallas_transposed.py on injected
    bits, over this world's "k" mesh, beside the unsharded ones."""
    from torch.distributed import get_world_size

    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS
    from pytorch_mppi_tpu_torch.ops import solve as PS
    from pytorch_mppi_tpu_torch.parallel import all_gather_cat

    n = get_world_size()
    k_mesh, model, x = mesh((n,), ("k",)), _kernel_model(), kernel_inputs()
    group = PS.Split(k_mesh, "k", KS).group
    out = {}

    def run(tag, cfg, sharded_factory, factory, lead, x0, args, emit):
        sh = sharded_factory(cfg, model, k_mesh, "k")
        un = factory(cfg, model, emit_perturbed=emit)
        x0T = torch.from_numpy(x0)[:, None].expand(NX, KS)
        r_sh, r_un = sh(torch.from_numpy(lead), x0T, *_t(*args)), un(
            torch.from_numpy(lead), x0T, *_t(*args))
        out.update({f"{tag}_d": _np(r_sh[0]), f"{tag}_m": _np(r_sh[1]),
                    f"{tag}_s": _np(r_sh[2]), f"{tag}_c": _np(all_gather_cat(r_sh[3], 0, group)),
                    f"{tag}_d1": _np(r_un[0]), f"{tag}_m1": _np(r_un[1]),
                    f"{tag}_s1": _np(r_un[2]), f"{tag}_c1": _np(r_un[3])})
        if emit:
            out[f"{tag}_p"] = _np(all_gather_cat(r_sh[4], 1, group))
            out[f"{tag}_p1"] = _np(r_un[4])

    base = MPPIConfig(nx=NX, nu=NU, K=KS, T=T, diag_sigma=True)
    null = dict(sample_null_action=True, fused_artifacts=True)
    run("mppi", base, PS.make_sharded_transposed_solve, FS.make_transposed_fused_solve,
        x["bits"], x["x0"], _mppi_args(x), False)
    run("null", MPPIConfig(nx=NX, nu=NU, K=KS, T=T, diag_sigma=True, **null),
        PS.make_sharded_transposed_solve, FS.make_transposed_fused_solve, x["bits"],
        x["x0"], _mppi_args(x), True)
    run("smppi", MPPIConfig(nx=NX, nu=NU, K=KS, T=T, diag_sigma=True, **null),
        PS.make_sharded_smppi_solve, FS.make_transposed_smppi_solve, x["bits"], x["x0s"],
        _smppi_args(x), True)
    run("kmppi", MPPIConfig(nx=NX, nu=NU, K=KS, T=T, diag_sigma=True, num_support_pts=NSP,
                            **null),
        PS.make_sharded_kmppi_solve, FS.make_transposed_kmppi_solve, x["bits_k"], x["x0s"],
        _kmppi_args(x, Wt), True)
    # the env-sharded batched solve: bits, then the noise operand
    d_mesh = mesh((n,), ("data",))
    dgroup = PS.Split(d_mesh, "data", NB).group
    cfg_b = MPPIConfig(nx=NX, nu=NU, K=KB, T=T, diag_sigma=True)
    for tag, lead, kw in (("bat", x["bits_b"], {}), ("op", x["noiseT"], {"noise_operand": True})):
        sh = PS.make_sharded_batched_solve(cfg_b, NB, model, d_mesh, "data", **kw)
        un = FS.make_transposed_batched_solve(cfg_b, NB, model, **kw)
        args = _t(*_batched_args(x))
        d_s, ms_s, c_s = sh(torch.from_numpy(lead), *args)
        d_1, ms_1, c_1 = un(torch.from_numpy(lead), *args)
        out.update({f"{tag}_d": _np(all_gather_cat(d_s, 1, dgroup)),
                    f"{tag}_ms": _np(all_gather_cat(ms_s, 1, dgroup)),
                    f"{tag}_c": _np(all_gather_cat(c_s, 0, dgroup)),
                    f"{tag}_d1": _np(d_1), f"{tag}_ms1": _np(ms_1), f"{tag}_c1": _np(c_1)})
    return out


def case_fused_controllers(mesh):
    """MPPI, SMPPI and KMPPI on the fused route (the kernels' plain
    versions on the CPU) with a "k" mesh of 8 ranks, beside the unsharded
    controllers: the same seed-mode noise (the ranks draw global samples),
    one null row, the per-sample artifacts gathered when read."""
    from pytorch_mppi_tpu_torch import KMPPI, MPPI, SMPPI

    model = _kernel_model()
    k_mesh = mesh((8,), ("k",))
    out = {}
    for name, cls, extra in (("mppi", MPPI, {}), ("smppi", SMPPI, {}),
                             ("kmppi", KMPPI, {"num_support_pts": 4})):
        kw = dict(num_samples=1024, horizon=T, lambda_=1.0, seed=7, device="cpu",
                  use_pallas=True, sample_null_action=True, fused_artifacts=True,
                  u_min=-torch.ones(2), u_max=torch.ones(2), noise_mu=torch.zeros(2), **extra)
        sh = cls(model.dynamics, model.running_cost, 2, torch.eye(2) * 0.5, mesh=k_mesh, **kw)
        un = cls(model.dynamics, model.running_cost, 2, torch.eye(2) * 0.5, **kw)
        assert sh._fns.fused and un._fns.fused
        x = torch.tensor([-3.0, -2.0])
        first, first1 = _np(sh.command(x)), _np(un.command(x))
        # the first command's, from the same nominal sequence
        out[f"{name}_c"], out[f"{name}_c1"] = _np(sh.cost_total), _np(un.cost_total)
        out[f"{name}_p"] = _np(sh.perturbed_action)
        out[f"{name}_p1"] = _np(un.perturbed_action)
        a, _ = _commands(sh, x, 2)
        a1, _ = _commands(un, x, 2)
        out[f"{name}_a"], out[f"{name}_a1"] = np.vstack([first, a]), np.vstack([first1, a1])
    return out


def case_routes(mesh):
    """The routing of a mesh: what the fused kernels cannot shard warns and
    takes the plain path (elites on a K-sharded mesh, both batched axes,
    the legacy route, K that does not divide), and the mesh API's errors."""
    import logging

    from torch.distributed import get_world_size

    from pytorch_mppi_tpu_torch import MPPI, MPPI_Batched
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    model = _kernel_model()
    k_mesh, dk_mesh = mesh((2,), ("k",)), mesh((1, 2), ("data", "k"))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log = logging.getLogger("pytorch_mppi_tpu_torch")
    log.addHandler(handler)
    kw = dict(num_samples=64, horizon=4, device="cpu", mesh=k_mesh)
    try:
        fused = {
            "elites": MPPI(model.dynamics, model.running_cost, 2, torch.eye(2), num_elites=2,
                           fused_artifacts=True, use_pallas=True, **kw),
            "legacy": MPPI(model.dynamics, model.running_cost, 2, torch.eye(2),
                           use_pallas="rollout", **kw),
            "odd_k": MPPI(model.dynamics, model.running_cost, 2, torch.eye(2),
                          use_pallas=True, **dict(kw, num_samples=63)),
            "both_axes": MPPI_Batched(model.dynamics, model.running_cost, 2, torch.eye(2),
                                      num_envs=4, num_samples=512, horizon=4, device="cpu",
                                      mesh=dk_mesh, env_axis="data", sample_axis="k",
                                      use_pallas="force"),
            "sharded": MPPI(model.dynamics, model.running_cost, 2, torch.eye(2),
                            use_pallas=True, **kw),
        }
        x = torch.tensor([0.5, -0.5])
        actions = {k: _np(c.command(x if k != "both_axes" else torch.zeros(4, 2)))
                   for k, c in fused.items()}
    finally:
        log.removeHandler(handler)
    try:
        make_mesh((get_world_size() + 1,), ("k",), device="cpu")
        bad_shape = ""
    except ValueError as e:
        bad_shape = str(e)
    initialize_multihost("localhost:1", 99, 98, device="cpu")  # a group exists: a no-op
    default = make_mesh(device="cpu")
    return dict(fused=np.array([fused[k]._fns.fused for k in sorted(fused)]),
                names=np.array(sorted(fused)), warnings=np.array(seen),
                bad_shape=np.array(bad_shape), default_shape=np.array(tuple(default.shape)),
                default_names=np.array(default.mesh_dim_names),
                finite=np.array([np.isfinite(a).all() for a in actions.values()]))


CASES = {
    8: (case_k_match, case_k_closed_loop, case_env_match, case_2d, case_progress,
        case_mesh_shapes, case_kernels, case_fused_controllers),
    4: (case_mesh_shapes, case_antithetic, case_terminal, case_uneven, case_kernels),
    2: (case_routes, case_stochastic, case_kernels),
}


def _worker(world, rank, init_file, out_dir):
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    initialize_multihost(f"file://{init_file}", world, rank, device="cpu")
    Wt = np.load(os.path.join(out_dir, "inputs.npz"))["Wt"]
    mesh = lambda shape, names: make_mesh(shape, names, device="cpu")
    results = {}
    for case in CASES[world]:
        results[case.__name__] = (case(mesh, Wt) if case is case_kernels else case(mesh))
    torch.save(results, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


class _Worlds:
    """The Gloo worlds of this module, started together; :meth:`get` waits
    for one and returns its ranks' results."""

    def __init__(self, out_dir):
        self.dir, self.procs, self.results = out_dir, {}, {}
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for n in WORLDS:
            init = os.path.join(out_dir, f"init{n}")
            self.procs[n] = [
                subprocess.Popen([sys.executable, HERE, str(n), str(r), init, out_dir], env=env,
                                 cwd=REPO, stdout=open(self._log(n, r), "w"),
                                 stderr=subprocess.STDOUT)
                for r in range(n)]

    def _log(self, n, r):
        return os.path.join(self.dir, f"world{n}_rank{r}.log")

    def get(self, n, timeout=240):
        if n not in self.results:
            procs, failed = self.procs[n], None
            try:
                for p in procs:
                    p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                failed = "timed out"
            self.kill(n)
            if failed is None and any(p.returncode for p in procs):
                failed = f"exit codes {[p.returncode for p in procs]}"
            if failed:
                logs = "\n".join(f"--- rank {r}:\n" + open(self._log(n, r)).read()[-3000:]
                                 for r in range(n))
                raise AssertionError(f"the {n}-rank world failed ({failed}):\n{logs}")
            self.results[n] = [torch.load(os.path.join(self.dir, f"world{n}_rank{r}.pt"),
                                          weights_only=False) for r in range(n)]
        return self.results[n]

    def case(self, n, name):
        """The case's results of rank 0, after checking that every rank
        holds the same (the replicated results of a sharded command)."""
        ranks = [r[name] for r in self.get(n)]
        for other in ranks[1:]:
            for k, v in ranks[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=f"{name}: {k} across ranks")
        return ranks[0]

    def kill(self, n=None):
        for m in ([n] if n is not None else list(self.procs)):
            for p in self.procs[m]:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from pytorch_mppi_tpu.ops.kernels import RBFKernel, interpolation_operators

    import jax.numpy as jnp

    out_dir = str(tmp_path_factory.mktemp("worlds"))
    interp_full, _ = interpolation_operators(RBFKernel(2.0), T, NSP, jnp.float32)
    np.savez(os.path.join(out_dir, "inputs.npz"),
             Wt=np.asarray(jnp.kron(interp_full, jnp.eye(NU, dtype=jnp.float32))))
    w = _Worlds(out_dir)
    yield w
    w.kill()


# ---------------------------------------------------------------------------
# JAX's side and the comparisons
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_normals(monkeypatch):
    """JAX's controllers draw :func:`normals` (traced once into each jitted
    step, as the port's steps draw the same block every command)."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(
        normals(shape), dtype or jnp.float64))


def _jlin():
    import jax.numpy as jnp

    B, G = jnp.asarray(B_NP), jnp.asarray(GOAL_NP)
    return (lambda s, a: s + a @ B.T), (lambda s, a: ((G - s) ** 2).sum(axis=-1))


def _jmesh(shape, names, n=None):
    import jax

    from pytorch_mppi_tpu.parallel import make_mesh

    return make_mesh(shape, names, devices=jax.devices()[: n or int(np.prod(shape))])


def _jcommands(ctrl, state, n):
    return np.stack([np.asarray(ctrl.command(state)) for _ in range(n)])


F64_ACTION = dict(rtol=1e-12)
F64_COST = dict(rtol=1e-9)


def test_k_sharded_matches_single_device(worlds, jax_normals):
    """K over 8 ranks changes nothing: the port's sharded plain path equals
    its unsharded one bit for bit and JAX's 8-device solve to JAX's rtol."""
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI as JMPPI

    dyn, cost = _jlin()
    j = JMPPI(dyn, cost, 2, jnp.eye(2), num_samples=512, horizon=10, lambda_=1.0, seed=SEED,
              mesh=_jmesh((8,), ("k",)))
    a_j = _jcommands(j, jnp.array([-3.0, -2.0]), 3)
    r = worlds.case(8, "case_k_match")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_array_equal(r["c_sh"], r["c_ref"])
    np.testing.assert_allclose(r["a_sh"], a_j, **F64_ACTION)
    np.testing.assert_allclose(r["c_sh"], np.asarray(j.cost_total), **F64_COST)


def test_k_sharded_closed_loop(worlds):
    r = worlds.case(8, "case_k_closed_loop")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    assert np.linalg.norm(r["final"] - GOAL_NP) < 2.0


def test_env_sharded_matches_single_device(worlds, jax_normals):
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI_Batched as JBatched

    dyn, cost = _jlin()
    states = jnp.asarray(np.random.RandomState(SEED).randn(16, 2))
    j = JBatched(dyn, cost, 2, jnp.eye(2), num_envs=16, num_samples=128, horizon=10,
                 lambda_=1.0, seed=SEED, mesh=_jmesh((8,), ("data",)))
    a_j = _jcommands(j, states, 3)
    r = worlds.case(8, "case_env_match")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_array_equal(r["c_sh"], r["c_ref"])
    assert r["c_sh"].shape == (16, 128) and r["U_sh"].shape == (16, 10, 2)
    np.testing.assert_allclose(r["a_sh"], a_j, **F64_ACTION)
    np.testing.assert_allclose(r["c_sh"], np.asarray(j.cost_total), **F64_COST)


def test_2d_mesh_env_and_sample_sharded(worlds, jax_normals):
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI_Batched as JBatched

    dyn, cost = _jlin()
    states = jnp.asarray(np.random.RandomState(SEED).randn(8, 2))
    j = JBatched(dyn, cost, 2, jnp.eye(2), num_envs=8, num_samples=64, horizon=10,
                 lambda_=1.0, seed=SEED, mesh=_jmesh((2, 4), ("data", "k")),
                 env_axis="data", sample_axis="k")
    a_j = _jcommands(j, states, 1)
    r = worlds.case(8, "case_2d")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_array_equal(r["c_sh"], r["c_ref"])
    np.testing.assert_allclose(r["a_sh"], a_j, **F64_ACTION)


def test_sharded_progress_toward_goal(worlds):
    r = worlds.case(8, "case_progress")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    assert r["final"].mean() < r["initial"].mean()


def test_same_result_on_different_mesh_shapes(worlds, jax_normals):
    """The mesh's layout does not leak into the numbers: 8 ranks, 4 ranks
    and none agree, and agree with JAX's (8,)-device mesh."""
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI as JMPPI

    dyn, cost = _jlin()
    j = JMPPI(dyn, cost, 2, jnp.eye(2), num_samples=256, horizon=10, lambda_=1.0, seed=SEED,
              mesh=_jmesh((8,), ("k",)))
    a_j = np.asarray(j.command(jnp.array([1.0, -1.0])))
    r8, r4 = worlds.case(8, "case_mesh_shapes"), worlds.case(4, "case_mesh_shapes")
    np.testing.assert_array_equal(r8["a_mesh"], r8["a_none"])
    np.testing.assert_array_equal(r4["a_mesh"], r8["a_mesh"])
    np.testing.assert_allclose(r8["a_mesh"], a_j, **F64_ACTION)


def test_antithetic_sharded_matches_single_device(worlds, jax_normals):
    """JAX's tolerance (rtol 1e-12, atol 1e-13) against its sharded solve;
    the port's sharded plain path is bit for bit its unsharded one."""
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI as JMPPI

    dyn, cost = _jlin()
    j = JMPPI(dyn, cost, 2, jnp.eye(2), num_samples=64, horizon=6, lambda_=1.0, seed=11,
              antithetic_sampling=True, mesh=_jmesh((4,), ("k",)), sample_axis="k")
    a_j = _jcommands(j, jnp.array([-2.0, 1.0]), 3)
    r = worlds.case(4, "case_antithetic")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_allclose(r["a_sh"], a_j, rtol=1e-12, atol=1e-13)


def test_mesh_sharding_invariance(worlds, jax_normals):
    """test_extensions.py:1496-1512: the K-sharded plain solve with a
    final-state terminal cost is bit for bit the unsharded one; against
    JAX's sharded solve, rtol 1e-12."""
    import jax.numpy as jnp

    from pytorch_mppi_tpu import MPPI as JMPPI

    dyn, cost = _jlin()
    goal = jnp.asarray(TERM_GOAL)
    fterm = lambda s, a: 10.0 * ((s - goal) ** 2).sum(axis=-1) + 0.1 * (a ** 2).sum(axis=-1)
    j = JMPPI(dyn, cost, 2, 0.5 * jnp.eye(2), num_samples=64, horizon=6, lambda_=1.0, seed=3,
              u_min=-jnp.ones(2), u_max=jnp.ones(2), terminal_final_cost=fterm,
              mesh=_jmesh((4,), ("k",)))
    a_j = np.asarray(j.command(jnp.array([-2.0, 1.0])))
    r = worlds.case(4, "case_terminal")
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_allclose(r["a_sh"], a_j, **F64_ACTION)


def test_uneven_split_matches_single_device(worlds):
    r = worlds.case(4, "case_uneven")
    np.testing.assert_array_equal(r["b_sh"], r["b_ref"])
    np.testing.assert_array_equal(r["a_sh"], r["a_ref"])
    np.testing.assert_array_equal(r["c_sh"], r["c_ref"])
    assert r["c_sh"].shape == (50,)


def _jax_kernel_outputs():
    """JAX's sharded and unsharded interpret-mode kernels on
    :func:`kernel_inputs` (``test_pallas_transposed.py:596-800``)."""
    import jax
    import jax.numpy as jnp

    from pytorch_mppi_tpu.config import MPPIConfig as JConfig
    from pytorch_mppi_tpu.ops import solve as S

    x = kernel_inputs()
    f32 = jnp.float32
    B, G = jnp.asarray(B_NP, f32), jnp.asarray(GOAL_NP, f32)
    dyn = lambda s, a: s + a @ B.T
    cost = lambda s, a: ((G - s) ** 2).sum(axis=-1)
    mesh = _jmesh((8,), ("k",))
    out = {}

    def run(tag, cfg, sharded_factory, lead, x0, args):
        wd, wc = S.wrap_dynamics(cfg, dyn), S.wrap_cost(cfg, cost)
        sh = sharded_factory(cfg, wd, wc, mesh, "k", rng_in_kernel=False)
        x0T = jnp.broadcast_to(jnp.asarray(x0)[:, None], (NX, KS))
        args = tuple(jnp.asarray(a) for a in args)
        res = jax.jit(sh)(jnp.asarray(lead), x0T, *args)
        out[tag] = [np.asarray(v) for v in res]

    null = dict(sample_null_action=True, fused_artifacts=True)
    run("mppi", JConfig(nx=NX, nu=NU, K=KS, T=T, dtype=f32, diag_sigma=True),
        S.make_sharded_transposed_solve, x["bits"], x["x0"], _mppi_args(x))
    run("null", JConfig(nx=NX, nu=NU, K=KS, T=T, dtype=f32, diag_sigma=True, **null),
        S.make_sharded_transposed_solve, x["bits"], x["x0"], _mppi_args(x))
    run("smppi", JConfig(nx=NX, nu=NU, K=KS, T=T, dtype=f32, diag_sigma=True, **null),
        S.make_sharded_smppi_solve, x["bits"], x["x0s"], _smppi_args(x))
    from pytorch_mppi_tpu.ops.kernels import RBFKernel, interpolation_operators

    interp_full, _ = interpolation_operators(RBFKernel(2.0), T, NSP, f32)
    Wt = np.asarray(jnp.kron(interp_full, jnp.eye(NU, dtype=f32)))
    run("kmppi", JConfig(nx=NX, nu=NU, K=KS, T=T, dtype=f32, diag_sigma=True,
                         num_support_pts=NSP, **null),
        S.make_sharded_kmppi_solve, x["bits_k"], x["x0s"], _kmppi_args(x, Wt))
    cfg_b = JConfig(nx=NX, nu=NU, K=KB, T=T, dtype=f32, diag_sigma=True)
    d_mesh = _jmesh((8,), ("data",))
    wd, wc = S.wrap_dynamics(cfg_b, dyn), S.wrap_cost(cfg_b, cost)
    bargs = tuple(jnp.asarray(a) for a in _batched_args(x))
    for tag, lead, kw in (("bat", x["bits_b"], dict(rng_in_kernel=False)),
                          ("op", x["noiseT"], dict(noise_operand=True))):
        sh = S.make_sharded_batched_solve(cfg_b, NB, wd, wc, d_mesh, "data", **kw)
        out[tag] = [np.asarray(v) for v in jax.jit(sh)(jnp.asarray(lead), *bargs)]
    return out


@pytest.fixture(scope="module")
def jax_kernels():
    return _jax_kernel_outputs()


def _check_merge(r, tag, j, cost_tol, update_tol):
    """The port's sharded kernel against its unsharded one (JAX's sharded
    tolerances) and against JAX's sharded kernel (the port's tolerances)."""
    np.testing.assert_allclose(r[f"{tag}_c"], r[f"{tag}_c1"], **cost_tol)
    np.testing.assert_allclose(r[f"{tag}_d"] / r[f"{tag}_s"], r[f"{tag}_d1"] / r[f"{tag}_s1"],
                               **update_tol)
    np.testing.assert_allclose(r[f"{tag}_c"], j[3], **CPU_COST_TOL)
    np.testing.assert_allclose(r[f"{tag}_m"], j[1], **CPU_COST_TOL)
    np.testing.assert_allclose(r[f"{tag}_s"], j[2], rtol=2e-5)
    np.testing.assert_allclose(r[f"{tag}_d"] / r[f"{tag}_s"], j[0] / j[2], **CPU_UPDATE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_matches_unsharded(worlds, jax_kernels, world):
    """The K-sharded fused MPPI solve (per-rank kernels merged by the three
    collectives) over 2, 4 and 8 ranks, on the global bits."""
    r = worlds.case(world, "case_kernels")
    np.testing.assert_allclose(r["mppi_m"], r["mppi_m1"], rtol=1e-7)
    np.testing.assert_allclose(r["mppi_s"], r["mppi_s1"], rtol=1e-5)
    _check_merge(r, "mppi", jax_kernels["mppi"], dict(rtol=1e-6, atol=1e-6),
                 dict(rtol=1e-4, atol=1e-7))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_variant_solves_match_unsharded(worlds, jax_kernels, world):
    """SMPPI and KMPPI with the null gate and the emitted actions: sample 0
    is the one null sample, on the rank that holds it."""
    r = worlds.case(world, "case_kernels")
    _check_merge(r, "smppi", jax_kernels["smppi"], dict(rtol=1e-5, atol=1e-5),
                 dict(rtol=1e-4, atol=1e-7))
    _check_merge(r, "kmppi", jax_kernels["kmppi"], dict(rtol=1e-4, atol=1e-3),
                 dict(rtol=1e-3, atol=1e-6))
    for tag in ("smppi", "kmppi"):
        np.testing.assert_allclose(r[f"{tag}_p"], r[f"{tag}_p1"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r[f"{tag}_p"], jax_kernels[tag][4], **EMIT_TOL)
        assert np.abs(r[f"{tag}_p"][:, 0]).max() == 0.0


def test_sharded_null_action_and_artifacts(worlds, jax_kernels):
    """The gate zeroes global sample 0 alone; the emitted set joins across
    the ranks into the global (D, K)."""
    r = worlds.case(8, "case_kernels")
    pert = r["null_p"]
    assert pert.shape == (D, KS)
    assert pert[:, 0].max() == 0.0 and pert[:, 0].min() == 0.0
    zero_cols = (np.abs(pert) < 1e-12).all(axis=0)
    assert zero_cols.sum() == 1 and zero_cols[0]
    np.testing.assert_allclose(pert, r["null_p1"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pert, jax_kernels["null"][4], **EMIT_TOL)
    _check_merge(r, "null", jax_kernels["null"], dict(rtol=1e-6, atol=1e-6),
                 dict(rtol=1e-4, atol=1e-7))


def test_sharded_batched_solve_matches_unsharded(worlds, jax_kernels):
    """Plants over "data" with no collective: the shared noise holds across
    the ranks (bits), and the noise operand gives the unsharded pair's
    results bit for bit."""
    r = worlds.case(8, "case_kernels")
    np.testing.assert_allclose(r["bat_c"], r["bat_c1"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["bat_d"] / r["bat_ms"][1][None],
                               r["bat_d1"] / r["bat_ms1"][1][None], rtol=1e-4, atol=1e-6)
    for tag in ("bat", "op"):
        d_j, ms_j, c_j = jax_kernels[tag]
        np.testing.assert_allclose(r[f"{tag}_c"], c_j, **CPU_COST_TOL)
        np.testing.assert_allclose(r[f"{tag}_d"] / r[f"{tag}_ms"][1][None],
                                   d_j / ms_j[1][None], **CPU_UPDATE_TOL)
    for k in ("op_c", "op_d", "op_ms"):
        np.testing.assert_array_equal(r[k], r[k + "1"])


@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_fused_controllers_sharded(worlds, variant):
    """The fused route on a K-sharded mesh draws what one process draws:
    the first command's costs and perturbed set (one null row) bit for bit,
    the actions within the merge's float32 rounding (rtol 1e-5, atol
    1e-6)."""
    r = worlds.case(8, "case_fused_controllers")
    np.testing.assert_array_equal(r[f"{variant}_c"], r[f"{variant}_c1"])
    np.testing.assert_array_equal(r[f"{variant}_p"], r[f"{variant}_p1"])
    assert r[f"{variant}_c"].shape == (1024,)
    assert (np.abs(r[f"{variant}_p"]).reshape(1024, -1).max(axis=1) == 0).sum() == 1
    np.testing.assert_allclose(r[f"{variant}_a"], r[f"{variant}_a1"], rtol=1e-5, atol=1e-6)


def test_mesh_routing_and_api(worlds):
    r = worlds.case(2, "case_routes")
    fused = dict(zip(r["names"], r["fused"]))
    assert fused == {"both_axes": False, "elites": False, "legacy": False, "odd_k": False,
                     "sharded": True}
    text = "\n".join(r["warnings"])
    for want in ("num_elites on a K-sharded mesh", "both the env and the sample axes",
                 "the legacy kernels do not shard", "must divide evenly"):
        assert want in text, want
    assert "does not cover 2 devices" in str(r["bad_shape"])
    assert tuple(r["default_shape"]) == (1, 2)
    assert tuple(r["default_names"]) == ("data", "k")
    assert r["finite"].all()


@pytest.mark.parametrize("tag", ["data", "data_k", "k"])
def test_stochastic_dynamics_sharded_matches_unsharded(worlds, tag):
    """Stochastic dynamics on a 2-rank mesh give the unsharded commands and
    costs bit for bit: the draws do not depend on the sharding, as JAX's."""
    r = worlds.case(2, "case_stochastic")
    np.testing.assert_array_equal(r[f"{tag}_sh"], r[f"{tag}_ref"])
    np.testing.assert_array_equal(r[f"{tag}_c_sh"], r[f"{tag}_c_ref"])
    assert np.isfinite(r[f"{tag}_sh"]).all()


# ---------------------------------------------------------------------------
# One process: the gate against JAX's gated kernels, and its arity
# ---------------------------------------------------------------------------


def _gated_pair(variant):
    import jax.numpy as jnp

    from pytorch_mppi_tpu.config import MPPIConfig as JConfig
    from pytorch_mppi_tpu.ops import pallas_rollout as PR
    from pytorch_mppi_tpu.ops import solve as S
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    K = 256
    flags = dict(nx=NX, nu=NU, K=K, T=T, diag_sigma=True, sample_null_action=True,
                 num_support_pts=NSP if variant == "kmppi" else 0)
    jcfg, cfg = JConfig(dtype=jnp.float32, **flags), MPPIConfig(**flags)
    B, G = jnp.asarray(B_NP, jnp.float32), jnp.asarray(GOAL_NP, jnp.float32)
    dyn = lambda s, a: s + a @ B.T
    cost = lambda s, a: ((G - s) ** 2).sum(axis=-1)
    factory_j = {"mppi": PR.make_transposed_fused_solve, "smppi": PR.make_transposed_smppi_solve,
                 "kmppi": PR.make_transposed_kmppi_solve}[variant]
    factory_p = {"mppi": FS.make_transposed_fused_solve, "smppi": FS.make_transposed_smppi_solve,
                 "kmppi": FS.make_transposed_kmppi_solve}[variant]
    solve_j = factory_j(jcfg, S.wrap_dynamics(jcfg, dyn), S.wrap_cost(jcfg, cost),
                        rng_in_kernel=False, emit_perturbed=True, null_dynamic_gate=True)
    solve_p = factory_p(cfg, _kernel_model(), pair_block=solve_j.block_k, emit_perturbed=True,
                        null_dynamic_gate=True)
    return solve_j, solve_p


@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi"])
def test_gated_plain_versions_match_jax(variant, gate):
    """The plain versions with the gate against JAX's
    ``null_dynamic_gate=True`` kernels in interpret mode on the same bits:
    gate 1 zeroes sample 0, gate 0 leaves it drawn."""
    import jax.numpy as jnp

    from pytorch_mppi_tpu.ops.kernels import RBFKernel, interpolation_operators

    solve_j, solve_p = _gated_pair(variant)
    x = kernel_inputs()
    K = 256
    rows = DP if variant == "kmppi" else D
    lead = x["bits_k" if variant == "kmppi" else "bits"][:rows, :K].copy()
    if variant == "mppi":
        args, x0 = _mppi_args(x), x["x0"]
    elif variant == "smppi":
        args, x0 = _smppi_args(x), x["x0s"]
    else:
        interp_full, _ = interpolation_operators(RBFKernel(2.0), T, NSP, jnp.float32)
        args = _kmppi_args(x, np.asarray(jnp.kron(interp_full, jnp.eye(NU, dtype=jnp.float32))))
        x0 = x["x0s"]
    x0T = np.broadcast_to(x0[:, None], (NX, K))
    out_j = solve_j(jnp.asarray(lead), jnp.asarray(x0T), *(jnp.asarray(a) for a in args),
                    jnp.asarray([gate], jnp.int32))
    out_p = solve_p(torch.from_numpy(lead), torch.from_numpy(x0)[:, None].expand(NX, K),
                    *_t(*args), torch.tensor([gate], dtype=torch.int32))
    d_j, m_j, s_j, c_j, p_j = (np.asarray(v) for v in out_j)
    d_p, m_p, s_p, c_p, p_p = (v.numpy() for v in out_p)
    np.testing.assert_allclose(c_p, c_j, **CPU_COST_TOL)
    np.testing.assert_allclose(s_p, s_j, rtol=2e-5)
    np.testing.assert_allclose(d_p / s_p, d_j / s_j, **CPU_UPDATE_TOL)
    np.testing.assert_allclose(p_p, p_j, **EMIT_TOL)
    assert (np.abs(p_p[:, 0]).max() == 0.0) == bool(gate)


@pytest.mark.parametrize("antithetic", [False, True])
def test_shard_reports_its_own_k(antithetic):
    """A shard's solve reports its own K as ``K_pad`` and the global
    padded K only in its injected bits' columns."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    cfg = MPPIConfig(nx=NX, nu=NU, K=250, T=T, diag_sigma=True, antithetic=antithetic)
    whole = FS.make_transposed_fused_solve(MPPIConfig(nx=NX, nu=NU, K=1000, T=T,
                                                      diag_sigma=True, antithetic=antithetic),
                                           _kernel_model())
    for i in range(4):
        shard = FS.make_transposed_fused_solve(cfg, _kernel_model(), shard=(i, 4))
        assert shard.K_pad == 250
        assert shard.bits_cols == whole.bits_cols == (500 if antithetic else 1000)


def test_gate_arity_is_loud():
    """A gate passed to a solve built without ``null_dynamic_gate`` raises,
    and so does a gated solve called without one (JAX's TypeError)."""
    from pytorch_mppi_tpu_torch.config import MPPIConfig
    from pytorch_mppi_tpu_torch.ops import fused_solve as FS

    cfg = MPPIConfig(nx=NX, nu=NU, K=64, T=T, diag_sigma=True, sample_null_action=True)
    model = _kernel_model()
    args = (torch.zeros(D, 64, dtype=torch.int32), torch.zeros(NX, 64), torch.zeros(D),
            torch.ones(D), torch.zeros(D), -torch.ones(D), torch.ones(D), torch.zeros(D),
            torch.tensor(1.0))
    ungated = FS.make_transposed_fused_solve(cfg, model)
    with pytest.raises(TypeError, match="null_dynamic_gate"):
        ungated(*args, torch.ones(1, dtype=torch.int32))
    gated = FS.make_transposed_fused_solve(cfg, model, null_dynamic_gate=True)
    with pytest.raises(TypeError, match="null_dynamic_gate"):
        gated(*args)
    for factory, n in ((FS.make_transposed_smppi_solve, 14),
                       (FS.make_transposed_kmppi_solve, 13)):
        kcfg = MPPIConfig(nx=NX, nu=NU, K=64, T=T, diag_sigma=True, sample_null_action=True,
                          num_support_pts=NSP)
        with pytest.raises(TypeError, match="null_dynamic_gate"):
            factory(kcfg, model, null_dynamic_gate=True).plain(*([torch.zeros(1)] * n))


@pytest.fixture
def gloo_mesh(tmp_path):
    """A Gloo world of this one process and its "k" mesh of one rank,
    taken down after the test."""
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost(f"file://{tmp_path / 'group'}", 1, 0, device="cpu")
    try:
        yield make_mesh((1,), ("k",), device="cpu")
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    from pytorch_mppi_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh((1,), ("k",), device="cpu")


def test_sharded_controller_is_not_exportable_yet(gloo_mesh):
    """Exporting a controller with a mesh raises the NotImplementedError
    naming its ROADMAP item; run_mppi_jit runs its commands eagerly."""
    from pytorch_mppi_tpu_torch import MPPI, run_mppi_jit
    from pytorch_mppi_tpu_torch.utils import deploy

    model = _kernel_model()
    ctrl = MPPI(model.dynamics, model.running_cost, 2, torch.eye(2), num_samples=32, horizon=4,
                device="cpu", use_pallas=True, mesh=gloo_mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12b"):
        deploy.export_solver(ctrl)
    twin = MPPI(model.dynamics, model.running_cost, 2, torch.eye(2), num_samples=32, horizon=4,
                device="cpu", use_pallas=True)
    x0 = torch.tensor([-1.0, 0.5])
    got, want = (run_mppi_jit(c, model.dynamics, x0, 5)[1] for c in (ctrl, twin))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


if __name__ == "__main__":
    try:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
