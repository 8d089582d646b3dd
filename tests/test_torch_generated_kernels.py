"""The user-dynamics tests of JAX's ``tests/test_pallas_transposed.py``
against the port's dynamics bridge (``ops/batch_last.py``).

The user's callables are passed untagged, so no named device model applies:
the port traces them into a generated model, whose kernels' plain versions
(``fused_solve_plain``, ``batched_solve_plain`` with the traced program as
the model) run here on the CPU.  Each is held against JAX's
``make_transposed_*_solve(rng_in_kernel=False)`` in Pallas interpret mode
with the user's jnp callables, fed the same int32 bits, with JAX's own
tolerances (``tests/test_pallas_transposed.py:102-107``): costs rtol 2e-5 /
atol 1e-5, m rtol 1e-6, s rtol 1e-5, the update delta/s rtol 2e-4 / atol
2e-6.  Callables outside the vocabulary take the plain path with a warning
naming the op (JAX raises ``UnsupportedPrimitive`` at build time, which
its routing turns into the XLA path).

The emitted C++ (``GeneratedKernel.header``) is compiled with the host
``g++`` and held against the program's evaluator in float32 (rtol 1e-5,
atol 1e-5: the same operations, with the C library's transcendentals in
place of torch's, each within an ulp or two), so the emitter's arithmetic is
checked here and not only on the card; skipped where there is no ``g++``.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` (phase 11).
"""
import logging
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import solve as PS

torch.set_num_threads(1)

DT = jnp.float32
K, T, NU, NX = 256, 6, 2, 2
D = T * NU
TOL_C = dict(rtol=2e-5, atol=1e-5)
TOL_U = dict(rtol=2e-4, atol=2e-6)

B_NP = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
GOAL_NP = np.array([2.0, 2.0], np.float32)
JB, JG = jnp.asarray(B_NP), jnp.asarray(GOAL_NP)
TB, TG = torch.from_numpy(B_NP), torch.from_numpy(GOAL_NP)
W1_NP = (np.random.RandomState(0).randn(4, 16) * 0.3).astype(np.float32)
W2_NP = (np.random.RandomState(1).randn(16, 2) * 0.3).astype(np.float32)
JW1, JW2 = jnp.asarray(W1_NP), jnp.asarray(W2_NP)
TW1, TW2 = torch.from_numpy(W1_NP), torch.from_numpy(W2_NP)


def j_lin(s, a):
    return s + a @ JB.T


def t_lin(s, a):
    return s + a @ TB.T


def j_quad(s, a):
    return ((JG - s) ** 2).sum(axis=-1)


def t_quad(s, a):
    return ((TG - s) ** 2).sum(dim=-1)


def j_mlp(s, a):
    return s + jnp.tanh(jnp.concatenate([s, a], axis=-1) @ JW1) @ JW2


def t_mlp(s, a):
    return s + torch.tanh(torch.cat([s, a], dim=-1) @ TW1) @ TW2


def _bits(seed, shape):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, -(2**31),
                                         2**31 - 1, jnp.int32))


def _assert_single(out_p, out_j):
    delta_p, m_p, s_p, ct_p = (np.asarray(v) for v in out_p[:4])
    delta_j, m_j, s_j, ct_j = (np.asarray(v) for v in out_j[:4])
    np.testing.assert_allclose(ct_p, ct_j, **TOL_C)
    np.testing.assert_allclose(float(m_p), float(m_j), rtol=1e-6)
    np.testing.assert_allclose(float(s_p), float(s_j), rtol=1e-5)
    np.testing.assert_allclose(delta_p / s_p, delta_j / s_j, **TOL_U)


def _run_pair(jdyn, jcost, tdyn, tcost, jterm=None, tterm=None, nu=NU, T_=T, K_=K, nx=NX,
              x0=(-3.0, -2.0), scale=0.8, mu=0.05, bits_seed=3, u_seed=5, **flags):
    """One fused MPPI iteration of JAX's kernel (interpret mode) and of the
    port's plain version with the traced model, on the same bits."""
    D_ = T_ * nu
    jcfg = JConfig(nx=nx, nu=nu, K=K_, T=T_, dtype=DT, diag_sigma=True, **flags)
    cfg = MPPIConfig(nx=nx, nu=nu, K=K_, T=T_, diag_sigma=True, **flags)
    solve_j = PR.make_transposed_fused_solve(
        jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False,
        terminal_final=None if jterm is None else JS.wrap_final_cost(jterm))
    model = BL.kernel_model(cfg, tdyn, tcost)
    assert isinstance(model, BL.GeneratedModel)
    solve_p = FS.make_transposed_fused_solve(cfg, model, pair_block=solve_j.block_k,
                                             terminal_final=tterm)
    assert solve_p.spec.model_id >= BL.GENERATED
    bits = _bits(bits_seed, (D_, solve_j.K_pad))
    U2 = np.asarray(jax.random.normal(jax.random.PRNGKey(u_seed), (D_,), DT) * 0.1)
    ops = (U2, np.full(D_, scale, np.float32), np.full(D_, mu, np.float32),
           np.full(D_, -1.0, np.float32), np.full(D_, 1.0, np.float32),
           U2 * 0.7, np.float32(1.0))
    x0T = np.broadcast_to(np.asarray(x0, np.float32)[:, None], (nx, K_))
    out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in ops))
    out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(np.ascontiguousarray(x0T)),
                    *(torch.from_numpy(np.array(v)) for v in ops))
    _assert_single(out_p, out_j)
    return model


class TestTransposedSolve:
    def test_mlp(self):
        _run_pair(j_mlp, j_quad, t_mlp, t_quad)

    def test_step_dependent(self):
        _run_pair(lambda s, a, t: s + a @ JB.T * (1.0 + 0.01 * t),
                  lambda s, a, t: j_quad(s, a) * (1.0 + 0.005 * t),
                  lambda s, a, t: s + a @ TB.T * (1.0 + 0.01 * t),
                  lambda s, a, t: t_quad(s, a) * (1.0 + 0.005 * t),
                  step_dependent_dynamics=True)

    def test_odd_shapes_padded(self):
        """nu = 3 (D = 21) with K = 200, u_scale 1.3: the shape corners the
        flagship never takes."""
        B3 = (np.random.RandomState(2).randn(2, 3) * 0.5).astype(np.float32)
        jB3, tB3 = jnp.asarray(B3), torch.from_numpy(B3)
        _run_pair(lambda s, a: s + a @ jB3.T, j_quad, lambda s, a: s + a @ tB3.T, t_quad,
                  nu=3, T_=7, K_=200, x0=(-2.0, 1.0), scale=0.9, mu=0.0, u_scale=1.3)

    def test_unsupported_dynamics_raises(self, caplog):
        """JAX's ``bad_dyn`` (a mean over the batch axis): the tracer raises
        naming the op, and the controller takes the plain path with a
        warning that names it."""
        def bad_dyn(s, a):
            return s - s.mean(dim=0, keepdim=True) + a

        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)
        with pytest.raises(BL.UnsupportedPrimitive, match="mean over the batch axis"):
            BL.kernel_model(cfg, bad_dyn, t_quad)
        with caplog.at_level(logging.WARNING, logger="pytorch_mppi_tpu_torch"):
            ctrl = P.MPPI(bad_dyn, t_quad, NX, torch.eye(NU), num_samples=K, horizon=T,
                          device="cpu", use_pallas=True)
        assert not ctrl._fns.fused and "mean over the batch axis" in caplog.text

    def test_named_model_keeps_its_device_model(self):
        """A tagged pair keeps its named model; the tracer is not tried."""
        lq = P.linear_quadratic(TB, TG)
        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T)
        assert BL.kernel_model(cfg, lq.dynamics, lq.running_cost) is lq
        solve = FS.make_transposed_fused_solve(cfg, lq)
        assert solve.spec.model_id == lq.model_id < BL.GENERATED


def _fuzz_pair(seed0, seed):
    """The JAX and the torch program pair of one fuzz seed (JAX's
    ``TestFuzzFused`` draws), from two RandomStates in lockstep."""
    from fuzz_programs import gen_program
    from test_torch_batch_last import gen_program_torch

    jr, tr = np.random.RandomState(seed0 + seed), np.random.RandomState(seed0 + seed)
    nx, nu = int(jr.randint(1, 5)), int(jr.randint(1, 4))
    assert (int(tr.randint(1, 5)), int(tr.randint(1, 4))) == (nx, nu)
    jcore, _, _ = gen_program(jr, force_kind="dynamics", nx=nx, nu=nu, dtype=DT)
    jcost_core, _, _ = gen_program(jr, force_kind="cost", nx=nx, nu=nu, dtype=DT)
    tcore, _, _ = gen_program_torch(tr, force_kind="dynamics", nx=nx, nu=nu,
                                    dtype=torch.float32)
    tcost_core, _, _ = gen_program_torch(tr, force_kind="cost", nx=nx, nu=nu,
                                         dtype=torch.float32)
    fns = (lambda s, a: s + 0.1 * jnp.tanh(jcore(s, a)),
           lambda s, a: jnp.abs(jcost_core(s, a)) + (s**2).sum(axis=-1),
           lambda s, a: s + 0.1 * torch.tanh(tcore(s, a)),
           lambda s, a: torch.abs(tcost_core(s, a)) + (s**2).sum(dim=-1))
    return jr, nx, nu, fns


class TestFuzzFused:
    """Random dynamics and cost programs (``tests/fuzz_programs.py`` and its
    torch copy) through the fused MPPI iteration, at random (nx, nu)."""

    @pytest.mark.parametrize("seed", range(8))
    def test_random_dynamics_and_cost(self, seed):
        rng, nx, nu, (jdyn, jcost, tdyn, tcost) = _fuzz_pair(2000, seed)
        Kf, Tf = 256, 5
        Df = Tf * nu
        jcfg = JConfig(nx=nx, nu=nu, K=Kf, T=Tf, dtype=DT, diag_sigma=True)
        cfg = MPPIConfig(nx=nx, nu=nu, K=Kf, T=Tf, diag_sigma=True)
        solve_j = PR.make_transposed_fused_solve(
            jcfg, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost), rng_in_kernel=False)
        solve_p = FS.make_transposed_fused_solve(cfg, BL.kernel_model(cfg, tdyn, tcost),
                                                 pair_block=solve_j.block_k)
        bits = _bits(seed, (Df, Kf))
        U2 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 50), (Df,), DT) * 0.1)
        ops = (U2, np.full(Df, 0.6, np.float32), np.zeros(Df, np.float32),
               np.full(Df, -1.5, np.float32), np.full(Df, 1.5, np.float32), U2 * 0.5,
               np.float32(1.0))
        x0 = rng.randn(nx).astype(np.float32)
        x0T = np.ascontiguousarray(np.broadcast_to(x0[:, None], (nx, Kf)))
        out_j = solve_j(jnp.asarray(bits), jnp.asarray(x0T), *(jnp.asarray(v) for v in ops))
        out_p = solve_p(torch.from_numpy(bits), torch.from_numpy(x0T),
                        *(torch.from_numpy(np.array(v)) for v in ops))
        np.testing.assert_allclose(out_p[3].numpy(), np.asarray(out_j[3]), **TOL_C)
        np.testing.assert_allclose(float(out_p[2]), float(out_j[2]), rtol=1e-5)
        np.testing.assert_allclose(out_p[0].numpy() / float(out_p[2]),
                                   np.asarray(out_j[0]) / float(out_j[2]), **TOL_U)


class TestFuzzBatched:
    """The same programs through the N-plant batched iteration: one shared
    draw, per-plant clamp, rollout and softmax."""

    @pytest.mark.parametrize("seed", range(4))
    def test_random_dynamics_and_cost(self, seed):
        rng, nx, nu, (jdyn, jcost, tdyn, tcost) = _fuzz_pair(3000, seed)
        N, Kf, Tf = 3, 256, 5
        Df = Tf * nu
        jcfg = JConfig(nx=nx, nu=nu, K=Kf, T=Tf, dtype=DT, diag_sigma=True)
        cfg = MPPIConfig(nx=nx, nu=nu, K=Kf, T=Tf, diag_sigma=True)
        solve_j = PR.make_transposed_batched_solve(
            jcfg, N, JS.wrap_dynamics(jcfg, jdyn), JS.wrap_cost(jcfg, jcost),
            rng_in_kernel=False)
        solve_p = FS.make_transposed_batched_solve(cfg, N, BL.kernel_model(cfg, tdyn, tcost),
                                                   pair_block=solve_j.block_k)
        bits = _bits(seed, (Df, Kf))
        U = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 50), (N, Tf, nu), DT) * 0.1)
        x0 = rng.randn(N, nx).astype(np.float32)
        ops = (np.ascontiguousarray(x0.T), np.ascontiguousarray(U.reshape(N, Df).T),
               np.full(Df, 0.6, np.float32), np.zeros(Df, np.float32),
               np.full(Df, -1.5, np.float32), np.full(Df, 1.5, np.float32),
               np.ascontiguousarray((U.reshape(N, Df) * 0.5).T), np.float32(1.0))
        out_j = solve_j(jnp.asarray(bits), *(jnp.asarray(v) for v in ops))
        out_p = solve_p(torch.from_numpy(bits), *(torch.from_numpy(np.array(v)) for v in ops))
        delta_p, ms_p, ct_p = (v.numpy() for v in out_p)
        delta_j, ms_j, ct_j = (np.asarray(v) for v in out_j)
        np.testing.assert_allclose(ct_p, ct_j, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(delta_p / ms_p[1], delta_j / ms_j[1], **TOL_U)


class TestTerminalFinalKernel:
    """A traced final-state terminal cost in the fused MPPI iteration: its
    closure constants (W, GOAL) go to the terminal's constants buffer."""

    JW, TW = jnp.asarray([3.0, 1.0], DT), torch.tensor([3.0, 1.0])

    @pytest.mark.parametrize("dyn", ["lin", "mlp"])
    def test_mppi_parity(self, dyn):
        jdyn, tdyn = (j_lin, t_lin) if dyn == "lin" else (j_mlp, t_mlp)
        jterm = lambda s, a: (self.JW * (s - JG) ** 2).sum(axis=-1) + 0.2 * (a**2).sum(-1)  # noqa
        tterm = lambda s, a: (self.TW * (s - TG) ** 2).sum(dim=-1) + 0.2 * (a**2).sum(-1)  # noqa
        _run_pair(jdyn, j_quad, tdyn, t_quad, jterm=jterm, tterm=tterm, mu=0.05, u_scale=0.9)

    def test_unsupported_terminal_raises_at_build(self):
        """A terminal cost outside the vocabulary raises at build time,
        naming it and the op; the routing takes it to the plain path."""
        cfg = MPPIConfig(nx=NX, nu=NU, K=K, T=T, diag_sigma=True)

        def weird_term(s, a):
            return torch.sort(s, dim=-1).values[..., 0]

        with pytest.raises(BL.UnsupportedPrimitive, match="'weird_term' cannot be traced"):
            FS.make_transposed_fused_solve(cfg, BL.kernel_model(cfg, t_lin, t_quad),
                                           terminal_final=weird_term)


class TestRouting:
    """Untagged callables within the vocabulary reach the kernel route in
    every controller and the legacy route, step-dependent ones included."""

    @pytest.mark.parametrize("cls,kw", [
        ("MPPI", {"use_pallas": True}), ("MPPI", {"use_pallas": "rollout"}),
        ("SMPPI", {"use_pallas": True}), ("KMPPI", {"use_pallas": True}),
        ("MPPI_Batched", {"use_pallas": "force", "num_envs": 3}),
        ("MPPI_Batched", {"use_pallas": "kernel_rng", "num_envs": 3})])
    @pytest.mark.parametrize("step_dependent", [False, True], ids=["plain", "step_dependent"])
    def test_untagged_callables_take_the_kernel(self, cls, kw, step_dependent):
        if step_dependent:
            dyn = lambda s, a, t: s + a @ TB.T * (1.0 + 0.01 * t)  # noqa: E731
            cost = lambda s, a, t: t_quad(s, a) * (1.0 + 0.005 * t)  # noqa: E731
        else:
            dyn, cost = t_lin, t_quad
        ctrl = getattr(P, cls)(dyn, cost, NX, torch.eye(NU), num_samples=64, horizon=5,
                               device="cpu", step_dependent_dynamics=step_dependent, **kw)
        assert ctrl._fns.fused
        x = torch.zeros((3, NX) if cls == "MPPI_Batched" else (NX,))
        assert torch.isfinite(ctrl.command(x)).all()

    def test_step_dependent_equals_the_plain_path_in_float64_costs(self):
        """The traced step-dependent model's rollout equals the user's
        callables' on the same actions (float32, the same operations)."""
        cfg = MPPIConfig(nx=NX, nu=NU, K=64, T=5, step_dependent_dynamics=True)
        dyn = lambda s, a, t: s + a @ TB.T * (1.0 + 0.01 * t)  # noqa: E731
        cost = lambda s, a, t: t_quad(s, a) * (1.0 + 0.005 * t)  # noqa: E731
        model = BL.kernel_model(cfg, dyn, cost)
        g = torch.Generator().manual_seed(1)
        u = torch.randn(5 * NU, 64, generator=g)
        x0T = torch.randn(NX, 64, generator=g)
        got = FS._rollout_total(model, u, x0T, 5, NU, 1.0)
        want, _, _ = PS.rollout_costs(cfg, PS.wrap_dynamics(cfg, dyn), PS.wrap_cost(cfg, cost),
                                      x0T.T, u.T.reshape(64, 5, NU))
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)

    def test_factories_take_the_users_pair(self):
        """The ops-level factories take the user's ``(dynamics, cost)`` pair
        in place of a kernel model: traced where untagged, the named model
        where tagged."""
        from pytorch_mppi_tpu_torch.ops import legacy as LG
        from pytorch_mppi_tpu_torch.ops import rowmajor as RM

        cfg = MPPIConfig(nx=NX, nu=NU, K=32, T=4, num_support_pts=2)
        for make in (FS.make_transposed_fused_solve, FS.make_transposed_smppi_solve,
                     FS.make_transposed_kmppi_solve,
                     lambda c, m: FS.make_transposed_batched_solve(c, 3, m)):
            solve = make(cfg, (t_lin, t_quad))
            assert isinstance(solve.model, BL.GeneratedModel)
            assert solve.spec.model_id >= BL.GENERATED
        lq = P.linear_quadratic(TB, TG)
        assert FS.make_transposed_fused_solve(cfg, (lq.dynamics, lq.running_cost)).model is lq
        rollout = LG.make_fused_rollout(cfg, (t_lin, t_quad))
        x0, u = torch.zeros(32, NX), torch.ones(32, 4, NU)
        want = LG.fused_rollout_plain(x0, u, model=BL.kernel_model(cfg, t_lin, t_quad))
        torch.testing.assert_close(rollout(x0, u), want)
        assert RM.make_fused_solve(cfg, (t_lin, t_quad)).spec.model_id >= BL.GENERATED

    def test_shards_of_a_generated_model_merge_to_the_whole(self):
        """The per-shard solves a mesh runs (``shard=(i, n)``) with a traced
        model, merged as ``solve._merge_stats`` merges them, give the whole
        solve's costs and update on the same bits."""
        import dataclasses

        cfg = MPPIConfig(nx=NX, nu=NU, K=1000, T=5, diag_sigma=True)
        model = BL.kernel_model(cfg, t_lin, t_quad)
        whole = FS.make_transposed_fused_solve(cfg, model)
        D_ = 5 * NU
        bits = _bits(7, (D_, whole.bits_cols))
        g = torch.Generator().manual_seed(3)
        x0T = torch.randn(NX, 1000, generator=g)
        U2 = torch.randn(D_, generator=g) * 0.1
        ops = (U2, torch.full((D_,), 0.8), torch.zeros(D_), torch.full((D_,), -1.0),
               torch.full((D_,), 1.0), U2 * 0.7, torch.tensor(1.0))
        d, m, s, c = whole(torch.from_numpy(bits), x0T, *ops)
        shard_cfg = dataclasses.replace(cfg, K=250)
        parts = [FS.make_transposed_fused_solve(shard_cfg, model, shard=(i, 4))(
            torch.from_numpy(bits), x0T[:, 250 * i:250 * (i + 1)], *ops) for i in range(4)]
        m_g = torch.stack([p[1] for p in parts]).max()
        s_g = sum(p[2] * torch.exp(p[1] - m_g) for p in parts)
        d_g = sum(p[0] * torch.exp(p[1] - m_g) for p in parts)
        torch.testing.assert_close(torch.cat([p[3] for p in parts]), c, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(d_g / s_g, d / s, rtol=2e-4, atol=2e-6)

    def test_kernel_cache_is_keyed_by_the_traced_parts(self):
        """One generated kernel for a model with no terminal or a named one
        (the named library's ``quadratic_terminal`` runs by its constants);
        another with a traced terminal."""
        cfg = MPPIConfig(nx=NX, nu=NU, K=8, T=3)
        model = BL.kernel_model(cfg, t_lin, t_quad)
        named = P.quadratic_terminal([2.0, 2.0], 1.0, 0.1).kernel_terminal
        traced = BL.trace_terminal(cfg, lambda s, a: (s ** 2).sum(-1))
        plain = BL.generated_kernel(model, None)
        assert BL.generated_kernel(model, named) is plain
        assert BL.generated_kernel(model, traced) is not plain
        assert BL.generated_kernel(model, traced).terminal is traced
        assert BL.launch_id(P.linear_quadratic(TB, TG)) < BL.GENERATED

    def test_graph_runner_takes_the_generated_route(self):
        """``run_mppi_jit`` with untagged callables (on the CPU the eager
        loop; the card's CUDA graph is held to it by chip_smoke.py phase 11)
        equals a loop of ``command`` from the same seed."""
        kw = dict(num_samples=32, horizon=4, device="cpu", use_pallas=True, seed=5)
        a, b = P.MPPI(t_lin, t_quad, NX, torch.eye(NU), **kw), P.MPPI(t_lin, t_quad, NX,
                                                                      torch.eye(NU), **kw)
        assert a._fns.fused
        x0 = torch.tensor([-3.0, -2.0])
        _, acts, _ = P.run_mppi_jit(a, lambda x, u: t_lin(x[None], u[None])[0], x0, 5)
        x, want = x0, []
        for _ in range(5):
            want.append(b.command(x))
            x = t_lin(x[None], want[-1][None])[0]
        torch.testing.assert_close(acts, torch.stack(want), rtol=0, atol=0)

    def test_failed_build_raises_with_the_compiler_output(self, tmp_path, monkeypatch):
        """A generated library whose ``nvcc`` fails raises with its output;
        nothing falls back to the plain path."""
        from pytorch_mppi_tpu_torch.ops import _build

        script = tmp_path / "nvcc"
        script.write_text("#!/bin/sh\necho 'error: the compiler refused it'\nexit 2\n")
        script.chmod(0o755)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        cfg = MPPIConfig(nx=NX, nu=NU, K=8, T=3)
        kernel = BL.generated_kernel(BL.kernel_model(cfg, t_lin, t_quad), None)
        with pytest.raises(RuntimeError, match="the compiler refused it"):
            FS.library_of(kernel.id, FS.MPPI)

    def test_export_refuses_a_generated_model(self, tmp_path):
        """The controller whose kernel runs a traced model, once refused,
        exports: the file carries the traced program, and the loaded
        artifact replays the live controller bit for bit (a fresh process
        does too: ``tests/test_torch_deploy_traced.py``)."""
        from pytorch_mppi_tpu_torch.utils import deploy

        ctrl = P.MPPI(t_lin, t_quad, NX, torch.eye(NU), num_samples=32, horizon=4,
                      device="cpu", use_pallas=True)
        path = str(tmp_path / "generated.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        (kernel,) = solver.kernels
        assert kernel.generated_model and kernel.id >= BL.GENERATED
        x = torch.tensor([-3.0, -2.0])
        for _ in range(3):
            a, b = ctrl.command(x), solver.command(x)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            x = t_lin(x[None], a[None])[0]


# ---------------------------------------------------------------------------
# The emitted C++ on the host
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
namespace fused_mppi {
#include "model.cuh"
}
using fused_mppi::Generated;
int main() {
  int h[6];  // K, nx, nu, t, constants, terminal constants
  if (fread(h, sizeof(int), 6, stdin) != 6) return 1;
  const int K = h[0], nx = h[1], nu = h[2], t = h[3];
  float* c = (float*)malloc(sizeof(float) * (h[4] + 1));
  float* tc = (float*)malloc(sizeof(float) * (h[5] + 1));
  float* xs = (float*)malloc(sizeof(float) * K * nx);
  float* us = (float*)malloc(sizeof(float) * K * nu);
  if (fread(c, sizeof(float), h[4], stdin) != (size_t)h[4]) return 1;
  if (fread(tc, sizeof(float), h[5], stdin) != (size_t)h[5]) return 1;
  if (fread(xs, sizeof(float), K * nx, stdin) != (size_t)(K * nx)) return 1;
  if (fread(us, sizeof(float), K * nu, stdin) != (size_t)(K * nu)) return 1;
  for (int k = 0; k < K; ++k) {
    float x[Generated::kN], u[Generated::kN];
    for (int i = 0; i < nx; ++i) x[i] = xs[k * nx + i];
    for (int j = 0; j < nu; ++j) u[j] = us[k * nu + j];
    float term = 0.0f;
#if HAS_TERMINAL
    term = Generated::terminal<Generated::kN>(tc, x, u, nx, nu);
#endif
    Generated::step<Generated::kN>(c, x, u, nx, nu, t);
    const float cost = Generated::cost<Generated::kN>(c, x, u, nx, nu, t);
    fwrite(x, sizeof(float), nx, stdout);
    fwrite(&cost, sizeof(float), 1, stdout);
    fwrite(&term, sizeof(float), 1, stdout);
  }
  return 0;
}
"""


def _host_run(tmp_path, kernel, x, u, t):
    """The emitted model on the host: (next states, costs, terminal costs)."""
    (tmp_path / "model.cuh").write_text(kernel.header())
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-DHAS_TERMINAL={int(kernel.terminal is not None)}",
                    "-o", str(exe), str(tmp_path / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    m = kernel.model
    tc = kernel.terminal.consts if kernel.terminal is not None else torch.zeros(0)
    K_, nx, nu = x.shape[0], m.nx, m.nu
    blob = struct.pack("6i", K_, nx, nu, t, m.consts.numel(), tc.numel())
    blob += b"".join(a.float().contiguous().numpy().tobytes()
                     for a in (m.consts, tc, x, u))
    out = subprocess.run([str(exe)], input=blob, capture_output=True, check=True,
                         timeout=120).stdout
    res = np.frombuffer(out, np.float32).reshape(K_, nx + 2)
    return res[:, :nx], res[:, nx], res[:, nx + 1]


def _pendulum_pair():
    from pytorch_mppi_tpu_torch.models.pendulum import (pendulum_dynamics,
                                                        pendulum_running_cost)

    return (lambda s, a: pendulum_dynamics(s, a), lambda s, a: pendulum_running_cost(s, a),
            2, 1, False)


HOST_CASES = {
    "pendulum": _pendulum_pair,
    "mlp": lambda: (t_mlp, t_quad, 2, 2, False),
    "step_dependent": lambda: (lambda s, a, t: s + a @ TB.T * (1.0 + 0.01 * t),
                               lambda s, a, t: t_quad(s, a) * (1.0 + 0.005 * t), 2, 2, True),
    "einsum_where_cumsum": lambda: (
        lambda s, a: torch.cumsum(s, dim=-1) + torch.where(s > 0.5, a, -a),
        lambda s, a: torch.einsum("bi,ij,bj->b", s, torch.tensor([[2.0, 0.3], [0.3, 1.0]]), s)
        + torch.remainder(s[:, 0], 0.7) + torch.atan2(s[:, 1], a[:, 0]), 2, 2, False),
}


@pytest.mark.parametrize("case", list(HOST_CASES) + [f"fuzz{i}" for i in range(4)])
def test_emitted_source_on_the_host(tmp_path, case):
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the emitted source")
    if case.startswith("fuzz"):
        _, nx, nu, (_, _, dyn, cost) = _fuzz_pair(2000, int(case[4:]))
        step_dependent = False
    else:
        dyn, cost, nx, nu, step_dependent = HOST_CASES[case]()
    cfg = MPPIConfig(nx=nx, nu=nu, K=64, T=5, step_dependent_dynamics=step_dependent)
    model = BL.kernel_model(cfg, dyn, cost)
    terminal = BL.trace_terminal(cfg, lambda s, a: ((s - 0.5) ** 2).sum(-1)
                                 + torch.tanh(a).sum(-1) * 0.1)
    kernel = BL.generated_kernel(model, terminal)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(64, nx, generator=g)
    u = torch.randn(64, nu, generator=g)
    t = 3 if step_dependent else 0
    ns_h, c_h, term_h = _host_run(tmp_path, kernel, x, u, t)
    ns, c = model.rollout_step(x, u, t)
    np.testing.assert_allclose(ns_h, ns.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c_h, c.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(term_h, terminal.cost(x, u).numpy(), rtol=1e-5, atol=1e-5)
