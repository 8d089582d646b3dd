"""The fused sampling front-end of the port against the JAX package on the
CPU.

``rowmajor.make_fused_sampler`` (its plain version, on CPU tensors) against
``pallas_rollout.make_fused_sampler(rng_in_kernel=False)`` in Pallas
interpret mode, fed the same int32 random bits: the diagonal and full
operators, the per-block antithetic halves, the null row with the absolute
action cost, and K padded to the block.  Also ``sampler_eligible`` against
JAX's, the seed mode's Philox convention against the transposed solve's, the
op-shape check, and the bound's count of work.

Tolerances (``tpu_tests/test_tpu_pallas.py:497-500``): ``perturbed`` rtol
1e-5 / atol 1e-6 (the normals differ by one rounding of ``log1p`` and of
fused multiply-adds, and a full op's sum by its order), the action cost
rtol 1e-4 / atol 1e-4.  Float32 on both sides (``tests/conftest.py`` turns
on x64).  The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_mppi_tpu.config import MPPIConfig as JConfig
from pytorch_mppi_tpu.ops import pallas_rollout as PR
from pytorch_mppi_tpu.ops import solve as JS

from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import rowmajor as RM

torch.set_num_threads(1)

F32 = jnp.float32


def _rand_bits(rs, shape):
    return rs.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)


def _full_op(T, nu, rho, sigma):
    """kron(A_rhoᵀ, cholᵀ), the (D, D) operator applied as ``z @ op``."""
    mix = np.asarray(JS.ar1_mixing(T, rho, F32), np.float64) if rho else np.eye(T)
    return np.kron(mix.T, np.linalg.cholesky(sigma).T).astype(np.float32)


# name, K, T, nu, config flags, block_k, full op
CASES = [
    ("diag", 256, 6, 2, {}, None, False),
    ("antithetic_K300_block128", 300, 6, 2, {"antithetic": True}, 128, False),
    ("full_op_rho", 256, 6, 2, {"noise_rho": 0.5}, None, True),
    ("null_abs", 256, 6, 2, {"sample_null_action": True, "noise_abs_cost": True}, None, False),
    ("K1100_block1024", 1100, 5, 2, {}, None, False),
    # D not a multiple of 4; mirror rows past K; the null row with antithetic pairs
    ("D15_T15_nu1", 200, 15, 1, {}, None, False),
    ("antithetic_K777_block128", 777, 6, 2, {"antithetic": True}, 128, False),
    ("null_antithetic", 300, 6, 2, {"antithetic": True, "sample_null_action": True}, 128, False),
]


@pytest.mark.parametrize("K,T,nu,flags,block_k,full", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_sampler_plain_matches_jax_kernel(K, T, nu, flags, block_k, full):
    rs = np.random.RandomState(11)
    D = T * nu
    diag = not full
    jsample = PR.make_fused_sampler(JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=diag,
                                            **flags), block_k=block_k, rng_in_kernel=False)
    sample = RM.make_fused_sampler(MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=diag, **flags),
                                   block_k=block_k)
    bh = sample.block_k // 2 if flags.get("antithetic") else sample.block_k
    assert sample.bits_rows == sample.K_pad // sample.block_k * bh
    bits = _rand_bits(rs, (sample.bits_rows, D))
    if full:
        op = _full_op(T, nu, flags["noise_rho"], np.array([[1.0, 0.3], [0.3, 0.5]]))
    else:
        op = (rs.rand(D) * 0.8 + 0.4).astype(np.float32)
    U2, mu, a = (rs.randn(3, D) * [[0.3], [0.05], [0.7]]).astype(np.float32)
    lo, hi = np.full(D, -1.0, np.float32), np.full(D, 1.2, np.float32)
    args = [bits, U2, op, mu, lo, hi, a]
    pert_j, cost_j = (np.asarray(v) for v in jsample(*(jnp.asarray(v) for v in args)))
    pert_p, cost_p = sample(*(torch.from_numpy(v) for v in args))
    assert pert_p.shape == (K, D) and cost_p.shape == (K,) and pert_p.dtype == torch.float32
    np.testing.assert_allclose(pert_p.numpy(), pert_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cost_p.numpy(), cost_j, rtol=1e-4, atol=1e-4)
    if flags.get("sample_null_action"):
        assert (pert_p[0] == torch.clamp(torch.zeros(D), -1.0, 1.2)).all()
    if flags.get("antithetic"):
        # rows j and j + block_k/2 of a block mirror one draw: with U = 0,
        # mu = 0 and no bounds their noises sum to zero (but on the null row)
        free = sample(torch.from_numpy(bits), torch.zeros(D), torch.from_numpy(op),
                      torch.zeros(D), torch.full((D,), -np.inf), torch.full((D,), np.inf),
                      torch.zeros(D))[0]
        half = sample.block_k // 2
        first = 1 if flags.get("sample_null_action") else 0
        assert (free[first:half] + free[half + first:2 * half] == 0).all()


@pytest.mark.parametrize("K", [1, 100, 128, 129, 511, 512, 1023, 1024, 1025, 10_000])
def test_block_and_padding_match_jax(K):
    """The default block and the bits' rows (``pallas_rollout.py:1385-1394``)."""
    for anti in (False, True):
        sample = RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=K, T=3, antithetic=anti))
        block = 1024 if K >= 1024 else 128
        K_pad = -(-K // block) * block
        assert (sample.block_k, sample.K_pad) == (block, K_pad)
        assert sample.bits_rows == (K_pad // 2 if anti else K_pad)


# D, full op, expected (rows, lanes or register rows, panel, threads)
GEOMETRY = [
    (60, False, (16, 16, 0, 256)),  # the flagship: 15 groups on 16 lanes, two rows a warp
    (15, False, (64, 4, 0, 256)),
    (4, False, (256, 1, 0, 256)),
    (300, False, (2, 96, 0, 192)),  # a row spans three warps
    (1100, False, (1, 288, 0, 256)),  # a row wider than the block
    (60, True, (34, 2, 16, 256)),  # 17 threads share a column group, 2 rows each
    (15, True, (64, 1, 16, 256)),
    (300, True, (36, 12, 16, 256)),
    (1100, True, (12, 12, 16, 256)),
    (3000, True, (12, 12, 1, 256)),  # the panel shrinks until the tiles fit
]


@pytest.mark.parametrize("D,full,expected", GEOMETRY,
                         ids=[f"D{g[0]}_{'full' if g[1] else 'diag'}" for g in GEOMETRY])
def test_sampler_geometry(D, full, expected):
    """The sampler kernels' blocks (``csrc/fused_mppi.cu``
    ``fused_mppi_sampler_geometry``, checked against this rule when the
    library loads): a thread per (row, four elements) with a row's groups
    padded to a power of two up to 32 lanes, else to a multiple of 32; for
    a full op, Q = 256 // groups threads of a column group with the fewest
    register rows that give 32 rows a block."""
    geo = RM.sampler_geometry(D, full)
    assert (geo["rows"], geo["tile"] if full else geo["lanes"], geo["panel"],
            geo["threads"]) == expected
    groups = -(-D // 4)
    assert geo["smem"] <= FS.MAX_SMEM_BYTES
    if full:
        q = 256 // groups if groups < 256 else 1
        assert geo["rows"] == q * geo["tile"] and geo["rows"] >= min(32, q * 12)
        assert geo["smem"] == 4 * (geo["rows"] * 4 * groups + geo["panel"] * 4 * groups
                                   + 2 * geo["rows"] * groups)
    else:
        assert geo["lanes"] >= groups and geo["threads"] % 32 == 0
        assert geo["rows"] * geo["lanes"] == geo["threads"] or geo["rows"] == 1


def test_sampler_geometry_refuses_what_does_not_fit():
    """A full op whose tiles exceed a block's shared memory is refused when
    the sampler is built; a diagonal op keeps no row in shared memory."""
    with pytest.raises(FS.FusedSolveUnavailable, match="shared memory"):
        RM.sampler_geometry(10_000, True)
    assert RM.sampler_geometry(10_000, False)["smem"] == 2 * (2528 // 32) * 4
    RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=64, T=5000, diag_sigma=True))


@pytest.mark.parametrize("K,block_k,anti,rows", [
    (10_000, 1024, False, 10_000), (10_000, 1024, True, 5120), (777, 128, True, 393),
    (300, 128, True, 172), (64, 128, True, 64), (1, 128, True, 1)])
def test_sampler_source_rows_and_one_wave(K, block_k, anti, rows):
    """The source rows the kernel draws, once for both rows of an
    antithetic pair: those that reach a row below K, as the plain
    version's pairing reads them; and the flagship's grid, 625 blocks of 256
    threads (320 with antithetic pairs), fits one wave of five blocks on
    each of the H100's 132 SMs."""
    assert RM.sampler_source_rows(K, block_k, anti) == rows
    src, _ = FS.source_columns(K, block_k, anti, "cpu")
    assert int(src.unique().numel()) == rows
    sample = RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=K, T=30, diag_sigma=True,
                                              antithetic=anti), block_k=block_k)
    assert sample.blocks == -(-rows // 16)
    if K == 10_000:
        assert sample.blocks == (320 if anti else 625) and sample.blocks <= 5 * FS.H100_SMS


def test_sampler_eligible_matches_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        for specific in (False, True):
            for mesh in (None, object()):
                cfg = MPPIConfig(nx=2, nu=2, K=8, T=3, dtype=dtype)
                jcfg = JConfig(nx=2, nu=2, K=8, T=3, dtype=jdtype)
                assert (RM.sampler_eligible(cfg, specific, mesh)
                        == PR.sampler_eligible(jcfg, specific, mesh))
    assert RM.sampler_eligible(MPPIConfig(nx=2, nu=2, K=8, T=3), False, None)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_seed_mode_draws_the_transposed_solves_normals(antithetic):
    """For one key, the sampler's normals are the transpose of
    ``make_transposed_fused_solve``'s with ``pair_block = block_k``: with
    sigma = I, U = 0, mu = 0 and no bounds, both perturbed outputs are the
    normals themselves."""
    K, T, nu = 300, 5, 2
    D = T * nu
    key = FS.key_to_seed(0x0123456789ABCDEF)
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, antithetic=antithetic)
    sample = RM.make_fused_sampler(cfg)
    zeros, ones = torch.zeros(D), torch.ones(D)
    inf = torch.full((D,), np.inf)
    pert_s, cost_s = sample(key, zeros, ones, zeros, -inf, inf, zeros)
    x0T = torch.zeros(2, 1).expand(2, K)
    pert_t = FS.fused_solve_plain(key, x0T, zeros, ones, zeros, -inf, inf, zeros,
                                  torch.tensor(1.0), model=_lq(), K=K, T=T, nu=nu,
                                  antithetic=antithetic, emit_perturbed=True,
                                  pair_block=sample.block_k)[4]
    assert torch.equal(pert_s, pert_t.T)
    assert torch.equal(cost_s, torch.zeros(K))
    z = pert_s.double()
    assert abs(float(z.mean())) < 5 / z.numel() ** 0.5 * (2 if antithetic else 1)


def _lq():
    from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

    return linear_quadratic(torch.eye(2), torch.zeros(2))


def test_op_shape_must_match_the_config():
    """A diagonal config takes D values ((D,) or (1, D)), a full one (D, D);
    any other op is a ValueError on either route, as the JAX kernel refuses
    to broadcast it."""
    K, T, nu = 64, 3, 2
    D = T * nu
    bits = torch.zeros((128, D), dtype=torch.int32)
    vecs = [torch.zeros(D)] * 5
    diag = RM.make_fused_sampler(MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True))
    full = RM.make_fused_sampler(MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True,
                                            noise_rho=0.3))
    assert diag(bits, vecs[0], torch.ones(1, D), *vecs[1:])[0].shape == (K, D)
    assert full(bits, vecs[0], torch.eye(D), *vecs[1:])[0].shape == (K, D)
    for fn, op in ((diag, torch.eye(D)), (diag, torch.ones(D + 1)), (full, torch.ones(D)),
                   (full, torch.ones(1, D))):
        with pytest.raises(ValueError, match="op"):
            fn(bits, vecs[0], op, *vecs[1:])
        with pytest.raises(ValueError, match="op"):
            fn.plain(bits, vecs[0], op, *vecs[1:])


def test_sampler_factory_and_wrapper_checks():
    cfg = MPPIConfig(nx=2, nu=2, K=64, T=3, antithetic=True)
    with pytest.raises(ValueError, match="even K block"):
        RM.make_fused_sampler(cfg, block_k=127)
    with pytest.raises(ValueError, match="float32"):
        RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=64, T=3, dtype=torch.float64))
    with pytest.raises(FS.FusedSolveUnavailable, match="shared"):
        RM.make_fused_sampler(MPPIConfig(nx=2, nu=2, K=64, T=30_000))
    sample = RM.make_fused_sampler(cfg)
    vecs = [torch.zeros(6)] * 6
    with pytest.raises(ValueError, match="bits"):
        sample(torch.zeros((128, 6), dtype=torch.int32), *vecs)  # antithetic: (64, 6)
    with pytest.raises(ValueError, match="int32"):
        sample(torch.zeros((64, 6)), *vecs)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sample((1, 2), *(torch.empty(6, device="meta") for _ in range(6)))
    assert {"sampler", "rowmajor"} <= set(FS.launches)


def test_sampler_front_end_loop_matches_jax():
    """JAX's "psampler" solve (``benchmarks/noise_experiments.py:139-147``)
    built from the port's kernels: the sampler, the legacy rollout on the
    scaled perturbed actions plus the action cost, the weighted update of
    ``perturbed − U``, ``U += pert / s`` and the shift; five commands on
    the same fresh bits each on both sides, held to JAX's three kernels in
    interpret mode.  λ = 5 keeps the loop from amplifying float32
    rounding (see ``tests/test_torch_rowmajor_solve.py``)."""
    from pytorch_mppi_tpu_torch.ops import legacy as LG
    from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic

    rs = np.random.RandomState(6)
    K, T, nu, steps, lam, u_scale = 256, 10, 2, 5, np.float32(5.0), 1.5
    D = T * nu
    B = np.array([[1.0, 0.0], [0.0, -1.0]], np.float32)
    goal = np.array([2.0, 2.0], np.float32)
    jcfg = JConfig(nx=2, nu=nu, K=K, T=T, dtype=F32, diag_sigma=True, u_scale=u_scale)
    jB, jgoal = jnp.asarray(B), jnp.asarray(goal)
    jroll = PR.make_fused_rollout(
        jcfg, JS.wrap_dynamics(jcfg, lambda s, a: s + a @ jB.T),
        JS.wrap_cost(jcfg, lambda s, a: ((jgoal - s) ** 2).sum(axis=-1)))
    jsample = PR.make_fused_sampler(jcfg, rng_in_kernel=False)
    cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=True, u_scale=u_scale)
    lq = linear_quadratic(torch.from_numpy(B), torch.from_numpy(goal))
    sample, roll = RM.make_fused_sampler(cfg), LG.make_fused_rollout(cfg, lq)
    op = np.full(D, np.sqrt(0.5), np.float32)
    mu, lo, hi = np.zeros(D, np.float32), np.full(D, -1.0, np.float32), np.ones(D, np.float32)
    x_j = x_p = np.array([-3.0, -2.0], np.float32)
    U_j, U_p = jnp.zeros(D, F32), torch.zeros(D)
    for _ in range(steps):
        bits = _rand_bits(rs, (sample.bits_rows, D))
        a_j = lam * U_j / 0.5
        pert, pc = jsample(jnp.asarray(bits), U_j, jnp.asarray(op), jnp.asarray(mu),
                           jnp.asarray(lo), jnp.asarray(hi), a_j)
        cost = jroll(jnp.broadcast_to(jnp.asarray(x_j), (K, 2)),
                     (pert * u_scale).reshape(K, T, nu)) + pc
        upd, _, s = PR.fused_weighted_update(cost, pert - U_j[None], lam)
        U_j = U_j + upd / s
        x_j = np.asarray(x_j + U_j[:nu] @ jB.T, np.float32)
        U_j = jnp.concatenate([U_j[nu:], jnp.zeros(nu, F32)])

        a_p = float(lam) * U_p / 0.5
        pert, pc = sample(torch.from_numpy(bits), U_p, *(torch.from_numpy(v)
                                                          for v in (op, mu, lo, hi)), a_p)
        cost = roll(torch.from_numpy(x_p)[None].expand(K, 2),
                    (pert * u_scale).reshape(K, T, nu)) + pc
        upd, _, s = LG.fused_weighted_update(cost, pert - U_p, torch.tensor(lam))
        U_p = U_p + upd / s
        x_p = (torch.from_numpy(x_p) + U_p[:nu] @ torch.from_numpy(B).T).numpy()
        U_p = torch.cat([U_p[nu:], torch.zeros(nu)])
    np.testing.assert_allclose(U_p.numpy(), np.asarray(U_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x_p, x_j, rtol=1e-4, atol=1e-4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_sampler_work_counts_inputs_once():
    """``chip_smoke.sampler_work``, the bound's count: the bits as given
    read once, the D-vectors and the op once, perturbed and the cost
    written once; one draw for each source row a live sample reads."""
    smoke = _chip_smoke()
    K, T, nu = 300, 4, 2
    D = T * nu
    for anti, full in ((False, False), (True, False), (False, True)):
        cfg = MPPIConfig(nx=2, nu=nu, K=K, T=T, diag_sigma=not full,
                         noise_rho=0.5 if full else 0.0, antithetic=anti)
        sample = RM.make_fused_sampler(cfg)
        bits = torch.zeros((sample.bits_rows, D), dtype=torch.int32)
        op = torch.zeros((D, D) if full else D)
        ops, nbytes = smoke.sampler_work(cfg, sample, bits, op)
        assert nbytes == 4 * (bits.numel() + 5 * D + op.numel() + K * D + K)
        # antithetic blocks of 128 samples read 64 source rows each; the last
        # 44 samples read 44
        draws = 64 + 64 + 44 if anti else K
        # the transform, U + n, the clamp, the rectified noise, its cost
        per_elem = (2 * D + 1 if full else 2) + 1 + 2 + 1 + 2
        assert ops == draws * D * 30 + K * D * per_elem
        seed_ops, seed_bytes = smoke.sampler_work(cfg, sample, (1, 2), op)
        assert seed_bytes == nbytes - 4 * bits.numel()
        assert seed_ops == ops + draws * -(-D // 4) * 98
