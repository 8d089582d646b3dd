"""The port's learned residual-dynamics MLP (``models/mlp.py``) against the
JAX package's, on the CPU.

* ``mlp_apply`` and ``make_residual_dynamics`` (plain, clipped, wrapped,
  wrapped with the (sin, cos) encoding) on the same seeded numpy weights
  (``utils/convert.mlp_params_from_numpy``) and inputs, in float64 at 1e-12:
  the same operations in the same order, so only the matmul's summation
  order differs;
* 20 ``make_train_step`` steps and ``train_epochs`` against optax's Adam in
  float64 at rtol 1e-11 / atol 1e-13: the two Adams compute the same update
  in another order (optax divides by √(ν̂) + ε, torch by √ν / √(1 − β₂ᵗ) +
  ε), which moves the weights by a few ulp a step (3e-14 relative after 20
  steps);
* ports of JAX's ``tests/test_models.py:76-166``: training reduces the
  error, the online weight swap, and the ``run_mppi`` closed loop with
  retraining;
* ``mlp_init``'s scheme, the ``mesh`` argument's error, and each example's
  ``main`` at a small size.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu import models as JM

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch import models as PM
from pytorch_mppi_tpu_torch.utils.convert import mlp_params_from_numpy

torch.set_num_threads(1)

SEED = 42
TOL_64 = dict(rtol=1e-12, atol=1e-12)
TOL_TRAIN = dict(rtol=1e-11, atol=1e-13)


def _np_params(sizes, seed=0):
    rs = np.random.RandomState(seed)
    return [((rs.rand(a, b) * 2 - 1) / math.sqrt(a), (rs.rand(b) * 2 - 1) / math.sqrt(a))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _jax_params(np_params):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in np_params]


def _batch(rs, n=256):
    s = np.concatenate([rs.uniform(-4.0, 4.0, (n, 1)), rs.uniform(-8.0, 8.0, (n, 1))], axis=1)
    a = rs.uniform(-3.0, 3.0, (n, 1))
    ns = np.array(JM.pendulum_dynamics(jnp.asarray(s), jnp.asarray(a)))
    return s, a, ns


def test_mlp_apply_matches_jax():
    npp = _np_params([3, 32, 32, 2])
    x = np.random.RandomState(1).randn(64, 3)
    out_j = np.asarray(JM.mlp_apply(_jax_params(npp), jnp.asarray(x)))
    out_p = PM.mlp_apply(mlp_params_from_numpy(npp), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_p, out_j, **TOL_64)


DYN_CASES = {
    "plain": ([3, 16, 2], {}),
    "u_clip": ([3, 32, 32, 2], dict(u_clip=(-2.0, 2.0))),
    "wrap": ([3, 32, 32, 2], dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,))),
    "wrap_encode": ([4, 32, 32, 2], dict(u_clip=(-2.0, 2.0), angle_wrap_dims=(0,),
                                         angle_encode_dims=(0,))),
}


@pytest.mark.parametrize("case", list(DYN_CASES))
def test_residual_dynamics_matches_jax(case):
    """Angles beyond ±π and actions beyond the clip, in float64."""
    sizes, kw = DYN_CASES[case]
    npp = _np_params(sizes, seed=3)
    s, a, _ = _batch(np.random.RandomState(2))
    out_j = np.asarray(JM.make_residual_dynamics(2, 1, **kw)(
        _jax_params(npp), jnp.asarray(s), jnp.asarray(a)))
    out_p = PM.make_residual_dynamics(2, 1, **kw)(
        mlp_params_from_numpy(npp), torch.from_numpy(s), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(out_p, out_j, **TOL_64)
    if "angle_wrap_dims" in kw:
        assert (np.abs(out_p[:, 0]) <= math.pi).all()


TRAIN_CASES = {
    "plain": ([3, 32, 32, 2], {}),
    "angle_diff": ([3, 32, 32, 2], dict(angle_diff_dims=(0,))),
    "angle_encode": ([4, 32, 32, 2], dict(angle_diff_dims=(0,), angle_encode_dims=(0,))),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_matches_optax(case):
    """20 Adam steps (lr 1e-3) on one full batch, against optax.adam(1e-3):
    the weights and the losses at rtol 1e-11, and the steps leave their
    arguments unchanged, as JAX's pure functions."""
    sizes, kw = TRAIN_CASES[case]
    npp = _np_params(sizes, seed=4)
    s, a, ns = _batch(np.random.RandomState(5))
    jstep, jinit = JM.make_train_step(nx=2, **kw)
    pstep, pinit = PM.make_train_step(nx=2, **kw)
    jp, pp = _jax_params(npp), mlp_params_from_numpy(npp)
    jo, po = jinit(jp), pinit(pp)
    jb = tuple(jnp.asarray(v) for v in (s, a, ns))
    pb = tuple(torch.from_numpy(v) for v in (s, a, ns))
    p0 = [(W.clone(), b.clone()) for W, b in pp]
    first_state = pinit(pp)
    for i in range(20):
        jp, jo, jl = jstep(jp, jo, jb)
        new, po_next, pl = pstep(pp, po, pb)
        if i == 0:
            assert all(torch.equal(W, W0) and torch.equal(b, b0)
                       for (W, b), (W0, b0) in zip(pp, p0))
            assert po["state"] == first_state["state"] == {}
        pp, po = new, po_next
        np.testing.assert_allclose(pl.item(), float(jl), **TOL_TRAIN)
    for (Wj, bj), (Wp, bp) in zip(jp, pp):
        np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), **TOL_TRAIN)
        np.testing.assert_allclose(bp.numpy(), np.asarray(bj), **TOL_TRAIN)
    assert po["state"][0]["step"] == 20


def test_train_epochs_matches_jax():
    npp = _np_params([3, 32, 32, 2], seed=6)
    s, a, ns = _batch(np.random.RandomState(7))
    jstep, jinit = JM.make_train_step(nx=2, angle_diff_dims=(0,))
    pstep, pinit = PM.make_train_step(nx=2, angle_diff_dims=(0,))
    jp = _jax_params(npp)
    pp = mlp_params_from_numpy(npp)
    jp, _, jl = JM.train_epochs(jstep, jp, jinit(jp), tuple(jnp.asarray(v) for v in (s, a, ns)),
                                25)
    pp, po, pl = PM.train_epochs(pstep, pp, pinit(pp), tuple(torch.from_numpy(v)
                                                              for v in (s, a, ns)), 25)
    assert pl.shape == (25,)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL_TRAIN)
    for (Wj, bj), (Wp, bp) in zip(jp, pp):
        np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), **TOL_TRAIN)
        np.testing.assert_allclose(bp.numpy(), np.asarray(bj), **TOL_TRAIN)


def test_custom_loss_and_optimizer():
    """``dynamics_loss`` replaces the default loss and ``optimizer`` builds
    the torch optimizer (here SGD: one step is params − lr·grad)."""
    npp = _np_params([3, 8, 2], seed=8)
    s, a, ns = _batch(np.random.RandomState(9), n=16)
    pb = tuple(torch.from_numpy(v) for v in (s, a, ns))

    def loss(params, batch):
        return (PM.mlp_apply(params, torch.cat(batch[:2], dim=1)) ** 2).sum()

    step, init = PM.make_train_step(dynamics_loss=loss,
                                    optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    pp = mlp_params_from_numpy(npp)
    new, _, l0 = step(pp, init(pp), pb)
    work = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True)) for W, b in pp]
    grads = torch.autograd.grad(loss(work, pb), [t for layer in work for t in layer])
    want = [t.detach() - 0.1 * g for t, g in zip([t for layer in work for t in layer], grads)]
    got = [t for layer in new for t in layer]
    assert all(torch.allclose(g, w, rtol=1e-12, atol=1e-14) for g, w in zip(got, want))
    assert l0.item() == pytest.approx(loss(pp, pb).item(), rel=1e-12)


def test_mesh_is_not_ported(tmp_path):
    """Data-parallel training, ported since: on a mesh of one rank the step
    is the single-process step (float64; the several-rank case is in
    tests/test_torch_distributed.py)."""
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch.parallel import initialize_multihost, make_mesh

    params = PM.mlp_init((4, 8, 2), torch.Generator().manual_seed(1), dtype=torch.float64,
                         device="cpu")
    batch = tuple(torch.randn(6, n, dtype=torch.float64) for n in (2, 2, 2))
    step, init = PM.make_train_step()
    want, _, want_loss = step(params, init(params), batch)
    initialize_multihost(f"file://{tmp_path / 'group'}", 1, 0, device="cpu")
    try:
        dstep, dinit = PM.make_train_step(mesh=make_mesh((1,), ("data",), device="cpu"))
        got, _, loss = dstep(params, dinit(params), batch)
    finally:
        dist.destroy_process_group()
    assert loss.item() == want_loss.item()
    for (W, b), (Ww, bw) in zip(got, want):
        torch.testing.assert_close(W, Ww, rtol=0, atol=0)
        torch.testing.assert_close(b, bw, rtol=0, atol=0)


def test_mlp_init_scheme():
    """nn.Linear's scheme: W (n_in, n_out) and b (n_out,) uniform in
    ±1/√n_in, from the generator (the same seed, the same weights)."""
    params = PM.mlp_init([3, 32, 32, 2], torch.Generator().manual_seed(0), torch.float64,
                         device="cpu")
    again = PM.mlp_init([3, 32, 32, 2], torch.Generator().manual_seed(0), torch.float64,
                        device="cpu")
    assert [tuple(W.shape) + tuple(b.shape) for W, b in params] == [(3, 32, 32), (32, 32, 32),
                                                                     (32, 2, 2)]
    for (W, b), (W2, b2), n_in in zip(params, again, (3, 32, 32)):
        assert W.dtype == torch.float64 and torch.equal(W, W2) and torch.equal(b, b2)
        bound = 1 / math.sqrt(n_in)
        assert W.abs().max() <= bound and b.abs().max() <= bound
        assert W.abs().max() > 0.8 * bound


class TestLearnedDynamics:
    """JAX's ``tests/test_models.py:67-166`` on the port, in float64."""

    def _collect(self, rng, n=512):
        s = np.concatenate([rng.uniform(-np.pi, np.pi, (n, 1)), rng.uniform(-8, 8, (n, 1))],
                           axis=1)
        a = rng.uniform(-2, 2, (n, 1))
        s, a = torch.from_numpy(s), torch.from_numpy(a)
        return s, a, PM.pendulum_dynamics(s, a)

    def test_training_reduces_error(self):
        batch = self._collect(np.random.RandomState(SEED))
        params = PM.mlp_init([3, 32, 32, 2], torch.Generator().manual_seed(SEED), torch.float64,
                             device="cpu")
        train_step, init_opt = PM.make_train_step(nx=2, angle_diff_dims=(0,))
        dyn = PM.make_residual_dynamics(2, 1, u_clip=(-2, 2), angle_wrap_dims=(0,))

        def val_err(p):
            s, a, ns = batch
            diff = dyn(p, s, a) - ns
            diff = torch.cat([PM.angle_normalize(diff[:, :1]), diff[:, 1:]], dim=1)
            return float((diff ** 2).mean())

        err0 = val_err(params)
        params, _, losses = PM.train_epochs(train_step, params, init_opt(params), batch, 300)
        err1 = val_err(params)
        assert err1 < err0 * 0.1, f"training did not reduce error: {err0} -> {err1}"
        assert losses[-1] < losses[0]

    def test_mppi_with_learned_dynamics_and_online_swap(self):
        """The weights are ``dynamics_params``: swapping them changes the
        solve without rebuilding the controller."""
        batch = self._collect(np.random.RandomState(SEED))
        params = PM.mlp_init([3, 32, 32, 2], torch.Generator().manual_seed(SEED), torch.float64,
                             device="cpu")
        train_step, init_opt = PM.make_train_step(nx=2, angle_diff_dims=(0,))
        trained, _, _ = PM.train_epochs(train_step, params, init_opt(params), batch, 300)
        dyn = PM.make_residual_dynamics(2, 1, u_clip=(-2, 2), angle_wrap_dims=(0,))
        ctrl = P.MPPI(dyn, PM.pendulum_running_cost, nx=2,
                      noise_sigma=torch.tensor(5.0, dtype=torch.float64), num_samples=100,
                      horizon=10, lambda_=1.0, u_min=torch.tensor(-2.0),
                      u_max=torch.tensor(2.0), seed=SEED, dynamics_params=params,
                      device="cpu")
        state = torch.tensor([np.pi / 2, 0.0], dtype=torch.float64)
        fns = ctrl._fns
        a_untrained = ctrl.command(state, shift_nominal_trajectory=False)
        ctrl.dynamics_params = trained  # the online retrain's swap
        a_trained = ctrl.command(state, shift_nominal_trajectory=False)
        assert ctrl._fns is fns
        assert a_untrained.shape == a_trained.shape == (1,)
        assert bool(torch.isfinite(a_trained).all())
        assert not torch.equal(a_untrained, a_trained)

    def test_online_learning_closed_loop(self):
        """Online model learning through ``run_mppi`` on the pendulum env
        (reference pendulum_approximate.py:119-198)."""
        env = PM.PendulumEnv(downward_start=True)
        params = PM.mlp_init([3, 32, 32, 2], torch.Generator().manual_seed(SEED), torch.float64,
                             device="cpu")
        train_step, init_opt = PM.make_train_step(nx=2, angle_diff_dims=(0,))
        opt_state = [init_opt(params)]
        dyn = PM.make_residual_dynamics(2, 1, u_clip=(-2, 2), angle_wrap_dims=(0,))
        ctrl = P.MPPI(dyn, PM.pendulum_running_cost, nx=2,
                      noise_sigma=torch.tensor(10.0, dtype=torch.float64), num_samples=100,
                      horizon=12, lambda_=1.0, u_min=torch.tensor(-2.0),
                      u_max=torch.tensor(2.0), seed=SEED, dynamics_params=params,
                      device="cpu")
        rng = np.random.RandomState(SEED)
        ss, aa, nss = [], [], []
        s = torch.tensor([np.pi, 1.0], dtype=torch.float64)
        for _ in range(100):
            a = torch.from_numpy(rng.uniform(-2, 2, (1,)))
            ns = PM.pendulum_dynamics(s[None], a[None])[0]
            ss.append(s), aa.append(a), nss.append(ns)
            s = ns
        boot = (torch.stack(ss), torch.stack(aa), torch.stack(nss))
        new_params, new_opt, _ = PM.train_epochs(train_step, ctrl.dynamics_params,
                                                 opt_state[0], boot, 200)
        ctrl.dynamics_params = new_params
        opt_state[0] = new_opt
        retrains = []

        def retrain(dataset):
            ds = dataset.to(torch.float64)
            b = (ds[:-1, :2], ds[:-1, 2:3], ds[1:, :2])
            p, o, _ = PM.train_epochs(train_step, ctrl.dynamics_params, opt_state[0], b, 100)
            ctrl.dynamics_params = p
            opt_state[0] = o
            retrains.append(ds.shape[0])

        total_reward, _ = P.run_mppi(ctrl, env, retrain, retrain_after_iter=25, iter=60,
                                     render=False)
        assert np.isfinite(total_reward)
        assert retrains == [25, 25]
        assert opt_state[0]["state"][0]["step"] == 400


class TestExamples:
    """Each example's ``main`` at a small size on the CPU."""

    def test_pendulum(self):
        from pytorch_mppi_tpu_torch.examples import pendulum

        out = pendulum.main(steps=100, device="cpu")
        assert np.isfinite(out["total_reward"]) and abs(out["final_angle"]) < 0.5

    @pytest.mark.parametrize("name", ["pendulum_approximate", "pendulum_approximate_continuous"])
    def test_pendulum_approximate(self, name):
        import importlib

        ex = importlib.import_module(f"pytorch_mppi_tpu_torch.examples.{name}")
        out = ex.main(timesteps=10, num_samples=64, iters=40, train_epoch=20, bootstrap_iter=30,
                      retrain_after_iter=20, validation=100, device="cpu")
        # the bootstrap's 30 rows, then the two retrains' 20 each (run_mppi
        # retrains at i = 20 only: its last block is not trained on)
        assert out["dataset_rows"] == 50
        assert np.isfinite(out["total_reward"]) and np.isfinite(out["val_error"])

    def test_fused_kernel_demo(self):
        from pytorch_mppi_tpu_torch.examples import fused_kernel_demo

        out = fused_kernel_demo.main(epochs=50, transitions=512, num_samples=128, horizon=8,
                                     commands=5, device="cpu")
        for name in ("plain", "fused"):
            assert math.isfinite(out[name]["final_angle"])
            assert out[name]["launches"] == 0  # CPU tensors run the kernel's plain version
        assert math.isfinite(out["loss"])
