"""The port's deployment artifact (``pytorch_mppi_tpu_torch/utils/deploy.py``)
and the kernels as ``torch.library`` operators (``ops/library.py``), on the
CPU.

* every test of JAX's ``tests/test_deploy.py`` on the port: a loaded
  artifact replays the live controller bit for bit (MPPI, the no-shift
  entry point, SMPPI and KMPPI, MPPI_Batched), ``dynamics_params`` and the
  parameters stay runtime inputs, a live ``info`` and a wrong version are
  refused, the serving process needs no user code, the elites and a
  final-state terminal cost ride the artifact;
* the kernel routes: MPPI, SMPPI and KMPPI with ``use_pallas=True``, the
  legacy pair, MPPI_Batched's pair in operand and seed mode, the
  terminal cost, iterations and elites, and the device models the kernels
  name (toy2d, the pendulum, a residual MLP) export with the port's
  operators in their graph (``ep.graph``); on the CPU the operators run the
  kernels' plain versions, and the loaded artifact replays the live
  controller bit for bit, in a fresh process too;
* the operators' CPU implementations equal the wrappers' plain versions,
  and what cannot be exported yet raises ``NotImplementedError`` naming
  its ROADMAP item; an artifact exported on the card does not load where
  there is no card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.models import PENDULUM_MODEL, Toy2DEnvironment
from pytorch_mppi_tpu_torch.ops import fused_solve as FS
from pytorch_mppi_tpu_torch.ops import legacy as LG
from pytorch_mppi_tpu_torch.ops import library
from pytorch_mppi_tpu_torch.ops.kernel_models import (
    linear_quadratic,
    plain_model,
    quadratic_terminal,
    residual_mlp_model,
)
from pytorch_mppi_tpu_torch.utils import checkpoint as ckpt
from pytorch_mppi_tpu_torch.utils import deploy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPE = torch.float32  # the kernels' dtype, and the JAX tests'
SEED = 7

B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=DTYPE)
GOAL = torch.tensor([2.0, 2.0], dtype=DTYPE)
LQ = linear_quadratic(B, GOAL)


def linear_dynamics(state, action):
    return state + action @ B.T


def quadratic_cost(state, action):
    return ((GOAL - state) ** 2).sum(dim=-1)


def _mk(cls=P.MPPI, dynamics=linear_dynamics, cost=quadratic_cost, **kw):
    return cls(dynamics, cost, 2, torch.eye(2, dtype=DTYPE), num_samples=64, horizon=8,
               lambda_=1.0, seed=SEED, u_max=torch.tensor([0.8, 0.8]), device="cpu", **kw)


def _drive(obj, steps=3, x=(-3.0, -2.0)):
    s = torch.tensor(x, dtype=DTYPE)
    acts = []
    for _ in range(steps):
        a = obj.command(s)
        acts.append(a.clone())
        s = linear_dynamics(s, a)
    return acts


def _assert_replays(live, served):
    for a, b in zip(live, served):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _port_ops(solver) -> set:
    """The operators of the port's namespace in the artifact's graphs."""
    return {str(n.target).split(".")[1] for ep in solver.programs for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(library.NAMESPACE + ".")}


class TestExportRoundtrip:
    def test_mppi_bit_matches_live_controller(self, tmp_path):
        """The exported program is the same body: a loaded artifact
        reproduces the live controller's closed loop bit for bit from the
        captured state."""
        ctrl = _mk()
        path = str(tmp_path / "solver.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        _assert_replays(_drive(ctrl), _drive(solver))
        # artifact surface mirrors the controller's
        assert solver.cost_total is not None
        assert solver.omega.shape == (64,)
        assert solver.meta["route"] == "plain" and not _port_ops(solver)

    def test_no_shift_entry_point(self, tmp_path):
        ctrl = _mk()
        solver = deploy.export_solver(ctrl, str(tmp_path / "s.npz"))
        a1 = ctrl.command(torch.zeros(2), shift_nominal_trajectory=False)
        a2 = solver.command(torch.zeros(2), shift_nominal_trajectory=False)
        torch.testing.assert_close(a1, a2, rtol=0, atol=0)

    def test_smppi_kmppi_roundtrip(self, tmp_path):
        for name, ctrl in (
            ("smppi", _mk(P.SMPPI, w_action_seq_cost=0.1, delta_t=1.0)),
            ("kmppi", _mk(P.KMPPI, num_support_pts=4)),
        ):
            path = str(tmp_path / f"{name}.npz")
            deploy.export_solver(ctrl, path)
            solver = deploy.load_solver(path)
            _assert_replays(_drive(ctrl), _drive(solver))

    def test_batched_roundtrip(self, tmp_path):
        ctrl = P.MPPI_Batched(linear_dynamics, quadratic_cost, 2, torch.eye(2, dtype=DTYPE),
                              num_envs=3, num_samples=32, horizon=6, seed=SEED, device="cpu")
        path = str(tmp_path / "batched.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        x0 = torch.tensor([[-3.0, -2.0], [3.0, 2.0], [0.0, 0.0]])
        for _ in range(2):
            torch.testing.assert_close(ctrl.command(x0), solver.command(x0), rtol=0, atol=0)

    def test_dynamics_params_stay_runtime_inputs(self, tmp_path):
        """Learned-model weights are inputs of the exported program: the
        serving host can swap them (e.g. after retraining) without
        re-exporting."""
        def param_dyn(params, state, action):
            return state + action @ params["B"].T

        ctrl = P.MPPI(param_dyn, quadratic_cost, 2, torch.eye(2, dtype=DTYPE),
                      num_samples=32, horizon=6, seed=SEED, dynamics_params={"B": B},
                      device="cpu")
        solver = deploy.export_solver(ctrl, str(tmp_path / "p.npz"))
        solver2 = deploy.load_solver(str(tmp_path / "p.npz"))
        solver2.command(torch.tensor([-3.0, -2.0]))
        c_orig = solver2.cost_total.clone()
        solver2.dyn_params = {"B": 2.0 * B}
        solver2.state = solver.state  # rewind to compare at equal state
        solver2.command(torch.tensor([-3.0, -2.0]))
        # the rollout costs see the swapped weights
        assert not torch.equal(c_orig, solver2.cost_total)

    def test_dynamics_params_dict_in_any_key_order(self, tmp_path):
        """A ``dynamics_params`` dict whose keys are not sorted (a file
        holds them sorted) still reaches the loaded program's inputs in
        order."""
        def param_dyn(params, state, action):
            return params["z_scale"] * state + action @ params["a_B"].T

        ctrl = P.MPPI(param_dyn, quadratic_cost, 2, torch.eye(2, dtype=DTYPE),
                      num_samples=32, horizon=6, seed=SEED, device="cpu",
                      dynamics_params={"z_scale": torch.tensor(0.9), "a_B": B})
        path = str(tmp_path / "order.npz")
        deploy.export_solver(ctrl, path)
        _assert_replays(_drive(ctrl), _drive(deploy.load_solver(path)))

    def test_params_swappable_after_load(self, tmp_path):
        """Tunable hyperparameters are runtime inputs: a tuner's result can
        be applied to a loaded artifact."""
        ctrl = _mk()
        deploy.export_solver(ctrl, str(tmp_path / "s.npz"))
        solver = deploy.load_solver(str(tmp_path / "s.npz"))
        s0 = solver.state
        a1 = solver.command(torch.tensor([-3.0, -2.0]))
        solver.state = s0
        solver.params = solver.params._replace(lambda_=torch.tensor(100.0))
        a2 = solver.command(torch.tensor([-3.0, -2.0]))
        assert not torch.equal(a1, a2)

    def test_live_info_rejected(self, tmp_path):
        ctrl = _mk()
        ctrl.command(torch.zeros(2), info={"x": torch.zeros(1)})
        with pytest.raises(ValueError, match="info"):
            deploy.export_solver(ctrl, str(tmp_path / "s.npz"))

    def test_version_guard(self, tmp_path):
        ctrl = _mk()
        path = str(tmp_path / "s.npz")
        deploy.export_solver(ctrl, path)
        tree = ckpt.load(path)
        meta = json.loads(tree["meta"])
        meta["version"] = 999
        tree["meta"] = json.dumps(meta)
        ckpt.save(path, tree)
        with pytest.raises(ValueError, match="version"):
            deploy.load_solver(path)


def _serve_in_child(path, out, steps=2, x=(-3.0, -2.0)):
    """Drive an artifact in a fresh interpreter that imports only the port
    (and torch and numpy): no dynamics or cost is defined there."""
    child = (
        "import numpy as np, sys, torch\n"
        "from pytorch_mppi_tpu_torch.utils import deploy\n"
        f"solver = deploy.load_solver({path!r})\n"
        f"s = torch.tensor({list(x)!r})\n"
        "acts = []\n"
        f"for _ in range({steps}):\n"
        "    a = solver.command(s)\n"
        "    acts.append(a.numpy())\n"
        "    s = s + a @ torch.tensor([[1., 0.], [0., -1.]]).T\n"
        f"np.save({out!r}, np.stack(acts))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pytorch_mppi_tpu')]\n"
        "print('SERVED OK', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                          text=True, timeout=300, cwd=str(os.path.dirname(path)))
    assert done.returncode == 0 and "SERVED OK []" in done.stdout, (
        done.stdout[-2000:] + done.stderr[-2000:])
    return np.load(out)


class TestFreshProcess:
    def test_serving_host_needs_no_user_code(self, tmp_path):
        """The serving contract: a fresh interpreter that never imports or
        defines the dynamics or cost (nor JAX) loads the artifact and
        produces the live controller's exact actions."""
        ctrl = _mk()
        path = str(tmp_path / "solver.npz")
        deploy.export_solver(ctrl, path)
        expected = torch.stack(_drive(ctrl, steps=2)).numpy()
        got = _serve_in_child(path, str(tmp_path / "acts.npy"))
        np.testing.assert_array_equal(got, expected)

    def test_kernel_route_serves_in_a_fresh_process(self, tmp_path):
        """The fused route's artifact, whose graph holds kernel A's
        operator: the child runs the operator's plain version and gives the
        live controller's actions bit for bit."""
        ctrl = _mk(dynamics=LQ.dynamics, cost=LQ.running_cost, use_pallas=True)
        path = str(tmp_path / "fused.npz")
        solver = deploy.export_solver(ctrl, path)
        assert _port_ops(solver) == {"kernel_a"}
        expected = torch.stack(_drive(ctrl, steps=3)).numpy()
        got = _serve_in_child(path, str(tmp_path / "acts.npy"), steps=3)
        np.testing.assert_array_equal(got, expected)


class TestRound5FeatureExport:
    def test_elites_and_terminal_final_round_trip(self, tmp_path):
        """The artifact carries the state and features of the MPPI
        extensions: MPPIState.elites rides the exported state, the command
        holds the final-state terminal cost, and the served solver replays
        the controller bit for bit."""
        fterm = lambda s, a: 3.0 * (s ** 2).sum(dim=-1)
        ctrl = P.MPPI(linear_dynamics, quadratic_cost, 2, 0.5 * torch.eye(2), num_samples=32,
                      horizon=6, seed=3, num_elites=2, terminal_final_cost=fterm,
                      u_min=-torch.ones(2), u_max=torch.ones(2), device="cpu")
        path = str(tmp_path / "solver.mppi.npz")
        deploy.export_solver(ctrl, path)
        srv = deploy.load_solver(path)
        x = torch.tensor([-2.0, 1.0])
        for _ in range(3):
            a_live = ctrl.command(x)
            torch.testing.assert_close(a_live, srv.command(x), rtol=0, atol=0)
            x = linear_dynamics(x, a_live)
        assert srv.state.elites is not None
        torch.testing.assert_close(srv.state.elites, ctrl._state.elites, rtol=0, atol=0)
        ctrl.reset()
        torch.testing.assert_close(ctrl._state.elites[1], ctrl._state.U, rtol=0, atol=0)


def _lq_ctrl(cls=P.MPPI, **kw):
    return _mk(cls, dynamics=LQ.dynamics, cost=LQ.running_cost, **kw)


KERNEL_ROUTES = {
    "mppi_fused": (lambda: _lq_ctrl(use_pallas=True), {"kernel_a"}),
    "smppi_fused": (lambda: _lq_ctrl(P.SMPPI, use_pallas=True, w_action_seq_cost=0.1),
                    {"kernel_a"}),
    "kmppi_fused": (lambda: _lq_ctrl(P.KMPPI, use_pallas=True, num_support_pts=4),
                    {"kernel_a"}),
    "mppi_rollout": (lambda: _lq_ctrl(use_pallas="rollout"), {"rollout", "weighted_update"}),
    "mppi_fused_terminal_iter2_null": (
        lambda: _lq_ctrl(use_pallas=True, num_iterations=2, sample_null_action=True,
                         terminal_final_cost=quadratic_terminal(GOAL, 1.0, 0.1)),
        {"kernel_a"}),
    "mppi_fused_elites_antithetic": (
        lambda: _lq_ctrl(use_pallas=True, num_elites=2, fused_artifacts=True,
                         antithetic_sampling=True), {"kernel_a"}),
    "smppi_fused_full_sigma_rho": (
        lambda: P.SMPPI(LQ.dynamics, LQ.running_cost, 2, torch.tensor([[1.0, 0.3], [0.3, 0.5]]),
                        num_samples=48, horizon=6, seed=2, noise_rho=0.5, use_pallas=True,
                        fused_artifacts=True, device="cpu"), {"kernel_a"}),
    "mppi_rollout_iter2": (lambda: _lq_ctrl(use_pallas="rollout", num_iterations=2),
                           {"rollout", "weighted_update"}),
}


class TestKernelRoutes:
    @pytest.mark.parametrize("route", sorted(KERNEL_ROUTES))
    def test_exports_through_the_operators(self, tmp_path, route):
        """The kernel routes' artifacts hold the port's operators, and on
        the CPU (their plain versions) replay the live controller bit for
        bit, artifacts included."""
        make, ops = KERNEL_ROUTES[route]
        ctrl = make()
        path = str(tmp_path / f"{route}.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        assert _port_ops(solver) == ops
        x = torch.tensor([-3.0, -2.0])
        for _ in range(3):
            torch.testing.assert_close(ctrl.command(x), solver.command(x), rtol=0, atol=0)
            torch.testing.assert_close(ctrl.cost_total, solver.cost_total, rtol=0, atol=0)
            torch.testing.assert_close(ctrl.omega, solver.omega, rtol=0, atol=0)
        assert (ctrl.noise is None) == (solver.noise is None)
        assert solver.state.counter == ctrl._state.counter

    @pytest.mark.parametrize("mode", ["force", "kernel_rng"])
    def test_batched_pair(self, tmp_path, mode):
        """MPPI_Batched on the batched kernel pair, in operand mode (the
        draws are the program's input) and in seed mode (the key buffer
        is)."""
        ctrl = P.MPPI_Batched(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), num_envs=3,
                              num_samples=32, horizon=6, seed=SEED, use_pallas=mode,
                              device="cpu")
        path = str(tmp_path / "batched.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        assert _port_ops(solver) == {"batched"}
        assert solver.meta["kernel_keys"] == (mode == "kernel_rng")
        x0 = torch.tensor([[-3.0, -2.0], [3.0, 2.0], [0.0, 0.0]])
        for _ in range(3):
            torch.testing.assert_close(ctrl.command(x0), solver.command(x0), rtol=0, atol=0)
            torch.testing.assert_close(ctrl.cost_total, solver.cost_total, rtol=0, atol=0)

    @pytest.mark.parametrize("model", ["toy2d", "pendulum", "residual_mlp"])
    def test_device_models(self, tmp_path, model):
        """Each device model the kernels name, rebuilt from its constants
        alone by the operator (``kernel_models.plain_model``), computes what
        the live controller's model does, bit for bit."""
        x = torch.tensor([-3.0, -2.0])
        if model == "toy2d":
            env = Toy2DEnvironment(device="cpu")
            ctrl = P.SMPPI(env.dynamics, env.running_cost, 2, torch.eye(2), num_samples=64,
                           horizon=8, seed=3, use_pallas=True, device="cpu")
        elif model == "pendulum":
            m = PENDULUM_MODEL
            ctrl = P.MPPI(m.dynamics, m.running_cost, 2, torch.eye(1), num_samples=64,
                          horizon=8, seed=3, use_pallas=True, device="cpu")
            x = torch.tensor([3.1, 1.0])
        else:
            rng = np.random.default_rng(0)
            params = [(torch.tensor(rng.standard_normal((a, c)) * 0.3, dtype=DTYPE),
                       torch.tensor(rng.standard_normal(c) * 0.1, dtype=DTYPE))
                      for a, c in ((4, 16), (16, 16), (16, 2))]
            m = residual_mlp_model(params, 2, 1, u_clip=(-2.0, 2.0), angle_wrap_dims=(0,),
                                   angle_encode_dims=(0,))
            ctrl = P.KMPPI(m.dynamics, m.running_cost, 2, torch.eye(1), num_samples=64,
                           horizon=8, seed=3, use_pallas=True, num_support_pts=4, device="cpu")
            x = torch.tensor([3.1, 1.0])
        path = str(tmp_path / f"{model}.npz")
        deploy.export_solver(ctrl, path)
        solver = deploy.load_solver(path)
        assert _port_ops(solver) == {"kernel_a"}
        for _ in range(3):
            torch.testing.assert_close(ctrl.command(x), solver.command(x), rtol=0, atol=0)

    def test_per_sample_states(self, tmp_path):
        """A (K, nx) ``x0_example`` exports the per-sample-state entry
        point."""
        ctrl = _lq_ctrl(use_pallas=True)
        solver = deploy.export_solver(ctrl, str(tmp_path / "k.npz"),
                                      x0_example=torch.zeros(64, 2))
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(64, 2, generator=g)
        torch.testing.assert_close(ctrl.command(xs), solver.command(xs), rtol=0, atol=0)


class TestOperators:
    def test_registered(self):
        for name in library.OPERATORS:
            assert hasattr(getattr(torch.ops, library.NAMESPACE), name)

    @pytest.mark.parametrize("variant", ["mppi", "smppi", "kmppi", "batched"])
    def test_cpu_implementation_is_the_plain_version(self, variant):
        """Through its operator, a wrapper on CPU tensors gives what its
        plain version gives on the same inputs, bit for bit."""
        g = torch.Generator().manual_seed(11)
        K, T, nu, N = 40, 5, 2, 3
        config = MPPIConfig(nx=2, nu=nu, K=K, T=T, num_support_pts=3 if variant == "kmppi"
                            else 0, diag_sigma=True)
        D = T * nu
        R = 3 * nu if variant == "kmppi" else D
        x0T = torch.randn(2, N if variant == "batched" else K, generator=g)
        key = FS.key_to_seed(1234567)
        common = (torch.ones(R), torch.zeros(R), -torch.ones(R), torch.ones(R))
        lam = torch.tensor(0.7)
        if variant == "batched":
            solve = FS.make_transposed_batched_solve(config, N, LQ)
            args = (key, x0T, torch.randn(D, N, generator=g), *common,
                    torch.randn(D, N, generator=g), lam)
        elif variant == "mppi":
            solve = FS.make_transposed_fused_solve(config, LQ)
            args = (key, x0T, torch.randn(D, generator=g), *common,
                    torch.randn(D, generator=g), lam)
        elif variant == "smppi":
            solve = FS.make_transposed_smppi_solve(config, LQ)
            args = (key, x0T, torch.randn(D, generator=g), torch.randn(D, generator=g),
                    *common, -2 * torch.ones(D), 2 * torch.ones(D),
                    torch.randn(D, generator=g), lam, torch.tensor(0.1), torch.tensor(1.0))
        else:
            solve = FS.make_transposed_kmppi_solve(config, LQ)
            args = (key, x0T, torch.randn(D, generator=g), torch.randn(R, generator=g),
                    *common, -torch.ones(D), torch.ones(D), torch.randn(D, generator=g),
                    torch.randn(D, R, generator=g), lam)
        plain = solve.plain(*args)
        with library.exporting():
            through = solve(*args)
        assert len(plain) == len(through)
        for a, b in zip(plain, through):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_legacy_pair_cpu_implementation(self):
        g = torch.Generator().manual_seed(12)
        K, T, nu = 50, 4, 2
        rollout = LG.make_fused_rollout(MPPIConfig(nx=2, nu=nu, K=K, T=T), LQ)
        x0_K, u = torch.randn(K, 2, generator=g), torch.randn(K, T, nu, generator=g)
        cost, noise = torch.randn(K, generator=g), torch.randn(K, T * nu, generator=g)
        with library.exporting():
            c_op = rollout(x0_K, u)
            w_op = LG.fused_weighted_update(cost, noise, torch.tensor(0.5))
        torch.testing.assert_close(c_op, rollout.plain(x0_K, u), rtol=0, atol=0)
        for a, b in zip(w_op, LG.weighted_update_plain(cost, noise, torch.tensor(0.5))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_plain_model_is_cached_and_rejects_unknown_ids(self):
        assert plain_model(0, LQ.consts, 2, 2) is plain_model(0, LQ.consts.clone(), 2, 2)
        with pytest.raises(ValueError, match="no device model"):
            plain_model(99, LQ.consts, 2, 2)


class TestRefusals:
    @pytest.mark.parametrize("what", ["stochastic", "refinement"])
    def test_not_exportable_yet(self, tmp_path, what):
        if what == "stochastic":
            ctrl = _mk(dynamics=lambda s, a, rng: linear_dynamics(s, a),
                       stochastic_dynamics=True)
        else:
            ctrl = _mk(gradient_refinement_steps=2)
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 10"):
            deploy.export_solver(ctrl, str(tmp_path / "x.npz"))

    def test_card_artifact_does_not_load_without_a_card(self, tmp_path):
        """An artifact exported on the card is never moved to the CPU: where
        there is no card, loading it raises."""
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        path = str(tmp_path / "s.npz")
        deploy.export_solver(_mk(), path)
        tree = ckpt.load(path)
        meta = json.loads(tree["meta"])
        meta["device"] = "cuda:0"
        tree["meta"] = json.dumps(meta)
        ckpt.save(path, tree)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deploy.load_solver(path)

    def test_export_leaves_the_launch_counts(self, tmp_path):
        before = dict(FS.launches)
        deploy.export_solver(_lq_ctrl(use_pallas=True))
        assert FS.launches == before
