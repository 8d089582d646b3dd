"""The deploy artifact with the user's own code in the kernels
(``pytorch_mppi_tpu_torch/utils/deploy.py`` with ``ops/batch_last.py``), on
the CPU.

A controller whose kernels run a device model or a terminal cost traced
from its callables exports with the traced programs in the file, and a
fresh process with none of the user's code registers them
(``batch_last.load_kernel``) and serves the live controller's commands bit
for bit: the fused route (with a traced terminal cost, and a named model
with one), SMPPI and KMPPI on a step-dependent plant, ``MPPI_Batched`` in
seed and operand mode, the legacy route, gradient refinement on the plain
and the fused route, and the block models: a residual MLP beyond the
per-thread bounds (``ResidualMLPBlock``, a named model) and a traced
network beyond ``MAX_OPS`` (a program with dense layers); and a TD-MPC
world model, whose running cost and terminal cost have dense layers (the
terminal's with a LayerNorm).  Two artifacts of different traced models serve
side by side, a process that traced its own models first still serves
them, loading an artifact again registers nothing, and a version-1 file
(no kernels) still loads.  The rebuilt programs are held against the JAX
functions of the same plant and costs on the same numpy inputs (float32,
rtol 1e-6, atol 1e-5: the same operations, with sums of two products in
another order).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIConfig
from pytorch_mppi_tpu_torch.ops import _build
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.ops.kernel_models import linear_quadratic, residual_mlp_model
from pytorch_mppi_tpu_torch.utils import checkpoint as ckpt
from pytorch_mppi_tpu_torch.utils import deploy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
B_OTHER = torch.tensor([[0.5, 0.0], [0.0, -1.5]])
GOAL = torch.tensor([2.0, 2.0])
W_TERM = torch.tensor([3.0, 1.0])
COMMANDS = 3
JAX_RTOL, JAX_ATOL = 1e-6, 1e-5


def lin(s, u):
    return s + u @ B.T


def lin_other(s, u):
    return s + u @ B_OTHER.T


def quad(s, u):
    return ((GOAL - s) ** 2).sum(-1)


def step_lin(s, u, t):
    return s + u @ B.T * (1.0 + 0.01 * t)


def step_quad(s, u, t):
    return ((GOAL - s) ** 2).sum(-1) * (1.0 + 0.005 * t)


def term(s, u):
    return (W_TERM * (s - GOAL) ** 2).sum(-1) + 0.2 * (u ** 2).sum(-1)


def _wide_weights():
    """A [4, 128, 128, 2] network: about 17,000 multiply-adds a step, beyond
    MAX_OPS as scalar operations, so traced with dense layers."""
    g = torch.Generator().manual_seed(31)
    sizes = [4, 128, 128, 2]
    w = [(torch.randn(a, b, generator=g) / a ** 0.5, torch.randn(b, generator=g) * 0.1)
         for a, b in zip(sizes, sizes[1:])]
    w[-1] = (w[-1][0] * 0.1, w[-1][1] * 0.1)
    return w


WIDE = _wide_weights()


def wide(s, u):
    h = torch.cat([s, u], dim=-1)
    for i, (W, b) in enumerate(WIDE):
        h = h @ W + b
        if i + 1 < len(WIDE):
            h = torch.tanh(h)
    return s + h


def j_step(s, u, t):
    return s + u @ jnp.asarray(B.numpy()).T * (1.0 + 0.01 * t)


def j_step_cost(s, u, t):
    return ((jnp.asarray(GOAL.numpy()) - s) ** 2).sum(-1) * (1.0 + 0.005 * t)


def j_lin(s, u):
    return s + u @ jnp.asarray(B.numpy()).T


def j_quad(s, u):
    return ((jnp.asarray(GOAL.numpy()) - s) ** 2).sum(-1)


def j_term(s, u):
    return ((jnp.asarray(W_TERM.numpy()) * (s - jnp.asarray(GOAL.numpy())) ** 2).sum(-1)
            + 0.2 * (u ** 2).sum(-1))


LQ = linear_quadratic(B, GOAL)
# a residual MLP of 80 units, beyond the per-thread model's 64: ResidualMLPBlock
BLOCK_MLP = residual_mlp_model(
    [(torch.randn(4, 80, generator=torch.Generator().manual_seed(37)) * 0.5, torch.zeros(80)),
     (torch.randn(80, 2, generator=torch.Generator().manual_seed(41)) * 0.01, torch.zeros(2))],
    2, 2, cost="quadratic", goal=GOAL)


def block_plant(s, u):
    return BLOCK_MLP.dynamics(s[None], u[None])[0]


def _world_model():
    """TD-MPC's networks at nx = nu = 2 and 128 units (beyond MAX_OPS as
    scalar operations, so traced with dense layers): a residual latent
    ``mlp`` (ELU), a reward ``mlp`` in the running cost with a discount of
    the timestep, and the minimum of two ``q`` networks (LayerNorm, Tanh,
    ELU) as the terminal cost."""
    g = torch.Generator().manual_seed(43)

    def linear(a, b):
        lin = torch.nn.Linear(a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(b, a, generator=g) / a ** 0.5)
            lin.bias.copy_(torch.randn(b, generator=g) * 0.1)
        return lin

    def mlp(out):
        return torch.nn.Sequential(linear(4, 128), torch.nn.ELU(), linear(128, 128),
                                   torch.nn.ELU(), linear(128, out))

    def q():
        return torch.nn.Sequential(linear(4, 128), torch.nn.LayerNorm(128), torch.nn.Tanh(),
                                   linear(128, 128), torch.nn.ELU(), linear(128, 1))

    dyn_net, rew_net, q1, q2 = mlp(2), mlp(1), q(), q()

    def dyn(s, u, t):
        return s + 0.1 * dyn_net(torch.cat([s, u], -1))

    def cost(s, u, t):
        discount = torch.exp(torch.as_tensor(t) * -0.01)
        return -discount * rew_net(torch.cat([s, u], -1))[..., 0]

    def terminal(s, u):
        su = torch.cat([s, u], -1)
        return -torch.minimum(q1(su), q2(su))[..., 0]

    return dyn, cost, terminal


WORLD = _world_model()


def world_plant(s, u):
    with torch.no_grad():
        return WORLD[0](s, u, 0)
KW = dict(num_samples=48, horizon=6, lambda_=1.0, seed=7, u_max=torch.tensor([0.8, 0.8]),
          device="cpu")
SD = dict(step_dependent_dynamics=True)

# name: (controller, plant of one command (the dynamics the states follow))
ROUTES = {
    "fused": (lambda: P.MPPI(lin, quad, 2, torch.eye(2), use_pallas=True, **KW), lin),
    "fused_other_weights": (
        lambda: P.MPPI(lin_other, quad, 2, torch.eye(2), use_pallas=True, **KW), lin_other),
    "fused_traced_terminal": (
        lambda: P.MPPI(lin, quad, 2, torch.eye(2), use_pallas=True, terminal_final_cost=term,
                       **KW), lin),
    "named_model_traced_terminal": (
        lambda: P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), use_pallas=True,
                       terminal_final_cost=term, **KW), lin),
    "smppi_step": (
        lambda: P.SMPPI(step_lin, step_quad, 2, torch.eye(2), use_pallas=True,
                        w_action_seq_cost=0.1, **SD, **KW), lin),
    "kmppi_step": (
        lambda: P.KMPPI(step_lin, step_quad, 2, torch.eye(2), use_pallas=True,
                        num_support_pts=3, **SD, **KW), lin),
    "rollout_step": (
        lambda: P.MPPI(step_lin, step_quad, 2, torch.eye(2), use_pallas="rollout", **SD, **KW),
        lin),
    "batched_seed": (
        lambda: P.MPPI_Batched(lin, quad, 2, 0.5 * torch.eye(2), num_envs=3,
                               use_pallas="kernel_rng", **KW), lin),
    "batched_operand": (
        lambda: P.MPPI_Batched(lin, quad, 2, 0.5 * torch.eye(2), num_envs=3,
                               use_pallas="force", **KW), lin),
    "refine_plain": (
        lambda: P.MPPI(lin, quad, 2, torch.eye(2), gradient_refinement_steps=2, **KW), lin),
    "refine_fused": (
        lambda: P.MPPI(lin, quad, 2, torch.eye(2), gradient_refinement_steps=2,
                       use_pallas=True, **KW), lin),
    "version_1": (
        lambda: P.MPPI(LQ.dynamics, LQ.running_cost, 2, torch.eye(2), use_pallas=True, **KW),
        lin),
    "fused_block_mlp": (
        lambda: P.MPPI(BLOCK_MLP.dynamics, BLOCK_MLP.running_cost, 2, torch.eye(2),
                       use_pallas=True, **KW), block_plant),
    "fused_dense": (lambda: P.MPPI(wide, quad, 2, torch.eye(2), use_pallas=True, **KW), wide),
    "fused_world_model": (
        lambda: P.MPPI(WORLD[0], WORLD[1], 2, torch.eye(2), use_pallas=True,
                       terminal_final_cost=WORLD[2], **SD, **KW), world_plant),
}
# the operators of each route's programs
OPS = {"rollout_step": {"rollout", "weighted_update"}, "refine_plain": set(),
       "batched_seed": {"batched"}, "batched_operand": {"batched"}}
# the keys of a version-1 file's meta, as the exporter before version 2 wrote them
V1_META = {"version", "class", "route", "device", "dtype", "takes_info", "torch_version",
           "artifacts", "kernel_keys", "noise", "streams"}

SERVE = r"""
import json, sys
import numpy as np
import torch
from pytorch_mppi_tpu_torch.ops import batch_last as BL
from pytorch_mppi_tpu_torch.utils import deploy

jobs = json.load(open(sys.argv[1]))
report = {"artifacts": {}}
OWN = jobs.get("own")
if OWN:  # a process that traced and ran models of its own before it loads
    from pytorch_mppi_tpu_torch import MPPI

    def own(B):
        B = torch.tensor(B)
        goal = torch.tensor([2.0, 2.0])
        ctrl = MPPI(lambda s, u: s + u @ B.T, lambda s, u: ((goal - s) ** 2).sum(-1), 2,
                    torch.eye(2), num_samples=48, horizon=6, seed=11, use_pallas=True,
                    device="cpu")
        x = torch.tensor([-1.0, 1.0])
        return ctrl, [ctrl.command(x).tolist() for _ in range(2)]

    own_before = {str(b): own(b)[1] for b in OWN}
    report["own_ids"] = sorted(BL._KERNELS)
for job in jobs["artifacts"]:
    before = len(BL._KERNELS)
    solver = deploy.load_solver(job["path"])
    xs = torch.from_numpy(np.load(job["states"]))
    acts = [solver.command(x) for x in xs]
    np.save(job["actions"], torch.stack(acts).numpy())
    row = dict(registered=len(BL._KERNELS) - before, ids=[k.id for k in solver.kernels])
    if "probe" in job:  # the rebuilt programs on the probe's inputs
        p = np.load(job["probe"])
        x, u = torch.from_numpy(p["x"]), torch.from_numpy(p["u"])
        kernel = solver.kernels[0]
        ns, c = kernel.model.rollout_step(x, u, int(p["t"]))
        row["step"], row["cost"] = ns.tolist(), c.tolist()
        if kernel.terminal is not None:
            row["terminal"] = kernel.terminal.cost(x, u).tolist()
    report["artifacts"][job["name"]] = row
again = jobs["artifacts"][0]
before = len(BL._KERNELS)
solver = deploy.load_solver(again["path"])
xs = torch.from_numpy(np.load(again["states"]))
acts = torch.stack([solver.command(x) for x in xs]).numpy()
report["again"] = dict(registered=len(BL._KERNELS) - before,
                       same=bool(np.array_equal(acts, np.load(again["actions"]))))
if OWN:
    report["own_after"] = {str(b): own(b)[1] for b in OWN}
    report["own_before"] = own_before
report["modules"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "pytorch_mppi_tpu", "tests", "conftest")
                           or m.startswith("test_"))
json.dump(report, open(sys.argv[2], "w"))
print("SERVED OK")
"""


def _serve(tmp, jobs, tag):
    job_file, out = tmp / f"jobs_{tag}.json", tmp / f"served_{tag}.json"
    job_file.write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run([sys.executable, "-c", SERVE, str(job_file), str(out)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=str(tmp))
    assert done.returncode == 0 and "SERVED OK" in done.stdout, (
        done.stdout[-3000:] + done.stderr[-3000:])
    return json.loads(out.read_text())


def _probe(tmp, name, t):
    g = np.random.default_rng(2024)
    path = tmp / f"probe_{name}.npz"
    np.savez(path, x=g.standard_normal((16, 2)).astype(np.float32),
             u=g.standard_normal((16, 2)).astype(np.float32), t=t)
    return str(path)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every route of ``ROUTES`` exported after one command, then run for
    COMMANDS commands live; one fresh process with no user code serves
    every artifact on the live states, and another that traced two models
    of its own first (one of them the ``fused`` artifact's plant) serves
    ``fused`` and ``fused_other_weights``."""
    tmp = tmp_path_factory.mktemp("traced")
    live, jobs, solvers = {}, [], {}
    for name, (make, plant) in ROUTES.items():
        ctrl = make()
        x = torch.tensor([[-3.0, -2.0], [3.0, 2.0], [0.0, 0.0]]) \
            if isinstance(ctrl, P.MPPI_Batched) else torch.tensor([-3.0, -2.0])
        x = plant(x, ctrl.command(x))
        path = tmp / f"{name}.npz"
        solvers[name] = deploy.export_solver(ctrl, str(path))
        if name == "version_1":  # as the exporter before version 2 wrote it
            tree = ckpt.load(str(path))
            meta = json.loads(tree["meta"])
            assert meta.pop("kernels") == [] and set(meta) == V1_META
            meta["version"] = 1
            tree["meta"] = json.dumps(meta)
            ckpt.save(str(path), tree)
        xs, acts = [], []
        for _ in range(COMMANDS):
            xs.append(x)
            acts.append(ctrl.command(x))
            x = plant(x, acts[-1])
        np.save(tmp / f"{name}_states.npy", torch.stack(xs).numpy())
        live[name] = dict(actions=torch.stack(acts).numpy(), fused=ctrl._fns.fused)
        job = dict(name=name, path=str(path), states=str(tmp / f"{name}_states.npy"),
                   actions=str(tmp / f"{name}_served.npy"))
        if name in ("fused_traced_terminal", "smppi_step"):
            job["probe"] = _probe(tmp, name, 3 if name == "smppi_step" else 0)
        jobs.append(job)
    report = _serve(tmp, {"artifacts": jobs}, "fresh")
    own_jobs = [dict(j, actions=j["actions"].replace(".npy", "_own.npy")) for j in jobs
                if j["name"] in ("fused", "fused_other_weights")]
    own = _serve(tmp, {"artifacts": own_jobs, "own": [B.tolist(), [[0.25, 0.0], [0.0, 2.0]]]},
                 "own")
    return dict(tmp=tmp, live=live, jobs={j["name"]: j for j in jobs}, report=report,
                own=own, own_jobs={j["name"]: j for j in own_jobs}, solvers=solvers)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_serves_bit_for_bit_in_a_fresh_process(served, name):
    """Each artifact, in a process with none of the user's code, gives the
    live controller's actions bit for bit; the kernel routes' programs hold
    the port's operators, and the artifact lists exactly the generated
    kernels they launch."""
    got = np.load(served["jobs"][name]["actions"])
    np.testing.assert_array_equal(got, served["live"][name]["actions"])
    solver = served["solvers"][name]
    ops = {str(n.target).split(".")[1] for ep in solver.programs for n in ep.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("mppi_torch.")}
    assert ops == OPS.get(name, {"kernel_a"})
    assert served["live"][name]["fused"] == (name != "refine_plain")
    traced = name not in ("refine_plain", "version_1", "fused_block_mlp")
    assert len(solver.meta["kernels"]) == (1 if traced else 0)
    assert served["report"]["artifacts"][name]["ids"] == [k["id"] for k in
                                                          solver.meta["kernels"]]
    assert served["report"]["modules"] == []


def test_artifact_format(served):
    """Version 2 and later list each generated kernel's program (JSON, no
    compiled code): a traced model's nodes, outputs, sizes, timestep use
    and float64 constants; a named model's id; the traced terminal cost's
    program.  Version 7 (version 3's residual-MLP constants with a header
    of 20 floats, version 4's block models, version 5's programs with a
    LayerNorm's statistics and dense layers in their costs, version 6's
    plan of stochastic dynamics' draws, and version 7's new nodes and
    per-sample programs beyond 32 states) is written today."""
    meta = served["solvers"]["fused_traced_terminal"].meta
    assert meta["version"] == 7
    (desc,) = meta["kernels"]
    assert set(desc["model"]) == {"nodes", "outputs", "nx", "nu", "uses_t", "consts64"}
    assert not desc["model"]["uses_t"] and desc["terminal"]["nx"] == 2
    assert served["solvers"]["smppi_step"].meta["kernels"][0]["model"]["uses_t"]
    named = served["solvers"]["named_model_traced_terminal"].meta["kernels"][0]
    assert named["model"]["named"] == LQ.model_id and named["terminal"] is not None
    assert json.loads(json.dumps(meta)) == meta


def test_two_traced_models_side_by_side(served):
    """Two artifacts of one program with different weights (the same
    header, so the same library) have different ids, and one process
    serves both."""
    rows = served["report"]["artifacts"]
    assert rows["fused"]["ids"] != rows["fused_other_weights"]["ids"]
    assert rows["fused"]["registered"] == rows["fused_other_weights"]["registered"] == 1
    k1, k2 = (served["solvers"][n].kernels[0] for n in ("fused", "fused_other_weights"))
    assert k1.header() == k2.header()
    assert _build.generated_path(k1.header(), 2) == _build.generated_path(k2.header(), 2)


def test_process_with_its_own_traces(served):
    """A process that traced and ran two models of its own before it loads:
    one of the same plant as the ``fused`` artifact (its kernel is the
    artifact's, and loading registers nothing), one of the same program
    with other weights.  Both artifacts serve bit for bit, and the
    process's own controllers command as before."""
    own = served["own"]
    for name, job in served["own_jobs"].items():
        np.testing.assert_array_equal(np.load(job["actions"]), served["live"][name]["actions"])
    fused, other = own["artifacts"]["fused"], own["artifacts"]["fused_other_weights"]
    assert fused["ids"][0] in own["own_ids"] and fused["registered"] == 0
    assert other["ids"][0] not in own["own_ids"] and other["registered"] == 1
    assert own["own_after"] == own["own_before"]


def test_loading_again_registers_nothing(served):
    again = served["report"]["again"]
    assert again["registered"] == 0 and again["same"]


@pytest.mark.parametrize("name", ["fused_traced_terminal", "smppi_step"])
def test_rebuilt_program_matches_jax(served, name):
    """The serving process's rebuilt program (one step and its cost, the
    terminal cost) against JAX's jnp functions of the same plant and costs
    on the same float32 numpy inputs."""
    row = served["report"]["artifacts"][name]
    p = np.load(served["jobs"][name]["probe"])
    x, u, t = jnp.asarray(p["x"]), jnp.asarray(p["u"]), int(p["t"])
    if name == "smppi_step":
        ns = j_step(x, u, jnp.int32(t))
        c = j_step_cost(ns, u, jnp.int32(t))
    else:
        ns = j_lin(x, u)
        c = j_quad(ns, u)
        np.testing.assert_allclose(row["terminal"], np.asarray(j_term(x, u)), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
    np.testing.assert_allclose(row["step"], np.asarray(ns), rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_allclose(row["cost"], np.asarray(c), rtol=JAX_RTOL, atol=JAX_ATOL)


def test_world_model_round_trip(served, monkeypatch):
    """The artifact of a traced program with dense layers in its running
    cost and its terminal cost (a LayerNorm's statistics among the
    terminal's nodes) rebuilds, from its description alone, the same
    header under the same id: a block struct that runs the cost's layers
    in the step and the terminal's in ``struct Terminal``; its plain
    versions compute what the traced model's do."""
    solver = served["solvers"]["fused_world_model"]
    (desc,) = solver.meta["kernels"]
    assert desc["model"]["uses_t"] and solver.meta["version"] == 7
    assert {n[0] for n in desc["terminal"]["nodes"]} >= {"dense", "lnmean", "lnrstd"}
    (kernel,) = solver.kernels
    monkeypatch.setattr(BL, "_KERNELS", {})
    rebuilt = BL.load_kernel(json.loads(json.dumps(desc)))
    assert (rebuilt.id, rebuilt.header()) == (kernel.id, kernel.header())
    assert rebuilt.block and "kStepCost = true" in rebuilt.header()
    assert "kBlockTerminal = true" in rebuilt.header()
    g = torch.Generator().manual_seed(5)
    x, u = torch.randn(9, 2, generator=g), torch.randn(9, 2, generator=g)
    ns, c = rebuilt.model.rollout_step(x, u, 2)
    with torch.no_grad():
        torch.testing.assert_close(ns, WORLD[0](x, u, 2), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(c, WORLD[1](ns, u, torch.tensor(2)), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rebuilt.terminal.cost(x, u), WORLD[2](x, u), rtol=1e-5,
                                   atol=1e-6)


class TestRegistry:
    CFG = MPPIConfig(nx=2, nu=2, K=8, T=3)

    def test_ids_are_the_content(self):
        """The same program and constants traced twice name one id; other
        weights another id with the same header."""
        a = BL.generated_kernel(BL.kernel_model(self.CFG, lin, quad), None)
        b = BL.generated_kernel(BL.kernel_model(self.CFG, lin, quad), None)
        c = BL.generated_kernel(BL.kernel_model(self.CFG, lin_other, quad), None)
        assert a is not b and a.id == b.id and BL.kernel_of(a.id) is BL.kernel_of(b.id)
        assert c.id != a.id and c.header() == a.header()
        assert BL.GENERATED <= min(a.id, c.id) < BL.GENERATED + BL.ID_SPACE

    def test_description_round_trip(self, monkeypatch):
        """A kernel rebuilt from its JSON description in an empty registry
        emits the same header under the same id, and its plain version
        computes what the traced model's does."""
        model = BL.kernel_model(self.CFG, lin, quad)
        terminal = BL.trace_terminal(self.CFG, term)
        kernel = BL.generated_kernel(model, terminal)
        desc = json.loads(json.dumps(kernel.describe()))
        monkeypatch.setattr(BL, "_KERNELS", {})
        rebuilt = BL.load_kernel(desc)
        assert rebuilt is not kernel and (rebuilt.id, rebuilt.header()) == (kernel.id,
                                                                            kernel.header())
        assert BL.load_kernel(desc) is rebuilt and len(BL._KERNELS) == 1
        g = torch.Generator().manual_seed(3)
        x, u = torch.randn(9, 2, generator=g), torch.randn(9, 2, generator=g)
        for a, b in zip(rebuilt.model.rollout_step(x, u, 0), model.rollout_step(x, u, 0)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(rebuilt.terminal.cost(x, u), terminal.cost(x, u), rtol=0,
                                   atol=0)

    def test_description_of_another_source_raises(self):
        desc = BL.generated_kernel(BL.kernel_model(self.CFG, lin, quad), None).describe()
        desc = dict(desc, id=desc["id"] + 1)
        with pytest.raises(ValueError, match="rebuilds to the id"):
            BL.load_kernel(desc)

    def test_a_hash_collision_raises(self, monkeypatch):
        """Two sources under one id never share an entry."""
        monkeypatch.setattr(BL, "_KERNELS", {})
        monkeypatch.setattr(BL, "ID_SPACE", 1)
        BL.generated_kernel(BL.kernel_model(self.CFG, lin, quad), None)
        with pytest.raises(RuntimeError, match="hash to the id"):
            BL.generated_kernel(BL.kernel_model(self.CFG, lin_other, quad), None)

    def test_unknown_id_names_the_loader(self):
        with pytest.raises(ValueError, match="load_solver"):
            BL.kernel_of(BL.GENERATED - 1 + BL.ID_SPACE + 5)


def test_unreadable_version_raises(tmp_path):
    path = str(tmp_path / "v8.npz")
    deploy.export_solver(ROUTES["version_1"][0](), path)
    tree = ckpt.load(path)
    meta = json.loads(tree["meta"])
    meta["version"] = 8  # the first version this build does not read
    tree["meta"] = json.dumps(meta)
    ckpt.save(path, tree)
    with pytest.raises(ValueError, match="reads versions 1, 2"):
        deploy.load_solver(path)
