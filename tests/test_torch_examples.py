"""JAX's ``tests/test_examples.py`` on the port's examples
(``pytorch_mppi_tpu_torch/examples/``), on the CPU, with JAX's shapes and
floors; its ``auto_tune_parameters`` test is
``tests/test_torch_autotune.py``'s.

* ``scenario_batch``: the port and JAX's example start from the same numpy
  start states (numpy seed 0; JAX's ``jax.random.uniform`` patched for its
  run) and each holds JAX's floor.  At N = 8 that floor is a draw in both
  packages: over numpy seeds 0-9 of the start states, "at least 75 % within
  0.5 after 30 steps" holds for JAX at 7 of 10 seeds and for the port at 8
  of 10 (each with its own noise); at seed 0 both have 7 of 8.  ``--mesh``
  runs in a 2-rank Gloo world (this file run as a script, ``python
  tests/test_torch_examples.py RANK INIT_FILE OUT_DIR [ARGS]``), on the
  plain path and with ``--pallas`` (the traced model on the sharded batched
  route), and its global count must equal the unmeshed run's; ``--jit-loop`` must equal the eager
  loop; the module entry runs in a subprocess at the shapes of JAX's mesh
  and jit-loop tests.
* ``differentiable_mpc``, ``deploy_serving``, ``gradient_refinement`` and
  ``elite_reuse`` at JAX's test sizes with its floors; ``smooth_mppi``
  (which JAX does not test) at a small size, its three rows finite and its
  gifs written.
"""
import json
import logging
import os
import pathlib
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
JAX_EXAMPLES = pathlib.Path(REPO) / "examples"

SCENARIO = ["--plants", "8", "--samples", "128", "--horizon", "8"]
MESH_PALLAS = ["--pallas", "--samples", "256"]  # the batched kernels' crossover K


def _states(seed=0, n=8):
    """Start states uniform in [-4, 0)², float32, from numpy."""
    return np.random.RandomState(seed).uniform(-4.0, 0.0, (n, 2)).astype(np.float32)


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return env


class TestScenarioBatch:
    def test_tiny_run_converges(self, monkeypatch):
        """JAX's shapes and floor (most plants converge at K = 128) on the
        same start states for both packages."""
        import jax
        import jax.numpy as jnp

        from pytorch_mppi_tpu_torch.examples import scenario_batch

        x = _states()
        args = SCENARIO + ["--steps", "30"]
        converged, N = scenario_batch.main(args, states=x, device="cpu")
        assert N == 8 and converged >= 0.75 * N

        monkeypatch.syspath_prepend(str(JAX_EXAMPLES))
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape, dtype, lo, hi: jnp.asarray(x, dtype))
        import scenario_batch as jax_scenario_batch

        jc, jn = jax_scenario_batch.main(args)
        assert jn == 8 and jc >= 0.75 * jn

    @pytest.mark.parametrize("extra", [[], MESH_PALLAS], ids=["plain", "pallas"])
    def test_meshed_run_matches_unmeshed(self, tmp_path, extra):
        """The plants split over "data" in a 2-rank Gloo world: every rank's
        global count equals the unmeshed run's.  With ``--pallas`` at K =
        256 the traced model takes the sharded batched kernel route (its
        plain versions on the CPU)."""
        from pytorch_mppi_tpu_torch.examples import scenario_batch

        c0, _ = scenario_batch.main(SCENARIO + ["--steps", "20"] + extra, states=_states(),
                                    device="cpu")
        init_file = str(tmp_path / "group")
        procs = [subprocess.Popen([sys.executable, HERE, str(r), init_file, str(tmp_path),
                                   *extra],
                                  env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
        for r in range(2):
            got = json.loads((tmp_path / f"rank{r}.json").read_text())
            assert got == {"converged": c0, "N": 8, "world": 2}, (r, got, c0)

    def test_mesh_without_a_process_group_raises(self):
        from pytorch_mppi_tpu_torch.examples import scenario_batch

        with pytest.raises(RuntimeError, match="initialize_multihost"):
            scenario_batch.main(SCENARIO + ["--steps", "1", "--mesh"], device="cpu")

    def test_jit_loop_matches_eager(self):
        """``run_mppi_jit`` reaches the eager loop's count: the same step
        functions and streams drive both."""
        from pytorch_mppi_tpu_torch.examples import scenario_batch

        args = SCENARIO + ["--steps", "20"]
        c0, _ = scenario_batch.main(args, states=_states(), device="cpu")
        c1, _ = scenario_batch.main(args + ["--jit-loop"], states=_states(), device="cpu")
        assert c0 == c1

    def test_module_entry(self):
        """``python -m pytorch_mppi_tpu_torch.examples.scenario_batch`` at
        the shapes of JAX's mesh and jit-loop tests: its own draw of start
        states and its own assert (more than 90 % within 0.5)."""
        out = subprocess.run(
            [sys.executable, "-m", "pytorch_mppi_tpu_torch.examples.scenario_batch",
             *SCENARIO, "--steps", "20", "--device", "cpu"], env=_env(), cwd=REPO,
            capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "plants within 0.5 of goal after 20 steps" in out.stderr


class TestDifferentiableMPCExample:
    def test_training_through_control_improves(self):
        from pytorch_mppi_tpu_torch.examples import differentiable_mpc

        l0, l1 = differentiable_mpc.main(train_steps=15, device="cpu")
        assert l1 < 0.6 * l0


class TestDeployServing:
    def test_build_then_serve_in_fresh_process(self):
        """Export in this process, close the loop in a subprocess that never
        defines the dynamics."""
        from pytorch_mppi_tpu_torch.examples import deploy_serving

        r = deploy_serving.main(["--steps", "8", "--samples", "64"], device="cpu")
        assert r["steps"] == 8 and np.isfinite(r["final_angle"])
        assert r["device"] == "cpu"


class TestGradientRefinementExample:
    def test_starved_k_rescued(self):
        """The refined starved-K controller beats the unrefined one on
        accumulated cost."""
        from pytorch_mppi_tpu_torch.examples import gradient_refinement

        rows = gradient_refinement.main(["--samples", "5", "--steps", "60", "--seeds", "2"],
                                        device="cpu")
        (_, _, cost_base), (_, angle_ref, cost_ref) = rows
        assert cost_ref < cost_base
        assert np.isfinite(angle_ref)


class TestEliteReuseExample:
    def test_starved_k_improves(self):
        """The elite-reuse controller beats the baseline on accumulated
        cost."""
        from pytorch_mppi_tpu_torch.examples import elite_reuse

        rows = elite_reuse.main(["--samples", "16", "--elites", "4", "--steps", "60",
                                 "--seeds", "2"], device="cpu")
        (_, cost_base, _), (_, cost_el, _) = rows
        assert cost_el < cost_base


class TestSmoothMPPIExample:
    def test_three_rows_finite_with_gifs(self, tmp_path, monkeypatch):
        from pytorch_mppi_tpu_torch.examples import smooth_mppi

        monkeypatch.chdir(tmp_path)
        rows = smooth_mppi.main(steps=4, record_gif=True, device="cpu")
        assert [r[0] for r in rows] == ["MPPI", "SMPPI", "KMPPI"]
        assert all(np.isfinite(v) for r in rows for v in r[1:])
        for name in ("mppi", "smppi", "kmppi"):
            assert (tmp_path / f"{name}_evolution.gif").stat().st_size > 0


def _mesh_worker(rank, init_file, out_dir, extra):
    """One rank of the 2-rank world of ``test_meshed_run_matches_unmeshed``."""
    import torch.distributed as dist

    from pytorch_mppi_tpu_torch.examples import scenario_batch
    from pytorch_mppi_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO)
    initialize_multihost(f"file://{init_file}", 2, rank, device="cpu")
    converged, N = scenario_batch.main(SCENARIO + ["--steps", "20", "--mesh"] + extra,
                                       states=_states(), device="cpu")
    world = dist.get_world_size()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(
        json.dumps({"converged": converged, "N": N, "world": world}))


if __name__ == "__main__":
    try:
        _mesh_worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
