"""The port's utilities (``pytorch_mppi_tpu_torch/utils/``: ``timer``,
``checkpoint``, ``cache``, ``viz``) on the CPU.

* every test of JAX's ``tests/test_utils.py`` classes ``TestTimer``,
  ``TestCheckpoint``, ``TestCacheUtils`` and ``TestViz`` on the port; JAX's
  two typed-PRNG-key tests become the round trip of the port's ``(seed,
  counter)`` and the ValueError on a JAX key;
* JAX's elites through a checkpoint (``tests/test_extensions.py:1286-1305``);
* held against the JAX package on the same data, made from a numpy seed: a
  tree that JAX's ``checkpoint.save`` writes loads in the port with the same
  structure and values, and the other way round; a ``LocalCache`` file
  written by one package is read by the other; ``sort_nicely`` orders
  hypothesis strings as JAX's does; the timer's dict keys are JAX's;
* what the port adds: a restore brings the noise transform up to date, a
  restored controller continues through ``run_mppi_jit``, the checks of
  ``load_controller``, the CUDA-event and profiler helpers on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import pytorch_mppi_tpu_torch as P
from pytorch_mppi_tpu_torch.config import MPPIParams, MPPIState
from pytorch_mppi_tpu_torch.utils import checkpoint
from pytorch_mppi_tpu_torch.utils import timer
from pytorch_mppi_tpu_torch.utils.timer import benchmark_command, benchmark_fn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SEED = 42

B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)
GOAL = torch.tensor([2.0, 2.0], dtype=F64)


def dyn(state, action):
    return state + action @ B.T


def cost(state, action):
    return ((GOAL - state) ** 2).sum(dim=-1)


def _ctrl(cls=P.MPPI, **kw):
    base = dict(num_samples=64, horizon=8, lambda_=1.0, seed=SEED, device="cpu")
    base.update(kw)
    return cls(dyn, cost, 2, torch.eye(2, dtype=F64), **base)


def _same_tree(a, b):
    """Equal structure and values: tensors and arrays by value, the rest by
    ``==``, NamedTuples by class name, dicts in any key order (a file holds
    them sorted)."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or hasattr(a, "__array__"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
        return
    if isinstance(a, (tuple, list)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
        return
    assert type(a) is type(b) and a == b


class TestTimer:
    def test_benchmark_command(self):
        ctrl = _ctrl()
        state = torch.tensor([0.0, 0.0], dtype=F64)
        stats = benchmark_command(ctrl, state, num_warmup=1, num_iters=5)
        assert stats["mean_s"] > 0
        assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]

    def test_benchmark_fn(self):
        f = lambda x: x * 2
        stats = benchmark_fn(f, torch.ones(4), num_warmup=1, num_iters=3)
        assert stats["median_s"] > 0

    def test_dict_keys_are_jax(self):
        """The same functions give the same keys as the JAX package's."""
        import pytorch_mppi_tpu as J
        from pytorch_mppi_tpu.utils import timer as JT

        jctrl = J.MPPI(lambda s, a: s + a @ jnp.asarray(B.numpy()).T,
                       lambda s, a: ((jnp.asarray(GOAL.numpy()) - s) ** 2).sum(axis=-1), 2,
                       jnp.eye(2), num_samples=16, horizon=4, seed=SEED)
        j_cmd = JT.benchmark_command(jctrl, jnp.zeros(2), num_warmup=1, num_iters=2)
        j_fn = JT.benchmark_fn(lambda x: x * 2, jnp.ones(4), num_warmup=1, num_iters=2)
        p_cmd = benchmark_command(_ctrl(num_samples=16, horizon=4), torch.zeros(2, dtype=F64),
                                  num_warmup=1, num_iters=2)
        p_fn = benchmark_fn(lambda x: x * 2, torch.ones(4), num_warmup=1, num_iters=2)
        assert list(p_cmd) == list(j_cmd) and list(p_fn) == list(j_fn)

    def test_chained_median_time_on_the_cpu(self):
        """Without a card the host clock times the call; the tiny op's time
        is subtracted, and the result stays positive."""
        rtt = timer.median_host_rtt(samples=3, device="cpu")
        assert rtt > 0
        x = torch.randn(64, 64)
        t = timer.chained_median_time(lambda a: a @ a, x, iters_per_dispatch=2, repeats=3)
        assert t > 0

    def test_median_host_rtt_never_falls_back_to_the_cpu(self, monkeypatch):
        """With no card and no device asked for, the probe raises instead
        of timing the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timer.median_host_rtt(samples=1)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with timer.trace(str(tmp_path / "tr")) as prof:
            torch.randn(32, 32) @ torch.randn(32, 32)
        assert prof is not None
        assert (tmp_path / "tr" / "trace.json").stat().st_size > 0

    def test_probe_reports_a_fast_failure_without_a_card(self, caplog):
        """Here there is no card: the probe's subprocess fails fast, and the
        report says so (not a timeout)."""
        import logging

        if torch.cuda.is_available():
            pytest.skip("a card is present: the probe succeeds")
        log = logging.getLogger("probe-test")
        with caplog.at_level(logging.WARNING, logger="probe-test"):
            assert timer.probe_device_reachable(timeout_s=120, logger=log) is False
        assert "failed fast" in caplog.text


class TestCheckpoint:
    def test_snapshot_restore_roundtrip(self):
        ctrl = _ctrl()
        state = torch.tensor([-1.0, 1.0], dtype=F64)
        ctrl.command(state)
        snap = checkpoint.snapshot(ctrl)
        a_expected = ctrl.command(state)

        checkpoint.restore(ctrl, snap)
        a_again = ctrl.command(state)
        torch.testing.assert_close(a_expected, a_again, rtol=0, atol=0)

    def test_save_load_controller(self, tmp_path):
        ctrl = _ctrl()
        state = torch.tensor([-1.0, 1.0], dtype=F64)
        ctrl.command(state)
        path = os.path.join(tmp_path, "ctrl.npz")
        checkpoint.save_controller(path, ctrl)
        a_expected = ctrl.command(state)

        # resume in a freshly built controller (different seed -> different state)
        ctrl2 = _ctrl(seed=999)
        checkpoint.load_controller(path, ctrl2)
        a_resumed = ctrl2.command(state)
        torch.testing.assert_close(a_expected, a_resumed, rtol=0, atol=0)

    def test_save_load_smppi_kmppi(self, tmp_path):
        for cls in (P.SMPPI, P.KMPPI):
            ctrl = _ctrl(cls)
            state = torch.tensor([0.5, -0.5], dtype=F64)
            ctrl.command(state)
            path = os.path.join(tmp_path, f"{cls.__name__}.npz")
            checkpoint.save_controller(path, ctrl)
            a_expected = ctrl.command(state)
            ctrl2 = _ctrl(cls, seed=7)
            checkpoint.load_controller(path, ctrl2)
            a_resumed = ctrl2.command(state)
            torch.testing.assert_close(a_expected, a_resumed, rtol=0, atol=0)

    def test_save_load_pytree(self, tmp_path):
        tree = {"a": torch.arange(3.0), "b": (torch.eye(2), torch.tensor(1.5))}
        path = os.path.join(tmp_path, "tree.npz")
        checkpoint.save(path, tree)
        loaded = checkpoint.load(path, like=tree)
        np.testing.assert_allclose(loaded["a"].numpy(), [0, 1, 2])
        np.testing.assert_allclose(loaded["b"][0].numpy(), np.eye(2))

    def test_load_is_self_describing(self, tmp_path):
        """load() without like= rebuilds the exact structure: dicts, lists,
        nested NamedTuples, None, python scalars."""
        tree = {
            "state": MPPIState(U=torch.ones((4, 2)), seed=7, counter=3),
            "params": MPPIParams(
                noise_mu=torch.zeros(2), noise_sigma=torch.eye(2),
                lambda_=torch.tensor(1.0), u_min=torch.full((2,), -1.0),
                u_max=torch.full((2,), 1.0), u_init=torch.zeros(2),
            ),
            "meta": [1, 2.5, None, ("x",)],
        }
        path = os.path.join(tmp_path, "sd.npz")
        checkpoint.save(path, tree)
        loaded = checkpoint.load(path)
        assert isinstance(loaded["state"], MPPIState)
        assert isinstance(loaded["params"], MPPIParams)
        assert loaded["state"].seed == 7 and loaded["state"].counter == 3
        assert loaded["meta"][0] == 1 and loaded["meta"][2] is None
        assert isinstance(loaded["meta"][3], tuple)
        _same_tree(loaded, tree)

    def test_seed_counter_roundtrip(self, tmp_path):
        """The port's random stream is ``(seed, counter)``: both travel as
        Python ints, and a controller resumed from them draws the noise the
        saved one would (in place of JAX's typed-key round trip)."""
        ctrl = _ctrl()
        x = torch.tensor([0.5, 0.5], dtype=F64)
        for _ in range(3):
            ctrl.command(x)
        path = os.path.join(tmp_path, "stream.npz")
        checkpoint.save(path, {"s": ctrl._state})
        state = checkpoint.load(path)["s"]
        assert type(state.seed) is int and type(state.counter) is int
        assert (state.seed, state.counter) == (ctrl._state.seed, ctrl._state.counter) != (
            ctrl._state.seed, 0)
        ctrl.command(x)
        torch.testing.assert_close(ctrl.noise, _noise_after(state, x), rtol=0, atol=0)

    @pytest.mark.parametrize("typed", [True, False], ids=["typed_key", "raw_key"])
    def test_jax_key_is_rejected(self, tmp_path, typed):
        """A JAX controller's state holds a PRNG key (a typed ``key`` node,
        or a raw uint32 key where ``prng_impl=None``) where the port keeps
        ``(seed, counter)``: loading it raises a ValueError that says so (in
        place of JAX's prng_impl diagnosis)."""
        from pytorch_mppi_tpu.config import MPPIState as JState
        from pytorch_mppi_tpu.utils import checkpoint as JC

        key = jax.random.key(5) if typed else jax.random.PRNGKey(5)
        path = os.path.join(tmp_path, "jax_state.npz")
        JC.save(path, {"state": JState(U=jnp.ones((4, 2)), key=key)})
        with pytest.raises(ValueError, match=r"JAX PRNG key.*\(seed, counter\)"):
            checkpoint.load(path)

    def test_fresh_interpreter_resume_bit_identical(self, tmp_path):
        """Save in one process, load in a FRESH interpreter (no like= tree),
        restore a controller built with another seed, and the next command
        is bit-identical."""
        ctrl = _ctrl()
        state = torch.tensor([-1.0, 1.0], dtype=F64)
        ctrl.command(state)
        path = os.path.join(tmp_path, "resume.npz")
        checkpoint.save_controller(path, ctrl)
        a_expected = ctrl.command(state).numpy()

        script = f"""
import numpy as np
import torch
from pytorch_mppi_tpu_torch import MPPI
from pytorch_mppi_tpu_torch.utils import checkpoint

B = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=torch.float64)
GOAL = torch.tensor([2.0, 2.0], dtype=torch.float64)
dyn = lambda s, a: s + a @ B.T
cost = lambda s, a: ((GOAL - s) ** 2).sum(dim=-1)
ctrl = MPPI(dyn, cost, 2, torch.eye(2, dtype=torch.float64), num_samples=64,
            horizon=8, lambda_=1.0, seed=12345, device="cpu")  # another seed on purpose
checkpoint.load_controller({path!r}, ctrl)
a = ctrl.command(torch.tensor([-1.0, 1.0], dtype=torch.float64))
np.save({os.path.join(tmp_path, "action.npy")!r}, a.numpy())
"""
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        subprocess.run([sys.executable, "-c", script], check=True, env=env, cwd=REPO,
                       timeout=300)
        a_resumed = np.load(os.path.join(tmp_path, "action.npy"))
        np.testing.assert_array_equal(a_expected, a_resumed)

    def test_shape_mismatch_rejected(self, tmp_path):
        ctrl = _ctrl(horizon=8)
        path = os.path.join(tmp_path, "h8.npz")
        checkpoint.save_controller(path, ctrl)
        other = _ctrl(horizon=5)
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load_controller(path, other)

    def test_controller_class_mismatch_rejected(self, tmp_path):
        """An SMPPI checkpoint must not silently restore into a plain MPPI:
        the structures differ, not just leaf shapes."""
        ctrl = _ctrl(P.SMPPI)
        path = os.path.join(tmp_path, "smppi.npz")
        checkpoint.save_controller(path, ctrl)
        with pytest.raises(ValueError, match="structure"):
            checkpoint.load_controller(path, _ctrl(P.MPPI))

    def test_dtype_and_elites_mismatch_rejected(self, tmp_path):
        """A float32 checkpoint into a float64 controller names the shape
        check; elites against None name the structure."""
        path = os.path.join(tmp_path, "f32.npz")
        checkpoint.save_controller(path, P.MPPI(dyn, cost, 2, torch.eye(2), num_samples=64,
                                                horizon=8, seed=SEED, device="cpu"))
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load_controller(path, _ctrl())
        path = os.path.join(tmp_path, "elites.npz")
        checkpoint.save_controller(path, _ctrl(num_elites=2))
        with pytest.raises(ValueError, match="structure"):
            checkpoint.load_controller(path, _ctrl())

    def test_elites_through_a_checkpoint(self, tmp_path):
        """JAX ``tests/test_extensions.py:1286-1305``: the elites ride
        MPPIState through save/load_controller; resuming from the file
        continues bit-identically."""
        def build():
            return _ctrl(num_samples=16, horizon=6, seed=11, num_elites=3)

        a = build()
        x = torch.tensor([1.0, -1.0], dtype=F64)
        a.command(x)
        path = os.path.join(tmp_path, "elites.npz")
        checkpoint.save_controller(path, a)
        b = build()
        checkpoint.load_controller(path, b)
        torch.testing.assert_close(a._state.elites, b._state.elites, rtol=0, atol=0)
        torch.testing.assert_close(a.command(x), b.command(x), rtol=0, atol=0)

    def test_restore_updates_the_noise_transform(self, tmp_path):
        """A full sigma restored into a controller built with a diagonal one
        selects the full transform, as a controller built with it."""
        sigma = torch.tensor([[1.0, 0.3], [0.3, 0.5]], dtype=F64)
        src = P.MPPI(dyn, cost, 2, sigma, num_samples=32, horizon=6, seed=1, device="cpu")
        x = torch.tensor([0.2, -0.4], dtype=F64)
        src.command(x)
        path = os.path.join(tmp_path, "sigma.npz")
        checkpoint.save_controller(path, src)
        dst = _ctrl(num_samples=32, horizon=6, seed=2)
        assert dst._diag_sigma
        checkpoint.load_controller(path, dst)
        assert not dst._diag_sigma and not dst.config.diag_sigma
        torch.testing.assert_close(src.command(x), dst.command(x), rtol=0, atol=0)

    @pytest.mark.parametrize("cls", ["MPPI", "MPPI_Batched"])
    def test_restored_controller_continues_in_run_mppi_jit(self, tmp_path, cls):
        """A controller restored after its twin's commands runs
        ``run_mppi_jit`` (the eager loop on the CPU) to the twin's result."""
        if cls == "MPPI":
            make = lambda seed: _ctrl(num_samples=32, horizon=6, seed=seed, num_elites=2)
            x0 = torch.tensor([-1.0, 1.0], dtype=F64)
            plant = dyn
        else:
            make = lambda seed: P.MPPI_Batched(dyn, cost, 2, torch.eye(2, dtype=F64),
                                               num_envs=3, num_samples=32, horizon=6,
                                               seed=seed, device="cpu")
            x0 = torch.tensor([[-1.0, 1.0], [0.5, 0.0], [2.0, -2.0]], dtype=F64)
            plant = dyn
        a = make(3)
        for _ in range(3):
            a.command(x0)
        path = os.path.join(tmp_path, "run.npz")
        checkpoint.save_controller(path, a)
        b = checkpoint.load_controller(path, make(4))
        ra = P.run_mppi_jit(a, plant, x0, 5)
        rb = P.run_mppi_jit(b, plant, x0, 5)
        for u, v in zip(ra, rb):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert a._state.counter == b._state.counter

    def test_jax_tree_loads_in_the_port(self, tmp_path):
        """A tree of dicts, lists, tuples, str, Python scalars and MPPIParams
        written by JAX's checkpoint.save loads in the port with the same
        structure and values."""
        from pytorch_mppi_tpu.config import MPPIParams as JParams
        from pytorch_mppi_tpu.utils import checkpoint as JC

        rng = np.random.default_rng(0)
        arrs = [rng.standard_normal(s) for s in ((2,), (2, 2), (), (2,), (2,), (2,), (3, 4))]
        jtree = {"params": JParams(*map(jnp.asarray, arrs[:6])), "z": [jnp.asarray(arrs[6]),
                 ("name", 3, 2.5, True)], "n": None}
        path = os.path.join(tmp_path, "jax.npz")
        JC.save(path, jtree)
        ptree = checkpoint.load(path)
        assert isinstance(ptree["params"], MPPIParams)
        assert isinstance(ptree["params"].lambda_, torch.Tensor)
        _same_tree(ptree, {"n": None, "params": MPPIParams(*map(torch.from_numpy, arrs[:6])),
                           "z": [torch.from_numpy(arrs[6]), ("name", 3, 2.5, True)]})

    def test_port_tree_loads_in_jax(self, tmp_path):
        """And the other way round: JAX's checkpoint.load reads the port's
        file with the same structure and values."""
        from pytorch_mppi_tpu.config import MPPIParams as JParams
        from pytorch_mppi_tpu.utils import checkpoint as JC

        rng = np.random.default_rng(1)
        arrs = [rng.standard_normal(s).astype(np.float32)
                for s in ((2,), (2, 2), (), (2,), (2,), (2,), (5,))]
        ptree = {"params": MPPIParams(*map(torch.from_numpy, arrs[:6])),
                 "z": (torch.from_numpy(arrs[6]), ["tag", 7, -1.25, False]), "n": None}
        path = os.path.join(tmp_path, "port.npz")
        checkpoint.save(path, ptree)
        jtree = JC.load(path)
        assert isinstance(jtree["params"], JParams)
        _same_tree(jtree, {"n": None, "params": JParams(*arrs[:6]),
                           "z": (arrs[6], ["tag", 7, -1.25, False])})


def _noise_after(state, x):
    """The rectified noise of the command a fresh twin runs from ``state``."""
    twin = _ctrl(seed=0)
    twin._state = state
    twin.command(x)
    return twin.noise


class TestCacheUtils:
    """The example-support replacements of arm_pytorch_utilities
    (cache.LocalCache, sort_nicely)."""

    def test_local_cache_roundtrip(self, tmp_path):
        from pytorch_mppi_tpu_torch.utils.cache import LocalCache

        path = os.path.join(tmp_path, "res.pkl")
        c = LocalCache(path)
        c["run1"] = {"cost": 1.5}
        c.save()
        c2 = LocalCache(path)
        assert c2["run1"] == {"cost": 1.5}

    def test_sort_nicely(self):
        from pytorch_mppi_tpu_torch.utils.cache import sort_nicely

        frames = ["f10.png", "f2.png", "f1.png", "f20.png"]
        sort_nicely(frames)
        assert frames == ["f1.png", "f2.png", "f10.png", "f20.png"]

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_local_cache_file_is_shared(self, tmp_path, writer):
        """A cache that one package writes, the other reads."""
        from pytorch_mppi_tpu.utils import cache as JCache
        from pytorch_mppi_tpu_torch.utils import cache as PCache

        rng = np.random.default_rng(3)
        content = {f"run{i}": {"cost": float(rng.standard_normal()),
                               "traj": rng.standard_normal(4).tolist()} for i in range(3)}
        write, read = (JCache, PCache) if writer == "jax" else (PCache, JCache)
        path = os.path.join(tmp_path, "shared.pkl")
        c = write.LocalCache(path)
        c.update(content)
        c.save()
        assert dict(read.LocalCache(path)) == content

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.text(alphabet="ab0123456789_.", max_size=8), max_size=12))
    def test_sort_nicely_orders_as_jax(self, items):
        from pytorch_mppi_tpu.utils.cache import sort_nicely as jax_sort
        from pytorch_mppi_tpu_torch.utils.cache import sort_nicely

        assert sort_nicely(list(items)) == jax_sort(list(items))


class TestViz:
    def test_gif_recorder_and_colored_rollouts(self, tmp_path):
        """Headless gif recording of rollout evolution (reference parity:
        smooth_mppi.py:265-285 records evolution frames to gifs), from
        tensors."""
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        from pytorch_mppi_tpu_torch.utils.viz import GifRecorder, draw_rollouts_colored

        fig, ax = plt.subplots(figsize=(2, 2))
        rec = GifRecorder(fig)
        g = torch.Generator().manual_seed(0)
        for _ in range(3):
            rollouts = torch.cumsum(torch.randn(5, 8, 2, generator=g), dim=1)
            artists = draw_rollouts_colored(ax, torch.zeros(2), rollouts, torch.arange(5.0))
            rec.capture()
            for a in artists:
                a.remove()
        path = rec.save(os.path.join(tmp_path, "evo.gif"), fps=4)
        from PIL import Image

        with Image.open(path) as im:
            assert im.format == "GIF"
            assert getattr(im, "n_frames", 1) == 3
        plt.close(fig)

    def test_gif_recorder_empty_raises(self, tmp_path):
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        from pytorch_mppi_tpu_torch.utils.viz import GifRecorder

        fig, _ = plt.subplots()
        with pytest.raises(ValueError):
            GifRecorder(fig).save(os.path.join(tmp_path, "x.gif"))
        plt.close(fig)

    def test_colored_rollouts_match_jax(self):
        """Tensors and the numpy arrays JAX's function takes draw the same
        lines in the same colors."""
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        from pytorch_mppi_tpu.utils.viz import draw_rollouts_colored as jax_draw
        from pytorch_mppi_tpu_torch.utils.viz import draw_rollouts_colored

        rng = np.random.default_rng(4)
        rollouts, costs = rng.standard_normal((6, 5, 2)), rng.random(6)
        fig, (a0, a1) = plt.subplots(1, 2)
        lines_p = draw_rollouts_colored(a0, torch.ones(2), torch.from_numpy(rollouts),
                                        torch.from_numpy(costs), max_rollouts=4)
        lines_j = jax_draw(a1, np.ones(2), rollouts, costs, max_rollouts=4)
        assert len(lines_p) == len(lines_j) == 4
        for lp, lj in zip(lines_p, lines_j):
            np.testing.assert_array_equal(lp.get_xydata(), lj.get_xydata())
            assert lp.get_color() == lj.get_color()
        plt.close(fig)


def test_toy2d_drawing_matches_jax(tmp_path):
    """The toy2d environment's drawing: the cost landscape's contours over
    the same grid agree with the JAX environment's (float32 costs), and the
    rollouts, the trajectory and the figure draw headless."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    from pytorch_mppi_tpu.models.toy2d import Toy2DEnvironment as JEnv
    from pytorch_mppi_tpu_torch.models import Toy2DEnvironment

    env, jenv = Toy2DEnvironment(device="cpu"), JEnv(dtype=jnp.float32)
    fig, jfig = env.start_visualization(), jenv.start_visualization()
    assert len(env.ax.collections) == len(jenv.ax.collections)
    for c, jc in zip(env.ax.collections[:2], jenv.ax.collections[:2]):  # filled, dashed
        np.testing.assert_array_equal(c.levels, jc.levels)
        paths, jpaths = c.get_paths(), jc.get_paths()
        assert len(paths) == len(jpaths)
        for path, jpath in zip(paths, jpaths):
            np.testing.assert_allclose(path.vertices, jpath.vertices, rtol=0, atol=1e-4)
    rng = np.random.default_rng(5)
    rollouts = np.cumsum(rng.standard_normal((4, 6, 2)) * 0.3, axis=1)
    env.draw_rollouts(torch.from_numpy(rollouts))
    jenv.draw_rollouts(rollouts)
    for line, jline in zip(env.ax.lines, jenv.ax.lines):
        np.testing.assert_allclose(line.get_xydata(), jline.get_xydata(), rtol=1e-6, atol=1e-6)
    env.draw_trajectory(torch.from_numpy(rollouts[0]), label="x")
    path = env.save_figure(str(tmp_path / "toy2d.png"))
    assert os.path.getsize(path) > 0
    plt.close(fig)
    plt.close(jfig)
