"""The dynamics bridge (``pytorch_mppi_tpu_torch/ops/batch_last.py``)
against JAX's ``tests/test_batch_last.py``.

Each program of JAX's test is written in torch, traced into the port's
per-sample scalar program, and the program's plain evaluator
(``Program.evaluate``) is held against the JAX function on the same numpy
inputs in float64, rtol 1e-12 (the same operations in the same order but
for the reductions' summation order, which moves the result by a few ulp);
the fuzz, rtol 1e-9 as JAX's own.  The vocabulary check of the port
(``supports_batch_last``) must agree with JAX's on every program.  The fuzz
draws its programs with a torch copy of ``tests/fuzz_programs.gen_program``
that consumes the same ``RandomState`` draws in the same order, so the JAX
and torch programs of one seed compute the same function.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mppi_tpu.ops.batch_last import supports_batch_last as jax_supports
from pytorch_mppi_tpu_torch.ops import batch_last as BL

B = 16
DT = jnp.float64
RTOL = 1e-12


def _rand(*shape):
    return np.random.RandomState(sum(shape) + 7).randn(*shape)


def _jax_ok(f, args, batched):
    closed = jax.make_jaxpr(f)(*args)
    return jax_supports(closed.jaxpr, closed.consts,
                        [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args], batched, B)


def _check(jf, tf, s, u, t=None, rtol=RTOL):
    """``jf`` (JAX) and ``tf`` (torch) on the same float64 inputs: the
    port's traced program against the JAX function, and both vocabulary
    checks true."""
    jargs = [jnp.asarray(s, DT), jnp.asarray(u, DT)]
    if t is not None:
        jargs.append(jnp.asarray(t, jnp.int32))
    want = jf(*jargs)
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    sizes = [int(np.prod(np.shape(w)[1:])) for w in want]
    nx, nu = s.shape[1], u.shape[1]
    prog, consts, outs = BL.trace_program(tf, nx, nu, sizes, torch.float64, t is not None)
    st, ut = torch.from_numpy(s), torch.from_numpy(u)
    for w, o in zip(want, outs):
        vals = prog.evaluate(o, consts, st, ut, 0 if t is None else t)
        got = torch.stack([v.expand(B) if v.ndim == 0 else v for v in vals], dim=1)
        np.testing.assert_allclose(got.numpy().reshape(np.shape(w)), np.asarray(w), rtol=rtol)
    ok, msg = BL.supports_batch_last(tf, nx, nu, sizes, torch.float64, t is not None)
    assert ok, msg
    jok, jmsg = _jax_ok(jf, jargs, [True, True] + ([False] if t is not None else []))
    assert jok, jmsg


Bmat = np.array([[1.0, 0.0], [0.0, -1.0]])
GOAL = np.array([2.0, 2.0])
JB, TB = jnp.asarray(Bmat, DT), torch.from_numpy(Bmat)
JG, TG = jnp.asarray(GOAL, DT), torch.from_numpy(GOAL)


class TestSupported:
    def test_linear_dynamics(self):
        _check(lambda s, u: s + u @ JB.T, lambda s, u: s + u @ TB.T, _rand(B, 2), _rand(B, 2))

    def test_quadratic_cost(self):
        _check(lambda s, u: ((JG - s) ** 2).sum(axis=-1),
               lambda s, u: ((TG - s) ** 2).sum(dim=-1), _rand(B, 2), _rand(B, 2))

    def test_pendulum_dynamics(self):
        def jf(state, action):
            th, thdot = state[..., 0], state[..., 1]
            u = jnp.clip(action[..., 0], -2.0, 2.0)
            newthdot = thdot + (3 * 10.0 / 2 * jnp.sin(th) + 3.0 * u) * 0.05
            newthdot = jnp.clip(newthdot, -8, 8)
            newth = th + newthdot * 0.05
            return jnp.stack([newth, newthdot], axis=-1)

        def tf(state, action):
            th, thdot = state[..., 0], state[..., 1]
            u = torch.clamp(action[..., 0], -2.0, 2.0)
            newthdot = thdot + (3 * 10.0 / 2 * torch.sin(th) + 3.0 * u) * 0.05
            newthdot = torch.clamp(newthdot, -8, 8)
            newth = th + newthdot * 0.05
            return torch.stack([newth, newthdot], dim=-1)

        _check(jf, tf, _rand(B, 2), _rand(B, 1))

    def test_angle_normalize_cost(self):
        def jf(state, action):
            th = ((state[..., 0] + jnp.pi) % (2 * jnp.pi)) - jnp.pi
            return th**2 + 0.1 * state[..., 1] ** 2 + 0.001 * (action**2).sum(-1)

        def tf(state, action):
            th = ((state[..., 0] + torch.pi) % (2 * torch.pi)) - torch.pi
            return th**2 + 0.1 * state[..., 1] ** 2 + 0.001 * (action**2).sum(-1)

        _check(jf, tf, _rand(B, 2), _rand(B, 1))

    def test_mlp_dynamics(self):
        W1, b1, W2, b2 = _rand(4, 32), _rand(32), _rand(32, 2), _rand(2)
        jW1, jb1, jW2, jb2 = (jnp.asarray(a, DT) for a in (W1, b1, W2, b2))
        tW1, tb1, tW2, tb2 = (torch.from_numpy(a) for a in (W1, b1, W2, b2))
        _check(lambda s, u: s + jnp.tanh(jnp.concatenate([s, u], axis=-1) @ jW1 + jb1) @ jW2
               + jb2,
               lambda s, u: s + torch.tanh(torch.cat([s, u], dim=-1) @ tW1 + tb1) @ tW2 + tb2,
               _rand(B, 2), _rand(B, 2))

    def test_quadratic_form_einsum(self):
        Q = np.array([[2.0, 0.3], [0.3, 1.0]])
        jQ, tQ = jnp.asarray(Q, DT), torch.from_numpy(Q)
        _check(lambda s, u: jnp.einsum("bi,ij,bj->b", s, jQ, s),
               lambda s, u: torch.einsum("bi,ij,bj->b", s, tQ, s), _rand(B, 2), _rand(B, 2))

    def test_where_and_select(self):
        def jf(s, u):
            speed = jnp.abs(s[..., 1])
            return jnp.where(speed > 1.0, speed * 2.0, speed + u[..., 0])

        def tf(s, u):
            speed = torch.abs(s[..., 1])
            return torch.where(speed > 1.0, speed * 2.0, speed + u[..., 0])

        _check(jf, tf, _rand(B, 2), _rand(B, 1))

    def test_broadcast_to_batch(self):
        _check(lambda s, u: s + jnp.broadcast_to(JG * 0.01, (s.shape[0], 2)) + u,
               lambda s, u: s + torch.broadcast_to(TG * 0.01, (s.shape[0], 2)) + u,
               _rand(B, 2), _rand(B, 2))

    def test_broadcast_rank_aligned_row_to_batch(self):
        """A (1, nx) constant broadcast to (B, nx): its size-1 batch slot
        becomes the batch axis, the constant the same for every sample."""
        b_row = _rand(1, 2)
        jrow, trow = jnp.asarray(b_row, DT), torch.from_numpy(b_row)
        _check(lambda s, u: s + u + jnp.broadcast_to(jrow, (s.shape[0], 2)),
               lambda s, u: s + u + torch.broadcast_to(trow, (s.shape[0], 2)),
               _rand(B, 2), _rand(B, 2))

    def test_reshape_feature_dims(self):
        def jf(s, u):
            x = s.reshape(s.shape[0], 2, 2)
            return (x * x).sum(axis=(1, 2)) + u[..., 0]

        def tf(s, u):
            x = s.reshape(s.shape[0], 2, 2)
            return (x * x).sum(dim=(1, 2)) + u[..., 0]

        _check(jf, tf, _rand(B, 4), _rand(B, 1))

    def test_unbatched_time_arg(self):
        _check(lambda s, u, t: s + u * (1.0 + 0.1 * t),
               lambda s, u, t: s + u * (1.0 + 0.1 * t), _rand(B, 2), _rand(B, 2), t=3)

    def test_jit_wrapped_fn_inlines(self):
        """JAX inlines a ``jit``-wrapped call; the port traces through a
        module's call the same way."""
        inner_j = jax.jit(lambda s: jnp.tanh(s) * 2.0)

        class Inner(torch.nn.Module):
            def forward(self, s):
                return torch.tanh(s) * 2.0

        inner_t = Inner()
        _check(lambda s, u: inner_j(s) + u, lambda s, u: inner_t(s) + u, _rand(B, 2),
               _rand(B, 2))

    def test_tuple_outputs(self):
        def jf(s, u):
            ns = s + u @ JB.T
            return ns, ((JG - ns) ** 2).sum(axis=-1)

        def tf(s, u):
            ns = s + u @ TB.T
            return ns, ((TG - ns) ** 2).sum(dim=-1)

        _check(jf, tf, _rand(B, 2), _rand(B, 2))

    def test_cumsum_feature_axis(self):
        _check(lambda s, u: jnp.cumsum(s, axis=-1) + jnp.cumprod(1.0 + 0.01 * u, axis=-1),
               lambda s, u: torch.cumsum(s, dim=-1) + torch.cumprod(1.0 + 0.01 * u, dim=-1),
               _rand(B, 4), _rand(B, 4))

    def test_norm_sqrt_rsqrt(self):
        def jf(s, u):
            n = jnp.sqrt((s**2).sum(axis=-1) + 1e-9)
            return s / (n[..., None] + 1.0) + u

        def tf(s, u):
            n = torch.sqrt((s**2).sum(dim=-1) + 1e-9)
            return s / (n[..., None] + 1.0) + u

        _check(jf, tf, _rand(B, 2), _rand(B, 2))


class TestUnsupported:
    def test_batch_reduction_rejected(self):
        jf = lambda s, u: s - s.mean(axis=0, keepdims=True) + u  # noqa: E731
        tf = lambda s, u: s - s.mean(dim=0, keepdim=True) + u  # noqa: E731
        ok, msg = BL.supports_batch_last(tf, 2, 2, [2], torch.float64)
        assert not ok and "batch axis" in msg
        jok, jmsg = _jax_ok(jf, [jnp.asarray(_rand(B, 2), DT)] * 2, [True, True])
        assert not jok and "batch axis" in jmsg

    def test_sort_rejected(self):
        ok, msg = BL.supports_batch_last(lambda s, u: torch.sort(s, dim=-1).values + u, 2, 2,
                                         [2], torch.float64)
        assert not ok and "sort" in msg
        jok, _ = _jax_ok(lambda s, u: jnp.sort(s, axis=-1) + u,
                         [jnp.asarray(_rand(B, 2), DT)] * 2, [True, True])
        assert not jok

    def test_probe_does_not_raise_on_eval(self):
        """The probe reports; the tracer itself raises."""
        tf = lambda s, u: s - s.mean(dim=0, keepdim=True) + u  # noqa: E731
        with pytest.raises(BL.UnsupportedPrimitive):
            BL.trace_program(tf, 2, 2, [2], torch.float64)
        assert BL.supports_batch_last(tf, 2, 2, [2], torch.float64)[0] is False


# ---------------------------------------------------------------------------
# The fuzz: a torch copy of tests/fuzz_programs.gen_program
# ---------------------------------------------------------------------------


def gen_program_torch(rng, force_kind=None, nx=None, nu=None, dtype=None):
    """``tests/fuzz_programs.gen_program`` with torch ops: the same draws
    from ``rng`` in the same order, so one seed plans the same program;
    returns ``(f, nx, nu)``."""
    DTt = torch.float64 if dtype is None else dtype
    nx = int(rng.randint(1, 5)) if nx is None else int(nx)
    nu = int(rng.randint(1, 4)) if nu is None else int(nu)
    n_ops = int(rng.randint(4, 10))
    plan = []
    dims = [nx, nu]
    for _ in range(n_ops):
        op = rng.choice([
            "unary", "binary", "const_bin", "matmul", "reduce",
            "concat", "slice", "where", "clip", "cumsum",
        ])
        i = int(rng.randint(0, len(dims)))
        j = int(rng.randint(0, len(dims)))
        if op == "unary":
            fn = rng.choice(["tanh", "sin", "cos", "logistic", "square",
                             "abs", "log1p_abs", "sqrt_abs"])
            plan.append(("unary", i, fn))
            dims.append(dims[i])
        elif op == "binary":
            cands = [k for k, d in enumerate(dims) if d == dims[i]]
            j = int(cands[rng.randint(0, len(cands))])
            fn = rng.choice(["add", "mul", "sub", "max", "min"])
            plan.append(("binary", i, j, fn))
            dims.append(dims[i])
        elif op == "const_bin":
            c = rng.randn(dims[i]) * 0.7
            plan.append(("const_bin", i, c, rng.choice(["add", "mul", "atan2"])))
            dims.append(dims[i])
        elif op == "matmul":
            dout = int(rng.randint(1, 6))
            W = rng.randn(dims[i], dout) * (1.0 / max(1, dims[i]))
            plan.append(("matmul", i, W))
            dims.append(dout)
        elif op == "reduce":
            fn = rng.choice(["sum", "max", "mean"])
            plan.append(("reduce", i, fn))
            dims.append(1)
        elif op == "concat":
            plan.append(("concat", i, j))
            dims.append(dims[i] + dims[j])
        elif op == "slice":
            k = int(rng.randint(1, dims[i] + 1))
            plan.append(("slice", i, k))
            dims.append(k)
        elif op == "where":
            cands = [k for k, d in enumerate(dims) if d == dims[i]]
            j = int(cands[rng.randint(0, len(cands))])
            plan.append(("where", i, j))
            dims.append(dims[i])
        elif op == "clip":
            lo = float(rng.uniform(-2.0, 0.0))
            plan.append(("clip", i, lo, lo + float(rng.uniform(0.5, 3.0))))
            dims.append(dims[i])
        elif op == "cumsum":
            plan.append(("cumsum", i))
            dims.append(dims[i])
    Wout = rng.randn(dims[-1], nx) * (1.0 / max(1, dims[-1]))
    as_cost = bool(rng.randint(0, 2)) if force_kind is None else (force_kind == "cost")
    consts = {id(step): torch.as_tensor(step[2], dtype=DTt) for step in plan
              if step[0] in ("const_bin", "matmul")}
    Wout_t = torch.as_tensor(Wout, dtype=DTt)

    def f(s, u):
        vals = [s, u]
        for step in plan:
            kind = step[0]
            if kind == "unary":
                _, i, fn = step
                x = {"tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos,
                     "logistic": torch.sigmoid, "square": torch.square, "abs": torch.abs,
                     "log1p_abs": lambda v: torch.log1p(torch.abs(v)),
                     "sqrt_abs": lambda v: torch.sqrt(torch.abs(v) + 1e-9)}[fn](vals[i])
                vals.append(x)
            elif kind == "binary":
                _, i, j, fn = step
                vals.append({"add": torch.add, "mul": torch.mul, "sub": torch.sub,
                             "max": torch.maximum, "min": torch.minimum}[fn](vals[i], vals[j]))
            elif kind == "const_bin":
                _, i, _, fn = step
                c = consts[id(step)]
                vals.append({"add": torch.add, "mul": torch.mul,
                             "atan2": torch.atan2}[fn](vals[i], c))
            elif kind == "matmul":
                vals.append(vals[step[1]] @ consts[id(step)])
            elif kind == "reduce":
                _, i, fn = step
                if fn == "max":
                    vals.append(torch.amax(vals[i], dim=-1, keepdim=True))
                else:
                    vals.append({"sum": torch.sum, "mean": torch.mean}[fn](
                        vals[i], dim=-1, keepdim=True))
            elif kind == "concat":
                _, i, j = step
                vals.append(torch.cat([vals[i], vals[j]], dim=-1))
            elif kind == "slice":
                _, i, k = step
                vals.append(vals[i][..., :k])
            elif kind == "where":
                _, i, j = step
                vals.append(torch.where(vals[i] > 0, vals[i], vals[j]))
            elif kind == "clip":
                _, i, lo, hi = step
                vals.append(torch.clamp(vals[i], lo, hi))
            elif kind == "cumsum":
                vals.append(torch.cumsum(vals[step[1]], dim=-1))
        out = vals[-1] @ Wout_t
        return (out**2).sum(dim=-1) if as_cost else out

    return f, nx, nu


class TestFuzz:
    """Seeded random programs of 4-9 ops over the vocabulary, the JAX and
    the torch copy of one plan, traced by the port and held against JAX's
    function (rtol 1e-9, as JAX's own fuzz)."""

    @pytest.mark.parametrize("seed", range(30))
    def test_random_program(self, seed):
        from fuzz_programs import gen_program

        jf, nx, nu = gen_program(np.random.RandomState(1000 + seed))
        rng = np.random.RandomState(1000 + seed)
        tf, tnx, tnu = gen_program_torch(rng)
        assert (tnx, tnu) == (nx, nu)
        s = rng.randn(B, nx)
        u = rng.randn(B, nu)
        _check(jf, tf, s, u, rtol=1e-9)


# ---------------------------------------------------------------------------
# The port's vocabulary beyond JAX's programs
# ---------------------------------------------------------------------------

_Q = torch.tensor([[2.0, 0.3], [0.3, 1.0]], dtype=torch.float64)
VOCABULARY = {
    "logsumexp": lambda s, u: torch.logsumexp(s, dim=-1),
    "var_std": lambda s, u: torch.var(s, dim=-1) + torch.std(s, dim=-1, correction=0),
    "softmax": lambda s, u: (torch.softmax(s, dim=-1) * u).sum(-1)
    + torch.log_softmax(u, dim=-1)[:, 0],
    "linear": lambda s, u: torch.nn.functional.linear(s, _Q, _Q[0]).sum(-1),
    "norms": lambda s, u: torch.linalg.norm(s, dim=-1) + torch.linalg.vector_norm(u, ord=1,
                                                                                  dim=-1),
    "index_roll_repeat": lambda s, u: s[:, [1, 0]].sum(-1) + torch.roll(s, 1, dims=-1)[:, 0]
    + s.repeat(1, 2).prod(-1),
    "max_min_dim": lambda s, u: s.max(dim=-1).values - u.min(dim=-1).values,
    "bmm_quadratic": lambda s, u: (s[:, None, :] @ _Q @ s[:, :, None]).reshape(-1),
    "scatter": lambda s, u: _scattered(s, u).sum(-1),
    "activations": lambda s, u: (torch.nn.functional.silu(s) + torch.nn.functional.gelu(u)
                                 + torch.nn.functional.softplus(s)
                                 + torch.nn.functional.leaky_relu(u, 0.2)).sum(-1),
    "remainder_floor_sign": lambda s, u: (torch.remainder(s, 0.7) + torch.floor(u)
                                          + torch.sign(s) * torch.fmod(u, 0.3)).sum(-1),
    "pad_flip_split": lambda s, u: sum(torch.split(torch.nn.functional.pad(
        torch.flip(s, dims=[-1]), (1, 1)), 2, dim=-1)).sum(-1),
    "int_and_bool": lambda s, u: ((s > 0).float() * 2 + (s > 0).sum(-1, keepdim=True)
                                  + torch.where(u < 0, 1, 3)).sum(-1),
}


def _scattered(s, u):
    out = torch.zeros_like(s)
    out[:, 0] = s[:, 1] * 2
    out[:, 1:] = u[:, :1] + 1
    return out


@pytest.mark.parametrize("name", list(VOCABULARY))
def test_port_vocabulary_against_torch(name):
    """Ops that JAX's programs do not use, traced and held against the torch
    function itself in float64 (rtol 1e-12)."""
    f = VOCABULARY[name]
    rs = np.random.RandomState(3)
    s, u = torch.from_numpy(rs.randn(B, 2)), torch.from_numpy(rs.randn(B, 2))
    prog, consts, (out,) = BL.trace_program(f, 2, 2, [1], torch.float64)
    got = prog.evaluate(out, consts, s, u, 0)[0]
    torch.testing.assert_close(got.expand(B), f(s, u).reshape(B).to(got.dtype), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name,f,what", [
    ("item", lambda s, u, t: s * float(t), "Python number"),
    ("if_on_t", lambda s, u, t: s if t > 3 else -s, "Python number"),
    ("random", lambda s, u, t: s + torch.randn_like(s), "random"),
    ("cat_batch", lambda s, u, t: torch.cat([s, u], dim=0)[:s.shape[0]], "batch axis"),
    ("select_batch", lambda s, u, t: s - s[0], "batch axis"),
    ("matmul_batch", lambda s, u, t: s @ (s.T @ u), "batch axis"),
])
def test_port_refusals_name_the_op(name, f, what):
    """What the bridge refuses, with the reason in the message: a Python
    number read from the timestep or a value (the trace would bake it in),
    a random op, and indexing, concatenating or contracting along the batch
    axis."""
    with pytest.raises(BL.UnsupportedPrimitive, match=what):
        BL.trace_program(f, 2, 2, [2], torch.float64, with_t=True)


def test_program_size_bound(monkeypatch):
    """A program over MAX_OPS scalar operations is refused."""
    monkeypatch.setattr(BL, "MAX_OPS", 10)
    W = torch.randn(2, 8, dtype=torch.float64)
    with pytest.raises(BL.UnsupportedPrimitive, match="scalar operations"):
        BL.trace_program(lambda s, u: torch.tanh(s @ W).sum(-1), 2, 2, [1], torch.float64)


def test_user_value_error_surfaces():
    """A ValueError of the user's code while it is traced is the user's
    bug, and surfaces."""
    def bad(s, u):
        raise ValueError("the user's bug")

    with pytest.raises(ValueError, match="the user's bug"):
        BL.trace_program(bad, 2, 2, [2], torch.float64)
