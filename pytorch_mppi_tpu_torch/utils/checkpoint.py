"""Checkpoint and resume of controller state and hyperparameters
(counterpart of ``pytorch_mppi_tpu/utils/checkpoint.py``).

``save``/``load`` write and read one ``.npz`` whose structure record is
self-describing, in the JAX package's format (version 2): a ``__spec__``
JSON header describes the tree (node kinds ``none``, ``dict``, ``nt`` for
the registered NamedTuples, ``tuple``, ``list``, ``str`` and ``leaf``, a
leaf's ``py`` naming a Python ``bool``, ``int`` or ``float``) and the leaves
are the arrays ``leaf_i``.  So a tree of plain arrays that one package
writes, the other reads; ``load`` rebuilds it in a fresh interpreter with no
example tree, and no pickle.

Tensors are written from ``.detach().cpu().numpy()`` and come back as CPU
tensors.  The port's controller state carries its random stream as the
Python ints ``seed`` and ``counter`` (``config.MPPIState``), which travel as
``int`` leaves; a JAX file's PRNG key has no counterpart here, and loading
one raises.
"""
from __future__ import annotations

import json
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 2


def _namedtuple_registry():
    # resolved when first used: the controller's modules import this package
    from ..config import (
        BatchedState,
        KMPPIParams,
        KMPPIState,
        MPPIParams,
        MPPIState,
        SMPPIParams,
        SMPPIState,
    )

    return {
        cls.__name__: cls
        for cls in (
            MPPIParams, SMPPIParams, KMPPIParams,
            MPPIState, SMPPIState, KMPPIState, BatchedState,
        )
    }


_EXTRA_NAMEDTUPLES: dict = {}


def register_checkpoint_namedtuple(cls):
    """Register a user NamedTuple so it survives a save/load round trip by
    name (the package's own state/params types are pre-registered)."""
    _EXTRA_NAMEDTUPLES[cls.__name__] = cls
    return cls


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _encode(obj, leaves: list):
    """Recursively encode a tree node into a JSON-able spec, appending leaf
    arrays to ``leaves`` in depth-first order."""
    if obj is None:
        return {"k": "none"}
    if isinstance(obj, dict):
        items = sorted(obj.items())  # jax's sorted-dict flatten order
        return {
            "k": "dict",
            "keys": [k for k, _ in items],
            "vals": [_encode(v, leaves) for _, v in items],
        }
    if _is_namedtuple(obj):
        return {
            "k": "nt",
            "cls": type(obj).__name__,
            "fields": [_encode(v, leaves) for v in obj],
        }
    if isinstance(obj, (tuple, list)):
        return {
            "k": "tuple" if isinstance(obj, tuple) else "list",
            "items": [_encode(v, leaves) for v in obj],
        }
    if isinstance(obj, str):
        return {"k": "str", "v": obj}
    idx = len(leaves)
    leaves.append(obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
                  else np.asarray(obj))
    py = type(obj).__name__ if isinstance(obj, (bool, int, float)) else None
    return {"k": "leaf", "i": idx, "py": py}


def _stream_position(cls, obj):
    """``obj`` of a state class of the port, whose ``seed`` and ``counter``
    must be the ints this package writes: a JAX state's key in their place
    raises."""
    if "seed" in cls._fields and not isinstance(obj.seed, int):
        raise ValueError(
            f"this checkpoint's {cls.__name__} holds a JAX PRNG key where "
            f"pytorch_mppi_tpu_torch's state carries its random stream as the ints "
            f"(seed, counter): a JAX controller's state cannot be resumed by the port")
    return obj


def _decode(spec, leaves):
    kind = spec["k"]
    if kind == "none":
        return None
    if kind == "dict":
        return {
            k: _decode(v, leaves) for k, v in zip(spec["keys"], spec["vals"])
        }
    if kind == "nt":
        registry = {**_namedtuple_registry(), **_EXTRA_NAMEDTUPLES}
        fields = [_decode(f, leaves) for f in spec["fields"]]
        cls = registry.get(spec["cls"])
        if cls is None:
            logger.warning(
                "checkpoint contains unregistered NamedTuple %r; returning a "
                "plain tuple (register it with register_checkpoint_namedtuple)",
                spec["cls"],
            )
            return tuple(fields)
        return _stream_position(cls, cls(*fields))
    if kind == "tuple":
        return tuple(_decode(v, leaves) for v in spec["items"])
    if kind == "list":
        return [_decode(v, leaves) for v in spec["items"]]
    if kind == "str":
        return spec["v"]
    if kind == "key":
        raise ValueError(
            f"this checkpoint holds a JAX PRNG key (impl {spec.get('impl')!r}), which "
            f"pytorch_mppi_tpu_torch does not have: the port's state carries its random "
            f"stream as the ints (seed, counter) in place of a key")
    if kind == "leaf":
        arr = leaves[spec["i"]]
        if spec.get("py") == "bool":
            return bool(arr)
        if spec.get("py") == "int":
            return int(arr)
        if spec.get("py") == "float":
            return float(arr)
        return torch.from_numpy(arr)
    raise ValueError(f"unknown checkpoint node kind {kind!r}")


def _flatten(tree) -> list:
    """The leaves of a tree in the file's order (a dict's sorted keys; None
    has none)."""
    if tree is None or isinstance(tree, str):
        return []
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in _flatten(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_flatten`'s order, by
    those of the iterator ``leaves``."""
    if tree is None or isinstance(tree, str):
        return tree
    if isinstance(tree, dict):
        new = {k: _unflatten(v, leaves) for k, v in sorted(tree.items())}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def tensors(tree) -> list:
    """The tensors of a tree, in the file's order (a dict's sorted keys)."""
    return [x for x in _flatten(tree) if isinstance(x, torch.Tensor)]


def map_tensors(tree, fn):
    """``tree`` with each tensor ``t`` replaced, in :func:`tensors`' order,
    by ``fn(t)``."""
    return _unflatten(tree, (fn(x) if isinstance(x, torch.Tensor) else x
                             for x in _flatten(tree)))


def _structure(tree):
    """What :func:`load_controller` holds equal: the tree's nodes, each
    NamedTuple's class and fields, and each leaf's kind (a tensor, or a
    Python scalar's type)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in sorted(tree.items())))
    if _is_namedtuple(tree):
        return (type(tree).__name__, tuple(zip(tree._fields, map(_structure, tree))))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(map(_structure, tree)))
    return "tensor" if isinstance(tree, torch.Tensor) else type(tree).__name__


def snapshot(ctrl):
    """An exact snapshot of a controller's mutable state: (solver state,
    tunable params), its tensors cloned, so that later commands and edits
    leave it as it was."""
    return map_tensors((ctrl._state, ctrl._params), lambda t: t.detach().clone())


def restore(ctrl, snap):
    """Restore a snapshot taken with :func:`snapshot` on a controller of the
    same configuration: its tensors go to the controller's device, and what
    the controller derives from them is brought up to date (the noise
    transform that the sigma's diagonality selects).  The next command, and
    ``run_mppi_jit``, which copies the controller's state into its graph's
    buffers at every run, continue from it."""
    state, params = map_tensors(snap, lambda t: t.to(ctrl.d))
    ctrl._state = state
    ctrl._params = params
    if hasattr(ctrl, "_diag_sigma"):
        ctrl.noise_sigma = params.noise_sigma
    return ctrl


def save(path: str, pytree):
    """Serialize a tree of tensors and arrays (dicts / lists / tuples / str /
    Python scalars / the package's NamedTuple types) to one self-describing
    .npz."""
    leaves: list = []
    spec = _encode(pytree, leaves)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    header = json.dumps({"version": _FORMAT_VERSION, "spec": spec})
    arrays["__spec__"] = np.frombuffer(header.encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str, like=None):
    """Load a tree saved with :func:`save`, its arrays as CPU tensors.

    The structure is rebuilt from the file's own spec: a fresh interpreter
    needs no example tree.  ``like=`` overrides the stored structure (the
    leaf order must match; every leaf comes back as a tensor)."""
    data = np.load(path, allow_pickle=False)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    raw = [data[f"leaf_{i}"] for i in range(n)]
    if like is not None:
        return _unflatten(like, (torch.from_numpy(x) for x in raw))
    if "__spec__" not in data.files:
        raise ValueError(
            f"{path} has no structure record (pre-v2 checkpoint?); pass like= "
            f"with an example tree to rebuild it"
        )
    header = json.loads(bytes(data["__spec__"]).decode())
    return _decode(header["spec"], raw)


def save_controller(path: str, ctrl):
    """Persist a controller's full resumable state (solver state + params)."""
    save(path, snapshot(ctrl))


def load_controller(path: str, ctrl):
    """Resume a controller from :func:`save_controller` output.  The
    controller must be built with the same configuration (the same class and
    shapes; its seed may differ: the stream position is restored).  A
    different structure (NamedTuple class, fields, None against a tensor)
    or a different leaf shape or dtype raises a ValueError."""
    snap = load(path)
    want = (ctrl._state, ctrl._params)
    got_s, want_s = _structure(snap), _structure(want)
    if got_s != want_s:
        raise ValueError(
            f"checkpoint structure {got_s} does not match the controller's {want_s}: "
            f"was it saved from the same controller class (MPPI/SMPPI/KMPPI/MPPI_Batched) "
            f"and configuration (num_elites, ...)?")
    for got, w in zip(_flatten(snap), _flatten(want)):
        if isinstance(got, torch.Tensor) and (got.shape != w.shape or got.dtype != w.dtype):
            raise ValueError(
                f"checkpoint leaf shape {tuple(got.shape)} {got.dtype} does not match the "
                f"controller's {tuple(w.shape)} {w.dtype}: was it built with the same "
                f"configuration?")
    return restore(ctrl, snap)
