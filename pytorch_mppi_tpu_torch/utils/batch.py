"""Batch-dimension handling utilities (counterpart of ``pytorch_mppi_tpu/utils/batch.py``).

``handle_batch_input`` lets a function written for n-dimensional inputs accept
inputs with extra leading batch dimensions: they are flattened before the call
and restored on every tensor output (reference contract:
``tests/test_batch_wrapper.py:5-47`` of pytorch_mppi).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray))


def handle_batch_input(n: int = 2):
    """Decorator: flatten >n leading batch dims before calling, restore after."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            batch_dims = None
            for arg in args:
                if _is_array(arg) and arg.ndim > n:
                    batch_dims = arg.shape[: -(n - 1)] if n > 1 else arg.shape
                    break
            if batch_dims is None:
                return func(*args, **kwargs)

            def flatten(a):
                if _is_array(a) and a.ndim > n:
                    return a.reshape(-1, *a.shape[-(n - 1):]) if n > 1 else a.reshape(-1)
                return a

            ret = func(*[flatten(a) for a in args], **kwargs)

            def restore(r):
                if _is_array(r):
                    return r.reshape(*batch_dims, *r.shape[1:])
                return r

            if isinstance(ret, tuple):
                return tuple(restore(r) for r in ret)
            return restore(ret)

        return wrapper

    return decorator


def ensure_tensor(device, dtype, *values):
    """Coerce values to tensors of ``dtype`` on ``device``."""
    coerced = tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in values)
    return coerced[0] if len(coerced) == 1 else coerced


def batch_quadratic_product(x, A):
    """x^T A x along the last dim for a batch of vectors."""
    return torch.einsum("...i,ij,...j->...", x, A, x)
