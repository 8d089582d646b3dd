"""Small example-support utilities (counterpart of ``pytorch_mppi_tpu/utils/cache.py``).

Native replacements for the ``arm_pytorch_utilities`` helpers the
reference's example scripts use: ``LocalCache`` (a pickled dict for
memoizing experiment results, reference ``tests/smooth_mppi.py:531``) and
``sort_nicely`` (human order for frame filenames, ``tests/smooth_mppi.py:270``).
The file format is the JAX package's: either package reads the other's cache.
"""
from __future__ import annotations

import os
import pickle
import re


class LocalCache(dict):
    """A dict persisted to a pickle file: ``cache = LocalCache("res.pkl")``,
    mutate it like a dict, call ``save()`` to persist."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.update(pickle.load(f))

    def save(self):
        with open(self.path, "wb") as f:
            pickle.dump(dict(self), f)


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def sort_nicely(items):
    """Sort strings in human order (frame2 < frame10). Sorts in place and
    returns the list."""
    items.sort(key=_natural_key)
    return items
