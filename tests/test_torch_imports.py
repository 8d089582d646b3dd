"""Import hygiene of the port: no module of ``pytorch_mppi_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, optax or the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "pytorch_mppi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "optax", "pytorch_mppi_tpu"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_package_is_allowed():
    assert not _forbidden("pytorch_mppi_tpu_torch")
    assert not _forbidden("pytorch_mppi_tpu_torch.ops.solve")
    assert _forbidden("jax.numpy") and _forbidden("pytorch_mppi_tpu.ops")
    assert _forbidden("optax")
