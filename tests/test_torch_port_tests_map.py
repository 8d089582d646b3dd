"""``docs/PORT_TESTS.md`` stays whole: every test function of the JAX
package's 14 test files has a row, every row names a JAX test that exists,
and every port test a row names exists.  The files are read with ``ast``,
never imported; a port node id is checked through its file and its
``def`` / ``class`` names (a parametrization in brackets is not checked)."""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
MAP = REPO / "docs" / "PORT_TESTS.md"
JAX_FILES = ("test_autotune", "test_batch_last", "test_batch_wrapper", "test_benchmarks",
             "test_deploy", "test_distributed", "test_examples", "test_extensions",
             "test_models", "test_mppi", "test_pallas_transposed",
             "test_reference_equivalence", "test_sharding", "test_utils")
STATUS = ("ported: ", "held by ", "not ported: ")
PORT_ID = re.compile(r"`(tests/test_torch_\w+\.py)((?:::\w+)+)(?:\[[^\]`]*\])?`")


def node_ids(path: Path) -> set:
    """``Class::test`` and ``test`` node ids of the file's test functions."""
    def is_test(node):
        return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
            node.name.startswith("test")

    ids = set()
    for node in ast.parse(path.read_text()).body:
        if is_test(node):
            ids.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            ids.update(f"{node.name}::{sub.name}" for sub in node.body if is_test(sub))
    return ids


def rows(name: str) -> dict:
    """The map's rows of ``tests/{name}.py``: JAX node id -> port cell."""
    out = {}
    prefix = f"| `tests/{name}.py::"
    for line in MAP.read_text().splitlines():
        if line.startswith(prefix):
            cells = [c.strip() for c in line.strip("|").split("|")]
            jid = cells[0].strip("`").split("::", 1)[1]
            assert jid not in out, f"two rows for {name}.py::{jid}"
            out[jid] = cells[1]
    return out


@pytest.mark.parametrize("name", JAX_FILES)
def test_map_is_whole(name):
    jax_ids = node_ids(REPO / "tests" / f"{name}.py")
    mapped = rows(name)
    assert not jax_ids - set(mapped), f"JAX tests without a row: {sorted(jax_ids - set(mapped))}"
    assert not set(mapped) - jax_ids, f"rows of no JAX test: {sorted(set(mapped) - jax_ids)}"
    port_files = {}
    for jid, cell in mapped.items():
        assert cell.startswith(STATUS), f"{jid}: the row must say one of {STATUS}: {cell!r}"
        found = PORT_ID.findall(cell)
        assert found or cell.startswith("not ported"), f"{jid}: no port test named"
        for path, parts in found:
            if path not in port_files:
                assert (REPO / path).is_file(), f"{jid}: no file {path}"
                port_files[path] = node_ids(REPO / path)
            assert parts[2:] in port_files[path], f"{jid}: no test {path}{parts}"
