"""``docs/PORT_TESTS.md`` stays whole: every test function of the JAX
package's 14 test files and of the 5 files of its real-chip lane
(``tpu_tests/``) has a row, every row names a JAX test that exists, every
port test a row names exists, and every case on the card a lane row names
is one ``chip_smoke.py`` runs.  The files are read with ``ast``, never
imported (``chip_smoke.py`` imports torch and needs a card); a port node id
is checked through its file and its ``def`` / ``class`` names (a
parametrization in brackets is not checked)."""
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
LANE_FILES = ("test_tpu_behavior", "test_tpu_pallas", "test_tpu_prng", "test_tpu_quality",
              "test_tpu_deploy")
STATUS = ("ported: ", "held by ", "not ported: ")
LANE_STATUS = ("chip: phase ", "held by ", "not ported: ")
PORT_ID = re.compile(r"`(tests/test_torch_\w+\.py)((?:::\w+)+)(?:\[[^\]`]*\])?`")
CHIP_CASE = re.compile(r"^chip: phase (\w+), case `([^`]+)`")


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


def rows(name: str, directory: str = "tests") -> dict:
    """The map's rows of ``{directory}/{name}.py``: JAX node id -> port cell."""
    out = {}
    prefix = f"| `{directory}/{name}.py::"
    for line in MAP.read_text().splitlines():
        if line.startswith(prefix):
            cells = [c.strip() for c in line.strip("|").split("|")]
            jid = cells[0].strip("`").split("::", 1)[1]
            assert jid not in out, f"two rows for {name}.py::{jid}"
            out[jid] = cells[1]
    return out


def chip_cases() -> tuple:
    """``chip_smoke.py``'s phase-13 cases (``TPU_LANE_CASES``), its phases
    (the labels it stamps) and every string it holds (a case of an earlier
    phase is named by the label it prints)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    lane, phases, strings = None, set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "TPU_LANE_CASES" for t in node.targets):
            lane = ast.literal_eval(node.value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "stamp" and isinstance(node.args[0], ast.Constant)):
            phases.add(node.args[0].value)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
    assert lane, "chip_smoke.py defines no TPU_LANE_CASES"
    return lane, phases, strings


def check_rows(directory, name, status):
    """The rows of one JAX file against its tests; returns them."""
    jax_ids = node_ids(REPO / directory / f"{name}.py")
    mapped = rows(name, directory)
    assert not jax_ids - set(mapped), f"JAX tests without a row: {sorted(jax_ids - set(mapped))}"
    assert not set(mapped) - jax_ids, f"rows of no JAX test: {sorted(set(mapped) - jax_ids)}"
    port_files = {}
    for jid, cell in mapped.items():
        assert cell.startswith(status), f"{jid}: the row must say one of {status}: {cell!r}"
        found = PORT_ID.findall(cell)
        assert found or cell.startswith(("not ported", "chip: ")), f"{jid}: no port test named"
        for path, parts in found:
            if path not in port_files:
                assert (REPO / path).is_file(), f"{jid}: no file {path}"
                port_files[path] = node_ids(REPO / path)
            assert parts[2:] in port_files[path], f"{jid}: no test {path}{parts}"
    return mapped


@pytest.mark.parametrize("name", JAX_FILES)
def test_map_is_whole(name):
    check_rows("tests", name, STATUS)


@pytest.mark.parametrize("name", LANE_FILES)
def test_lane_map_is_whole(name):
    """A lane row's case on the card: a phase-13 case of ``TPU_LANE_CASES``,
    or the label an earlier phase prints."""
    lane, phases, strings = chip_cases()
    for jid, cell in check_rows("tpu_tests", name, LANE_STATUS).items():
        if not cell.startswith("chip: "):
            continue
        m = CHIP_CASE.match(cell)
        assert m, f"{jid}: a chip row says `chip: phase N, case `name``: {cell!r}"
        phase, label = m.groups()
        assert phase in phases, f"{jid}: chip_smoke.py has no phase {phase}"
        if phase == "13":
            assert label in lane, f"{jid}: {label!r} is not in TPU_LANE_CASES"
        else:
            assert any(label in s for s in strings), f"{jid}: chip_smoke.py prints no {label!r}"


def test_every_lane_case_has_a_row():
    """Each phase-13 case holds a lane test: ``TPU_LANE_CASES`` names no
    case that no row of the map names."""
    lane = chip_cases()[0]
    named = set()
    for name in LANE_FILES:
        for cell in rows(name, "tpu_tests").values():
            m = CHIP_CASE.match(cell)
            if m and m.group(1) == "13":
                named.add(m.group(2))
    assert set(lane) == named, f"cases without a row: {sorted(set(lane) - named)}"
    assert len(lane) == len(set(lane)), "a case is named twice in TPU_LANE_CASES"
