"""Nothing under listbench/ imports JAX or the JAX package, by whole
top-level names (so ``repro_torch`` passes), and the reference imports
nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_OK = {"__future__", "math", "heapq", "torch", "numpy", "listbench"}


def imports(path: Path):
    """Top-level names and full module paths a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append(node.args[0].value)
    return out


def py_files():
    return sorted(BENCH.rglob("*.py"))


def test_top_level_names_compare_whole():
    names = {m.split(".")[0] for m in ["repro_torch.api", "repro.core"]}
    assert names & FORBIDDEN == {"repro"}


@pytest.mark.parametrize("path", py_files(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    bad = [m for m in imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for m in imports(path):
        top = m.split(".")[0]
        assert top in REFERENCE_OK, f"{path.name} imports {m}"
        if top == "listbench":
            assert m.startswith("listbench.reference"), \
                f"{path.name} imports {m}, outside the reference"
