"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their top-level name, whole: ``gossamer_tpu_torch`` is not
``gossamer_tpu``."""

import ast
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "gossamer_tpu"}


def imported(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").rglob("*.py")):
        assert not imported(path) & (JAX | {"gossamer_tpu_torch"}), path
        assert "import_module" not in path.read_text(), path


def test_the_run_names_what_it_finds_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gossamer_tpu_torch_fake.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gossamer_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["gossamer_tpu", "jaxlib"]
