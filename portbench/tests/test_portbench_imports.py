"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), and the plain
reference imports nothing of the program either."""
import ast
import importlib
import json
import sys

import pytest
from conftest import ROOT, cpu_run

from portbench import harness

BENCH = ROOT / "portbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((BENCH / "reference").rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, top-level name) of every import in the tree, at any depth."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module.split(".")[0]))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append((node.lineno, str(node.args[0].value).split(".")[0]))
    return out


def test_files_found():
    assert len(FILES) > 20 and REFERENCE


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    bad = [(line, m) for line, m in imported(ast.parse(path.read_text())) if m in BANNED]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    mods = {m for _, m in imported(ast.parse(path.read_text()))}
    assert "repro_torch" not in mods and "portbench" not in mods
    assert "repro_torch" not in path.read_text()


def test_guard_catches_each_form():
    src = ("import jax\nfrom repro.core import gf\nimport repro.x as a\n"
           "def f():\n    import flax\n    importlib.import_module('repro.y')\n"
           "from repro_torch.core import gf\n")
    names = sorted(m for _, m in imported(ast.parse(src)))
    assert names == ["flax", "jax", "repro", "repro", "repro", "repro_torch"]
    assert "repro_torch" not in BANNED


def test_report_prints_the_result_with_the_checks_last(capsys):
    r = cpu_run("rr16-restore-1")
    capsys.readouterr()
    assert harness.forbidden_modules() == [] and harness.report(r) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check failed_calls 0 limit 0"


def test_a_module_loaded_after_the_window_refuses_the_result(tmp_path, monkeypatch, capsys):
    """A metric reader, run after the window, that imports a module named
    ``jax``: the run exits 3 and prints no result."""
    stub = "jax"     # an empty package of that name, first on the path
    (tmp_path / stub).mkdir()
    (tmp_path / stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    importlib.invalidate_caches()
    assert harness.forbidden_modules() == []
    real = harness.load_module

    class Reader:
        def __init__(self, mod):
            self.mod = mod

        def read(self, run):
            importlib.import_module(stub)
            return self.mod.read(run)

    monkeypatch.setattr(harness, "load_module", lambda folder, name: (
        Reader(real(folder, name)) if folder == "metrics" else real(folder, name)))
    try:
        r = cpu_run("rr16-restore-1")
        capsys.readouterr()
        assert sys.modules[stub].__file__.startswith(str(tmp_path))
        assert harness.report(r) == 3
        out, err = capsys.readouterr()
        assert out == "" and "refusing to report: ['jax']" in err
    finally:
        sys.modules.pop(stub, None)
