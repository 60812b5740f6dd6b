"""The PyTorch/CUDA port stands alone: no module of ``src/repro_torch`` and
not ``chip_smoke.py`` imports ``jax`` (or ``jaxlib``) or anything of the JAX
package ``repro``, at module level or inside a function."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def imported(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, top-level package) of every import statement in the tree."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module.split(".")[0]))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.append((node.lineno, node.args[0].value.split(".")[0]))
    return out


def test_files_found():
    assert len(FILES) > 30 and (ROOT / "chip_smoke.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in imported(tree) if mod in BANNED]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_each_form():
    src = ("import jax\nfrom repro.core import gf\nimport repro.storage.archive as a\n"
           "def f():\n    import jax.numpy as jnp\n    importlib.import_module('repro.x')\n"
           "from repro_torch.core import gf\nimport torch\n")
    assert sorted(m for _, m in imported(ast.parse(src))) == [
        "jax", "jax", "repro", "repro", "repro", "repro_torch", "torch"]
