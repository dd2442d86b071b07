"""What the benchmark may load: no module of bench/ imports JAX or the JAX
package `repro` (top-level names compared whole: the port's `repro_torch`
begins with `repro`), nothing reads the JAX package's `benchmarks/`, and
the plain reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _strings(path: Path):
    """String constants of a source, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = set(_imports(path))
    assert not tops & FORBIDDEN, f"{path}: imports {tops & FORBIDDEN}"
    if path != Path(__file__):          # this file holds the needle
        assert not [c for c in _strings(path) if "benchmarks" in c], \
            f"{path} names the JAX package's benchmark directory"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imports(path))
    assert "harness" not in set(_imports(path))


def test_a_run_loads_no_jax():
    """Import everything a run imports, in a fresh interpreter, and look at
    sys.modules as the harness does after its window."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.main, reference.decoder, repro_torch.launch.serve\n"
        "import repro_torch.serving.proxy\n"
        "harness.main.files.arch(harness.main.deploy.ARCH_DIR, 'decoder')\n"
        "print(harness.main.forbidden_modules())\n"
        "sys.modules['flax'] = sys; sys.modules['repro.core'] = sys\n"
        "print(harness.main.forbidden_modules())\n"
    ) % (str(BENCH), str(BENCH.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")
    assert out[0] == "[]"
    assert out[1] == "['flax', 'repro.core']"
