"""Nothing the benchmark runs may load JAX or the JAX package ``amcx``, and
the plain reference may load nothing of the program (``amcx_torch``).
Top-level module names are compared whole: ``amcx_torch`` is not ``amcx``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "amcx"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_jax_package_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {n for n in _imports(path) if n.startswith("amcx")}
    text = path.read_text()
    assert "from .." not in text, "a relative import could reach the program's adapters"


def test_whole_name_comparison_tells_the_port_from_the_jax_package():
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench import run
    finally:
        sys.path.remove(str(ROOT))
    assert "amcx_torch".split(".")[0] not in run.FORBIDDEN
    assert "amcx.engine".split(".")[0] in run.FORBIDDEN


def test_loading_the_harness_and_a_route_loads_no_jax():
    code = ("import sys; from perfbench import run, control; "
            "from perfbench.routes import put_mega, maxcall_mega, put_fusedpath; "
            "import amcx_torch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'amcx')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
