"""Nothing of the benchmark loads JAX or the JAX package, and the plain
references load nothing of the program. Top-level module names are
compared whole: ``svtpu_torch`` is the program, ``svtpu`` the JAX
package."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "svtpu"}


def sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_jax_or_the_jax_package():
    for p in sources():
        assert not imported_roots(p) & FORBIDDEN, p


def test_references_import_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert "svtpu_torch" not in imported_roots(p), p


def test_loading_every_module_loads_no_jax():
    """Every module of the benchmark loaded in a fresh process (the
    drivers, readers and references by path, as the harness loads them):
    no module whose top-level name is JAX's or the JAX package's, and the
    references alone load nothing of the program."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.harness import load_module
import portbench.reference.rbvae, portbench.reference.data
refs_alone = sorted({{m.split('.')[0] for m in sys.modules}}
                    & {{'svtpu_torch', 'svtpu', 'jax'}})
for i, p in enumerate(sorted(Path({str(BENCH)!r}).rglob('*.py'))):
    if 'tests' not in p.parts:
        load_module(p, f'm{{i}}')
roots = {{m.split('.')[0] for m in sys.modules}}
print(refs_alone, sorted(roots & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.stdout.strip() == "[] []", out.stdout + out.stderr
