"""The import guard: nothing the benchmark runs may load JAX or the JAX
package. Module names are compared by their top-level name (the part
before the first dot), whole: ``transport_analysis_tpu_torch`` is the
program under test, ``transport_analysis_tpu`` is forbidden.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "transport_analysis_tpu"})
PROGRAM = "transport_analysis_tpu_torch"
# files under perfbench that may not import the program either
PLAIN = ("reference.py", "work.py", "traffic.py", "generators")


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """Top-level names of ``sys.modules`` (or ``modules``) that are
    forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names} & FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Top-level names a Python file imports (``import a.b``, ``from a.b
    import c``, ``importlib.import_module("a.b")`` with a literal)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top(node.module))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.add(top(node.args[0].value))
    return names


def scan(bench_dir: Path) -> list[str]:
    """Each file of the benchmark that imports a forbidden name, and each
    plain file (the reference, the formulas, the generators) that imports
    the program, as ``path: name``."""
    bench_dir = Path(bench_dir)
    found = []
    for path in sorted(bench_dir.rglob("*.py")):
        rel = path.relative_to(bench_dir)
        names = imported_names(path)
        bad = names & FORBIDDEN
        if str(rel) in PLAIN or rel.parts[0] in PLAIN:
            bad |= names & {PROGRAM}
        found += [f"{rel}: {name}" for name in sorted(bad)]
    return found
