"""The import checks: a measuring process holds nothing of JAX or of the
JAX package, and the yardstick's plain parts hold nothing of the program.

Modules are compared by their whole top-level name (the part before the
first dot): the port's package ``repro_torch`` begins with the JAX
package's name ``repro`` and is not it.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List

#: top-level names no measuring process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: top-level names the generator and the reference may not import
PROGRAM = ("repro_torch",) + FORBIDDEN
#: the yardstick's folders that stand apart from the program
PLAIN = ("gen", "reference")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def imported_roots(path: Path) -> List[str]:
    """Top-level names of every module a Python file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return sorted(out)


def program_imports(bench_dir: Path) -> List[str]:
    """``file: module`` for each import of the program (or of JAX) in the
    generator's and the reference's files."""
    bad = []
    for sub in PLAIN:
        for path in sorted((bench_dir / sub).rglob("*.py")):
            bad += [f"{path.relative_to(bench_dir)}: {m}"
                    for m in imported_roots(path) if m in PROGRAM]
    return bad
