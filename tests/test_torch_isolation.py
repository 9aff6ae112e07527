"""The port never imports jax or the JAX package (the JAX package's own
__init__ imports jax and rewrites its config)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "lsc_dr_planner_tpu_torch"
MODULES = sorted(p.relative_to(PKG.parent).with_suffix("").as_posix().replace("/", ".")
                 for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "lsc_dr_planner_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", MODULES)
def test_module_source_imports_no_jax(module):
    path = PKG.parent / (module.replace(".", "/") + ".py")
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stderr
    added = json.loads(res.stdout.strip().splitlines()[-1])
    assert "lsc_dr_planner_tpu_torch" in added
    bad = [m for m in added if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
