"""The port stands alone: no file of tbus_torch/, and not chip_smoke.py,
imports jax or anything of the JAX package (tbus)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, "tbus_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tbus")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_files_exist():
    files = _port_files()
    assert os.path.join(ROOT, "tbus_torch", "parallel", "runtime.py") in files
    assert all(os.path.exists(f) for f in files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_tbus(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
