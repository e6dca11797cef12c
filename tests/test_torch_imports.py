"""The port stands alone: no file of tbus_torch/, and none of
chip_smoke.py, loss_host_split.py and fold_turns.py, imports jax or
anything of the JAX package (tbus), neither in its code nor in the Python source it hands to
child processes (launch_local bodies, the dryrun's RPC leg). The card's
test files, which run there without tests/conftest.py, import neither
either."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "loss_host_split.py"),
             os.path.join(ROOT, "fold_turns.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, "tbus_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    tests = os.path.join(ROOT, "tests")
    files += [os.path.join(tests, n) for n in os.listdir(tests)
              if n.startswith("test_torch_") and n.endswith("_cuda.py")]
    return sorted(files)


# An import line inside a string constant: source run by a child process.
_SOURCE_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.MULTILINE)


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tbus")


def _imports(path):
    with open(path) as f:
        yield from _imports_of_source(f.read(), path)


def _imports_of_source(source, path="<string>"):
    tree = ast.parse(source, path)
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
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield from _SOURCE_IMPORT.findall(node.value)


_EXPECTED = [
    "tbus_torch/parallel/runtime.py", "tbus_torch/parallel/collective.py",
    "tbus_torch/parallel/distributed.py", "tbus_torch/parallel/params.py",
    "tbus_torch/kernels/gemm.py", "tbus_torch/kernels/ring_fold.py",
    "tbus_torch/entry.py", "tests/test_torch_row_transform_cuda.py",
    "tests/test_torch_gemm_cuda.py", "tests/test_torch_ring_fold_cuda.py",
    "tests/test_torch_entry_cuda.py", "tbus_torch/kernels/device_programs.py",
    "tbus_torch/rpc.py", "tbus_torch/_native.py",
    "tests/test_torch_device_cuda.py", "tbus_torch/kernels/fanout.py",
    "tests/test_torch_fanout_cuda.py", "tbus_torch/kernels/loss_update.py",
    "tests/test_torch_loss_update_cuda.py",
]


def test_port_files_exist():
    files = _port_files()
    for rel in _EXPECTED:
        assert os.path.join(ROOT, *rel.split("/")) in files, rel
    assert all(os.path.exists(f) for f in files)


def test_source_strings_are_checked():
    """The check reads the sources handed to children: an import of jax
    in a string constant is caught."""
    tree = 'BODY = """\nimport numpy\nfrom jax import numpy\n"""\n'
    assert list(_imports_of_source(tree)) == ["numpy", "jax"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_tbus(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
