"""Nothing the benchmark runs imports JAX or the JAX package (tbus), by
top-level module name compared whole: tbus_torch, the port, is not tbus;
that covers every file of benchmark/, the layouts (benchmark/layouts/) and
the reference's rules (benchmark/references/) among them. The reference
and its rules import nothing of the program at all."""

import glob

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "tbus")


def _py_files():
    out = []
    for d, dirs, names in os.walk(BENCH):
        dirs[:] = [x for x in dirs if not x.startswith(("_", "."))]
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(module):
    return module.split(".")[0]


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if _top(m) in FORBIDDEN]
    assert not bad, bad


def test_top_level_names_compare_whole():
    assert _top("tbus_torch.rpc") not in FORBIDDEN
    assert _top("tbus.rpc") in FORBIDDEN
    assert _top("jax") in FORBIDDEN


REFERENCE = [os.path.join(BENCH, "harness", "reference.py")] + sorted(
    glob.glob(os.path.join(BENCH, "references", "*.py")))


def test_the_scan_covers_the_layouts_and_the_rules():
    scanned = {os.path.relpath(p, BENCH) for p in _py_files()}
    for d in ("layouts", "references"):
        found = {os.path.relpath(p, BENCH)
                 for p in glob.glob(os.path.join(BENCH, d, "*.py"))}
        assert found and found <= scanned, d


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "typing", "numpy", "glob", "importlib", "os"}
    got = {_top(m) for m in _imports(path)}
    assert got <= allowed, got


def test_a_run_loads_neither_once_its_modules_are_in():
    """Every module of the harness, every layout, every rule and every
    metric's reader, imported in a fresh process with the port's RPC
    layer: no forbidden name lands in sys.modules."""
    code = f"""
import glob, os, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import run
from harness import cell, client, deploy, gen, guard, reference, roofline, \\
    spec, stats, timeline, trace, traffic
import tbus_torch.rpc
for path in glob.glob(os.path.join({BENCH!r}, "metrics", "*.py")):
    spec.reader(os.path.basename(path)[:-3])
for name in spec.layouts():
    spec.layout(name)
for name in reference.known():
    reference.rule(name)
found = guard.forbidden_modules()
assert not found, found
print("CLEAN")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0 and "CLEAN" in proc.stdout, proc.stderr[-2000:]
