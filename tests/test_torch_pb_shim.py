"""The protobuf-free build of the shared C++ core, checked on this host.

The port builds the core without libprotobuf where the compiler finds no
protobuf headers (tbus_torch/csrc/core/CMakeLists.txt): the headers under
tbus_torch/csrc/pb_shim stand in for protobuf's, first on the include
path, and tbus_torch/csrc/pb_absent.cc takes the place of cpp/rpc/pb.cc.
Here (a host with protobuf) the shim still comes first, so these checks
hold what the card's machine compiles:
- every function cpp/rpc/pb.h declares is defined in pb_absent.cc;
- the translation units that include protobuf headers compile against
  the shim (an override the shim lacks, or a pure virtual it adds, fails).
The whole protobuf-free build runs on the card (chip_smoke.py).
"""

import os
import re
import shutil
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(ROOT, "cpp")
CSRC = os.path.join(ROOT, "tbus_torch", "csrc")
SHIM = os.path.join(CSRC, "pb_shim")
FLAGS = ["-std=c++17", "-Wall", "-Wextra", "-Wno-unused-parameter",
         "-I", SHIM, "-I", CPP]

# The TUs of the core that include a protobuf header, and the port's own.
TUS = ["cpp/rpc/channel.cc", "cpp/rpc/controller.cc", "cpp/rpc/server.cc",
       "cpp/tpu/pjrt_runtime.cc", "cpp/capi/capi.cc",
       "tbus_torch/csrc/pb_absent.cc"]


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    return gxx


def _pb_h_functions():
    """(class or None, name) of every function pb.h declares without a
    body: free functions at namespace scope and out-of-line members."""
    with open(os.path.join(CPP, "rpc", "pb.h")) as f:
        src = f.read()
    # Join each declaration onto one line.
    src = re.sub(r",\s*\n\s*", ", ", src)
    out, cls = [], None
    for line in src.splitlines():
        m = re.match(r"class (\w+)", line)
        if m:
            cls = m.group(1)
            continue
        if line.startswith("};"):
            cls = None
            continue
        if line.lstrip().startswith("//") or not line.rstrip().endswith(";"):
            continue
        m = re.match(r"\s*(?:explicit\s+)?(?:[\w:<>]+[\s*&]+)*(\w+)\(", line)
        if m and m.group(1) not in ("return",):
            out.append((cls if line.startswith(" ") else None, m.group(1)))
    return out


def test_pb_h_declares_what_the_check_expects():
    names = {n for _, n in _pb_h_functions()}
    assert {"pb_serialize", "pb_parse", "PbCall", "AddPbService",
            "pb_services_dump", "pb_to_json", "json_to_pb", "Next",
            "BackUp", "Skip"} <= names, names


def test_pb_absent_defines_every_function_pb_h_declares(tmp_path):
    obj = tmp_path / "pb_absent.o"
    subprocess.run([_gxx(), *FLAGS, "-c", "-o", str(obj),
                    os.path.join(CSRC, "pb_absent.cc")], check=True,
                   capture_output=True, text=True)
    nm = subprocess.run(["nm", "-C", "--defined-only", str(obj)],
                        check=True, capture_output=True, text=True).stdout
    defined = {re.sub(r"\[abi:\w+\]", "", line.split(" ", 2)[2]).split("(")[0]
               for line in nm.splitlines() if line.count(" ") >= 2}
    missing = [f"{c}::{n}" if c else n for c, n in _pb_h_functions()
               if ("tbus::" + (f"{c}::" if c else "") + n) not in defined]
    assert not missing, missing
    # The flavour marker tbus_torch._native.core_flavor() looks up.
    assert "tbus_core_without_protobuf" in defined


@pytest.mark.parametrize("tu", TUS)
def test_tu_compiles_against_the_shim(tu):
    proc = subprocess.run([_gxx(), *FLAGS, "-fsyntax-only",
                           os.path.join(ROOT, tu)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
