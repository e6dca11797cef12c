"""BENCHMARK.json and the files it names: every cell's configuration, the
layout it names and its traffic mix, every per-layer metric's reader,
found by name, and the contract's limits on names, units and keys."""

import glob
import json
import os
import re

import pytest

from harness import spec, traffic

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = spec.Cell(BENCH, cell)
    assert c.config["name"] == c.entry["config"]
    traffic.check(c.traffic)
    assert c.traffic["method"] in c.config["methods"]
    assert c.traffic["method"] in c.config["guarantee"]
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_names_units_and_keys():
    names = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        names += [w["name"], w["config"], w["traffic"]]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        names.append(c["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    for group in ("workloads", "configs", "end_to_end"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("name", spec.layouts())
def test_a_layout_is_found_by_name(name):
    layout = spec.layout(name)
    assert layout.__name__ == "Layout"
    for method in ("counters", "window", "close"):
        assert callable(getattr(layout, method)), method


def test_the_layouts():
    assert {"client_server", "fanout_in_process"} <= set(spec.layouts())


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    spec.BENCH_DIR, "configs", "*.json"))), ids=os.path.basename)
def test_every_configuration_names_a_known_layout(path):
    assert spec.load_json(path)["layout"] in spec.layouts()


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_brings_up_the_layout_its_configuration_names(cell):
    c = spec.Cell(BENCH, cell)
    assert c.layout.__module__ == f"bench_layout_{c.config['layout']}"


def test_an_unknown_layout_names_the_known_ones(tmp_path):
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    config = dict(spec.Cell(BENCH, CELLS[0]).config, layout="no_such")
    (tmp_path / "benchmark" / "configs" / "x.json").write_text(
        json.dumps(config))
    bench = dict(BENCH, configs=[{"name": "x",
                                  "file": "benchmark/configs/x.json"}],
                 workloads=[dict(BENCH["workloads"][0], config="x")])
    with pytest.raises(KeyError, match="no_such") as err:
        spec.Cell(bench, BENCH["workloads"][0]["name"], root=str(tmp_path))
    assert ", ".join(spec.layouts()) in str(err.value)


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="rdma_perf.xor_1m.c8"):
        spec.Cell(BENCH, "no_such_cell")


def test_payloads_follow_the_seed():
    mix = {"method": "Xor", "clients": 3, "payload_bytes": 100,
           "payloads_per_client": 2, "rate": 0,
           "warmup_calls_per_client": 1, "timeout_ms": 100,
           "client_workers": 0}
    a, b = traffic.payloads(mix, 2**31 + 7), traffic.payloads(mix, 2**31 + 7)
    assert a.shape == (3, 2, 100) and (a == b).all()
    assert not (a == traffic.payloads(mix, 2**31 + 8)).all()
    assert traffic.payloads(mix, -5).shape == (3, 2, 100)
    with pytest.raises(ValueError):
        traffic.check(dict(mix, clients=0))
