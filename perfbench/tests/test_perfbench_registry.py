"""The harness finds every piece by name, and BENCHMARK.json keeps to the
benchmark's format."""

import json
import os
import re

import pytest

from perfbench import cell as cells

BENCH = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_pieces(workload):
    c = cells.find(workload)
    assert c.traffic["driver"] in ("sample", "train", "serve")
    assert c.driver.run and c.driver.control
    assert set(c.limits["checks"])
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.find("no-such-cell")
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric")


def test_benchmark_json_format():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["perfbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024
