"""BENCHMARK.json keeps to the benchmark's contract: the keys, names,
units and bounds, and every cell, configuration, traffic file and metric
it names exists here."""
import json
import pathlib
import re

from bench import harness, workload

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    b = _bench()
    names = {c["name"] for c in b["configs"]}
    assert len(names) == len(b["configs"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        _line(c["why"])
        _line(c["source"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert conf["published"][key] != conf[key]
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4)
        _line(w["why"])
        workload.load_traffic(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    used = {w["config"] for w in b["workloads"]}
    assert used == names


def test_metrics():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
        harness.reader(m["name"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        _line(m["layer"])
        # each cell it lists reports the metric it moves
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        got = {m["name"] for m in harness.cell_metrics(b, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(b, cell, True)
