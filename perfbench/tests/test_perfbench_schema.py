"""BENCHMARK.json against the benchmark's contract: keys, names and
units, cells and their configurations, and that each per-layer metric
moves an end-to-end metric its cells report; and BENCHMARK.json with the
shelved entries (`shelved.json`) moved in, so that moving them is
enough."""

import json
import re

import pytest

from conftest import REPO, bench, with_shelved

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ROOT = REPO / "perfbench"
BOTH = pytest.mark.parametrize("load", [bench, with_shelved],
                               ids=["benchmark", "with_shelved"])


def reports(b, metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in
                                            b["workloads"]])


def test_top_level():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == [
        "python3", "perfbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@BOTH
def test_names_units_and_lines(load):
    b = load()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for k in ("end_to_end", "per_layer"):
        for m in b[k]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert m["source"] in SOURCES
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
        assert "\t" not in x["why"]


@BOTH
def test_configs_and_cells(load):
    b = load()
    configs = {c["name"]: c for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()
        mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (ROOT / "kinds" / f"{mix['kind']}.py").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


@BOTH
def test_metrics(load):
    b = load()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m for m in b["end_to_end"] if reports(b, m, cell)]
        assert len(mine) >= 2 and any(m["name"] == "setup_s" for m in mine)
        assert any(reports(b, m, cell) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert reports(b, e2e[m["moves"]], cell)
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"].lower(), m["layer"])
        assert layers[m["layer"].lower()] == m["layer"]


def test_every_file_is_named_from_name_characters():
    for p in ROOT.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.match(r"[A-Za-z0-9_./-]+\Z", rel), rel
