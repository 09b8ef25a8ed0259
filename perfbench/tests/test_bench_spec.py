"""BENCHMARK.json keeps to the benchmark's rules, and every piece it
names is a file the harness finds."""

import json
import re

import pytest
from conftest import BENCH, REPO

import harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            extra = set(entry) - KEYS[group]
            assert set(entry) >= KEYS[group]
            assert extra <= ({"workloads"} if group in (
                "end_to_end", "per_layer") else set()), (group, extra)
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(set(names)) == len(names)
    for e in SPEC[group]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.fullmatch(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.fullmatch(key)


def test_command_and_paths():
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", [cell])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    b = harness.Bench(SPEC)
    for cell in cells:
        reported = {m["name"] for m in b.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert b.per_layer(cell)


def test_cells_and_budget():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    # a full check of 24 cells fits its 43200 s
    n = 24
    runs = 2 + 14 * n
    assert runs * (SPEC["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_every_piece_is_a_file():
    b = harness.Bench(SPEC)
    files = set()
    for c in SPEC["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        files.add(c["file"])
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"]
    assert len(files) == len(SPEC["configs"])
    for w in SPEC["workloads"]:
        b.config(w["config"])
        mix = b.traffic(w["traffic"])
        assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert callable(b.reader(m["name"]).read)
