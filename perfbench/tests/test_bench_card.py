"""On a card: each cell runs a short window and comes out correct, and its
control does not. Marked ``cuda``; skips without a card."""

import json
import time

import pytest
import torch
from conftest import REPO

import control
import harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    bench = harness.Bench(SPEC)
    out = harness.run(bench, cell, 2**31 + 99, 1.0, False,
                      t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    w = bench.workload(cell)
    mix = bench.traffic(w["traffic"])
    wrap = control.control_wrap(mix["kind"], bench.config(w["config"]), mix,
                                card)
    out = harness.run(bench, cell, 2**31 + 99, 1.0, False,
                      t_start=time.perf_counter(), wrap=wrap)
    assert not out["correct"]
    torch.cuda.empty_cache()
